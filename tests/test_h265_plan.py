"""H.265 Phase-B roundtrip: the JAX whole-picture graph vs the Python
decoder (itself differentially bit-exact vs the reference binary, see
test_h265_decode.py).

One decode collects the Phase-A plans + per-picture oracle planes;
replay_plans re-runs every picture through the jitted Phase-B graph
over a fresh frame pool and must reproduce each picture byte-for-byte
(including frame-pool staleness in the padding domains)."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402

from m2dec_tpu.codecs.h265 import reconstruct as RC  # noqa: E402
from m2dec_tpu.codecs.h265.headers import H265Decoder  # noqa: E402


def run_roundtrip(gen, n_pics):
    data = gen.generate(n_pics)
    dec = H265Decoder()
    dec.set_data(data)
    dec.decode_all(collect_plans=True, keep_oracle=True)
    assert dec.plans
    outs = RC.replay_plans(dec.plans)
    for i, (p, (y, cb, cr)) in enumerate(zip(dec.plans, outs)):
        oy, ocb, ocr = p.oracle
        for name, a, b in (("y", y, oy), ("cb", cb, ocb),
                           ("cr", cr, ocr)):
            assert np.array_equal(a, b), \
                f"pic {i} plane {name}: " \
                f"{np.count_nonzero(a != b)} pixel diffs"


CASES = {
    "intra_16ctb": (dict(seed=1), (64, 48), 2),
    "intra_nonaligned": (dict(seed=3), (52, 36), 2),
    "residual_deep": (dict(seed=14, ctb_log2=5, qp=16, split_prob=0.8,
                           nxn_prob=0.8, cbf_prob=0.6), (64, 64), 2),
    "angular_all": (dict(seed=21, qp=14, cbf_prob=0.4,
                         modes=ALL_MODES), (64, 48), 3),
    "angular_ctb32_strong": (dict(seed=22, ctb_log2=5, qp=14,
                                  cbf_prob=0.3, modes=ALL_MODES,
                                  strong_smoothing=1, split_prob=0.3),
                             (96, 64), 2),
    "sdh_tskip": (dict(seed=32, qp=14, cbf_prob=0.7, modes=ALL_MODES,
                       transform_skip=1, sign_data_hiding=1,
                       split_prob=0.7, nxn_prob=0.8), (64, 48), 2),
    "deblock": (dict(seed=41, qp=30, cbf_prob=0.5, modes=ALL_MODES,
                     deblock=1, max_level=1), (64, 48), 3),
    "sao_deblock": (dict(seed=53, qp=32, cbf_prob=0.5, modes=ALL_MODES,
                         sao=1, deblock=1, max_level=1), (64, 48), 3),
    "p_filters": (dict(seed=62, qp=32, cbf_prob=0.4, modes=ALL_MODES,
                       deblock=1, sao=1, max_level=1), (64, 48),
                  "IPPP"),
    "p_amvp": (dict(seed=71, qp=14, cbf_prob=0.4, modes=ALL_MODES,
                    tmvp=1, amvp_prob=1.0, skip_prob=0.0), (64, 48),
               "IPPP"),
    "b_filters": (dict(seed=82, qp=32, cbf_prob=0.4, modes=ALL_MODES,
                       tmvp=1, deblock=1, sao=1, max_level=1), (64, 48),
                  "IPBPB"),
    "amp": (dict(seed=92, qp=14, cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
                 part_mode_prob=0.6, amp=1), (64, 48), "IPB"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_b_roundtrip(case):
    kw, (w, h), n = CASES[case]
    run_roundtrip(H265StreamGen(w, h, **kw), n)


def test_kernel_units():
    """Residual transform matrices reproduce the butterflies exactly
    (matrix form of _lineN; saturations only at the two stage ends)."""
    from m2dec_tpu.codecs.h265 import residual as R

    rng = np.random.RandomState(0)
    for sl2 in (2, 3, 4, 5):
        size = 1 << sl2
        col = rng.randint(-512, 512, size).tolist()
        want = R._LINE[sl2](col, 1, lambda v: v)
        got = RC._TMAT[sl2] @ np.asarray(col)
        assert np.array_equal(got, want)


# -- multi-slice pictures through Phase B: row-aligned
#    slice segments replay the reference's per-segment decode ->
#    window-masked deblock -> whole-frame SAO sequence in the jit graph
#    (slice_layer, /root/reference/src/lib/h265.cpp:4682-4729) ---------


class _MultiSliceGen(H265StreamGen):
    def __init__(self, *args, slices_per_pic=2, **kw):
        super().__init__(*args, **kw)
        self.slices_per_pic = slices_per_pic


@pytest.mark.parametrize("nsl", [2, 3, 4])
def test_phase_b_roundtrip_multi_slice(nsl):
    gen = _MultiSliceGen(64, 96, seed=100 + nsl, qp=30, cbf_prob=0.5,
                         modes=ALL_MODES, deblock=1, sao=1, max_level=1,
                         slices_per_pic=nsl)
    data = gen.generate(3)
    dec = H265Decoder()
    dec.set_data(data)
    dec.decode_all(collect_plans=True, keep_oracle=True)
    assert dec.plans
    assert any(p.multi_slice and len(p.slice_rows) == nsl
               for p in dec.plans)
    outs = RC.replay_plans(dec.plans)
    for i, (p, (y, cb, cr)) in enumerate(zip(dec.plans, outs)):
        oy, ocb, ocr = p.oracle
        for name, a, b in (("y", y, oy), ("cb", cb, ocb),
                           ("cr", cr, ocr)):
            assert np.array_equal(a, b), \
                f"pic {i} plane {name} ({nsl} segments): " \
                f"{np.count_nonzero(a != b)} pixel diffs"
