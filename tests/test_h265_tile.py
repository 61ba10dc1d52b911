"""CTU-tile intra wavefront (reconstruct._wavefront_tile): the
statically-unrolled z-slot diagonal scan vs the dependency-level
schedule and the Python oracle.

The tile path is the auto default for CTB 16 (every default-ctb case in
test_h265_plan.py already rides it); these tests pin the two backends
against each other explicitly and force the CTB-32 tile variant (S=32
slots + strong smoothing) that auto mode leaves on the level path.
Reference CTU walk being modelled: /root/reference/src/lib/h265.cpp:4752-4799.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402

from m2dec_tpu.codecs.h265 import reconstruct as RC  # noqa: E402
from m2dec_tpu.codecs.h265.headers import H265Decoder  # noqa: E402


def _replay(gen_kw, size, n, mode, monkeypatch):
    monkeypatch.setenv("M2DEC_TPU_H265_WF", mode)
    gen = H265StreamGen(*size, **gen_kw)
    dec = H265Decoder()
    dec.set_data(gen.generate(n))
    dec.decode_all(collect_plans=True, keep_oracle=True)
    assert dec.plans
    outs = RC.replay_plans(dec.plans)
    for i, (p, (y, cb, cr)) in enumerate(zip(dec.plans, outs)):
        oy, ocb, ocr = p.oracle
        for name, a, b in (("y", y, oy), ("cb", cb, ocb),
                           ("cr", cr, ocr)):
            assert np.array_equal(a, b), \
                f"{mode} pic {i} plane {name}: " \
                f"{np.count_nonzero(a != b)} diffs"
    return outs


KW4 = dict(seed=7, qp=30, cbf_prob=0.5, modes=ALL_MODES, deblock=1,
           sao=1, max_level=1)


@pytest.mark.parametrize("mode", ["tile", "level"])
def test_tile_vs_level_ctb16(mode, monkeypatch):
    """Both wavefront backends reproduce the oracle byte-for-byte on
    the same CTB-16 IPB stream (all 35 modes, residuals, deblock,
    SAO)."""
    _replay(KW4, (96, 64), "IPB", mode, monkeypatch)


def test_tile_ctb32_strong(monkeypatch):
    """Env-forced tile wavefront at CTB 32: 64 luma z-slots, 32x32 TUs,
    strong intra smoothing (auto mode keeps level here for XLA:CPU
    compile cost — see wf_mode_for)."""
    _replay(dict(seed=22, ctb_log2=5, qp=14, cbf_prob=0.3,
                 modes=ALL_MODES, strong_smoothing=1, split_prob=0.3),
            (96, 64), 2, "tile", monkeypatch)


def test_tile_turbo_batched(monkeypatch):
    """The batched H265SeqPhaseB scan graph through the tile wavefront
    (stack_plans tile tensors) matches the serial decode."""
    monkeypatch.setenv("M2DEC_TPU_H265_WF", "tile")
    gen = H265StreamGen(96, 64, **KW4)
    data = gen.generate("IPBPB")
    from m2dec_tpu.runtime.turbo import TurboH265Decoder

    ser = H265Decoder()
    ser.set_data(data)
    ref = ser.decode_all(backend="python")
    got = TurboH265Decoder(data, batch=3).decode_all()
    assert len(got) == len(ref) > 0
    for i, (a, b) in enumerate(zip(ref, got)):
        for nm in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, nm)),
                                  np.asarray(getattr(b, nm))), (i, nm)
