"""H.265 end-to-end bit-exactness: our decoder vs the reference binary.

Randomized conformance streams (tests/streamgen/h265_enc.py) decoded by
the compiled reference (`h264dec -o <file>.265`, extension selects the
HEVC codec) must match our output byte-for-byte.

Reference-domain constraints baked into the generator (found by probing
the reference, see h265_enc.py): num_short_term_ref_pic_sets must cover
every frame-pool index (colpics carve, h265.cpp:121-129) and rps[0] is
parsed even when the count is zero (h265.cpp:487-495).
"""

import pathlib
import subprocess
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h265_enc import H265StreamGen  # noqa: E402

from m2dec_tpu.codecs.h265.headers import H265Decoder  # noqa: E402
from m2dec_tpu.runtime.output import cropped_nv12_bytes  # noqa: E402


def oracle_decode(reference_bins, data: bytes, tmp_path) -> bytes:
    src = tmp_path / "in.265"
    src.write_bytes(data)
    subprocess.run(
        [str(reference_bins["h264dec"]), "-o", "in.265"],
        cwd=tmp_path,
        capture_output=True,
    )
    return (tmp_path / "in.out").read_bytes()


def run_case(reference_bins, tmp_path, gen, n_pics=2):
    data = gen.generate(n_pics)  # int -> IDR count, str -> pattern
    golden = oracle_decode(reference_bins, data, tmp_path)
    assert golden, "reference produced no output"
    dec = H265Decoder()
    dec.set_data(data)
    ours = b"".join(cropped_nv12_bytes(f) for f in dec.decode_all())
    assert ours == golden


def test_intra_idr_16ctb(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path, H265StreamGen(64, 48, seed=1), 3)


def test_intra_idr_32ctb(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=2, ctb_log2=5), 2)


def test_intra_nonaligned_size(reference_bins, tmp_path):
    """Frame-boundary-forced quad splits (no split flag coded)."""
    run_case(reference_bins, tmp_path,
             H265StreamGen(52, 36, seed=3), 2)


def test_intra_qp_range(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=4, qp=40), 2)


def test_intra_deep_split(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 64, seed=5, ctb_log2=5, split_prob=0.8,
                           nxn_prob=0.8), 2)


def test_residual_intra(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=11, qp=14, cbf_prob=0.6), 3)


def test_residual_ctb32(reference_bins, tmp_path):
    """32x32 TUs (CTB 32 = max transform size) + residuals."""
    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=12, ctb_log2=5, qp=12,
                           cbf_prob=0.5), 2)


def test_residual_nonaligned(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path,
             H265StreamGen(52, 36, seed=13, qp=14, cbf_prob=0.7), 2)


def test_residual_deep_split(reference_bins, tmp_path):
    """4x4 DST TUs via NxN intra split with residuals."""
    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=14, qp=12, cbf_prob=0.8,
                           split_prob=0.8, nxn_prob=0.9), 2)


def test_residual_higher_qp(reference_bins, tmp_path):
    """Moderate qp, levels kept small (CLIP255C LUT domain)."""
    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=15, qp=22, cbf_prob=0.5,
                           max_level=1), 2)


def test_angular_all_modes(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=21, qp=14, cbf_prob=0.4,
                           modes=ALL_MODES), 3)


def test_angular_ctb32_strong(reference_bins, tmp_path):
    """32x32 blocks with strong intra smoothing enabled."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=22, ctb_log2=5, qp=14,
                           cbf_prob=0.3, modes=ALL_MODES,
                           strong_smoothing=1, split_prob=0.3), 2)


def test_angular_nonaligned(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(52, 36, seed=23, qp=14, cbf_prob=0.5,
                           modes=ALL_MODES), 2)


def test_sign_data_hiding(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=31, qp=14, cbf_prob=0.6,
                           modes=ALL_MODES, sign_data_hiding=1,
                           coeff_prob=0.4), 2)


def test_transform_skip(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=32, qp=14, cbf_prob=0.7,
                           modes=ALL_MODES, transform_skip=1,
                           split_prob=0.7, nxn_prob=0.8), 2)


def test_deblocking(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=41, qp=30, cbf_prob=0.5,
                           modes=ALL_MODES, deblock=1, max_level=1), 3)


def test_deblocking_offsets_unused(reference_bins, tmp_path):
    """PPS beta/tc offsets are parsed but never reach the filter
    (slice_header_body quirk, h265.cpp:896-903)."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=42, qp=24, cbf_prob=0.5,
                           modes=ALL_MODES, deblock=1, max_level=1,
                           beta_offset_div2=3, tc_offset_div2=-2), 2)


def test_deblocking_ctb32(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=43, qp=37, ctb_log2=5,
                           cbf_prob=0.4, modes=ALL_MODES, deblock=1,
                           max_level=1), 2)


def test_sao(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=51, qp=30, cbf_prob=0.5,
                           modes=ALL_MODES, sao=1, max_level=1), 3)


def test_sao_ctb32(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=52, qp=35, ctb_log2=5,
                           cbf_prob=0.4, modes=ALL_MODES, sao=1,
                           max_level=1), 2)


def test_sao_with_deblocking(reference_bins, tmp_path):
    """Both in-loop filters: deblock per CTU, SAO whole-frame pass over
    pre-SAO neighbour lines."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=53, qp=32, cbf_prob=0.5,
                           modes=ALL_MODES, sao=1, deblock=1,
                           max_level=1), 3)


def test_sao_nonaligned(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(52, 36, seed=54, qp=30, cbf_prob=0.5,
                           modes=ALL_MODES, sao=1, max_level=1), 2)


def test_p_slices(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=61, qp=14, cbf_prob=0.4,
                           modes=ALL_MODES), "IPPP")


def test_p_slices_deblock_sao(reference_bins, tmp_path):
    """Inter deblocking strengths (mv-diff/ref-diff) + SAO over P."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=62, qp=32, cbf_prob=0.4,
                           modes=ALL_MODES, deblock=1, sao=1,
                           max_level=1), "IPPP")


def test_p_slices_ctb32(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=63, qp=14, ctb_log2=5,
                           cbf_prob=0.4, modes=ALL_MODES), "IPPPP")


def test_p_slices_nonaligned(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(52, 36, seed=64, qp=14, cbf_prob=0.5,
                           modes=ALL_MODES), "IPP")


def test_p_amvp(reference_bins, tmp_path):
    """AMVP PUs with spatial + temporal MVP and MV scaling (tmvp on;
    merge/skip suppressed — the reference's P temporal merge candidate
    is stack-garbage, and AMVP with tmvp off null-derefs)."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=71, qp=14, cbf_prob=0.4,
                           modes=ALL_MODES, tmvp=1, amvp_prob=1.0,
                           skip_prob=0.0), "IPPP")


def test_p_amvp_large_mvd(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=72, qp=14, ctb_log2=5,
                           cbf_prob=0.3, modes=ALL_MODES, tmvp=1,
                           amvp_prob=1.0, skip_prob=0.0, max_mvd=300),
             "IPP")


def test_b_slices(reference_bins, tmp_path):
    """B slices: bidir AMVP + merge (incl. temporal + combined
    candidates), display reorder via the POC-sorted DPB."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=81, qp=14, cbf_prob=0.4,
                           modes=ALL_MODES, tmvp=1), "IPBPB")


def test_b_slices_filters(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=82, qp=32, cbf_prob=0.4,
                           modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                           max_level=1), "IPBPB")


def test_b_slices_ctb32(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(96, 64, seed=83, qp=14, ctb_log2=5,
                           cbf_prob=0.4, modes=ALL_MODES, tmvp=1),
             "IPBPB")


def test_inter_part_modes(reference_bins, tmp_path):
    """2NxN/Nx2N partitions with per-PU merge/AMVP."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=91, qp=14, cbf_prob=0.4,
                           modes=ALL_MODES, tmvp=1, part_mode_prob=0.5),
             "IPBPB")


def test_inter_amp(reference_bins, tmp_path):
    """Asymmetric partitions (2NxnU/D, nL/nRx2N)."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=92, qp=14, cbf_prob=0.4,
                           modes=ALL_MODES, tmvp=1, part_mode_prob=0.6,
                           amp=1), "IPB")


# -- multi-slice pictures (slice_segment_address; per-segment whole-frame
#    SAO + duplicate DPB insert, exactly like the reference) -------------
class _MultiSliceGen(H265StreamGen):
    def __init__(self, *args, slices_per_pic=2, **kw):
        super().__init__(*args, **kw)
        self.slices_per_pic = slices_per_pic


@pytest.mark.parametrize("nsl", [2, 3])
def test_h265_multi_slice_intra(reference_bins, tmp_path, nsl):
    run_case(reference_bins, tmp_path,
             _MultiSliceGen(64, 48, seed=6, slices_per_pic=nsl), 2)


def test_h265_multi_slice_sao(reference_bins, tmp_path):
    run_case(reference_bins, tmp_path,
             _MultiSliceGen(64, 48, seed=7, sao=True,
                            slices_per_pic=2), 2)


def _run_backend_case(reference_bins, tmp_path, gen, pat, backend,
                      want_deblock=False):
    data = gen.generate(pat)
    golden = oracle_decode(reference_bins, data, tmp_path)
    assert golden
    dec = H265Decoder()
    dec.set_data(data)
    out = dec.decode_all(backend=backend)
    ours = b"".join(cropped_nv12_bytes(f) for f in out)
    assert ours == golden
    p0 = dec.plans[0]
    assert p0.multi_slice and p0.slice_aligned and len(p0.slice_rows) > 1
    if want_deblock:
        assert p0.dbv[..., 0].any() or p0.dbh[..., 0].any()


def test_h265_multi_slice_phase_b_jax(reference_bins, tmp_path):
    """Multi-slice pictures through the device Phase B: per-slice
    decode -> window-masked deblock -> whole-frame SAO snapshot
    sequence (slice_layer, h265.cpp:4849-4866), active deblock."""
    from streamgen.h265_enc import ALL_MODES

    _run_backend_case(
        reference_bins, tmp_path,
        _MultiSliceGen(64, 48, seed=41, qp=30, cbf_prob=0.5,
                       modes=ALL_MODES, deblock=1, max_level=1,
                       slices_per_pic=2), 3, "jax", want_deblock=True)


def test_h265_multi_slice_phase_b_jax_inter_sao(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    _run_backend_case(
        reference_bins, tmp_path,
        _MultiSliceGen(64, 48, seed=45, qp=33, sao=True, cbf_prob=0.5,
                       modes=ALL_MODES, tmvp=1, deblock=1, max_level=1,
                       slices_per_pic=3), "IPB", "jax", want_deblock=True)


def test_h265_multi_slice_phase_b_jax_ctb32(reference_bins, tmp_path):
    from streamgen.h265_enc import ALL_MODES

    _run_backend_case(
        reference_bins, tmp_path,
        _MultiSliceGen(96, 64, seed=43, qp=37, ctb_log2=5, cbf_prob=0.4,
                       modes=ALL_MODES, deblock=1, max_level=1,
                       slices_per_pic=2), 2, "jax", want_deblock=True)


def test_h265_multi_slice_phase_b_native(reference_bins, tmp_path):
    """Native C++ Phase A + multi-slice Phase B end to end."""
    from m2dec_tpu.native import load_h265
    from streamgen.h265_enc import ALL_MODES

    if load_h265() is None:
        pytest.skip("native toolchain unavailable")
    _run_backend_case(
        reference_bins, tmp_path,
        _MultiSliceGen(64, 48, seed=45, qp=33, sao=True, cbf_prob=0.5,
                       modes=ALL_MODES, tmvp=1, deblock=1, max_level=1,
                       slices_per_pic=3), "IPB", "native",
        want_deblock=True)


# -- slice-header features: slice-local RPS, deblocking override,
#    dependent slice segments (reference slice_header_body parity) -------


def test_h265_slice_local_rps(reference_bins, tmp_path):
    """RPS carried in the slice header (h265.cpp:722-730): both the
    nopred and the inter-predicted-against-an-SPS-set parser paths."""
    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=51, slice_local_rps=1,
                           cbf_prob=0.4, max_level=2), "IPPBP")


def test_h265_deblock_override(reference_bins, tmp_path):
    """Per-slice deblock parameter override (h265.cpp:896-903): slices
    toggle the filter and carry their own beta/tc offsets while the PPS
    says disabled."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=52, qp=30, cbf_prob=0.5,
                           modes=ALL_MODES, max_level=1, deblock=0,
                           deblock_override=1), "IPP")


def test_h265_deblock_override_disables(reference_bins, tmp_path):
    """Override on top of PPS-enabled deblocking (slices may disable)."""
    from streamgen.h265_enc import ALL_MODES

    run_case(reference_bins, tmp_path,
             H265StreamGen(64, 48, seed=53, qp=32, cbf_prob=0.5,
                           modes=ALL_MODES, max_level=1, deblock=1,
                           beta_offset_div2=2, tc_offset_div2=-1,
                           deblock_override=1), 3)


@pytest.mark.parametrize("nsl", [2, 3])
def test_h265_dependent_slices(reference_bins, tmp_path, nsl):
    """Dependent slice segments (h265.cpp:910-919): the header body is
    inherited from the previous segment; decode restarts like a normal
    segment (full ctu_init per segment, h265.cpp:4751-4799)."""
    run_case(reference_bins, tmp_path,
             _MultiSliceGen(64, 48, seed=54 + nsl, slices_per_pic=nsl,
                            dependent_slices=1, cbf_prob=0.4,
                            max_level=2), 2)


def test_h265_dependent_slices_inter_jax(reference_bins, tmp_path):
    """Dependent segments + deblock override through the device Phase B."""
    from streamgen.h265_enc import ALL_MODES

    _run_backend_case(
        reference_bins, tmp_path,
        _MultiSliceGen(64, 48, seed=57, qp=31, cbf_prob=0.5,
                       modes=ALL_MODES, deblock=1, max_level=1,
                       slices_per_pic=2, dependent_slices=1,
                       deblock_override=1, slice_local_rps=1),
        "IPB", "jax", want_deblock=True)
