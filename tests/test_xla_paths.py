"""The plain XLA Phase-B building blocks, on the CPU: the MPEG-2 IDCT,
the H.264 intra/deblock wavefront scans against the numpy reference,
the intra mode matrices' exactness under TF32 (a GPU may run the f32
matmul in TF32), and the MC default, which no longer follows the
backend."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from m2dec_tpu.kernels.mpeg2_idct import idct8x8  # noqa: E402


def _idct_random():
    rng = np.random.default_rng(0)
    return rng.integers(-2048, 2048, (700, 8, 8)).astype(np.int32)


def _idct_int16_wrap():
    # drive the horizontal-store int16 wraparound domain explicitly
    coef = np.zeros((4, 8, 8), np.int32)
    coef[:, 0, :] = 2047
    coef[:, 7, :] = -2048
    return coef


@pytest.mark.parametrize("case", ["random", "int16_wrap"])
def test_idct_xla_matches_exact(case):
    import jax
    import jax.numpy as jnp

    coef = {"random": _idct_random, "int16_wrap": _idct_int16_wrap}[case]()
    got = np.asarray(jax.jit(lambda c: idct8x8(c, jnp))(coef))
    assert np.array_equal(got, idct8x8(coef, np))


def _intra_stream(kind):
    from streamgen.h264_enc import H264HighGen, H264IntraGen

    if kind == "intra4_16":
        gen = H264IntraGen(64, 48, seed=5, qp=28, disable_deblock=False)
    else:  # intra 8x8 + deblocking
        gen = H264HighGen(64, 48, seed=6, intra_prob=0.3, skip_prob=0.1,
                          qp=29, disable_deblock=False, i8x8_prob=0.6)
    return gen.generate("II" if kind == "intra4_16" else "IP")


@pytest.mark.parametrize("kind", ["intra4_16", "intra8_deblock"])
def test_wavefront_scans_match_numpy_reference(kind):
    """The jitted per-picture Phase B (skewed intra + deblock lax.scan
    wavefronts) against recon_ref's numpy Phase B on the same native
    plans, every plane of every picture."""
    from m2dec_tpu.codecs.h264.decoder import H264Decoder

    data = _intra_stream(kind)
    outs = {}
    for phase_b in ("jax", "np"):
        dec = H264Decoder(native=True, phase_b=phase_b)
        dec.set_data(data)
        outs[phase_b] = dec.decode_all()
    kinds = np.concatenate([p.kind for p in dec.plans])
    assert (kinds == (2 if kind == "intra8_deblock" else 1)).any()
    assert len(outs["jax"]) == len(outs["np"]) == 2
    for a, b in zip(outs["jax"], outs["np"]):
        for pa, pb in ((a.y, b.y), (a.cb, b.cb), (a.cr, b.cr)):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


def _round_tf32(x):
    """float32 -> nearest TF32 value (10 explicit mantissa bits, ties to
    even), as a GPU tensor core rounds matmul operands."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("mat", ["i4", "i8"])
def test_intra_mode_matrix_exact_in_tf32(mat):
    from m2dec_tpu.codecs.h264 import reconstruct as R

    mats = {"i4": R._I4_MAT, "i8": R._I8_MAT}[mat]
    M = mats[0]
    pixels = np.arange(256, dtype=np.float32)
    assert np.array_equal(_round_tf32(M), M)
    assert np.array_equal(_round_tf32(pixels), pixels)
    # every column sum stays far inside the f32 accumulator's exact range
    assert 255 * M.sum(axis=0).max() < 2 ** 12
    rng = np.random.default_rng(1)
    line = rng.integers(0, 256, (512, M.shape[0])).astype(np.int32)
    mode = rng.integers(0, 9, 512).astype(np.int32)
    P = M.shape[1] // 9
    acc = (_round_tf32(line) @ _round_tf32(M)).astype(np.int32)
    vals = (acc + mats[1][None]) >> mats[2][None]
    got = np.stack([vals[i, mode[i] * P:(mode[i] + 1) * P]
                    for i in range(len(mode))])
    assert np.array_equal(got, R._mode_eval(line, mode, mats, P, np))


def _mc_aux_inputs():
    rng = np.random.default_rng(2)
    n = 6  # MBs
    slot = rng.integers(-1, 3, (2, n, 4, 2)).astype(np.int8)
    mv = rng.integers(-8, 8, (2, n * 16, 2, 2)).astype(np.int16)
    wp = np.zeros((2, n, 4, 12), np.int16)
    return slot, mv, wp


@pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda"])
def test_mc_aux_default_ignores_backend(monkeypatch, backend):
    """The MC path default (dense) is the same whatever
    jax.default_backend() says; only M2DEC_TPU_MC picks compact."""
    import jax

    from m2dec_tpu.codecs.h264.reconstruct import _derive_mc_aux

    monkeypatch.delenv("M2DEC_TPU_MC", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    slot, mv, wp = _mc_aux_inputs()
    s1, s2 = slot.copy(), slot.copy()
    (got,) = _derive_mc_aux([s1], 3, [mv], [wp], [{}], 3, 2)
    (want,) = _derive_mc_aux([s2], 3, [mv], [wp], [{}], 3, 2,
                             compact=False)
    assert got[2] is None and got[3] is None  # dense: no nu/uni lists
    for a, b in zip(got, want):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert np.array_equal(s1, s2)
