"""MPEG-2 8x8 fixed-point inverse DCT, bit-exact with the reference decoder.

Replicates the exact integer semantics of the reference's Wang-style fast
IDCT (reference: src/lib/idct.cpp:35-40 W constants, :144-235 horizontal,
:286-358 vertical), including:

* int16 wraparound when the horizontal pass stores back intermediates
  (the reference writes them into the int16 coefficient array);
* arithmetic right shifts on negative int32 values;
* the `(x*181+128)>>8` sqrt(1/2) rotations and final `>>14` with clipping
  applied by the caller (ClipStore/AddStore, idct.cpp:364-382).

The reference's per-row DC shortcut and zero-operand shortcuts
(`coef_exist` sparsity bitmap) are arithmetic identities of the full path,
so this vectorized version always computes the full path: dense batched
arithmetic over all blocks of a frame instead of data-dependent
branching (SURVEY.md §7 design stance).

Written against the array-namespace `xp` so the identical code runs under
numpy (host reference / unit tests) and jax.numpy (jit Phase-B path); all
ops are int32 with wrap semantics matching C.
"""

from __future__ import annotations

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565


def idct8x8(coef, xp):
    """Inverse DCT of a batch of 8x8 blocks.

    Args:
      coef: int array [..., 8, 8] of dequantized coefficients (int16 range),
        raster order (row, col).
      xp: numpy or jax.numpy.

    Returns:
      int32 array [..., 8, 8] of residual/sample values BEFORE clipping
      (the reference's `(...)>>14` store operands).
    """
    i16 = xp.int16
    i32 = xp.int32
    c = coef.astype(i32)

    # --- horizontal pass (per row; reference idct.cpp:144-235) ------------
    s = [c[..., :, k] for k in range(8)]
    x0 = s[0] * 2048 + 128
    x1 = s[4] * 2048
    x0, x1 = x0 - x1, x0 + x1
    t = W7 * (s[1] + s[7])
    x4 = t + (W1 - W7) * s[1]
    x5 = t - (W1 + W7) * s[7]
    t = W3 * (s[5] + s[3])
    x6 = t - (W3 - W5) * s[5]
    x7 = t - (W3 + W5) * s[3]
    x4, x6 = x4 - x6, x4 + x6
    x5, x7 = x5 - x7, x5 + x7
    x5, x4 = ((x4 + x5) * 181 + 128) >> 8, ((x4 - x5) * 181 + 128) >> 8
    t = W6 * (s[2] + s[6])
    x2 = t - (W2 + W6) * s[6]
    x3 = t + (W2 - W6) * s[2]
    x0, x2 = x0 - x2, x0 + x2
    x1, x3 = x1 - x3, x1 + x3
    h = xp.stack(
        [
            (x3 + x6) >> 8,
            (x2 + x5) >> 8,
            (x0 + x4) >> 8,
            (x1 + x7) >> 8,
            (x1 - x7) >> 8,
            (x0 - x4) >> 8,
            (x2 - x5) >> 8,
            (x3 - x6) >> 8,
        ],
        axis=-1,
    )
    # the reference stores horizontal results back into the int16_t
    # coefficient array (idct.cpp:223-230) — wraparound is observable
    h = h.astype(i16).astype(i32)

    # --- vertical pass (per column; reference idct.cpp:286-358) -----------
    v = [h[..., k, :] for k in range(8)]
    x8 = W3 * (v[5] + v[3]) + 4
    x6 = (x8 - (W3 - W5) * v[5]) >> 3
    x7 = (x8 - (W3 + W5) * v[3]) >> 3
    x8 = W7 * (v[1] + v[7]) + 4
    x4 = (x8 + (W1 - W7) * v[1]) >> 3
    x5 = (x8 - (W1 + W7) * v[7]) >> 3
    x1t = W6 * (v[2] + v[6]) + 4
    x2 = (x1t - (W2 + W6) * v[6]) >> 3
    x3 = (x1t + (W2 - W6) * v[2]) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x0 = v[0] * 256 + 8192
    x7 = v[4] * 256
    x8 = x0 + x7
    x0 = x0 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = ((x4 + x5) * 181 + 128) >> 8
    x4 = ((x4 - x5) * 181 + 128) >> 8
    out = xp.stack(
        [
            (x7 + x1) >> 14,
            (x3 + x2) >> 14,
            (x0 + x4) >> 14,
            (x8 + x6) >> 14,
            (x8 - x6) >> 14,
            (x0 - x4) >> 14,
            (x3 - x2) >> 14,
            (x7 - x1) >> 14,
        ],
        axis=-2,
    )
    return out


def idct8x8_reference_scalar(coef):
    """Slow scalar mirror with the reference's zero-shortcuts, for tests.

    Mirrors idct.cpp control flow exactly (DC-shortcut rows included) so the
    vectorized `idct8x8` can be differentially validated against it
    (the `test_idct_horizontal` pattern, reference idct.cpp:269-282).
    """
    import numpy as np

    coef = np.array(coef, dtype=np.int64).reshape(8, 8)
    tmp = coef.astype(np.int64).copy()
    w = lambda v: np.int64(np.int32(v))  # wrap to int32
    w16 = lambda v: np.int64(np.int16(np.int32(v)))

    coef_exist = 0
    for r in range(8):
        if np.any(coef[r, 1:]):
            coef_exist |= 1 << r
    for r in range(8):
        row = tmp[r]
        if not (coef_exist >> r) & 1:
            row[:] = w16(row[0] * 8)
            continue
        x0 = w(row[0] * 2048 + 128)
        x4, x5, x3, x7 = row[1], row[7], row[2], row[3]
        x1 = w(row[4] * 2048)
        x0, x1 = w(x0 - x1), w(x0 + x1)
        if x4 or x5:
            t = w(W7 * (x4 + x5))
            x4, x5 = w(t + (W1 - W7) * x4), w(t - (W1 + W7) * x5)
        x6 = row[5]
        if x7 or x6:
            t = w(W3 * (x6 + x7))
            x6, x7 = w(t - (W3 - W5) * x6), w(t - (W3 + W5) * x7)
        x4, x6 = w(x4 - x6), w(x4 + x6)
        x5, x7 = w(x5 - x7), w(x5 + x7)
        x5, x4 = w(w((x4 + x5) * 181 + 128) >> 8), w(w((x4 - x5) * 181 + 128) >> 8)
        x2 = row[6]
        if x3 or x2:
            t = w(W6 * (x3 + x2))
            x2, x3 = w(t - (W2 + W6) * x2), w(t + (W2 - W6) * x3)
        x0, x2 = w(x0 - x2), w(x0 + x2)
        x1, x3 = w(x1 - x3), w(x1 + x3)
        row[0] = w16(w(x3 + x6) >> 8)
        row[1] = w16(w(x2 + x5) >> 8)
        row[2] = w16(w(x0 + x4) >> 8)
        row[3] = w16(w(x1 + x7) >> 8)
        row[4] = w16(w(x1 - x7) >> 8)
        row[5] = w16(w(x0 - x4) >> 8)
        row[6] = w16(w(x2 - x5) >> 8)
        row[7] = w16(w(x3 - x6) >> 8)

    out = np.zeros((8, 8), dtype=np.int64)
    for col in range(8):
        s = tmp[:, col]
        x7, x6 = s[3], s[5]
        if x7 or x6:
            x8 = w(W3 * (x6 + x7) + 4)
            x6 = w(w(x8 - (W3 - W5) * x6) >> 3)
            x7 = w(w(x8 - (W3 + W5) * x7) >> 3)
        x4, x5 = s[1], s[7]
        if x4 or x5:
            x8 = w(W7 * (x4 + x5) + 4)
            x4 = w(w(x8 + (W1 - W7) * x4) >> 3)
            x5 = w(w(x8 - (W1 + W7) * x5) >> 3)
        x3, x2 = s[2], s[6]
        if x3 or x2:
            x1 = w(W6 * (x3 + x2) + 4)
            x2 = w(w(x1 - (W2 + W6) * x2) >> 3)
            x3 = w(w(x1 + (W2 - W6) * x3) >> 3)
        x1 = w(x4 + x6)
        x4 = w(x4 - x6)
        x6 = w(x5 + x7)
        x5 = w(x5 - x7)
        x0 = w(s[0] * 256 + 8192)
        x7 = w(s[4] * 256)
        x8 = w(x0 + x7)
        x0 = w(x0 - x7)
        x7 = w(x8 + x3)
        x8 = w(x8 - x3)
        x3 = w(x0 + x2)
        x0 = w(x0 - x2)
        x2 = w(w((x4 + x5) * 181 + 128) >> 8)
        x4 = w(w((x4 - x5) * 181 + 128) >> 8)
        out[0, col] = w(x7 + x1) >> 14
        out[1, col] = w(x3 + x2) >> 14
        out[2, col] = w(x0 + x4) >> 14
        out[3, col] = w(x8 + x6) >> 14
        out[4, col] = w(x8 - x6) >> 14
        out[5, col] = w(x0 - x4) >> 14
        out[6, col] = w(x3 - x2) >> 14
        out[7, col] = w(x7 - x1) >> 14
    return out.astype(np.int32)
