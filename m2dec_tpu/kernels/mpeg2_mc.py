"""MPEG-2 half-pel motion compensation, bit-exact with the reference.

Replicates the semantics of the reference's dispatch + kernels
(reference: src/lib/motioncomp.cpp:488-546 dispatch,
:39-44 AVERAGE2 round-up average, :313-356 bilinear (a+b+c+d+2)>>2,
:69-76 bidirectional combine (pred1+pred2+1)>>1), redesigned for a
data-parallel device:

* instead of 4 scalar kernels dispatched per macroblock, a single batched
  gather-and-blend computes every macroblock of the frame at once: four
  shifted gathers (a,b;c,d) and `where`-selects keyed on the half-pel flags
  (dense math instead of per-MB branching);
* frames are planar (Y, Cb, Cr) internally; the reference's NV12
  interleaved-chroma kernels are arithmetically per-component, so planar
  compute is bit-identical (interleaving happens only in the output writer).

Chroma motion vectors use C truncation-toward-zero division by 2
(reference motioncomp.cpp:506-508 `mvxy[0] / 2`), which differs from
floor-division for negative odd values — preserved here.

Works under numpy and jax.numpy via the `xp` parameter.
"""

from __future__ import annotations


def _avg2(a, b):
    # AVERAGE2 (motioncomp.cpp:39-43): (a+b+1)>>1, round up
    return (a + b + 1) >> 1


def mc_gather(ref, py, px, hx, hy, bh, bw, xp):
    """Half-pel prediction for a batch of blocks from one reference plane.

    Args:
      ref: int32 [H+1, W+1] padded reference plane (1 replicated/zero pad at
        bottom/right so the +1 taps are addressable; callers guarantee MVs
        keep the interpolation window inside the real frame).
      py, px: int32 [N] top-left integer sample position per block.
      hx, hy: int32 [N] half-pel flags per block.
      bh, bw: static block height/width (16x16 luma, 8x8 chroma).
      xp: numpy or jax.numpy.

    Returns:
      int32 [N, bh, bw] prediction (reference Store semantics, pre-clip —
      values are already in 0..255).
    """
    ys = py[:, None, None] + xp.arange(bh, dtype=xp.int32)[None, :, None]
    xs = px[:, None, None] + xp.arange(bw, dtype=xp.int32)[None, None, :]
    # clamp: when frame and field predictions are both evaluated and
    # where()-selected, the unselected mode's MVs may index out of range
    ys = xp.clip(ys, 0, ref.shape[0] - 2)
    xs = xp.clip(xs, 0, ref.shape[1] - 2)
    a = ref[ys, xs]
    b = ref[ys, xs + 1]
    c = ref[ys + 1, xs]
    d = ref[ys + 1, xs + 1]
    return _halfpel_blend(a, b, c, d, hx, hy, xp)


def _halfpel_blend(a, b, c, d, hx, hy, xp):
    hx = hx[:, None, None]
    hy = hy[:, None, None]
    # HALFPEL dispatch (motioncomp.cpp:28, :451-463):
    # 00 copy; 01 horiz avg2(a,b); 10 vert avg2(a,c); 11 (a+b+c+d+2)>>2
    horiz = _avg2(a, b)
    vert = _avg2(a, c)
    both = (a + b + c + d + 2) >> 2
    return xp.where(
        hy == 1,
        xp.where(hx == 1, both, vert),
        xp.where(hx == 1, horiz, a),
    )


def luma_pred(ref, mvx, mvy, mbx, mby, xp):
    """16x16 luma prediction per MB (reference motioncomp.cpp:488-492).

    mvx/mvy are half-pel motion vectors [N]; mbx/mby MB coordinates [N].
    """
    px = mbx * 16 + (mvx >> 1)
    py = mby * 16 + (mvy >> 1)
    return mc_gather(ref, py, px, mvx & 1, mvy & 1, 16, 16, xp)


def chroma_pred(ref, mvx, mvy, mbx, mby, xp):
    """8x8 chroma prediction per MB on a planar Cb or Cr plane.

    Implements the reference's NV12 chroma addressing
    (motioncomp.cpp:504-510): mv_c = mv/2 with C truncation, integer part
    mv_c>>1, half-pel flags mv_c&1.
    """
    # C truncation-toward-zero division by 2
    mvx_c = xp.where(mvx < 0, -((-mvx) >> 1), mvx >> 1)
    mvy_c = xp.where(mvy < 0, -((-mvy) >> 1), mvy >> 1)
    px = mbx * 8 + (mvx_c >> 1)
    py = mby * 8 + (mvy_c >> 1)
    return mc_gather(ref, py, px, mvx_c & 1, mvy_c & 1, 8, 8, xp)


def combine_bidir(fwd, bwd):
    """Bi-directional combine (AveStore, motioncomp.cpp:66-76)."""
    return (fwd + bwd + 1) >> 1


def _ctrunc2(v, xp):
    # C truncation-toward-zero division by 2 (motioncomp.cpp:506-508)
    return xp.where(v < 0, -((-v) >> 1), v >> 1)


def mc_gather_field(ref, py, px, hx, hy, bh, bw, xp):
    """Field variant of mc_gather: rows advance by 2 (one field line),
    vertical half-pel taps the NEXT field line (reference field MC:
    stride*2 kernels, mpeg2.cpp:1293-1305 m2d_motion_comp mv_count==2).
    ``py`` is the FRAME row of the field's first line; callers bound MVs
    so ys+2 stays within the padded plane."""
    ys = py[:, None, None] + 2 * xp.arange(bh, dtype=xp.int32)[None, :, None]
    xs = px[:, None, None] + xp.arange(bw, dtype=xp.int32)[None, None, :]
    ys = xp.clip(ys, 0, ref.shape[0] - 3)
    xs = xp.clip(xs, 0, ref.shape[1] - 2)
    a = ref[ys, xs]
    b = ref[ys, xs + 1]
    c = ref[ys + 2, xs]
    d = ref[ys + 2, xs + 1]
    return _halfpel_blend(a, b, c, d, hx, hy, xp)


# ---------------------------------------------------------------------
# word-window variants (device path): the per-pixel fancy-index gathers
# above issue 4 gather elements PER PIXEL (~25M elements per 1080p
# picture). One (bh+1)x(bw+1) uint32-word window per (MB, ref) — 85
# words for a 16x16 luma block vs 1024 elements — and the a/b/c/d taps
# become in-window slices. The per-pixel path above remains the numpy
# executable spec.
# ---------------------------------------------------------------------


def _win(ref_p, py, px, rows, cols, xp):
    from m2dec_tpu.codecs.h264.reconstruct import _flat_windows32

    slot = xp.zeros_like(py)
    return _flat_windows32(ref_p, slot, py, px, rows, cols, xp)


def _mc_win(ref_p, py, px, hx, hy, bh, bw, xp):
    g = _win(ref_p, py, px, bh + 1, bw + 1, xp)
    a = g[:, :bh, :bw]
    b = g[:, :bh, 1 : bw + 1]
    c = g[:, 1 : bh + 1, :bw]
    d = g[:, 1 : bh + 1, 1 : bw + 1]
    return _halfpel_blend(a, b, c, d, hx, hy, xp)


def _mc_win_field(ref_p, py, px, hx, hy, bh, bw, xp):
    g = _win(ref_p, py, px, 2 * bh + 1, bw + 1, xp)
    a = g[:, 0 : 2 * bh - 1 : 2, :bw]
    b = g[:, 0 : 2 * bh - 1 : 2, 1 : bw + 1]
    c = g[:, 2 : 2 * bh + 1 : 2, :bw]
    d = g[:, 2 : 2 * bh + 1 : 2, 1 : bw + 1]
    return _halfpel_blend(a, b, c, d, hx, hy, xp)


def luma_pred_win(ref_p, H, W, mvx, mvy, mbx, mby, xp):
    """Window-gather twin of luma_pred; ref_p [1,Hp,Wp] uint8 with >=
    bh+1 edge pad bottom/right (valid windows are bit-identical; MVs
    of unselected modes clamp to valid garbage that the caller's
    where() discards)."""
    px = mbx * 16 + (mvx >> 1)
    py = mby * 16 + (mvy >> 1)
    return _mc_win(ref_p, xp.clip(py, 0, H - 1), xp.clip(px, 0, W - 1),
                   mvx & 1, mvy & 1, 16, 16, xp)


def chroma_pred_win(ref_p, H, W, mvx, mvy, mbx, mby, xp):
    mvx_c = _ctrunc2(mvx, xp)
    mvy_c = _ctrunc2(mvy, xp)
    px = mbx * 8 + (mvx_c >> 1)
    py = mby * 8 + (mvy_c >> 1)
    return _mc_win(ref_p, xp.clip(py, 0, H - 1), xp.clip(px, 0, W - 1),
                   mvx_c & 1, mvy_c & 1, 8, 8, xp)


def luma_pred_field_win(ref_p, H, W, mv1, mv2, sel, mbx, mby, xp):
    outs = []
    for f, mv in ((0, mv1), (1, mv2)):
        mvx, mvy = mv[:, 0], mv[:, 1]
        px = mbx * 16 + (mvx >> 1)
        py = mby * 16 + 2 * (mvy >> 1) + ((sel >> f) & 1)
        outs.append(_mc_win_field(
            ref_p, xp.clip(py, 0, H - 2), xp.clip(px, 0, W - 1),
            mvx & 1, mvy & 1, 8, 16, xp))
    return xp.stack(outs, axis=2).reshape(outs[0].shape[0], 16, 16)


def chroma_pred_field_win(ref_p, H, W, mv1, mv2, sel, mbx, mby, xp):
    outs = []
    for f, mv in ((0, mv1), (1, mv2)):
        cmvx = _ctrunc2(mv[:, 0], xp)
        cmvy = _ctrunc2(mv[:, 1], xp)
        px = mbx * 8 + (cmvx >> 1)
        py = mby * 8 + 2 * (cmvy >> 1) + ((sel >> f) & 1)
        outs.append(_mc_win_field(
            ref_p, xp.clip(py, 0, H - 2), xp.clip(px, 0, W - 1),
            cmvx & 1, cmvy & 1, 4, 8, xp))
    return xp.stack(outs, axis=2).reshape(outs[0].shape[0], 8, 8)


def luma_pred_field(ref, mv1, mv2, sel, mbx, mby, xp):
    """16x16 luma from two per-field predictions (motion_type=1 in frame
    pictures). mv1/mv2: [N,2] field-unit MVs; sel: [N] 2-bit field
    selects (bit i = source field of dest field i)."""
    outs = []
    for f, mv in ((0, mv1), (1, mv2)):
        mvx, mvy = mv[:, 0], mv[:, 1]
        px = mbx * 16 + (mvx >> 1)
        py = mby * 16 + 2 * (mvy >> 1) + ((sel >> f) & 1)
        outs.append(mc_gather_field(ref, py, px, mvx & 1, mvy & 1, 8, 16, xp))
    return xp.stack(outs, axis=2).reshape(outs[0].shape[0], 16, 16)


def chroma_pred_field(ref, mv1, mv2, sel, mbx, mby, xp):
    """8x8 chroma from two 8x4 field predictions (C-truncated mv/2)."""
    outs = []
    for f, mv in ((0, mv1), (1, mv2)):
        cmvx = _ctrunc2(mv[:, 0], xp)
        cmvy = _ctrunc2(mv[:, 1], xp)
        px = mbx * 8 + (cmvx >> 1)
        py = mby * 8 + 2 * (cmvy >> 1) + ((sel >> f) & 1)
        outs.append(mc_gather_field(ref, py, px, cmvx & 1, cmvy & 1, 4, 8, xp))
    return xp.stack(outs, axis=2).reshape(outs[0].shape[0], 8, 8)
