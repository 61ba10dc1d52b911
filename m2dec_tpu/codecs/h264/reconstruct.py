"""H.264 Phase-B reconstruction on the device: one fused jax.jit graph per
picture geometry.

Consumes the PicturePlan tensors (codecs/h264/plan.py) and the reference
frame stack; produces the reconstructed (and deblocked) picture planes,
bit-exact with the reference decoder (reference: src/lib/h264.cpp — see
recon_ref.py for the scalar executable spec this is verified against).

Device mapping:

* inter prediction: one dense gather of 9x9 (luma) / 3x3 (chroma)
  support windows for every 4x4 block of the picture, 6-tap/bilinear
  integer filters vectorized over all blocks, all 16 quarter-pel cases
  computed by mask selection (the reference's 16 inter_pred_luma_fracXY
  kernels, h264.cpp:6118-6262, collapsed into one batched kernel);
* residual: batched 4x4/8x8 integer inverse transforms over the whole
  picture (h264.cpp:2272-2360, :3986-4068);
* intra prediction: a lax.scan wavefront over macroblock anti-diagonals
  d = mbx + 2*mby (left/top/top-right dependencies), every MB on a
  diagonal computed in parallel lanes, the 16 coding-order 4x4 blocks
  (or 4 8x8 / the 16x16 pass) unrolled inside the step — the data-
  parallel replacement for the reference's strictly sequential in-place MB loop;
* deblocking: a second lax.scan wavefront with the same diagonal order,
  reproducing deblock_pb's raster-sequential edge updates
  (h264.cpp:10540-10663) exactly: per MB all four vertical edges then
  all four horizontal edges, strong/normal filters branchless.

Everything is int32 on device; host code only packs plan arrays and
remaps reference slots.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from . import tables as T

# =====================================================================
# batched inverse transforms
# =====================================================================


def _stage4(r, xp):
    e0 = r[..., 0] + r[..., 2]
    e1 = r[..., 0] - r[..., 2]
    e2 = (r[..., 1] >> 1) - r[..., 3]
    e3 = r[..., 1] + (r[..., 3] >> 1)
    return xp.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)


def idct4_batch(coef, xp):
    """[..., 16] raster -> [..., 4, 4] residual."""
    c = coef.reshape(coef.shape[:-1] + (4, 4)).astype(xp.int32)
    c = c.at[..., 0, 0].add(32) if xp is not np else _npadd(c, 32)
    f = _stage4(c, xp)
    g = _stage4(xp.swapaxes(f, -1, -2), xp)
    return xp.swapaxes(g, -1, -2) >> 6


def _npadd(c, v):
    c = c.copy()
    c[..., 0, 0] += v
    return c


def _stage8(r, xp):
    s = [r[..., i] for i in range(8)]
    t0 = s[0] + s[4]
    t2 = s[0] - s[4]
    t4 = (s[2] >> 1) - s[6]
    t6 = s[2] + (s[6] >> 1)
    t1 = s[5] - s[3] - s[7] - (s[7] >> 1)
    t7 = s[3] + s[5] + s[1] + (s[1] >> 1)
    t3 = s[1] + s[7] - s[3] - (s[3] >> 1)
    t5 = s[5] + (s[5] >> 1) + s[7] - s[1]
    t0, t6 = t0 + t6, t0 - t6
    t2, t4 = t2 + t4, t2 - t4
    t1, t7 = t1 + (t7 >> 2), t7 - (t1 >> 2)
    t3, t5 = t3 + (t5 >> 2), (t3 >> 2) - t5
    return xp.stack(
        [t0 + t7, t2 + t5, t4 + t3, t6 + t1, t6 - t1, t4 - t3, t2 - t5,
         t0 - t7], axis=-1)


def idct8_batch(coef, xp):
    c = coef.reshape(coef.shape[:-1] + (8, 8)).astype(xp.int32)
    c = c.at[..., 0, 0].add(32) if xp is not np else _npadd(c, 32)
    f = _stage8(c, xp)
    g = _stage8(xp.swapaxes(f, -1, -2), xp)
    return xp.swapaxes(g, -1, -2) >> 6


def residual_mb(plan_coef_luma, t8x8, xp, has_i8=True):
    """[n,256] + flag -> assembled [n,16,16] luma residual.

    has_i8=False (static): the batch provably has no 8x8-transform
    MBs (neither intra8x8 nor inter t8x8 — see _recon_core's has_i8
    derivation), so the idct8 arm is skipped entirely instead of
    computed-and-discarded by the where()."""
    n = plan_coef_luma.shape[0]
    r4 = idct4_batch(plan_coef_luma.reshape(n, 16, 16), xp)  # [n,16,4,4]
    a4 = (r4.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
          .reshape(n, 16, 16))
    if not has_i8:
        return a4
    r8 = idct8_batch(plan_coef_luma.reshape(n, 4, 64), xp)  # [n,4,8,8]
    a8 = (r8.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4)
          .reshape(n, 16, 16))
    return xp.where((t8x8 != 0)[:, None, None], a8, a4)


def residual_chroma(plan_coef_chroma, xp):
    """[n,2,4,16] -> [n,2,8,8]."""
    n = plan_coef_chroma.shape[0]
    r = idct4_batch(plan_coef_chroma, xp)  # [n,2,4,4,4]
    return (r.reshape(n, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5)
            .reshape(n, 2, 8, 8))


# =====================================================================
# inter prediction (dense 4x4-block gather + 6-tap/bilinear filters)
# =====================================================================


def _tap6(a):
    """6-tap along the last axis, windows of 6."""
    return (a[..., :-5] - 5 * a[..., 1:-4] + 20 * a[..., 2:-3]
            + 20 * a[..., 3:-2] - 5 * a[..., 4:-1] + a[..., 5:])


def _fuse_break(*xs):
    """Materialization barrier before gathers.

    An optimization_barrier on the gather inputs forces them into
    materialized buffers, so a gather's operand/index producer fusion
    is not inlined per gathered element. It was introduced against
    executable-size blowup under the original accelerator's gather
    codegen; whether it pays on the GPU is an open A/B (ROADMAP D2).
    No-op semantics on all backends."""
    import jax

    out = jax.lax.optimization_barrier(xs)
    return out[0] if len(xs) == 1 else out


_MC_PAD = 16  # edge-replicate padding of ref planes (UMV fill domain)


def _pad_refs_edge(refs, xp):
    """Edge-replicate pad of [R,H,W] planes by _MC_PAD — the reference
    pads each frame once before MC (fill_rect_umv_*, h264.cpp:5932-6117);
    window slices from the padded plane reproduce the per-pixel clamped
    gather exactly (flat windows filter to the edge value)."""
    return xp.pad(refs, ((0, 0), (_MC_PAD, _MC_PAD), (_MC_PAD, _MC_PAD)),
                  mode="edge")


def _flat_windows(refs_p, slot, sy, sx, win, xp):
    """Gather [B,win,win] windows from padded planes via one flat
    single-dimension take; padding removes the per-pixel clamp index
    math entirely."""
    R, Hp, Wp = refs_p.shape
    ar = xp.arange(win)
    row = (xp.clip(slot, 0, R - 1) * Hp + sy)[:, None] + ar[None, :]
    idx = row[:, :, None] * Wp + (sx[:, None] + ar[None, :])[:, None, :]
    flat, idx = _fuse_break(refs_p.reshape(-1), idx)
    return _fuse_break(xp.take(flat, idx))


def _flat_windows32(refs_p, slot, sy, sx, rows, cols, xp,
                    even_x=False):
    """Gather [B,rows,cols] byte windows by fetching whole uint32 words:
    the gather unit is issue-rate-bound per ELEMENT, so fetching
    ceil((cols+3)/4) words per row instead of cols bytes cuts the
    gathered element count ~3x. The byte re-alignment (window start mod
    4) is plain vector arithmetic. Requires (cols + 3) <= 4*nwords and
    Wp % 4 == 0 (guaranteed by _MC_PAD=16 on 16-aligned planes).

    even_x=True: caller guarantees sx is always even (the interleaved
    chroma plane doubles its x coordinates), so only word phases
    {0, 2} can occur — one fewer gathered word per row and half the
    phase-select chain."""
    import jax

    R, Hp, Wp = refs_p.shape
    maxph = 2 if even_x else 3
    nw = (cols + maxph + 3) // 4  # words covering cols at any phase
    words = jax.lax.bitcast_convert_type(
        refs_p.reshape(R, Hp, Wp // 4, 4), xp.uint32)
    arr = xp.arange(rows)
    arw = xp.arange(nw)
    rowi = (xp.clip(slot, 0, R - 1) * Hp + sy)[:, None] + arr[None, :]
    w0 = sx >> 2
    phase = sx & 3
    idx = (rowi[:, :, None] * (Wp // 4)
           + (w0[:, None] + arw[None, :])[:, None, :])
    wflat, idx = _fuse_break(words.reshape(-1), idx)
    g = _fuse_break(xp.take(wflat, idx))  # [B, rows, nw] uint32
    # little-endian unpack to 4*nw bytes, then static phase select
    # (a per-column word/shift select was measured SLOWER here)
    sh = (xp.arange(4, dtype=xp.uint32) * 8)[None, None, None, :]
    byts = ((g[..., None] >> sh) & 0xFF).astype(xp.int32)
    byts = byts.reshape(byts.shape[0], rows, nw * 4)
    out = byts[:, :, 0:cols]
    for a in ((2,) if even_x else (1, 2, 3)):
        out = xp.where((phase == a)[:, None, None],
                       byts[:, :, a : a + cols], out)
    return out


def _halfpel_planes(refs_p, xp):
    """Pre-interpolate the three half-pel planes per (padded) reference
    plane: b (half-x), h (half-y), j (half-both) — the reference's
    inter_pred_luma_frac20/02/22 intermediates (h264.cpp:6118-6262)
    computed densely once per picture instead of per 4x4 block.

    refs_p [R,Hp,Wp] -> [4,R,Hp,Wp] int32 stack (G,b,h,j), borders
    (2 px in, 3 px out) zero — never sampled (window starts clamp to
    [-9, dim+1], i.e. padded coords >= 7)."""
    P = refs_p.astype(xp.int32)
    R, Hp, Wp = P.shape
    raw_b = _tap6(P)                              # [R,Hp,Wp-5] at x-2
    raw_h = xp.swapaxes(_tap6(xp.swapaxes(P, -1, -2)), -1, -2)
    raw_j = xp.swapaxes(_tap6(xp.swapaxes(raw_b, -1, -2)), -1, -2)

    def clip255(a):
        return xp.clip(a, 0, 255)

    def embed(a, ro, co):
        return xp.pad(a, ((0, 0), (ro, Hp - ro - a.shape[1]),
                          (co, Wp - co - a.shape[2])))

    b = embed(clip255((raw_b + 16) >> 5), 0, 2)
    h = embed(clip255((raw_h + 16) >> 5), 2, 0)
    j = embed(clip255((raw_j + 512) >> 10), 2, 2)
    return xp.stack([P, b, h, j]).astype(xp.uint8)


#: (plane1, dy1, dx1, plane2, dy2, dx2) per frac index fy*4+fx: every
#: quarter-pel case is avg(P1[pos+o1], P2[pos+o2]) (exact cases use
#: P1 == P2, avg(a, a) == a). Planes: 0=G 1=b 2=h 3=j.
_HP_TAB = np.array([
    (0, 0, 0, 0, 0, 0), (0, 0, 0, 1, 0, 0),   # (fy0) fx 0,1
    (1, 0, 0, 1, 0, 0), (0, 0, 1, 1, 0, 0),   #       fx 2,3
    (0, 0, 0, 2, 0, 0), (1, 0, 0, 2, 0, 0),   # (fy1) fx 0,1
    (1, 0, 0, 3, 0, 0), (1, 0, 0, 2, 0, 1),   #       fx 2,3
    (2, 0, 0, 2, 0, 0), (2, 0, 0, 3, 0, 0),   # (fy2) fx 0,1
    (3, 0, 0, 3, 0, 0), (3, 0, 0, 2, 0, 1),   #       fx 2,3
    (0, 1, 0, 2, 0, 0), (1, 1, 0, 2, 0, 0),   # (fy3) fx 0,1
    (3, 0, 0, 1, 1, 0), (1, 1, 0, 2, 0, 1),   #       fx 2,3
], np.int32)


def _qpel_planes(planes4, xp):
    """[4,R,Hp,Wp] half-pel stack -> [16,R,Hp,Wp] dense quarter-pel
    planes: plane f = fy*4+fx holds avg(P1[.+o1], P2[.+o2]) per
    _HP_TAB, so every quarter-pel prediction becomes ONE window fetch
    (vs two + avg in _luma_mc_hp) — half the gathered words and one
    byte-unpack chain instead of two per cell. Exact: the averaging
    is positionally invariant, and the +1-shifted reads stay inside
    the _MC_PAD margins for every clamped window start (max sampled
    row/col H+21 < Hp-1; the zero fill introduced at the last row/col
    is never sampled). The four exact-phase planes reuse the half-pel
    stack directly (avg(a,a) == a)."""
    P4 = planes4.astype(xp.int32)
    R = planes4.shape[1]

    def shifted(p, dy, dx):
        a = P4[p]
        if dy:
            a = xp.concatenate(
                [a[:, 1:, :], xp.zeros_like(a[:, :1, :])], axis=1)
        if dx:
            a = xp.concatenate(
                [a[:, :, 1:], xp.zeros_like(a[:, :, :1])], axis=2)
        return a

    outs = []
    for f in range(16):
        p1, dy1, dx1, p2, dy2, dx2 = (int(v) for v in _HP_TAB[f])
        if (p1, dy1, dx1) == (p2, dy2, dx2):
            outs.append(planes4[p1])
            continue
        a = shifted(p1, dy1, dx1)
        b = shifted(p2, dy2, dx2)
        outs.append(((a + b + 1) >> 1).astype(xp.uint8))
    return xp.stack(outs)


def _luma_mc_qp(planes16, slot, posx, posy, fracx, fracy, xp, H, W,
                size=4):
    """Quarter-pel luma via the dense 16-phase plane stack: ONE
    size x size window fetch per prediction (see _qpel_planes).
    Bit-exact with _luma_mc_hp / _luma_mc."""
    posy_c = xp.clip(posy, -9, H + 1)
    posx_c = xp.clip(posx, -9, W + 1)
    nplanes, R, Hp, Wp = planes16.shape
    flat = planes16.reshape(nplanes * R, Hp, Wp)
    sl = xp.clip(slot, 0, R - 1)
    return _flat_windows32(
        flat, (fracy * 4 + fracx) * R + sl,
        posy_c + _MC_PAD, posx_c + _MC_PAD, size, size, xp)


def _luma_mc_hp(planes4, slot, posx, posy, fracx, fracy, xp, H, W,
                size=4):
    """Quarter-pel luma via the half-pel plane stack: two size x size
    window fetches + one average, bit-exact with _luma_mc.

    size=4 is the per-4x4-cell path; size=16 serves a whole
    uniform-MV macroblock with ONE pair of 16x16 window fetches
    (5 words/row instead of 2 words per 4-px cell row — ~38% fewer
    gathered words; the gather unit is issue-rate-bound per element).
    Callers of size=16 must guarantee the clips below never engage
    (host-side exclusion: base in [-9, dim-11]) — a clipped base
    breaks the contiguity of the per-cell windows."""
    posy_c = xp.clip(posy, -9, H + 1)
    posx_c = xp.clip(posx, -9, W + 1)
    nplanes, R, Hp, Wp = planes4.shape
    flat = planes4.reshape(nplanes * R, Hp, Wp)
    tab = xp.asarray(_HP_TAB)[fracy * 4 + fracx]   # [B,6]
    sl = xp.clip(slot, 0, R - 1)

    def fetch(pcol, dycol, dxcol):
        return _flat_windows32(
            flat, tab[:, pcol] * R + sl,
            posy_c + tab[:, dycol] + _MC_PAD,
            posx_c + tab[:, dxcol] + _MC_PAD, size, size, xp)

    w1 = fetch(0, 1, 2)
    w2 = fetch(3, 4, 5)
    return (w1 + w2 + 1) >> 1


def _luma_mc(refs_p, slot, posx, posy, fracx, fracy, xp, H, W):
    """Quarter-pel 4x4 luma for B blocks.

    refs_p [R,H+2p,W+2p] uint8 (edge-padded); slot/pos/frac [B].
    Returns [B,4,4] in 0..255. Mirrors inter.luma_interp exactly: the
    window start is clamped into the saturation domain (beyond it every
    clamped window is flat, filtering to the edge pixel), then one
    contiguous slice per block replaces the per-pixel clamped gather.
    """
    posy_c = xp.clip(posy, -9, H + 1)
    posx_c = xp.clip(posx, -9, W + 1)
    g = _flat_windows32(refs_p, slot, posy_c - 2 + _MC_PAD,
                        posx_c - 2 + _MC_PAD, 9, 9, xp)

    def clip255(a):
        return xp.clip(a, 0, 255)

    G = g[:, 2:6, 2:6]
    raw_b = _tap6(g)                      # [B,9,4]
    b_full = clip255((raw_b + 16) >> 5)
    b = b_full[:, 2:6]
    raw_h = xp.swapaxes(_tap6(xp.swapaxes(g, -1, -2)), -1, -2)  # [B,4,9]
    h_full = clip255((raw_h + 16) >> 5)
    h = h_full[:, :, 2:6]
    j_raw = xp.swapaxes(_tap6(xp.swapaxes(raw_b, -1, -2)), -1, -2)
    j = clip255((j_raw + 512) >> 10)      # [B,4,4]
    Gx1 = g[:, 2:6, 3:7]
    Gy1 = g[:, 3:7, 2:6]
    s_row = b_full[:, 3:7]
    m_col = h_full[:, :, 3:7]

    def avg(a, bb):
        return (a + bb + 1) >> 1

    fx = fracx[:, None, None]
    fy = fracy[:, None, None]
    # fy == 0 row
    r_y0 = xp.where(fx == 0, G, xp.where(fx == 1, avg(G, b),
                    xp.where(fx == 2, b, avg(Gx1, b))))
    # fx == 0 col
    r_x0 = xp.where(fy == 1, avg(G, h), xp.where(fy == 2, h, avg(Gy1, h)))
    # fy == 2 (uses j)
    r_y2 = xp.where(fx == 1, avg(h, j), xp.where(fx == 2, j, avg(j, m_col)))
    # fx == 2
    r_x2 = xp.where(fy == 1, avg(b, j), avg(j, s_row))
    # diagonal quarters
    bb = xp.where(fy == 1, b, s_row)
    hh = xp.where(fx == 1, h, m_col)
    r_diag = avg(bb, hh)
    out = xp.where(fy == 0, r_y0,
          xp.where(fx == 0, r_x0,
          xp.where(fy == 2, r_y2,
          xp.where(fx == 2, r_x2, r_diag))))
    return out


def _chroma_mc(refs_p, slot, posx, posy, fracx, fracy, xp, H, W):
    """1/8-pel bilinear 2x2 chroma; refs_p [R,Hc+2p,Wc+2p] edge-padded."""
    posy_c = xp.clip(posy, -3, H - 1)
    posx_c = xp.clip(posx, -3, W - 1)
    g = _flat_windows32(refs_p, slot, posy_c + _MC_PAD, posx_c + _MC_PAD,
                        3, 3, xp)
    a = g[:, 0:2, 0:2]
    b = g[:, 0:2, 1:3]
    c = g[:, 1:3, 0:2]
    d = g[:, 1:3, 1:3]
    fx = fracx[:, None, None]
    fy = fracy[:, None, None]
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def _chroma_mc_ilv(refs_ilv_p, slot, posx, posy, fracx, fracy, xp, H, W,
                   size=2):
    """Bilinear chroma from a column-INTERLEAVED CbCr plane
    [R, Hc+2p, 2*(Wc+2p)] (NV12 row layout, frames.h interleaved
    chroma): cb and cr windows share coordinates, so ONE word-gather
    per prediction serves both components — half the fetches and ~25%
    fewer gathered words than per-plane fetching (the gather unit is
    issue-rate-bound per element). Returns (pcb, pcr) [B,size,size].

    size=2 is the per-cell path; size=8 serves a uniform-MV MB's whole
    chroma with one 9-row interleaved fetch (~60% fewer words than 16
    per-cell 3x3 windows). size=8 callers must guarantee the clips
    never engage (host exclusion: base in [-3, dim-7])."""
    posy_c = xp.clip(posy, -3, H - 1)
    posx_c = xp.clip(posx, -3, W - 1)
    t = size + 1  # texel rows needed for size bilinear outputs
    g = _flat_windows32(refs_ilv_p, slot, posy_c + _MC_PAD,
                        2 * (posx_c + _MC_PAD), t, 2 * t, xp,
                        even_x=True)
    # interleaved bilinear: the +1-texel taps are +2 byte-columns
    a = g[:, 0:size, 0 : 2 * size]
    b = g[:, 0:size, 2 : 2 * size + 2]
    c = g[:, 1 : size + 1, 0 : 2 * size]
    d = g[:, 1 : size + 1, 2 : 2 * size + 2]
    fx = fracx[:, None, None]
    fy = fracy[:, None, None]
    out = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
           + (8 - fx) * fy * c + fx * fy * d + 32) >> 6  # ilv
    return out[:, :, 0::2], out[:, :, 1::2]


def _interleave_chroma(cb_p, cr_p, xp):
    """[R,Hp,Wp] x2 -> [R,Hp,2*Wp] column-interleaved."""
    R_, Hp, Wp = cb_p.shape
    return xp.stack([cb_p, cr_p], axis=-1).reshape(R_, Hp, 2 * Wp)


def _combine_wp(p0, p1, both, w0, w1, o, s, xp):
    """Unified copy/AVERAGE2/explicit/implicit combine (plan.py wp)."""
    rnd = xp.where(s > 0, 1 << xp.maximum(s - 1, 0), 0)
    uni = ((p0 * w0 + rnd) >> s) + o
    bi = ((p0 * w0 + p1 * w1 + rnd) >> s) + o
    return xp.clip(xp.where(both, bi, uni), 0, 255)


def inter_pass(plan_mv, plan_slot, plan_wp, refs_y, refs_cb, refs_cr,
               mb_w, mb_h, xp, y_off=0, used=None, bi_idx=None,
               nu=None, uni=None, ubi=None):
    """Predict every 4x4 block of the picture from the ref stacks.

    Returns pred_y [n,16,16], pred_cb/cr [n,8,8] int32 (garbage for
    intra MBs; selected out later). y_off: pixel-row offset of this MB
    block within the full picture (tile-band sharding: MVs address the
    replicated reference frames in global coordinates).

    used: optional [K] compact list of pool slots this picture actually
    references (host-derived; plan slots pre-remapped to 0..K-1) — the
    half-pel plane stack and padded ref copies then cover K planes
    instead of the whole pool.
    bi_idx: optional [Bb] compacted bi-predicted cell rows (absolute
    cell indices padded with B when nu is None; positions into `nu`
    padded with its capacity otherwise). The second prediction is
    fetched ONLY for those rows.
    nu/uni/ubi: host MC compaction (see _derive_mc_aux) — `uni` [U]
    lists uniform-MV inter MBs served by ONE 16x16/9-row-chroma fetch
    pair each, `nu` [Bn] the remaining inter cells (intra cells fetch
    NOTHING), `ubi` [Ub] positions into `uni` needing a second
    prediction. Together they cut the gathered-word count ~2-3x on
    skip/16x16-partition-heavy content."""
    # _derive_mc_aux's clip-exclusion proof computes block bases with
    # y_off=0; the compacted aux is invalid for band-sharded tiles
    # (advisor r4) — the mesh tile path must pass nu=uni=None.
    # (y_off is a tracer under the tile-band pjit, so only check when
    # compaction aux is actually supplied.)
    if nu is not None or uni is not None:
        assert isinstance(y_off, int) and y_off == 0, \
            "MC compaction aux is derived for y_off=0 only"
    n = mb_w * mb_h
    B = n * 16

    H, W = refs_y.shape[1], refs_y.shape[2]
    if used is not None:
        refs_y, refs_cb, refs_cr = _fuse_break(
            refs_y[used], refs_cb[used], refs_cr[used])
    refs_y_p = _pad_refs_edge(refs_y, xp)
    refs_c_p = _interleave_chroma(_pad_refs_edge(refs_cb, xp),
                                  _pad_refs_edge(refs_cr, xp), xp)
    planes16 = _qpel_planes(_halfpel_planes(refs_y_p, xp), xp)

    def pred_one(sl, mvv, bxv, byv, size=4):
        mvx, mvy = mvv[:, 0], mvv[:, 1]
        py = _luma_mc_qp(planes16, sl, bxv + (mvx >> 2),
                         byv + (mvy >> 2), mvx & 3, mvy & 3, xp, H, W,
                         size=size)
        cxp = (bxv >> 1) + (mvx >> 3)
        cyp = (byv >> 1) + (mvy >> 3)
        pcb, pcr = _chroma_mc_ilv(refs_c_p, sl, cxp, cyp, mvx & 7,
                                  mvy & 7, xp, H >> 1, W >> 1,
                                  size=size >> 1)
        return py, pcb, pcr

    def comb(wpa, pi, pa, pb, mask3):
        w0 = wpa[:, pi, 0][:, None, None]
        w1 = wpa[:, pi, 1][:, None, None]
        o = wpa[:, pi, 2][:, None, None]
        s = wpa[:, pi, 3][:, None, None]
        return _combine_wp(pa, pb, mask3, w0, w1, o, s, xp)

    if nu is None:
        # dense path: every cell (incl. intra garbage rows) fetches
        mb = xp.arange(n, dtype=xp.int32)
        x0 = (mb % mb_w) * 16
        y0 = (mb // mb_w) * 16 + y_off
        blk = xp.arange(16, dtype=xp.int32)
        bx = (x0[:, None] + (blk[None, :] & 3) * 4).reshape(B)
        by = (y0[:, None] + (blk[None, :] >> 2) * 4).reshape(B)
        quad = ((blk >> 3) * 2 + ((blk >> 1) & 1))[None, :]  # [1,16]
        quad = xp.broadcast_to(quad, (n, 16)).reshape(B)
        slot = plan_slot.reshape(n, 4, 2)[
            xp.repeat(mb, 16), quad]  # [B,2]
        wp = plan_wp.reshape(n, 4, 3, 4)[xp.repeat(mb, 16), quad]
        mv = plan_mv.reshape(B, 2, 2)

        s0, s1 = slot[:, 0], slot[:, 1]
        both = (s0 >= 0) & (s1 >= 0)
        # single-list predictions route through p0 (recorder convention)
        p0_slot = xp.where(s0 >= 0, s0, s1)
        p0_mv = xp.where((s0 >= 0)[:, None], mv[:, 0], mv[:, 1])
        p0y, p0cb, p0cr = pred_one(p0_slot, p0_mv, bx, by)

        if bi_idx is None:
            p1y, p1cb, p1cr = pred_one(
                xp.where(both, s1, p0_slot),
                xp.where(both[:, None], mv[:, 1], p0_mv), bx, by)
            both3 = both[:, None, None]
            out_y = comb(wp, 0, p0y, p1y, both3)     # [B,4,4]
            out_cb = comb(wp, 1, p0cb, p1cb, both3)  # [B,2,2]
            out_cr = comb(wp, 2, p0cr, p1cr, both3)
        else:
            # uni combine everywhere, compacted bi rows overwrite
            pad = bi_idx >= B
            bidx = xp.clip(bi_idx, 0, B - 1)
            (s1c, mv1c, bxc, byc, wpc, p0yc, p0cbc,
             p0crc) = _fuse_break(s1[bidx], mv[bidx, 1], bx[bidx],
                                  by[bidx], wp[bidx], p0y[bidx],
                                  p0cb[bidx], p0cr[bidx])
            p1y, p1cb, p1cr = pred_one(s1c, mv1c, bxc, byc)
            out_y = comb(wp, 0, p0y, p0y, False)
            out_cb = comb(wp, 1, p0cb, p0cb, False)
            out_cr = comb(wp, 2, p0cr, p0cr, False)
            sidx = xp.where(pad, B + 16, bidx)  # dropped rows
            out_y = _fuse_break(out_y.at[sidx].set(
                comb(wpc, 0, p0yc, p1y, True), mode="drop"))
            out_cb = _fuse_break(out_cb.at[sidx].set(
                comb(wpc, 1, p0cbc, p1cb, True), mode="drop"))
            out_cr = _fuse_break(out_cr.at[sidx].set(
                comb(wpc, 2, p0crc, p1cr, True), mode="drop"))
    else:
        # compacted path: fetch only real inter work; scatters are as
        # expensive as gathers on this backend, so results assemble
        # fully inside the compact domain (bi overwrites, interleaved
        # cb|cr) and ride exactly ONE luma + ONE chroma scatter per
        # partition (nu cells, uniform MBs)
        out_y = xp.zeros((B, 4, 4), xp.int32)
        out_c = xp.zeros((B, 2, 4), xp.int32)  # cb|cr interleaved

        def ilv(cb, cr):
            s = cb.shape
            return xp.stack([cb, cr], axis=-1).reshape(s[:-1]
                                                       + (2 * s[-1],))

        # --- non-uniform inter cells ---------------------------------
        Bn = nu.shape[0]
        nupad = nu >= B
        nuc = xp.clip(nu, 0, B - 1)
        mbn = nuc >> 4
        blkn = nuc & 15
        qn = (blkn >> 3) * 2 + ((blkn >> 1) & 1)
        slotn = plan_slot.reshape(n, 4, 2)[mbn, qn]      # [Bn,2]
        wpn = plan_wp.reshape(n, 4, 3, 4)[mbn, qn]       # [Bn,3,4]
        mvn = plan_mv.reshape(B, 2, 2)[nuc]              # [Bn,2,2]
        bxn = (mbn % mb_w) * 16 + (blkn & 3) * 4
        byn = (mbn // mb_w) * 16 + (blkn >> 2) * 4 + y_off
        (slotn, wpn, mvn, bxn, byn) = _fuse_break(slotn, wpn, mvn,
                                                  bxn, byn)
        s0, s1 = slotn[:, 0], slotn[:, 1]
        p0_slot = xp.where(s0 >= 0, s0, s1)
        p0_mv = xp.where((s0 >= 0)[:, None], mvn[:, 0], mvn[:, 1])
        p0y, p0cb, p0cr = pred_one(p0_slot, p0_mv, bxn, byn)
        r_y = comb(wpn, 0, p0y, p0y, False)
        r_cb = comb(wpn, 1, p0cb, p0cb, False)
        r_cr = comb(wpn, 2, p0cr, p0cr, False)

        # bi rows among nu (bi_idx holds positions INTO nu): overwrite
        # within the compact domain, before the single scatter out
        if bi_idx is not None:
            bipad = bi_idx >= Bn
            bidx = xp.clip(bi_idx, 0, Bn - 1)
            (s1c, mv1c, bxc, byc, wpc, p0yc, p0cbc,
             p0crc) = _fuse_break(s1[bidx], mvn[bidx, 1], bxn[bidx],
                                  byn[bidx], wpn[bidx], p0y[bidx],
                                  p0cb[bidx], p0cr[bidx])
            p1y, p1cb, p1cr = pred_one(s1c, mv1c, bxc, byc)
            sidx_b = xp.where(bipad, Bn + 1, bidx)
            r_y = r_y.at[sidx_b].set(
                comb(wpc, 0, p0yc, p1y, True), mode="drop")
            r_cb = r_cb.at[sidx_b].set(
                comb(wpc, 1, p0cbc, p1cb, True), mode="drop")
            r_cr = r_cr.at[sidx_b].set(
                comb(wpc, 2, p0crc, p1cr, True), mode="drop")
        sidx_n = xp.where(nupad, B + 16, nuc)
        out_y = _fuse_break(out_y.at[sidx_n].set(r_y, mode="drop"))
        out_c = _fuse_break(out_c.at[sidx_n].set(ilv(r_cb, r_cr),
                                                 mode="drop"))

        # --- uniform-MV macroblocks: one wide fetch per MB -----------
        if uni is not None:
            U = uni.shape[0]
            upad = uni >= n
            um = xp.clip(uni, 0, n - 1)
            slotm = plan_slot.reshape(n, 4, 2)[um, 0]     # [U,2]
            wpm = plan_wp.reshape(n, 4, 3, 4)[um, 0]      # [U,3,4]
            mvm = plan_mv.reshape(n, 16, 2, 2)[um, 0]     # [U,2,2]
            x0m = (um % mb_w) * 16
            y0m = (um // mb_w) * 16 + y_off
            (slotm, wpm, mvm, x0m, y0m) = _fuse_break(slotm, wpm, mvm,
                                                      x0m, y0m)
            s0m, s1m = slotm[:, 0], slotm[:, 1]
            p0s = xp.where(s0m >= 0, s0m, s1m)
            p0mv = xp.where((s0m >= 0)[:, None], mvm[:, 0], mvm[:, 1])
            puy, pucb, pucr = pred_one(p0s, p0mv, x0m, y0m, size=16)
            uy = comb(wpm, 0, puy, puy, False)     # [U,16,16]
            ucb = comb(wpm, 1, pucb, pucb, False)  # [U,8,8]
            ucr = comb(wpm, 2, pucr, pucr, False)
            if ubi is not None:
                ubpad = ubi >= U
                ubc = xp.clip(ubi, 0, U - 1)
                (s1u, mv1u, x0u, y0u, wpu, puyc, pucbc,
                 pucrc) = _fuse_break(s1m[ubc], mvm[ubc, 1], x0m[ubc],
                                      y0m[ubc], wpm[ubc], puy[ubc],
                                      pucb[ubc], pucr[ubc])
                p1y, p1cb, p1cr = pred_one(s1u, mv1u, x0u, y0u, size=16)
                sidx_ub = xp.where(ubpad, U + 1, ubc)
                uy = uy.at[sidx_ub].set(
                    comb(wpu, 0, puyc, p1y, True), mode="drop")
                ucb = ucb.at[sidx_ub].set(
                    comb(wpu, 1, pucbc, p1cb, True), mode="drop")
                ucr = ucr.at[sidx_ub].set(
                    comb(wpu, 2, pucrc, p1cr, True), mode="drop")
            cells = um[:, None] * 16 + xp.arange(16, dtype=xp.int32)
            sidx_u = xp.where(upad[:, None], B + 16, cells)  # [U,16]
            uy_c = (uy.reshape(U, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
                    .reshape(U, 16, 4, 4))
            uc = ilv(ucb, ucr)  # [U,8,16] cb|cr interleaved columns
            uc_c = (uc.reshape(U, 4, 2, 4, 4).transpose(0, 1, 3, 2, 4)
                    .reshape(U, 16, 2, 4))
            out_y = _fuse_break(out_y.at[sidx_u].set(uy_c, mode="drop"))
            out_c = _fuse_break(out_c.at[sidx_u].set(uc_c, mode="drop"))
        out_cb = out_c[:, :, 0::2]
        out_cr = out_c[:, :, 1::2]

    pred_y = (out_y.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
              .reshape(n, 16, 16))
    pred_cb = (out_cb.reshape(n, 4, 4, 2, 2).transpose(0, 1, 3, 2, 4)
               .reshape(n, 8, 8))
    pred_cr = (out_cr.reshape(n, 4, 4, 2, 2).transpose(0, 1, 3, 2, 4)
               .reshape(n, 8, 8))
    return pred_y, pred_cb, pred_cr


# =====================================================================
# intra prediction formulas on lane-stacked neighbor vectors
# =====================================================================


def _fir3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _fir2(a, b):
    return (a + b + 1) >> 1


def _sel_mode(stack, mode, xp):
    """stack [M][L,h,w]; mode [L] -> [L,h,w]."""
    out = stack[0]
    for m in range(1, len(stack)):
        out = xp.where((mode == m)[:, None, None], stack[m], out)
    return out



# =====================================================================
# gather-table intra modes: every predicted sample of every mode is
# fir3(A,B,C) or fir2(B,C) over one per-block "reference line" vector,
# with constant index tables — collapses the per-position expression
# trees into 3 gathers + 2 formulas + 1 select (scan bodies shrink
# with it). copy(x) = fir2(x,x); DC = fir2(dc,dc) with dc a line entry.
# =====================================================================

def _mk_tables4():
    """Index tables for the 9 4x4 modes over line layout:
    [0..3]=left, [4]=corner, [5..12]=top(+topright/substituted),
    [13]=DC."""
    L_, C_, T_, DC_ = 0, 4, 5, 13
    IA = np.zeros((9, 16), np.int32)
    IB = np.zeros((9, 16), np.int32)
    IC = np.zeros((9, 16), np.int32)
    K3 = np.zeros((9, 16), bool)

    def put(m, y, x, kind, a, b, c=0):
        p = y * 4 + x
        K3[m, p] = kind
        IA[m, p], IB[m, p], IC[m, p] = a, b, c
        if not kind:  # fir2 uses (B, C)
            IA[m, p] = b

    for y in range(4):
        for x in range(4):
            # 0 vert / 1 horiz / 2 dc
            put(0, y, x, False, 0, T_ + x, T_ + x)
            put(1, y, x, False, 0, L_ + y, L_ + y)
            put(2, y, x, False, 0, DC_, DC_)
            # 3 ddl
            i = x + y
            put(3, y, x, True, T_ + i, T_ + i + 1, T_ + min(i + 2, 7))
            # 4 ddr: line = [l3..l0, c, t0..t3], center j = 4 + x - y
            def ddr_idx(j):
                if j < 4:
                    return L_ + 3 - j
                if j == 4:
                    return C_
                return T_ + j - 5
            j = 4 + x - y
            put(4, y, x, True, ddr_idx(j - 1), ddr_idx(j), ddr_idx(j + 1))
            # 5 vr
            def tfull(k):
                return C_ if k == 0 else T_ + k - 1
            def lfull(k):
                return C_ if k == 0 else L_ + k - 1
            z = 2 * x - y
            if z >= 0:
                i = x - (y >> 1)
                if z & 1:
                    put(5, y, x, True, tfull(i - 1), tfull(i), tfull(i + 1))
                else:
                    put(5, y, x, False, 0, tfull(i), tfull(i + 1))
            elif z == -1:
                put(5, y, x, True, L_ + 0, C_, T_ + 0)
            else:
                put(5, y, x, True, lfull(y), lfull(y - 1), lfull(y - 2))
            # 6 hd
            z = 2 * y - x
            if z >= 0:
                i = y - (x >> 1)
                if z & 1:
                    put(6, y, x, True, lfull(i - 1), lfull(i), lfull(i + 1))
                else:
                    put(6, y, x, False, 0, lfull(i), lfull(i + 1))
            elif z == -1:
                put(6, y, x, True, T_ + 0, C_, L_ + 0)
            else:
                put(6, y, x, True, tfull(x), tfull(x - 1), tfull(x - 2))
            # 7 vl
            i = x + (y >> 1)
            if y & 1:
                put(7, y, x, True, T_ + i, T_ + i + 1, T_ + min(i + 2, 7))
            else:
                put(7, y, x, False, 0, T_ + i, T_ + i + 1)
            # 8 hu
            z = x + 2 * y
            if z < 5:
                i = y + (x >> 1)
                if z & 1:
                    put(8, y, x, True, L_ + i, L_ + i + 1,
                        L_ + min(i + 2, 3))
                else:
                    put(8, y, x, False, 0, L_ + i, L_ + i + 1)
            elif z == 5:
                put(8, y, x, True, L_ + 2, L_ + 3, L_ + 3)
            else:
                put(8, y, x, False, 0, L_ + 3, L_ + 3)
    return IA, IB, IC, K3


_I4_TAB = _mk_tables4()


def _mode_matrix(tab, n_line):
    """(IA, IB, IC, K3) index tables -> (coef [n_line, 9*P], rnd [9*P],
    shift [9*P]) so that for every mode m and position p
    vals[:, m*P+p] = (line @ coef + rnd)[:, m*P+p] >> shift[m*P+p]
    reproduces fir3(A,B,C) / fir2(B,C) exactly: line values are pixels
    0..255 and coefficients 0..4, all exact in TF32's 11 significant
    bits, and every sum stays below 2^12, exact in the f32 accumulator
    (tests/test_xla_paths.py). Gather-free."""
    IA, IB, IC, K3 = tab
    P = IA.shape[1]
    M = np.zeros((n_line, 9 * P), np.float32)
    for m in range(9):
        for p in range(P):
            col = m * P + p
            if K3[m, p]:
                M[IA[m, p], col] += 1
                M[IB[m, p], col] += 2
                M[IC[m, p], col] += 1
            else:
                M[IB[m, p], col] += 1
                M[IC[m, p], col] += 1
    rnd = np.where(K3.reshape(-1), 2, 1).astype(np.int32)
    shift = np.where(K3.reshape(-1), 2, 1).astype(np.int32)
    return M, rnd, shift


_I4_MAT = _mode_matrix(_I4_TAB, 14)


def _iota1(xp, n, start=0, dtype=None):
    """1-D index vector: np.arange on numpy, a lax iota under jax."""
    if xp is np:
        return np.arange(start, start + n,
                         dtype=dtype or np.int32)
    import jax

    v = jax.lax.broadcasted_iota(dtype or xp.int32, (n, 1), 0)[:, 0]
    return v + start if start else v


def _mode_eval(line, mode, mats, P, xp):
    """line [L,n] int32, mode [L] -> [L,P] selected mode values via one
    constant matmul + one-hot select (no gathers)."""
    M, rnd, shift = mats
    acc = xp.matmul(line.astype(xp.float32), M)
    vals = (acc.astype(xp.int32) + rnd[None]) >> shift[None]
    # mode select via static per-mode slices
    out = vals[:, 0:P]
    for m in range(1, 9):
        out = xp.where((mode == m)[:, None], vals[:, m * P : m * P + P],
                       out)
    return out


def intra4_modes(l, t, c, avail, mode, xp):
    """All 9 4x4 modes via the constant mode matrix; l[L,4], t[L,8] raw
    top+topright, c[L], avail bits; returns [L,4,4]."""
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    av4 = (avail & 4) != 0
    t4 = t[:, :4]
    th = xp.where(av4[:, None], t[:, 4:8], t[:, 3:4])
    sl = l.sum(axis=1)
    st = t4.sum(axis=1)
    dc = xp.where(av1 & av2, (sl + st + 4) >> 3,
         xp.where(av1, (sl + 2) >> 2,
         xp.where(av2, (st + 2) >> 2, 0x80)))
    line = xp.concatenate([l, c[:, None], t4, th, dc[:, None]], axis=1)
    out = _mode_eval(line, mode, _I4_MAT, 16, xp)
    return out.reshape(l.shape[0], 4, 4)


def _mk_tables8():
    """Index tables for the 9 8x8 modes over line layout:
    [0..7]=filtered left, [8]=filtered corner, [9..24]=filtered top
    run t'[0..15], [25]=DC."""
    LF, COR, TP, DC_ = 0, 8, 9, 25
    IA = np.zeros((9, 64), np.int32)
    IB = np.zeros((9, 64), np.int32)
    IC = np.zeros((9, 64), np.int32)
    K3 = np.zeros((9, 64), bool)

    def put(m, y, x, kind, a, b, c=0):
        p = y * 8 + x
        K3[m, p] = kind
        IA[m, p], IB[m, p], IC[m, p] = (a if kind else b), b, c

    def q(j):  # [cor] + lf
        return COR if j == 0 else LF + j - 1

    # hd rows resolved recursively to static indices
    def hd_entry(y, x):
        while y > 0 and x >= 2:
            y -= 1
            x -= 2
        if y == 0:
            if x == 0:
                return (False, 0, LF + 0, COR)
            if x == 1:
                return (True, LF + 0, COR, TP + 0)
            if x == 2:
                return (True, COR, TP + 0, TP + 1)
            return (True, TP + x - 3, TP + x - 2, TP + x - 1)
        zn = y + 1 if y + 1 < 9 else 8
        if x == 0:
            return (False, 0, q(y), q(zn))
        return (True, q(y - 1), q(y), q(zn))

    for y in range(8):
        for x in range(8):
            put(0, y, x, False, 0, TP + x, TP + x)        # vert
            put(1, y, x, False, 0, LF + y, LF + y)        # horiz
            put(2, y, x, False, 0, DC_, DC_)              # dc
            k = x + y                                     # ddl
            put(3, y, x, True, TP + k, TP + k + 1, TP + min(k + 2, 15))
            # ddr
            if x >= y:
                d = x - y
                if d == 0:
                    put(4, y, x, True, TP + 0, COR, LF + 0)
                elif d == 1:
                    put(4, y, x, True, COR, TP + 0, TP + 1)
                else:
                    put(4, y, x, True, TP + d - 2, TP + d - 1, TP + d)
            else:
                j = y - x - 1
                put(4, y, x, True, q(j), q(j + 1), q(min(j + 2, 8)))
            # vr
            kk, odd = divmod(y, 2)
            if x >= kk:
                i = x - kk
                if odd:
                    if i == 0:
                        put(5, y, x, True, TP + 0, COR, LF + 0)
                    elif i == 1:
                        put(5, y, x, True, COR, TP + 0, TP + 1)
                    else:
                        put(5, y, x, True, TP + i - 2, TP + i - 1, TP + i)
                else:
                    if i == 0:
                        put(5, y, x, False, 0, COR, TP + 0)
                    else:
                        put(5, y, x, False, 0, TP + i - 1, TP + i)
            else:
                j = 2 * (kk - x) - 2 + odd
                put(5, y, x, True, q(j), q(j + 1), q(min(j + 2, 8)))
            # hd
            kind, a, b, cc = hd_entry(y, x)
            put(6, y, x, kind, a, b, cc)
            # vl
            i = x + kk
            if odd:
                put(7, y, x, True, TP + i, TP + i + 1, TP + i + 2)
            else:
                put(7, y, x, False, 0, TP + i, TP + i + 1)
            # hu
            v = 2 * y + x
            if v < 14:
                i, vo = divmod(v, 2)
                if vo:
                    put(8, y, x, True, LF + i, LF + i + 1,
                        LF + min(i + 2, 7))
                else:
                    put(8, y, x, False, 0, LF + i, LF + i + 1)
            else:
                put(8, y, x, False, 0, LF + 7, LF + 7)
    return IA, IB, IC, K3


_I8_TAB = _mk_tables8()
_I8_MAT = _mode_matrix(_I8_TAB, 26)


def intra8_modes(t, l, c, tr, avail, mode, xp):
    """All 9 8x8 modes with reference-sample filtering (pred8x8.py),
    constant-matrix form."""
    L = t.shape[0]
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    av4 = (avail & 4) != 0
    av8 = (avail & 8) != 0

    def fir3v(a, b, cc):
        return (a + 2 * b + cc + 2) >> 2

    cprev = xp.where(av8, c, t[:, 0])
    def cat(*parts):
        return xp.concatenate(parts, axis=1)

    prevv = cat(cprev[:, None], t[:, :6])  # [L,7]
    tp7 = fir3v(prevv, t[:, :7], t[:, 1:8])
    full = cat(t, tr)  # [L,16]
    ext = fir3v(full[:, 6:15], full[:, 7:16],
                cat(full[:, 8:16], full[:, 15:16]))
    with_tr = cat(tp7, ext)  # [L,16]
    no_tr = cat(tp7, ((t[:, 6] + 3 * t[:, 7] + 2) >> 2)[:, None],
                xp.broadcast_to(t[:, 7:8], (L, 8)))
    tp16 = xp.where(av4[:, None], with_tr, no_tr)
    lprev = xp.where(av8, c, l[:, 0])
    lprevv = cat(lprev[:, None], l[:, :6])
    lf7 = fir3v(lprevv, l[:, :7], l[:, 1:8])
    lf = cat(lf7, ((l[:, 6] + 3 * l[:, 7] + 2) >> 2)[:, None])
    cor = (l[:, 0] + 2 * c + t[:, 0] + 2) >> 2
    sl = lf.sum(axis=1)
    st = tp16[:, :8].sum(axis=1)
    dc = xp.where(av1 & av2, (sl + st + 8) >> 4,
         xp.where(av1, (sl + 4) >> 3,
         xp.where(av2, (st + 4) >> 3, 0x80)))
    line = cat(lf, cor[:, None], tp16, dc[:, None])
    out = _mode_eval(line, mode, _I8_MAT, 64, xp)
    return out.reshape(L, 8, 8)


def intra16_modes(l16, t16, c, avail, mode, xp):
    """16x16 modes; l16/t16 [L,16], c [L] corner; returns [L,16,16]."""
    L = l16.shape[0]
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    m_vert = xp.broadcast_to(t16[:, None, :], (L, 16, 16))
    m_horiz = xp.broadcast_to(l16[:, :, None], (L, 16, 16))
    sl = l16.sum(axis=1)
    st = t16.sum(axis=1)
    dc = xp.where(av1 & av2, (sl + st + 16) >> 5,
         xp.where(av1, (sl + 8) >> 4,
         xp.where(av2, (st + 8) >> 4, 0x80)))
    m_dc = xp.broadcast_to(dc[:, None, None], (L, 16, 16))
    # plane: the corner|line concatenations fold into the weighted sums
    # algebraically (corner weight is -8 in both) — a reversal- and
    # concat-free form, identical integers
    wv = _iota1(xp, 16, start=-7)
    h = (t16 * wv[None, :]).sum(axis=1) - 8 * c
    v = (l16 * wv[None, :]).sum(axis=1) - 8 * c
    h = (5 * h + 32) >> 6
    v = (5 * v + 32) >> 6
    a = 16 * (l16[:, 15] + t16[:, 15])
    ys = _iota1(xp, 16)
    val = (a[:, None, None] + (ys[None, None, :] - 7) * h[:, None, None]
           + (ys[None, :, None] - 7) * v[:, None, None] + 16) >> 5
    m_plane = xp.clip(val, 0, 255)
    return _sel_mode([m_vert, m_horiz, m_dc, m_plane], mode, xp)


def intra_chroma_modes(l8, t8, c, avail, mode, xp):
    """Chroma modes on an 8x8 plane tile; returns [L,8,8]."""
    L = l8.shape[0]
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    sl0 = l8[:, 0:4].sum(axis=1)
    sl4 = l8[:, 4:8].sum(axis=1)
    st0 = t8[:, 0:4].sum(axis=1)
    st4 = t8[:, 4:8].sum(axis=1)
    dc0 = xp.where(av1 & av2, (sl0 + st0 + 4) >> 3,
          xp.where(av1, (sl0 + 2) >> 2,
          xp.where(av2, (st0 + 2) >> 2, 0x80)))
    dc1 = xp.where(av1 & av2, (st4 + 2) >> 2,
          xp.where(av1, (sl0 + 2) >> 2,
          xp.where(av2, (st4 + 2) >> 2, 0x80)))
    dc2 = xp.where(av1 & av2, (sl4 + 2) >> 2,
          xp.where(av1, (sl4 + 2) >> 2,
          xp.where(av2, (st0 + 2) >> 2, 0x80)))
    dc3 = xp.where(av1 & av2, (sl4 + st4 + 4) >> 3,
          xp.where(av1, (sl4 + 2) >> 2,
          xp.where(av2, (st4 + 2) >> 2, 0x80)))
    # 2x2 DC quadrants expanded to 8x8 via iota masks
    half = _iota1(xp, 8) >= 4
    rsel = half[None, :, None]
    csel = half[None, None, :]
    m_dc = xp.where(
        rsel,
        xp.where(csel, dc3[:, None, None], dc2[:, None, None]),
        xp.where(csel, dc1[:, None, None], dc0[:, None, None]))
    m_dc = xp.broadcast_to(m_dc, (L, 8, 8))
    m_horiz = xp.broadcast_to(l8[:, :, None], (L, 8, 8))
    m_vert = xp.broadcast_to(t8[:, None, :], (L, 8, 8))
    # plane mode: the corner|line concatenations fold into the weighted
    # sums algebraically (corner weight is -4 in both)
    wv8 = _iota1(xp, 8, start=-3)
    h = (t8 * wv8[None, :]).sum(axis=1) - 4 * c
    v = (l8 * wv8[None, :]).sum(axis=1) - 4 * c
    h = (17 * h + 16) >> 5
    v = (17 * v + 16) >> 5
    a = 16 * (l8[:, 7] + t8[:, 7])
    ys = _iota1(xp, 8)
    val = (a[:, None, None] + (ys[None, None, :] - 3) * h[:, None, None]
           + (ys[None, :, None] - 3) * v[:, None, None] + 16) >> 5
    m_plane = xp.clip(val, 0, 255)
    return _sel_mode([m_dc, m_horiz, m_vert, m_plane], mode, xp)


# =====================================================================
# intra wavefront (lax.scan over MB diagonals d = mbx + 2*mby)
# =====================================================================

_ZORDER = [(((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8,
            (i & 1) * 4 + ((i >> 2) & 1) * 8) for i in range(16)]


def _intra_step(carry, lanes, P, mb_w, has_i8, xp):
    y, cb, cr = carry
    lane_idx = lanes[0]
    L = lane_idx.shape[0]
    valid = lane_idx >= 0
    mbs = xp.maximum(lane_idx, 0)
    y0 = xp.maximum(lanes[1], 0)   # intra-pad luma row (stackable)
    cy0_lane = xp.maximum(lanes[2], 0)
    x0 = (mbs % mb_w) * 16
    ar17 = xp.arange(17)
    ar25 = xp.arange(25)
    ar16 = xp.arange(16)
    Ty = y[(y0[:, None] + ar17)[:, :, None],
           (x0[:, None] + ar25)[:, None, :]]  # [L,17,25]
    kind = P["kind"][mbs]
    res = P["res_y"][mbs]          # [L,16,16]
    res_c = P["res_c"][mbs]        # [L,2,8,8]
    mb_avail = P["mb_avail"][mbs]

    def clip(v):
        return xp.clip(v, 0, 255)

    # ---- intra 4x4 chain (coding order) ----
    i4m = P["i4_modes"][mbs]
    i4a = P["i4_avail"][mbs]
    T4 = Ty
    for oy, ox in _ZORDER:
        blk = (oy >> 2) * 4 + (ox >> 2)
        t = T4[:, oy, 1 + ox : 9 + ox]
        ll = T4[:, 1 + oy : 5 + oy, ox]
        c = T4[:, oy, ox]
        out = intra4_modes(ll, t, c, i4a[:, blk], i4m[:, blk], xp)
        out = clip(out + res[:, oy : oy + 4, ox : ox + 4])
        T4 = T4.at[:, 1 + oy : 5 + oy, 1 + ox : 5 + ox].set(out)
    tile = T4[:, 1:17, 1:17]

    # ---- intra 8x8 chain ----
    if has_i8:
        i8m = P["i8_modes"][mbs]
        i8a = P["i8_avail"][mbs]
        T8 = Ty
        for b in range(4):
            oy, ox = (b >> 1) * 8, (b & 1) * 8
            t = T8[:, oy, 1 + ox : 9 + ox]
            tr = T8[:, oy, 9 + ox : 17 + ox]
            ll = T8[:, 1 + oy : 9 + oy, ox]
            c = T8[:, oy, ox]
            out = intra8_modes(t, ll, c, tr, i8a[:, b], i8m[:, b], xp)
            out = clip(out + res[:, oy : oy + 8, ox : ox + 8])
            T8 = T8.at[:, 1 + oy : 9 + oy, 1 + ox : 9 + ox].set(out)
        tile = xp.where((kind == 2)[:, None, None], T8[:, 1:17, 1:17], tile)

    # ---- intra 16x16 ----
    t16 = Ty[:, 0, 1:17]
    l16 = Ty[:, 1:17, 0]
    c16 = Ty[:, 0, 0]
    out16 = clip(intra16_modes(l16, t16, c16, mb_avail,
                               P["i16_mode"][mbs], xp) + res)
    tile = xp.where((kind == 3)[:, None, None], out16, tile)
    tile = xp.where((kind == 1)[:, None, None] | (kind == 2)[:, None, None]
                    | (kind == 3)[:, None, None], tile, Ty[:, 1:17, 1:17])

    is_intra = valid & (kind >= 1) & (kind <= 3)
    BIG = y.shape[0] + y.shape[1] + 32
    sy = xp.where(is_intra, y0 + 1, BIG)
    iy = (sy[:, None] + ar16)[:, :, None]
    ix = ((x0 + 1)[:, None] + ar16)[:, None, :]
    y = y.at[iy, ix].set(tile, mode="drop")

    # ---- chroma ----
    cy0 = cy0_lane
    cx0 = x0 >> 1
    ar9 = xp.arange(9)
    ar8 = xp.arange(8)
    cmode = P["chroma_mode"][mbs]
    outs = []
    for ci, pl in enumerate((cb, cr)):
        Tc = pl[(cy0[:, None] + ar9)[:, :, None],
                (cx0[:, None] + ar9)[:, None, :]]
        t8 = Tc[:, 0, 1:9]
        l8 = Tc[:, 1:9, 0]
        cc = Tc[:, 0, 0]
        outc = clip(intra_chroma_modes(l8, t8, cc, mb_avail, cmode, xp)
                    + res_c[:, ci])
        outs.append(outc)
    scy = xp.where(is_intra, cy0 + 1, BIG)
    icy = (scy[:, None] + ar8)[:, :, None]
    icx = ((cx0 + 1)[:, None] + ar8)[:, None, :]
    cb = cb.at[icy, icx].set(outs[0], mode="drop")
    cr = cr.at[icy, icx].set(outs[1], mode="drop")
    return (y, cb, cr), None


# =====================================================================
# deblocking wavefront (same diagonal order; raster-exact)
# =====================================================================


def _clip3(x, lo, hi, xp):
    return xp.minimum(xp.maximum(x, lo), hi)


def _filter_lines_luma(cols, s, alpha, beta, tc0, xp):
    """cols [L,K,8] (q3 q2 q1 q0 | p0 p1 p2 p3), s [L,K] strength,
    alpha/beta [L,1] values, tc0 [L,K]. Returns updated cols."""
    q3, q2, q1, q0 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    p0, p1, p2, p3 = cols[..., 4], cols[..., 5], cols[..., 6], cols[..., 7]
    m = ((xp.abs(q1 - q0) < beta) & (xp.abs(q0 - p0) < alpha)
         & (xp.abs(p0 - p1) < beta) & (s > 0))
    m4 = m & (s == 4)
    mn = m & (s < 4)
    # strong (bs4)
    cond = xp.abs(q0 - p0) < ((alpha >> 2) + 2)
    m4s = m4 & cond
    m4w = m4 & ~cond
    aq_s = xp.abs(q0 - q2) < beta
    ap_s = xp.abs(p0 - p2) < beta
    tq = q0 + q1 + p0 + 2
    tp = p0 + p1 + q0 + 2
    q0_s = xp.where(aq_s, (tq * 2 + p1 + q2) >> 3, (q1 * 2 + q0 + p1 + 2) >> 2)
    q1_s = (tq + q2) >> 2
    q2_s = (q3 * 2 + q2 * 3 + tq + 2) >> 3
    p0_s = xp.where(ap_s, (tp * 2 + q1 + p2) >> 3, (p1 * 2 + p0 + q1 + 2) >> 2)
    p1_s = (tp + p2) >> 2
    p2_s = (p3 * 2 + p2 * 3 + tp + 2) >> 3
    tw = q1 + p1 + 2
    q0_w = (q1 + q0 + tw) >> 2
    p0_w = (p1 + p0 + tw) >> 2
    # normal (1..3)
    aq = xp.abs(q2 - q0) < beta
    ap = xp.abs(p2 - p0) < beta
    half = (p0 + q0 + 1) >> 1
    dq1 = _clip3((q2 + half - q1 * 2) >> 1, -tc0, tc0, xp)
    dp1 = _clip3((p2 + half - p1 * 2) >> 1, -tc0, tc0, xp)
    q1_n = xp.where(mn & (tc0 > 0) & aq, q1 + dq1, q1)
    p1_n = xp.where(mn & (tc0 > 0) & ap, p1 + dp1, p1)
    tc = tc0 + aq.astype(xp.int32) + ap.astype(xp.int32)
    delta = _clip3(((p0 - q0) * 4 + q1 - p1 + 4) >> 3, -tc, tc, xp)
    mdelta = mn & (tc > 0)
    q0_n = xp.clip(xp.where(mdelta, q0 + delta, q0), 0, 255)
    p0_n = xp.clip(xp.where(mdelta, p0 - delta, p0), 0, 255)
    # combine
    nq2 = xp.where(m4s & aq_s, q2_s, q2)
    nq1 = xp.where(m4s & aq_s, q1_s, xp.where(mn, q1_n, q1))
    nq0 = xp.where(m4s, q0_s, xp.where(m4w, q0_w, xp.where(mn, q0_n, q0)))
    np2 = xp.where(m4s & ap_s, p2_s, p2)
    np1 = xp.where(m4s & ap_s, p1_s, xp.where(mn, p1_n, p1))
    np0 = xp.where(m4s, p0_s, xp.where(m4w, p0_w, xp.where(mn, p0_n, p0)))
    def cl(v):
        return xp.clip(v, 0, 255)
    return xp.stack([q3, cl(nq2), cl(nq1), cl(nq0), cl(np0), cl(np1),
                     cl(np2), p3], axis=-1)


def _filter_lines_chroma(cols, s, alpha, beta, tc0, xp):
    """cols [L,K,4] (q1 q0 | p0 p1)."""
    q1, q0, p0, p1 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    m = ((xp.abs(q1 - q0) < beta) & (xp.abs(q0 - p0) < alpha)
         & (xp.abs(p0 - p1) < beta) & (s > 0))
    m4 = m & (s == 4)
    mn = m & (s < 4)
    t = q1 + p1 + 2
    q0_4 = (q1 + q0 + t) >> 2
    p0_4 = (p1 + p0 + t) >> 2
    tc = tc0 + 1
    delta = _clip3(((p0 - q0) * 4 + q1 - p1 + 4) >> 3, -tc, tc, xp)
    q0_n = q0 + delta
    p0_n = p0 - delta
    def cl(v):
        return xp.clip(v, 0, 255)
    nq0 = xp.where(m4, q0_4, xp.where(mn, q0_n, q0))
    np0 = xp.where(m4, p0_4, xp.where(mn, p0_n, p0))
    return xp.stack([q1, cl(nq0), cl(np0), p1], axis=-1)


def _edge_params(stbyte, str4, ab, nlines, shift, alpha_t, beta_t, tc0_t, xp):
    """Per-line strength + alpha/beta/tc0 lookups for one edge.

    stbyte/str4 [L]; ab [L,2] alpha/beta indices (may be negative = off).
    Returns s [L,K], alpha [L,1], beta [L,1], tc0 [L,K]."""
    k = _iota1(xp, nlines)
    j = k >> shift
    s = (stbyte[:, None] >> (2 * j)[None, :]) & 3
    s = xp.where((str4 > 0)[:, None], 4, s)
    aidx = ab[:, 0]
    on = aidx >= 0
    s = xp.where(on[:, None], s, 0)
    ai = xp.clip(aidx, -16, 35) + 16
    bi = xp.clip(ab[:, 1], -16, 35) + 16
    # gather-free table lookups (one-hot over the 52-entry tables)
    r52 = _iota1(xp, 52, dtype=ai.dtype)[None]
    oha = (ai[:, None] == r52).astype(xp.int32)
    ohb = (bi[:, None] == r52).astype(xp.int32)
    alpha = (oha * alpha_t[None]).sum(axis=1)[:, None]
    beta = (ohb * beta_t[None]).sum(axis=1)[:, None]
    t3 = (oha[:, None, :] * tc0_t[None]).sum(axis=2)   # [L,3]
    tc0 = xp.where(s <= 1, t3[:, 0:1],
          xp.where(s == 2, t3[:, 1:2], t3[:, 2:3]))
    return s, alpha, beta, tc0


def _deblock_step(carry, lanes, P, mb_w, xp, tabs):
    y, cb, cr = carry
    alpha_t, beta_t, tc0_t = tabs
    lane_idx = lanes[0]
    valid = lane_idx >= 0
    mbs = xp.maximum(lane_idx, 0)
    y0 = xp.maximum(lanes[3], 0)   # deblock-pad luma row (stackable)
    cy0 = xp.maximum(lanes[4], 0)
    x0 = (mbs % mb_w) * 16
    ar20 = xp.arange(20)
    ar12 = xp.arange(12)
    Wy = y[(y0[:, None] + ar20)[:, :, None],
           (x0[:, None] + ar20)[:, None, :]]  # [L,20,20]
    Wcb = cb[(cy0[:, None] + ar12)[:, :, None],
             ((x0 >> 1)[:, None] + ar12)[:, None, :]]
    Wcr = cr[(cy0[:, None] + ar12)[:, :, None],
             ((x0 >> 1)[:, None] + ar12)[:, None, :]]

    dstr = P["deb_str"][mbs]    # [L,2,4]
    dab = P["deb_ab"][mbs]      # [L,2,6,2]
    d4 = P["deb_str4"][mbs]     # [L,2]

    for axis in (0, 1):  # 0 = vertical edges, 1 = horizontal edges
        sb = dstr[:, axis]
        ab = dab[:, axis]
        zero = xp.zeros_like(d4[:, axis])
        for e in range(4):
            abe = ab[:, 0] if e == 0 else ab[:, 3]
            str4 = d4[:, axis] if e == 0 else zero
            s, al, be, tc0 = _edge_params(sb[:, e], str4, abe, 16, 2,
                                          alpha_t, beta_t, tc0_t, xp)
            c0 = 4 * e
            if axis == 0:
                cols = Wy[:, 4:20, c0 : c0 + 8]
                Wy = Wy.at[:, 4:20, c0 : c0 + 8].set(
                    _filter_lines_luma(cols, s, al, be, tc0, xp))
            else:
                rows = xp.swapaxes(Wy[:, c0 : c0 + 8, 4:20], 1, 2)
                out = _filter_lines_luma(rows, s, al, be, tc0, xp)
                Wy = Wy.at[:, c0 : c0 + 8, 4:20].set(
                    xp.swapaxes(out, 1, 2))
            if e in (0, 2):
                abrow = 1 if e == 0 else 4
                str4c = d4[:, axis] if e == 0 else zero
                for ci in range(2):
                    Wc = Wcb if ci == 0 else Wcr
                    s, al, be, tc0 = _edge_params(
                        sb[:, e], str4c, ab[:, abrow + ci], 8, 1,
                        alpha_t, beta_t, tc0_t, xp)
                    cc0 = 2 + 4 * (e >> 1)  # cols cx-2..cx+1 / cx+2..cx+5
                    if axis == 0:
                        cols = Wc[:, 4:12, cc0 : cc0 + 4]
                        Wc = Wc.at[:, 4:12, cc0 : cc0 + 4].set(
                            _filter_lines_chroma(cols, s, al, be, tc0, xp))
                    else:
                        rows = xp.swapaxes(Wc[:, cc0 : cc0 + 4, 4:12], 1, 2)
                        out = _filter_lines_chroma(rows, s, al, be, tc0, xp)
                        Wc = Wc.at[:, cc0 : cc0 + 4, 4:12].set(
                            xp.swapaxes(out, 1, 2))
                    if ci == 0:
                        Wcb = Wc
                    else:
                        Wcr = Wc

    BIG = y.shape[0] + y.shape[1] + 64
    sy = xp.where(valid, y0, BIG)
    iy = (sy[:, None] + ar20)[:, :, None]
    ix = (x0[:, None] + ar20)[:, None, :]
    y = y.at[iy, ix].set(Wy, mode="drop")
    scy = xp.where(valid, cy0, BIG)
    icy = (scy[:, None] + ar12)[:, :, None]
    icx = ((x0 >> 1)[:, None] + ar12)[:, None, :]
    cb = cb.at[icy, icx].set(Wcb, mode="drop")
    cr = cr.at[icy, icx].set(Wcr, mode="drop")
    return (y, cb, cr), None


# =====================================================================
# driver: host packing + jitted whole-picture graph
# =====================================================================


def _assemble(mbs, blk, mb_w, mb_h, xp):
    return (mbs.reshape(mb_h, mb_w, blk, blk).transpose(0, 2, 1, 3)
            .reshape(mb_h * blk, mb_w * blk))


@functools.lru_cache(maxsize=16)
def _diag_lanes(mb_w, mb_h):
    """Wavefront lane table [n_diag, 5, L]: per diagonal d = mbx + 2*mby
    the lanes' (plan index, intra-pad luma row, intra-pad chroma row,
    deblock-pad luma row, deblock-pad chroma row), -1 padded.

    Carrying pixel rows explicitly (instead of deriving them from the
    plan index) lets independent streams stack vertically on one tall
    plane with per-stream row bases — the per-scan-step op overhead then
    amortizes across streams (_stack_diag_lanes)."""
    diags = {}
    for mby in range(mb_h):
        for mbx in range(mb_w):
            diags.setdefault(mbx + 2 * mby, []).append(mby * mb_w + mbx)
    D = max(diags) + 1
    L = max(len(v) for v in diags.values())
    out = np.full((D, 5, L), -1, np.int32)
    for d, v in diags.items():
        idx = np.asarray(v, np.int32)
        y = idx // mb_w
        out[d, 0, : len(v)] = idx
        out[d, 1, : len(v)] = y * 16
        out[d, 2, : len(v)] = y * 8
        out[d, 3, : len(v)] = y * 16
        out[d, 4, : len(v)] = y * 8
    return out


def _stack_diag_lanes(mb_w, mb_h, n_streams, H, W):
    """Lane table for n_streams geometrically identical pictures stacked
    on tall planes: stream s's plan indices offset by s*n, its intra-pad
    rows by s*(1+H) (luma) / s*(1+H/2) (chroma), its deblock-pad rows by
    s*(4+H) / s*(4+H/2). Every stream runs its local diagonal d in the
    same scan step."""
    base = _diag_lanes(mb_w, mb_h)
    D, _, L = base.shape
    n = mb_w * mb_h
    out = np.full((D, 5, L * n_streams), -1, np.int32)
    offs = (n, 1 + H, 1 + (H >> 1), 4 + H, 4 + (H >> 1))
    for s in range(n_streams):
        seg = base.copy()
        for row, off in enumerate(offs):
            v = seg[:, row]
            seg[:, row] = np.where(v >= 0, v + s * off, -1)
        out[:, :, s * L : (s + 1) * L] = seg
    return out


def _recon_core(P, refs_y, refs_cb, refs_cr, diag, pcm_y, pcm_cb,
                pcm_cr, *, mb_w, mb_h, has_i8, has_pcm, deblock):
    """One picture's Phase-B graph; P = dict of plan tensors."""
    import jax
    import jax.numpy as jnp

    xp = jnp
    H, W = mb_h * 16, mb_w * 16
    Hc, Wc = H >> 1, W >> 1
    kind = P["kind"]
    res_y = residual_mb(P["coef_luma"], P["t8x8"], xp, has_i8=has_i8)
    res_c = residual_chroma(P["coef_chroma"], xp)
    P = dict(P)
    P["res_y"] = res_y
    P["res_c"] = res_c
    pred_y, pred_cb, pred_cr = inter_pass(
        P["mv"], P["slot"], P["wp"], refs_y, refs_cb, refs_cr, mb_w, mb_h,
        xp, used=P.get("mc_used"), bi_idx=P.get("mc_bi"),
        nu=P.get("mc_nu"), uni=P.get("mc_uni"), ubi=P.get("mc_ubi"))
    is_inter = (kind == 0)[:, None, None]
    inter_y = xp.where(is_inter, xp.clip(pred_y + res_y, 0, 255), 0)
    inter_cb = xp.where(is_inter, xp.clip(pred_cb + res_c[:, 0], 0, 255), 0)
    inter_cr = xp.where(is_inter, xp.clip(pred_cr + res_c[:, 1], 0, 255), 0)
    y_plane = _assemble(inter_y, 16, mb_w, mb_h, xp)
    cb_plane = _assemble(inter_cb, 8, mb_w, mb_h, xp)
    cr_plane = _assemble(inter_cr, 8, mb_w, mb_h, xp)
    if has_pcm:
        kind_mb = kind.reshape(mb_h, mb_w)
        kpix = xp.repeat(xp.repeat(kind_mb, 16, axis=0), 16, axis=1)
        y_plane = xp.where(kpix == 4, pcm_y.astype(xp.int32), y_plane)
        kpixc = xp.repeat(xp.repeat(kind_mb, 8, axis=0), 8, axis=1)
        cb_plane = xp.where(kpixc == 4, pcm_cb.astype(xp.int32), cb_plane)
        cr_plane = xp.where(kpixc == 4, pcm_cr.astype(xp.int32), cr_plane)

    # ---- intra + deblocking wavefronts on skewed planes ----
    from . import wavefront as WF

    g = WF.get_geom(mb_w, mb_h)
    ikeys = WF._INTRA_KEYS + (WF._I8_KEYS if has_i8 else ())
    Pd = WF.diag_gather(P, g, has_i8, deblock, xp)
    # skewed slab planes ride the scans as uint8 (values are clipped
    # pixels): quarter the per-step slab traffic; the step bodies
    # upcast their windows to int32 locally
    sky = WF.skew_luma(y_plane.astype(xp.uint8), g, xp)
    skcb = WF.skew_chroma(cb_plane.astype(xp.uint8), g, xp)
    skcr = WF.skew_chroma(cr_plane.astype(xp.uint8), g, xp)
    sky, skcb, skcr = WF.intra_scan(
        sky, skcb, skcr, {k: Pd[k] for k in ikeys}, g, has_i8, xp)
    if deblock:
        tabs = (xp.asarray(np.asarray(T.DEBLOCK_ALPHA, np.int32)),
                xp.asarray(np.asarray(T.DEBLOCK_BETA, np.int32)),
                xp.asarray(np.asarray(T.DEBLOCK_TC0, np.int32)))
        sky, skcb, skcr = WF.deblock_scan(
            sky, skcb, skcr, {k: Pd[k] for k in WF._DEB_KEYS}, g, xp,
            tabs)
    y_plane = WF.unskew_luma(sky, g, xp)
    cb_plane = WF.unskew_chroma(skcb, g, xp)
    cr_plane = WF.unskew_chroma(skcr, g, xp)

    return (y_plane.astype(xp.uint8), cb_plane.astype(xp.uint8),
            cr_plane.astype(xp.uint8))


_PLAN_KEYS = ("coef_luma", "coef_chroma", "t8x8", "kind", "i4_modes",
              "i4_avail", "i8_modes", "i8_avail", "i16_mode",
              "chroma_mode", "mb_avail", "mv", "slot", "wp", "deb_str",
              "deb_str4", "deb_ab")

#: wire dtypes for host->device plan transfer (upcast to int32 on
#: device). Values that can overflow the narrow type (coefficients,
#: weights, MVs in extreme streams) are range-checked at pack time with
#: an int32 fallback.
_WIRE_DTYPES = {
    "coef_luma": np.int16, "coef_chroma": np.int16, "t8x8": np.int8,
    "kind": np.int8, "i4_modes": np.int8, "i4_avail": np.int8,
    "i8_modes": np.int8, "i8_avail": np.int8, "i16_mode": np.int8,
    "chroma_mode": np.int8, "mb_avail": np.int8, "mv": np.int16,
    "slot": np.int8, "wp": np.int16, "deb_str": np.uint8,
    "deb_str4": np.int8, "deb_ab": np.int8,
}

_RANGE_CHECKED = ("coef_luma", "coef_chroma", "mv", "wp")

#: row shapes for palette-compressed fields: values repeat heavily
#: (one MV per partition, a handful of weight rows, few alpha/beta
#: combos), so ship a unique-row palette + small indices instead
_PALETTED = {"mv": (4, np.int16), "wp": (12, np.int16),
             "deb_ab": (24, np.int8)}


def _palette_pack(k, v):
    """v: narrowed array whose trailing dims flatten to the row size.
    Returns {"pal": [K, row], "idx": [...]} or None (too many rows)."""
    row, dt = _PALETTED[k]
    lead = v.shape[: v.ndim - _PAL_NDIM[k]]
    flat = np.ascontiguousarray(v).reshape(-1, row)
    voids = flat.view([("", "V%d" % (row * flat.dtype.itemsize))]).ravel()
    pal_v, inv = np.unique(voids, return_inverse=True)
    if len(pal_v) > 65535:
        return None
    pal = pal_v.view(flat.dtype).reshape(len(pal_v), row)
    idt = np.uint8 if len(pal_v) <= 255 else np.uint16
    return {"pal": pal, "idx": inv.astype(idt).reshape(lead)}


#: trailing dims folded into a palette row
_PAL_NDIM = {"mv": 2, "wp": 2, "deb_ab": 3}


def _pack_wire(stacked):
    """Narrow plan tensors for transfer; keep int32 where values
    overflow the wire dtype (rare, per-field fallback). Coefficient
    tensors additionally ship sparse (bitmap + packed nonzero values):
    conforming content is ~5-10% nonzero."""
    out = {}
    for k, v in stacked.items():
        dt = _WIRE_DTYPES[k]
        if k in _RANGE_CHECKED:
            info = np.iinfo(dt)
            if v.min() < info.min or v.max() > info.max:
                out[k] = v
                continue
        w = v.astype(dt)
        if k in _PALETTED:
            packed = _palette_pack(k, w)
            if packed is not None:
                out[k] = packed
                continue
        if k in ("coef_luma", "coef_chroma"):
            n = w.shape[0]
            flat = w.reshape(n, -1)
            mask = flat != 0
            counts = mask.sum(axis=1)
            cap = 1 << max(9, int(counts.max()).bit_length())
            bits = np.packbits(mask, axis=1)
            vals = np.zeros((n, cap), dt)
            for i in range(n):
                nz = flat[i][mask[i]]
                vals[i, : len(nz)] = nz
            out[k] = {"bits": bits, "vals": vals}
            continue
        out[k] = w
    return out


def _unpack_wire(stacked, xp, pals=None):
    if xp is not np:
        # scan-body callers slice the wire fields out of the carried
        # batch tensors — materialize those slices before the gathers
        # below (see _fuse_break)
        import jax

        stacked = jax.lax.optimization_barrier(stacked)
    out = {}
    for k, v in stacked.items():
        if isinstance(v, dict) and "idx" in v:
            pal = (pals[k] if pals else v["pal"]).astype(xp.int32)
            idx = v["idx"].astype(xp.int32)
            row, _ = _PALETTED[k]
            dense = pal[idx]  # [..., row]
            tail = {"mv": (2, 2), "wp": (3, 4), "deb_ab": (2, 6, 2)}[k]
            out[k] = dense.reshape(idx.shape + tail)
            continue
        if isinstance(v, dict):
            bits8 = v["bits"]
            lead = bits8.shape[:-1]
            shifts = xp.arange(7, -1, -1, dtype=xp.int32)
            bits = ((bits8[..., None].astype(xp.int32) >> shifts) & 1)
            bits = bits.reshape(lead + (-1,))
            idx = xp.cumsum(bits, axis=-1) - 1
            vals = v["vals"].astype(xp.int32)
            dense = xp.take_along_axis(
                vals, xp.clip(idx, 0, vals.shape[-1] - 1), axis=-1) * bits
            m = bits.shape[-1]
            shape = ((m // 256, 256) if k == "coef_luma"
                     else (m // 128, 2, 4, 16))
            out[k] = dense.reshape(lead + shape)
        else:
            out[k] = v.astype(xp.int32)
    if xp is not np:
        # gather outputs must not fuse into downstream consumers either
        # (consumer-side duplication is as explosive as producer-side)
        import jax

        out = jax.lax.optimization_barrier(out)
    return out


def _recon_picture(coef_luma, coef_chroma, t8x8, kind, i4m, i4a, i8m, i8a,
                   i16m, cmode, mb_avail, mv, slot, wp, deb_str, deb_str4,
                   deb_ab, refs_y, refs_cb, refs_cr, diag, pcm_y, pcm_cb,
                   pcm_cr, *, mb_w, mb_h, has_i8, has_pcm, deblock):
    P = {"coef_luma": coef_luma, "coef_chroma": coef_chroma, "t8x8": t8x8,
         "kind": kind, "i4_modes": i4m, "i4_avail": i4a, "i8_modes": i8m,
         "i8_avail": i8a, "i16_mode": i16m, "chroma_mode": cmode,
         "mb_avail": mb_avail, "mv": mv, "slot": slot, "wp": wp,
         "deb_str": deb_str, "deb_str4": deb_str4, "deb_ab": deb_ab}
    return _recon_core(P, refs_y, refs_cb, refs_cr, diag, pcm_y, pcm_cb,
                       pcm_cr, mb_w=mb_w, mb_h=mb_h, has_i8=has_i8,
                       has_pcm=has_pcm, deblock=deblock)


def _pcm_rows(plans, nmb):
    """Dense per-MB IPCM sample rows for a batch: [B, nmb, 384] uint8
    (256 luma raster + 64 cb + 64 cr, the native plan.pcm layout,
    h264parse.cpp mb_intrapcm). Zeros where no PCM MB."""
    rows = np.zeros((len(plans), nmb, 384), np.uint8)
    for b, p in enumerate(plans):
        for mbpos, (yb, cbb, crb) in p.pcm.items():
            rows[b, mbpos, :256] = yb.ravel()
            rows[b, mbpos, 256:320] = cbb.ravel()
            rows[b, mbpos, 320:] = crb.ravel()
    return rows


def _pcm_planes(rows, mb_w, mb_h, xp):
    """One picture's [nmb, 384] PCM rows -> (y, cb, cr) raster planes."""
    H, W = mb_h * 16, mb_w * 16
    y = rows[:, :256].reshape(mb_h, mb_w, 16, 16).transpose(
        0, 2, 1, 3).reshape(H, W)
    cb = rows[:, 256:320].reshape(mb_h, mb_w, 8, 8).transpose(
        0, 2, 1, 3).reshape(H >> 1, W >> 1)
    cr = rows[:, 320:384].reshape(mb_h, mb_w, 8, 8).transpose(
        0, 2, 1, 3).reshape(H >> 1, W >> 1)
    return y, cb, cr


def _pool_write(pool, v, idx, xp):
    """pool[idx] = v on the leading (slot) axis via masked select —
    see the executable-size note at the call site."""
    i = xp.arange(pool.shape[0], dtype=xp.int32)
    mask = (i == idx).reshape((pool.shape[0],) + (1,) * (pool.ndim - 1))
    return xp.where(mask, v[None].astype(pool.dtype), pool)


def _recon_batch(pool_y, pool_cb, pool_cr, stacked, pals, cur_idx, diag, *,
                 mb_w, mb_h, has_i8, deblock, extra=None, pcm=None):
    """Reconstruct a batch of pictures in one graph: lax.scan over
    pictures with the frame pool carried on device (the GOP-level
    batching that amortizes host<->device round trips).

    extra: optional (y, cb, cr) stacks of EXTERNAL reference pages
    (e.g. a neighbor shard's DPB pages fetched over a collective for
    open-GOP streams); plans address them as slots >= pool size.
    Pictures only ever write the local pool slots."""
    import jax
    import jax.numpy as jnp

    def step(pool, xs):
        py, pcb, pcr = pool
        if extra is not None:
            ry = jnp.concatenate([py, extra[0]])
            rcb = jnp.concatenate([pcb, extra[1]])
            rcr = jnp.concatenate([pcr, extra[2]])
        else:
            ry, rcb, rcr = py, pcb, pcr
        if pcm is not None:
            pcm_y, pcm_cb, pcm_cr = _pcm_planes(xs["pcm"], mb_w, mb_h,
                                                jnp)
        else:
            pcm_y = pcm_cb = pcm_cr = None
        y, cb, cr = _recon_core(
            _unpack_wire(xs["plan"], jnp, pals), ry, rcb, rcr, diag,
            pcm_y, pcm_cb, pcm_cr,
            mb_w=mb_w, mb_h=mb_h, has_i8=has_i8,
            has_pcm=pcm is not None, deblock=deblock)
        # materialize the planes before the pool write (_fuse_break),
        # then write via a masked select over the slot axis instead of
        # a dynamic_update_slice at a runtime index (chosen against the
        # original accelerator's executable size; A/B on the GPU is
        # ROADMAP D2)
        y, cb, cr = _fuse_break(y, cb, cr)
        idx = xs["cur_idx"]
        py = _pool_write(py, y, idx, jnp)
        pcb = _pool_write(pcb, cb, idx, jnp)
        pcr = _pool_write(pcr, cr, idx, jnp)
        return (py, pcb, pcr), (y, cb, cr)

    xs = {"plan": stacked, "cur_idx": cur_idx}
    if pcm is not None:
        xs["pcm"] = pcm
    pool, outs = jax.lax.scan(step, (pool_y, pool_cb, pool_cr), xs)
    return pool, outs


@functools.lru_cache(maxsize=8)
def _jitted_recon_batch(mb_w, mb_h, has_i8, deblock):
    import jax

    fn = functools.partial(_recon_batch, mb_w=mb_w, mb_h=mb_h,
                           has_i8=has_i8, deblock=deblock)
    return jax.jit(fn, donate_argnums=(0, 1, 2))


class _DevSlotMap:
    """Host-side compaction of frame-pool indices for the device pool.

    The host decoder's LRU deliberately wanders across its whole frame
    array (17+ slots at 1080p, reference pointer-rotation semantics,
    m2d_update_frames mpeg2.cpp:159-194 / find_empty_frame) while only
    ~(num_ref_frames + 1) frames are live at once. Device traffic for
    edge-pad, half-pel planes and the pool write scales with pool size,
    so plans' slot / cur_idx values are translated into a compact
    device slot space at dispatch time. A host index's device slot is
    recycled only once the frame can never be referenced again (it left
    ``plan.live`` — the pre-marking reference set plus current, a
    superset of every future plan's reference set)."""

    def __init__(self, cap):
        self.cap = cap
        self.map = {}

    def reset(self):
        self.map.clear()

    def translate(self, plan):
        """-> (tr, dev_cur): tr maps host idx -> dev slot (int32[64],
        unmapped = 0 — never read for unmapped hosts)."""
        slots = plan.used_slots()
        needed = set(slots) | {plan.cur_idx}
        live = set(getattr(plan, "live", None) or range(64))
        for h in needed:
            if h in self.map:
                continue
            used = set(self.map.values())
            free = [s for s in range(self.cap) if s not in used]
            if not free:
                victims = [k for k in self.map
                           if k not in live and k not in needed]
                if not victims:
                    raise RuntimeError(
                        f"device pool cap {self.cap} exceeded "
                        f"(live={sorted(live)})")
                del self.map[victims[0]]
                free = [s for s in range(self.cap)
                        if s not in set(self.map.values())]
            self.map[h] = free[0]
        tr = np.zeros(64, np.int32)
        for h, s in self.map.items():
            tr[h] = s
        return tr, self.map[plan.cur_idx]


#: 4x4 cell -> 8x8 quadrant within an MB (cell index = mb*16 + blk)
_CELL_QUAD = (np.array([((b >> 3) * 2 + ((b >> 1) & 1))
                        for b in range(16)], np.int32))


def _mv_keys(mv_field, pal, n):
    """[n,16,R] per-cell comparison keys + [n,2,2] dense cell-0 MVs."""
    if isinstance(mv_field, dict):
        idx = np.asarray(mv_field["idx"]).reshape(n, 16)
        dense0 = np.asarray(pal)[idx[:, 0]].reshape(n, 2, 2)
        return idx[:, :, None], dense0
    d = np.asarray(mv_field).reshape(n, 16, 4)
    return d, d[:, 0].reshape(n, 2, 2).astype(np.int32)


def _wp_keys(wp_field, n):
    """[n,4,R] per-quad comparison keys."""
    if isinstance(wp_field, dict):
        return np.asarray(wp_field["idx"]).reshape(n, 4)[:, :, None]
    return np.asarray(wp_field).reshape(n, 4, 12)


def _derive_mc_aux(slot_fields, pool_size, mv_fields, wp_fields,
                   pals_list, mb_w, mb_h, compact=None):
    """Host MC-compaction prep, run AFTER the device-slot remap.

    For each batch's [N, n, 4, 2] slot grid (mutated IN PLACE):
    * collects the compact used-slot list per picture and remaps the
      grid to 0..K-1 (the half-pel planes then cover K planes, not the
      whole pool);
    * partitions the picture's MC work for inter_pass's compacted path:
      `uni` — inter MBs whose 16 cells share slot/mv/wp (16x16
      partitions, P/B-skip, uniform direct) AND whose windows provably
      never hit the per-cell UMV clips: one 16x16 luma + one 9-row
      chroma fetch pair serves the whole MB;
      `nu` — the remaining inter cells (intra cells fetch nothing);
      `bi` — positions into `nu` needing the second prediction;
      `ubi` — positions into `uni` needing it.
    Shapes are pow2-bucketed across every batch in `slot_fields` so
    batches of one stream reuse executables. Returns a list of
    (used [N,K], bi [N,Bb], nu [N,Bn], uni [N,U], ubi [N,Ub]).

    compact=False derives only (used, bi-with-ABSOLUTE-cell-indices,
    None, None, None) for inter_pass's dense path. The default is dense
    on every backend: the compacted aux shapes (pow2 Bn/U/Ub buckets)
    multiply distinct executables per stream, and compact vs dense is
    not yet measured on the GPU (ROADMAP S4). Override with
    M2DEC_TPU_MC=compact|dense."""
    if compact is None:
        compact = os.environ.get("M2DEC_TPU_MC", "dense") != "dense"
    if not compact:
        cols2 = []
        for sf in slot_fields:
            useds, bis = [], []
            for b in range(sf.shape[0]):
                v = sf[b]
                used = np.unique(v[v >= 0]).astype(np.int32)
                if used.size == 0:
                    used = np.zeros(1, np.int32)
                remap = np.zeros(pool_size, np.int32)
                remap[used] = np.arange(len(used), dtype=np.int32)
                np.copyto(v, np.where(
                    v >= 0, remap[np.clip(v, 0, pool_size - 1)]
                    .astype(v.dtype), v))
                useds.append(used)
                both = (v[:, :, 0] >= 0) & (v[:, :, 1] >= 0)  # [n,4]
                cellboth = both[:, _CELL_QUAD].reshape(-1)
                bis.append(np.flatnonzero(cellboth).astype(np.int32))
            cols2.append((useds, bis))
        K = _next_pow2(max(len(u) for us, _ in cols2 for u in us))
        Bb = _next_pow2(max(1, max(len(x) for _, bs in cols2
                                   for x in bs)))
        out = []
        for sf, (useds, bis) in zip(slot_fields, cols2):
            N = sf.shape[0]
            B = sf.shape[1] * 16
            used_arr = np.zeros((N, K), np.int32)
            bi_arr = np.full((N, Bb), B, np.int32)
            for b in range(N):
                used_arr[b, : len(useds[b])] = useds[b]
                bi_arr[b, : len(bis[b])] = bis[b]
            out.append((used_arr, bi_arr, None, None, None))
        return out
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    mbi = np.arange(n, dtype=np.int32)
    x0 = (mbi % mb_w) * 16
    y0 = (mbi // mb_w) * 16
    cols = []
    for sf, mvf, wpf, pals in zip(slot_fields, mv_fields, wp_fields,
                                  pals_list):
        useds, bis, nus, unis, ubis = [], [], [], [], []
        for b in range(sf.shape[0]):
            v = sf[b]
            used = np.unique(v[v >= 0]).astype(np.int32)
            if used.size == 0:
                used = np.zeros(1, np.int32)
            remap = np.zeros(pool_size, np.int32)
            remap[used] = np.arange(len(used), dtype=np.int32)
            np.copyto(v, np.where(
                v >= 0, remap[np.clip(v, 0, pool_size - 1)]
                .astype(v.dtype), v))
            useds.append(used)

            quad_has = (v[:, :, 0] >= 0) | (v[:, :, 1] >= 0)  # [n,4]
            both_q = (v[:, :, 0] >= 0) & (v[:, :, 1] >= 0)
            is_inter = quad_has[:, 0]  # inter MBs predict all quads
            mvk, mv0 = _mv_keys(
                {k: a[b] for k, a in mvf.items()}
                if isinstance(mvf, dict) else mvf[b],
                pals.get("mv") if pals else None, n)
            wpk = _wp_keys(
                {k: a[b] for k, a in wpf.items()}
                if isinstance(wpf, dict) else wpf[b], n)
            uniform = ((v == v[:, :1, :]).all(axis=(1, 2))
                       & (mvk == mvk[:, :1]).all(axis=(1, 2))
                       & (wpk == wpk[:, :1]).all(axis=(1, 2))
                       & is_inter)
            # wide fetches need every per-cell clip to be a no-op
            s0 = v[:, 0, 0].astype(np.int32)
            p0mv = np.where((s0 >= 0)[:, None], mv0[:, 0], mv0[:, 1])

            def _ok(mv2, m=None):
                ty = y0 + (mv2[:, 1] >> 2)
                tx = x0 + (mv2[:, 0] >> 2)
                cy = (y0 >> 1) + (mv2[:, 1] >> 3)
                cx = (x0 >> 1) + (mv2[:, 0] >> 3)
                r = ((ty >= -9) & (ty <= H - 11)
                     & (tx >= -9) & (tx <= W - 11)
                     & (cy >= -3) & (cy <= (H >> 1) - 7)
                     & (cx >= -3) & (cx <= (W >> 1) - 7))
                return r if m is None else (r | ~m)

            uniform &= _ok(p0mv)
            uniform &= _ok(mv0[:, 1], both_q[:, 0])
            unis.append(np.flatnonzero(uniform).astype(np.int32))
            ubis.append(np.flatnonzero(
                both_q[uniform, 0]).astype(np.int32))
            cellmask = quad_has[:, _CELL_QUAD] & ~uniform[:, None]
            nu_b = np.flatnonzero(cellmask.reshape(-1)).astype(np.int32)
            nus.append(nu_b)
            cellboth = both_q[:, _CELL_QUAD].reshape(-1)
            bis.append(np.flatnonzero(cellboth[nu_b]).astype(np.int32))
        cols.append((useds, bis, nus, unis, ubis))
    K = _next_pow2(max(len(u) for c in cols for u in c[0]))
    Bb = _bucket_q(max(1, max(len(x) for c in cols for x in c[1])))
    Bn = _bucket_q(max(1, max(len(x) for c in cols for x in c[2])))
    U = _bucket_q(max(1, max(len(x) for c in cols for x in c[3])))
    Ub = _bucket_q(max(1, max(len(x) for c in cols for x in c[4])))
    out = []
    for sf, (useds, bis, nus, unis, ubis) in zip(slot_fields, cols):
        N = sf.shape[0]
        B = sf.shape[1] * 16
        used_arr = np.zeros((N, K), np.int32)
        bi_arr = np.full((N, Bb), Bn, np.int32)
        nu_arr = np.full((N, Bn), B, np.int32)
        uni_arr = np.full((N, U), sf.shape[1], np.int32)
        ubi_arr = np.full((N, Ub), U, np.int32)
        for b in range(N):
            used_arr[b, : len(useds[b])] = useds[b]
            bi_arr[b, : len(bis[b])] = bis[b]
            nu_arr[b, : len(nus[b])] = nus[b]
            uni_arr[b, : len(unis[b])] = unis[b]
            ubi_arr[b, : len(ubis[b])] = ubis[b]
        out.append((used_arr, bi_arr, nu_arr, uni_arr, ubi_arr))
    return out


def _remap_batch(slot_field, cur_idx, plans, smap):
    """Apply a _DevSlotMap to a batch IN PLACE: slot_field [B, n, 4, 2]
    (any int dtype, -1 preserved) and cur_idx [B] int32."""
    for b, p in enumerate(plans):
        tr, dev_cur = smap.translate(p)
        v = slot_field[b]
        np.copyto(v, np.where(v >= 0, tr[np.clip(v, 0, 63)]
                              .astype(v.dtype), v))
        cur_idx[b] = dev_cur


def dev_pool_size(num_ref_frames, host_pool):
    """Compact device pool size: refs + current + transition margin
    (an IDR's plan keeps the old refs live through its own picture)."""
    return min(host_pool, num_ref_frames + 3)


class BatchedPhaseB:
    """Device-resident frame pool + batched multi-picture Phase B.

    Feed plans in decode order; plans' host frame indexes are
    translated into the compact device slot space by _DevSlotMap."""

    def __init__(self, mb_w, mb_h, pool_size):
        import jax
        import jax.numpy as jnp

        self.mb_w, self.mb_h = mb_w, mb_h
        H, W = mb_h * 16, mb_w * 16

        # build the pool ON DEVICE (a jitted fill) instead of uploading
        # host zeros
        @jax.jit
        def _mk():
            return (jnp.zeros((pool_size, H, W), jnp.uint8),
                    jnp.zeros((pool_size, H >> 1, W >> 1), jnp.uint8),
                    jnp.zeros((pool_size, H >> 1, W >> 1), jnp.uint8))

        self.pool = _mk()
        self.diag = _diag_lanes(mb_w, mb_h)
        self.smap = _DevSlotMap(pool_size)

    def run_async(self, plans):
        """Dispatch a batch; returns device arrays (not materialized),
        letting host Phase A overlap with device Phase B."""
        has_pcm = any(p.pcm for p in plans)
        cur_idx = np.array([p.cur_idx for p in plans], np.int32)
        from .native_pack import pack_batches

        res = (pack_batches([plans])
               if all(p.coded is not None for p in plans) else None)
        if res is not None:
            blobs, layout, pals_list, has_i8, deblock = res
            blob, pals = blobs[0], pals_list[0]
        else:
            stacked = {k: np.stack([getattr(p, k) for p in plans])
                       for k in _PLAN_KEYS}
            has_i8 = bool(stacked["kind"].max() >= 2) or bool(
                ((stacked["t8x8"] != 0) & (stacked["kind"] == 0)).any())
            deblock = bool(stacked["deb_str"].any()
                           or stacked["deb_str4"].any())
            wire = _pack_wire(stacked)
            blob, layout, pals = _flatten_wire(wire)
        fn = _jitted_recon_blob(layout, self.mb_w, self.mb_h, has_i8,
                                deblock, has_pcm)
        fields = _wire_views(blob, layout)
        _remap_batch(fields["slot"], cur_idx, plans, self.smap)
        fields = dict(fields)
        (aux,) = _derive_mc_aux(
            [fields["slot"]], self.pool[0].shape[0], [fields["mv"]],
            [fields["wp"]], [pals], self.mb_w, self.mb_h)
        for k, a in zip(("mc_used", "mc_bi", "mc_nu", "mc_uni",
                         "mc_ubi"), aux):
            if a is not None:
                fields[k] = a
        args = (self.pool[0], self.pool[1], self.pool[2],
                fields, pals, cur_idx, self.diag)
        if has_pcm:
            args += (_pcm_rows(plans, self.mb_w * self.mb_h),)
        self.pool, outs = fn(*args)
        return outs

    @staticmethod
    def materialize(outs, n):
        ys, cbs, crs = (np.asarray(o) for o in outs)
        return [(ys[i], cbs[i], crs[i]) for i in range(n)]

    def run(self, plans):
        """Returns list of (y, cb, cr) numpy planes per plan."""
        outs = self.run_async(plans)
        return self.materialize(outs, len(plans))


@functools.lru_cache(maxsize=32)
def _jitted_recon(mb_w, mb_h, has_i8, has_pcm, deblock):
    import jax

    fn = functools.partial(_recon_picture, mb_w=mb_w, mb_h=mb_h,
                           has_i8=has_i8, has_pcm=has_pcm, deblock=deblock)
    return jax.jit(fn)


def _next_pow2(v):
    r = 1
    while r < v:
        r *= 2
    return r


def _bucket_q(v):
    """Eighth-pow2 capacity bucket: pow2 bucketing wastes up to 50% of
    every MC-compaction domain (measured 50k nu cells padded to 64k);
    rounding up to the next multiple of pow2(v)/8 caps the padding
    waste at ~12.5% while keeping the distinct-executable count
    bounded (<=8 buckets per octave)."""
    p = _next_pow2(max(1, v))
    if p <= 64:
        return p
    q = p // 8
    return ((v + q - 1) // q) * q


def reconstruct_plan_jax(plan, frames):
    """JAX Phase B: reconstruct plan into frames[plan.cur_idx] (host numpy
    pool, mirroring recon_ref.reconstruct_plan_np)."""
    slots = plan.used_slots()
    pool = len(frames)
    remap = np.full(pool + 1, 0, np.int32)
    R = _next_pow2(max(1, len(slots)))
    ry = np.zeros((R,) + frames[0].y.shape, np.uint8)
    rcb = np.zeros((R,) + frames[0].cb.shape, np.uint8)
    rcr = np.zeros((R,) + frames[0].cr.shape, np.uint8)
    for i, s in enumerate(slots):
        remap[s] = i
        ry[i] = frames[s].y
        rcb[i] = frames[s].cb
        rcr[i] = frames[s].cr
    slot_r = np.where(plan.slot >= 0, remap[np.clip(plan.slot, 0, pool)],
                      -1).astype(np.int32)
    diag = _diag_lanes(plan.mb_w, plan.mb_h)
    has_pcm = bool(plan.pcm)
    H, W = plan.mb_h * 16, plan.mb_w * 16
    if has_pcm:
        pcm_y = np.zeros((H, W), np.uint8)
        pcm_cb = np.zeros((H >> 1, W >> 1), np.uint8)
        pcm_cr = np.zeros((H >> 1, W >> 1), np.uint8)
        for mbpos, (yb, cbb, crb) in plan.pcm.items():
            yy, xx = (mbpos // plan.mb_w) * 16, (mbpos % plan.mb_w) * 16
            pcm_y[yy : yy + 16, xx : xx + 16] = yb
            pcm_cb[yy >> 1 : (yy >> 1) + 8, xx >> 1 : (xx >> 1) + 8] = cbb
            pcm_cr[yy >> 1 : (yy >> 1) + 8, xx >> 1 : (xx >> 1) + 8] = crb
    else:
        pcm_y = pcm_cb = pcm_cr = np.zeros((1, 1), np.uint8)
    has_i8 = bool((plan.kind == 2).any() or
                  ((plan.t8x8 != 0) & (plan.kind == 0)).any())
    deblock = bool(plan.deb_str.any() or plan.deb_str4.any())
    fn = _jitted_recon(plan.mb_w, plan.mb_h, has_i8, has_pcm, deblock)
    y, cb, cr = fn(plan.coef_luma, plan.coef_chroma, plan.t8x8, plan.kind,
                   plan.i4_modes, plan.i4_avail, plan.i8_modes,
                   plan.i8_avail, plan.i16_mode, plan.chroma_mode,
                   plan.mb_avail, plan.mv, slot_r, plan.wp, plan.deb_str,
                   plan.deb_str4, plan.deb_ab, ry, rcb, rcr, diag,
                   pcm_y, pcm_cb, pcm_cr)
    f = frames[plan.cur_idx]
    f.y[:] = np.asarray(y)
    f.cb[:] = np.asarray(cb)
    f.cr[:] = np.asarray(cr)


@functools.lru_cache(maxsize=4)
def get_batched_phase_b(mb_w, mb_h, pool_size):
    """Process-wide BatchedPhaseB per geometry: device pool buffers and
    their (donated) allocations are reused across decode runs. Correct
    across runs: plan slot indices only ever reference pictures written
    earlier in the same run."""
    return BatchedPhaseB(mb_w, mb_h, pool_size)


# ---------------------------------------------------------------------
# wire transport: the packer coalesces all fields into one host blob
# (one contiguous buffer to fill), but the DEVICE receives typed
# per-field arrays. Slicing/bitcasting a raw uint8 blob inside the
# graph fuses byte-granular relayout ops into every consumer and
# bloated the executable on the original accelerator; typed field
# arguments keep the graph independent of batch length.
# ---------------------------------------------------------------------


def _flatten_wire(wire):
    """-> (blob uint8[1-D], layout tuple, pals dict).

    layout entries: (path, dtype-name, shape, offset, nbytes); paths are
    ("k",) or ("k", "bits"/"vals"/"idx")."""
    leaves = []
    pals = {}
    for k in sorted(wire):
        v = wire[k]
        if isinstance(v, dict):
            if "pal" in v:
                pals[k] = v["pal"]
            for sub in sorted(v):
                if sub == "pal":
                    continue
                leaves.append(((k, sub), v[sub]))
        else:
            leaves.append(((k,), v))
    layout = []
    total = 0
    for path, a in leaves:
        a = np.ascontiguousarray(a)
        nb = a.nbytes
        layout.append((path, a.dtype.name, a.shape, total, nb))
        total += (nb + 7) & ~7  # 8-byte aligned fields
    blob = np.empty(total, np.uint8)
    for (path, _, _, off, nb), (_, a) in zip(layout, leaves):
        blob[off : off + nb] = np.ascontiguousarray(a).view(np.uint8).ravel()
    return blob, tuple(layout), pals


def _wire_views(blob, layout):
    """HOST-side split of a wire blob into typed numpy field views
    (zero-copy; each field is 8-byte aligned in the blob). These views
    are what gets passed to the jitted graph — never the raw blob."""
    out = {}
    for path, dtname, shape, off, nb in layout:
        dt = np.dtype(dtname)
        arr = blob[off : off + nb].view(dt).reshape(shape)
        if len(path) == 1:
            out[path[0]] = arr
        else:
            out.setdefault(path[0], {})[path[1]] = arr
    return out


def _recon_batch_fields(pool_y, pool_cb, pool_cr, fields, pals, cur_idx,
                        diag, *, mb_w, mb_h, has_i8, deblock, pcm=None):
    return _recon_batch(pool_y, pool_cb, pool_cr, fields, pals, cur_idx,
                        diag, mb_w=mb_w, mb_h=mb_h, has_i8=has_i8,
                        deblock=deblock, pcm=pcm)


def _recon_batch_stacked_blob(pool_y, pool_cb, pool_cr, stacked, pals,
                              cur_idx, diag, *, n_streams, mb_w,
                              mb_h, has_i8, deblock, pcm=None):
    """Multi-stream batched Phase B with the wavefront scans STACKED on
    tall planes: each scan step runs every stream's same-numbered
    diagonal in one set of ops, so the fixed per-step op overhead is
    paid once per step instead of once per stream.

    pool_* [S, R, H, W]; stacked [S] typed wire-field dicts (identical
    shapes); pals [S] palette dicts; cur_idx [n_pics, S]; diag from
    _stack_diag_lanes. Streams must share geometry."""
    import jax
    import jax.numpy as jnp

    from . import wavefront as WF

    S = n_streams
    H, W = mb_h * 16, mb_w * 16
    g = WF.get_geom(mb_w, mb_h)
    HskY = H + WF.MT + WF.MB_
    HskC = (H >> 1) + WF.MTC + WF.MBC
    stream_offs = tuple((s * HskY, s * HskC) for s in range(S))
    tabs = (jnp.asarray(np.asarray(T.DEBLOCK_ALPHA, np.int32)),
            jnp.asarray(np.asarray(T.DEBLOCK_BETA, np.int32)),
            jnp.asarray(np.asarray(T.DEBLOCK_TC0, np.int32)))
    # `stacked` arrives as typed per-field host arrays (see _wire_views)

    def step(pool, xs):
        py, pcb, pcr = pool
        Pds, skys, skcbs, skcrs = [], [], [], []
        for s in range(S):
            P = _unpack_wire(xs["plan"][s], jnp, pals[s])
            P["res_y"] = residual_mb(P["coef_luma"], P["t8x8"], jnp,
                                     has_i8=has_i8)
            P["res_c"] = residual_chroma(P["coef_chroma"], jnp)
            pred_y, pred_cb, pred_cr = inter_pass(
                P["mv"], P["slot"], P["wp"], py[s], pcb[s], pcr[s],
                mb_w, mb_h, jnp, used=P.get("mc_used"),
                bi_idx=P.get("mc_bi"), nu=P.get("mc_nu"),
                uni=P.get("mc_uni"), ubi=P.get("mc_ubi"))
            is_inter = (P["kind"] == 0)[:, None, None]
            iy = jnp.where(is_inter,
                           jnp.clip(pred_y + P["res_y"], 0, 255), 0)
            icb = jnp.where(is_inter,
                            jnp.clip(pred_cb + P["res_c"][:, 0], 0, 255),
                            0)
            icr = jnp.where(is_inter,
                            jnp.clip(pred_cr + P["res_c"][:, 1], 0, 255),
                            0)
            ypl = _assemble(iy, 16, mb_w, mb_h, jnp)
            cbpl = _assemble(icb, 8, mb_w, mb_h, jnp)
            crpl = _assemble(icr, 8, mb_w, mb_h, jnp)
            if pcm is not None:
                pcy, pccb, pccr = _pcm_planes(xs["pcm"][s], mb_w, mb_h,
                                              jnp)
                kind_mb = P["kind"].reshape(mb_h, mb_w)
                kpix = jnp.repeat(jnp.repeat(kind_mb, 16, 0), 16, 1)
                kpixc = jnp.repeat(jnp.repeat(kind_mb, 8, 0), 8, 1)
                ypl = jnp.where(kpix == 4, pcy.astype(jnp.int32), ypl)
                cbpl = jnp.where(kpixc == 4, pccb.astype(jnp.int32),
                                 cbpl)
                crpl = jnp.where(kpixc == 4, pccr.astype(jnp.int32),
                                 crpl)
            skys.append(WF.skew_luma(ypl.astype(jnp.uint8), g, jnp))
            skcbs.append(WF.skew_chroma(cbpl.astype(jnp.uint8), g,
                                        jnp))
            skcrs.append(WF.skew_chroma(crpl.astype(jnp.uint8), g,
                                        jnp))
            Pds.append(WF.diag_gather(P, g, has_i8, deblock, jnp))
        Pst = {k: jnp.concatenate([Pd[k] for Pd in Pds], axis=1)
               for k in Pds[0]}
        sky = jnp.concatenate(skys)
        skcb = jnp.concatenate(skcbs)
        skcr = jnp.concatenate(skcrs)

        ikeys = WF._INTRA_KEYS + (WF._I8_KEYS if has_i8 else ())
        sky, skcb, skcr = WF.intra_scan(
            sky, skcb, skcr, {k: Pst[k] for k in ikeys}, g, has_i8,
            jnp, stream_offs=stream_offs)
        if deblock:
            sky, skcb, skcr = WF.deblock_scan(
                sky, skcb, skcr, {k: Pst[k] for k in WF._DEB_KEYS}, g,
                jnp, tabs, stream_offs=stream_offs)
        ys = [WF.unskew_luma(sky[s * HskY : (s + 1) * HskY], g, jnp)
              for s in range(S)]
        cbs = [WF.unskew_chroma(skcb[s * HskC : (s + 1) * HskC], g, jnp)
               for s in range(S)]
        crs = [WF.unskew_chroma(skcr[s * HskC : (s + 1) * HskC], g, jnp)
               for s in range(S)]
        outs_y = jnp.stack([p.astype(jnp.uint8) for p in ys])
        outs_cb = jnp.stack([p.astype(jnp.uint8) for p in cbs])
        outs_cr = jnp.stack([p.astype(jnp.uint8) for p in crs])
        outs_y, outs_cb, outs_cr = _fuse_break(outs_y, outs_cb, outs_cr)
        for s in range(S):
            # static s + masked select over the slot axis (see the
            # pool-write note in _recon_batch)
            idx = xs["cur_idx"][s]
            py = py.at[s].set(_pool_write(py[s], outs_y[s], idx, jnp))
            pcb = pcb.at[s].set(_pool_write(pcb[s], outs_cb[s], idx, jnp))
            pcr = pcr.at[s].set(_pool_write(pcr[s], outs_cr[s], idx, jnp))
        return (py, pcb, pcr), (outs_y, outs_cb, outs_cr)

    xs = {"plan": stacked, "cur_idx": cur_idx}
    if pcm is not None:
        xs["pcm"] = pcm
    pool, outs = jax.lax.scan(step, (pool_y, pool_cb, pool_cr), xs)
    return pool, outs


@functools.lru_cache(maxsize=8)
def _jitted_recon_stacked(layout, n_streams, mb_w, mb_h, has_i8,
                          deblock, has_pcm=False):
    """layout is only the jit-cache key (field shapes/dtypes follow
    from it); the traced fn takes the typed field dicts directly."""
    import jax

    fn = functools.partial(_recon_batch_stacked_blob,
                           n_streams=n_streams, mb_w=mb_w, mb_h=mb_h,
                           has_i8=has_i8, deblock=deblock)
    if has_pcm:
        def fn_pcm(py, pcb, pcr, fields, pals, cur_idx, diag, pcm):
            return fn(py, pcb, pcr, fields, pals, cur_idx, diag, pcm=pcm)

        return jax.jit(fn_pcm, donate_argnums=(0, 1, 2))
    return jax.jit(fn, donate_argnums=(0, 1, 2))


@functools.lru_cache(maxsize=64)
def _jitted_recon_blob(layout, mb_w, mb_h, has_i8, deblock,
                       has_pcm=False):
    """layout is only the jit-cache key; the traced fn takes the typed
    field dict (see _wire_views) — never a raw uint8 blob."""
    import jax

    fn = functools.partial(_recon_batch_fields, mb_w=mb_w,
                           mb_h=mb_h, has_i8=has_i8, deblock=deblock)
    if has_pcm:
        # separate signature (extra pcm operand) so the common
        # PCM-free executable — and its persistent-cache entry —
        # stays byte-identical
        def fn_pcm(py, pcb, pcr, fields, pals, cur_idx, diag, pcm):
            return fn(py, pcb, pcr, fields, pals, cur_idx, diag, pcm=pcm)

        return jax.jit(fn_pcm, donate_argnums=(0, 1, 2))
    return jax.jit(fn, donate_argnums=(0, 1, 2))


# ---------------------------------------------------------------------
# multi-stream decode: one chip, N independent streams (GOP-per-stream
# data parallelism on a single device — the wavefront scan steps are
# latency-bound tiny-op chains, so widening every step by a stream axis
# raises throughput at nearly constant wall time)
# ---------------------------------------------------------------------


@functools.lru_cache(maxsize=2)
def _jitted_checksum():
    import jax
    import jax.numpy as jnp

    def one(a):
        flat = a.reshape(a.shape[0], -1).astype(jnp.int32)
        L = flat.shape[1]
        # weights are periodic mod 8191: fold into [C, 8191] chunks so
        # the weight vector stays an 8191-element constant — a flat
        # arange(L) % 8191 would constant-fold into a multi-hundred-MB
        # literal inside the executable
        C = -(-L // 8191)
        pad = C * 8191 - L
        fp = jnp.pad(flat, ((0, 0), (0, pad))).reshape(
            flat.shape[0], C, 8191)
        w = jnp.arange(1, 8192, dtype=jnp.int32)
        return jnp.stack([fp.sum(axis=(1, 2)),
                          (fp * w[None, None, :]).sum(axis=(1, 2))],
                         axis=-1)

    def cks(y, cb, cr):
        return jnp.stack([one(y), one(cb), one(cr)],
                         axis=1)  # [N, 3, 2] int32 (mod 2^32)

    return jax.jit(cks)


def host_checksum(y, cb, cr):
    """Host mirror of _jitted_checksum for one stream's frame stack."""
    out = np.zeros((3, 2), np.uint64)
    for i, a in enumerate((y, cb, cr)):
        flat = np.ascontiguousarray(a).reshape(-1).astype(np.uint64)
        w = (np.arange(flat.size, dtype=np.uint64) % 8191) + 1
        out[i, 0] = flat.sum() & 0xFFFFFFFF
        out[i, 1] = (flat * w % (1 << 32)).sum() & 0xFFFFFFFF
    return out.astype(np.int64).astype(np.uint32).view(np.int32)


class MultiStreamPhaseB:
    """N independent streams decoded concurrently on one chip: one
    whole-GOP Phase-B dispatch per stream against that stream's
    device-resident frame pool.

    Deliberately NOT a vmap: vmapping the wavefront scans turns their
    dynamic-slice/scatter steps into generalized batched gathers, which
    XLA serialized far behind the single-stream graph on the original
    accelerator. The streams' scans stack on tall planes (stacked=True)
    or queue as sequential async dispatches of the single-stream
    executable instead."""

    def __init__(self, n_streams, mb_w, mb_h, pool_size, stacked=True):
        import jax
        import jax.numpy as jnp

        self.n = n_streams
        self.mb_w, self.mb_h = mb_w, mb_h
        #: stacked=True runs the wavefront scans of all streams on tall
        #: concatenated planes (_recon_batch_stacked_blob) — one scan
        #: step per diagonal for the whole stream set
        self.stacked = stacked
        H, W = mb_h * 16, mb_w * 16

        if stacked:
            @jax.jit
            def _mk():
                return (jnp.zeros((n_streams, pool_size, H, W),
                                  jnp.uint8),
                        jnp.zeros((n_streams, pool_size, H >> 1, W >> 1),
                                  jnp.uint8),
                        jnp.zeros((n_streams, pool_size, H >> 1, W >> 1),
                                  jnp.uint8))

            self._mk = _mk
            self.pool = _mk()
            self.diag = _stack_diag_lanes(mb_w, mb_h, n_streams, H, W)
            self.smaps = [_DevSlotMap(pool_size) for _ in range(n_streams)]
        else:
            @jax.jit
            def _mk():
                return (jnp.zeros((pool_size, H, W), jnp.uint8),
                        jnp.zeros((pool_size, H >> 1, W >> 1),
                                  jnp.uint8),
                        jnp.zeros((pool_size, H >> 1, W >> 1),
                                  jnp.uint8))

            self._mk = _mk
            self.pools = [_mk() for _ in range(n_streams)]
            self.diag = _diag_lanes(mb_w, mb_h)
            self.smaps = [_DevSlotMap(pool_size) for _ in range(n_streams)]

    def reset(self):
        if self.stacked:
            self.pool = self._mk()
        else:
            self.pools = [self._mk() for _ in range(self.n)]
        for m in self.smaps:
            m.reset()

    def run(self, plans_per_stream):
        """plans_per_stream: list of N equal-length plan lists (wire
        layouts unified by the native packer; the Python fallback
        requires them identical). Returns a list of per-stream device
        outs (y, cb, cr) stacks."""
        curs = [np.array([p.cur_idx for p in plans], np.int32)
                for plans in plans_per_stream]
        from .native_pack import pack_batches

        res = (pack_batches(plans_per_stream)
               if all(p.coded is not None
                      for plans in plans_per_stream for p in plans)
               else None)
        if res is not None:
            blobs, layout0, pals_list, has_i8, deblock = res
        else:
            blobs = []
            layout0 = None
            st0 = None
            pals_list = []
            for plans in plans_per_stream:
                stacked = {k: np.stack([getattr(p, k) for p in plans])
                           for k in _PLAN_KEYS}
                if st0 is None:
                    st0 = stacked
                wire = _pack_wire(stacked)
                blob, layout, pl = _flatten_wire(wire)
                if layout0 is None:
                    layout0 = layout
                elif layout != layout0:
                    raise ValueError("stream wire layouts differ")
                blobs.append(blob)
                pals_list.append(pl)
            has_i8 = bool(st0["kind"].max() >= 2) or bool(
                ((st0["t8x8"] != 0) & (st0["kind"] == 0)).any())
            deblock = bool(st0["deb_str"].any() or st0["deb_str4"].any())
        has_pcm = any(p.pcm for plans in plans_per_stream
                      for p in plans)
        nmb = self.mb_w * self.mb_h
        fields = [dict(_wire_views(b, layout0)) for b in blobs]
        for s, plans in enumerate(plans_per_stream):
            _remap_batch(fields[s]["slot"], curs[s], plans,
                         self.smaps[s])
        pool_r = (self.pool[0].shape[1] if self.stacked
                  else self.pools[0][0].shape[0])
        auxs = _derive_mc_aux(
            [fd["slot"] for fd in fields], pool_r,
            [fd["mv"] for fd in fields], [fd["wp"] for fd in fields],
            pals_list, self.mb_w, self.mb_h)
        for f, aux in zip(fields, auxs):
            for k, a in zip(("mc_used", "mc_bi", "mc_nu", "mc_uni",
                             "mc_ubi"), aux):
                if a is not None:
                    f[k] = a
        if self.stacked:
            fn = _jitted_recon_stacked(layout0, self.n, self.mb_w,
                                       self.mb_h, has_i8, deblock,
                                       has_pcm)
            cur = np.stack(curs, axis=1)  # [n_pics, S]
            args = (self.pool[0], self.pool[1], self.pool[2], fields,
                    pals_list, cur, self.diag)
            if has_pcm:
                args += ([_pcm_rows(plans, nmb)
                          for plans in plans_per_stream],)
            self.pool, outs = fn(*args)
            return [(outs[0][:, s], outs[1][:, s], outs[2][:, s])
                    for s in range(self.n)]
        fn = _jitted_recon_blob(layout0, self.mb_w, self.mb_h, has_i8,
                                deblock, has_pcm)
        outs = []
        for i in range(len(plans_per_stream)):
            args = (self.pools[i][0], self.pools[i][1],
                    self.pools[i][2], fields[i], pals_list[i], curs[i],
                    self.diag)
            if has_pcm:
                args += (_pcm_rows(plans_per_stream[i], nmb),)
            self.pools[i], out = fn(*args)
            outs.append(out)
        return outs

    @staticmethod
    def checksums(outs):
        """Device-side per-stream checksums: forces execution while
        pulling only a few bytes (the bit-exactness bridge between the
        timed device-resident run and the verified materialized run)."""
        cks = _jitted_checksum()
        # leading axis 1: checksum each stream's whole picture stack as
        # one flat unit (host_checksum weight alignment)
        return np.stack([np.asarray(cks(o[0][None], o[1][None],
                                        o[2][None]))[0] for o in outs])
