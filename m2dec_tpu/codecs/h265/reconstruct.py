"""H.265 Phase-B reconstruction on the device: one fused jax.jit graph per
picture geometry.

Consumes the H265Plan tensors (codecs/h265/plan.py) plus the frame-pool
stacks and produces the reconstructed, deblocked, SAO-filtered picture
planes, bit-exact with the reference decoder (reference:
src/lib/h265.cpp — the Python decoder in this package is the scalar
executable spec this is verified against).

Device mapping (see plan.py for why each stage decouples):

* residual: batched inverse DCT/DST as two int matmuls with the
  reference's sat16<7>/sat16<12> stage saturations, all aligned s x s
  tiles of the coefficient plane per size class, variant-selected
  (dconly with the byte-lane wrap quirk / horiz-only / vert-only /
  full / transform-skip) — h265.cpp:1694-2185;
* inter: dense per-4x4-cell MC — 11x11 luma gathers + 8-tap separable
  FIR (all 16 frac phases as tap-table rows, the f0 phase folded in as
  a 64-weight tap so one 2-pass pipeline covers every case), chroma
  4-tap on *emulated packed-uint64 lanes* (two uint32 lanes with
  explicit carry/borrow) replicating interp_chroma's borrow-bias
  arithmetic bit-for-bit — h265.cpp:3386-3551;
* intra: lax.scan wavefront over CTU anti-diagonals d = cx + 2*cy,
  the z-ordered ops of each CTU stepped by an inner fori_loop, every
  lane (CTU on the diagonal) computed in parallel; each op evaluates
  planar/DC/H/V/angular on neighbour lines built with the reference's
  raw/filtered/strong pipelines expressed as index-clamped gathers +
  sliding FIRs (multipix_* in intra.py collapse to these forms);
* deblocking: whole-frame vertical pass then horizontal pass (the
  reference's (-4,-4)-window per-CTU order is exactly this schedule),
  strengths/thresholds from the plan's recorded edge maps;
* SAO: pure per-pixel map over the pre-SAO plane (band LUT / edge
  sign classes), per-CTU parameters broadcast.
"""

from __future__ import annotations

import functools

import numpy as np

from m2dec_tpu.codecs.h265 import residual as _RES
from m2dec_tpu.codecs.h265.intrapos_tables import COEF as _ACOEF
from m2dec_tpu.codecs.h265.intrapos_tables import POS as _APOS

# =====================================================================
# transform matrices (exact integer butterflies -> matrices)
# =====================================================================


def _mk_tmat(size_log2):
    size = 1 << size_log2
    line = _RES._LINE[size_log2]
    T = np.zeros((size, size), np.int32)
    for j in range(size):
        e = [0] * size
        e[j] = 1
        T[:, j] = line(e, 1, lambda v: v)
    return T


def _mk_dmat():
    T = np.zeros((4, 4), np.int32)
    for j in range(4):
        e = [0] * 4
        e[j] = 1
        T[:, j] = _RES._dst_line(e, 1, lambda v: v)
    return T


_TMAT = {2: _mk_tmat(2), 3: _mk_tmat(3), 4: _mk_tmat(4), 5: _mk_tmat(5)}
_DMAT = _mk_dmat()


def _sat16(v, xp):
    return xp.clip(v, -32768, 32767)


def _sat7(v, xp):
    return _sat16((v + 64) >> 7, xp)


def _sat12(v, xp):
    return _sat16((v + 2048) >> 12, xp)


def residual_plane(coef, tu, sizes, xp, with_dst):
    """coef [H,W] int, tu meta [H/4,W/4] -> residual [H,W] int32.

    Replicates transform/skip_transform variant selection
    (residual.py:314-377) on sanitized coefficient tiles."""
    H, W = coef.shape
    res = xp.zeros((H, W), xp.int32)
    coef = coef.astype(xp.int32)
    for s in sizes:
        if H % s or W % s:
            continue  # TU size exceeds the CTB (plane is CTB-aligned)
        sl2 = s.bit_length() - 1
        T = xp.asarray(_TMAT[sl2])
        N1, N2 = H // s, W // s
        tiles = coef.reshape(N1, s, N2, s).transpose(0, 2, 1, 3)
        meta = tu[:: s >> 2, :: s >> 2]
        present = (meta & 1) != 0
        match = present & (((meta >> 1) & 3) == sl2 - 2)
        variant = (meta >> 3) & 3
        # full 2-D: V = sat7(T @ C); out = sat12(V @ T^T)
        V = _sat7(xp.einsum("ky,abyx->abkx", T, tiles), xp)
        full = _sat12(xp.einsum("abyk,xk->abyx", V, T), xp)
        # dc-only with byte-lane wrap (m2d.h:307-326 semantics)
        c00 = tiles[:, :, 0, 0]
        adj = (c00 + 64) >> 7
        lane = xp.abs(adj) & 0xFF
        dcr = xp.where(adj < 0, -lane, lane)[:, :, None, None]
        dcr = xp.broadcast_to(dcr, tiles.shape)
        # horiz-only: pretruncated first row, one sat12 pass, rows equal
        pre = (tiles[:, :, 0, :] + 1) >> 1
        hrow = _sat12(xp.einsum("xk,abk->abx", T, pre), xp)
        hfull = xp.broadcast_to(hrow[:, :, None, :], tiles.shape)
        # vert-only: sat7 column pass then (v+32)>>6, cols equal
        vcol = _sat7(xp.einsum("yk,abk->aby", T, tiles[:, :, :, 0]), xp)
        vcol = (vcol + 32) >> 6
        vfull = xp.broadcast_to(vcol[:, :, :, None], tiles.shape)
        r = xp.where((variant == 0)[:, :, None, None], dcr,
            xp.where((variant == 1)[:, :, None, None], hfull,
            xp.where((variant == 2)[:, :, None, None], vfull, full)))
        if s == 4 and with_dst:
            D = xp.asarray(_DMAT)
            Vd = _sat7(xp.einsum("ky,abyx->abkx", D, tiles), xp)
            dfull = _sat12(xp.einsum("abyk,xk->abyx", Vd, D), xp)
            dst = ((meta >> 5) & 1) != 0
            r = xp.where(dst[:, :, None, None], dfull, r)
        if s == 4:
            tsk = ((meta >> 6) & 1) != 0
            r = xp.where(tsk[:, :, None, None], (tiles + 16) >> 5, r)
        r = xp.where(match[:, :, None, None], r, 0)
        res = res + r.transpose(0, 2, 1, 3).reshape(H, W)
    return res


# =====================================================================
# inter prediction: dense per-4x4-cell MC
# =====================================================================

#: 8-tap rows over offsets -3..+4 per quarter-pel phase (interp_luma
#: _fir1/_fir2/_fir3, h265.cpp:3193-3241; phase 0 = 64 at offset 0 so
#: the unified 2-pass pipeline scales every case to shift 12)
_LTAP = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)


def _luma_phase_planes(refs_used, xp):
    """Full-precision quarter-pel phase planes for the used ref slots:
    [K, 16, H+16, W+16] int32, plane (fy*4+fx) holding the 2-pass
    8-tap FIR value (scale 2^12, h265.cpp:3386-3474) at every integer
    base position in [-8, H+8) x [-8, W+8) over the EDGE-REPLICATED
    source.  Per-tap coordinate clamping (the executable-spec
    _luma_cell_mc) equals FIR on the edge-replicated extension, and
    the FIR is constant once its window is fully clamped, so clipping
    gather coordinates into the 8-pad domain is exact for arbitrary
    MVs.  The dense build costs ~200 MB*K of bandwidth; each cell then
    gathers 16 output pixels instead of 121 window elements — the
    gather unit is issue-rate-bound per element (the H.264 half-pel
    planes idea generalized to all 16 phases)."""
    K, H, W = refs_used.shape
    r = xp.pad(refs_used, ((0, 0), (12, 12), (12, 12)),
               mode="edge").astype(xp.int16)
    hv = []
    for fx in range(4):
        acc = None
        for j in range(8):
            t = int(_LTAP[fx, j])
            if t == 0:
                continue
            term = r[:, :, 1 + j : 1 + j + W + 16] * np.int16(t)
            acc = term if acc is None else acc + term
        hv.append(acc.astype(xp.int32))  # [K, H+24, W+16], |v| <= 22440
    planes = []
    for fy in range(4):
        for fx in range(4):
            acc = None
            for j in range(8):
                t = int(_LTAP[fy, j])
                if t == 0:
                    continue
                term = hv[fx][:, 1 + j : 1 + j + H + 16] * t
                acc = term if acc is None else acc + term
            planes.append(acc)
    return xp.stack(planes, 1)  # [K, 16, H+16, W+16]


def _luma_cell_mc_pp(planes, remap, slot, x0, y0, mvx, mvy, pic_w,
                     pic_h, xp):
    """Phase-plane twin of _luma_cell_mc: one 16-element gather per
    cell (exact — see _luma_phase_planes)."""
    xpos = x0 + (mvx >> 2)
    ypos = y0 + (mvy >> 2)
    ph = (mvy & 3) * 4 + (mvx & 3)
    s = remap[xp.clip(slot, 0, remap.shape[0] - 1)]
    ar4 = xp.arange(4)
    ys = xp.clip(ypos[:, None] + ar4[None, :] + 8, 0, pic_h + 15)
    xs_ = xp.clip(xpos[:, None] + ar4[None, :] + 8, 0, pic_w + 15)
    return planes[s[:, None, None], ph[:, None, None],
                  ys[:, :, None], xs_[:, None, :]]


def _luma_cell_mc(refs, slot, x0, y0, mvx, mvy, pic_w, pic_h, xp):
    """[B] cells -> [B,4,4] full-precision 2-pass FIR values (scale
    2^12; uni store = (v+2048)>>12 clip, bidir lane = v>>6)."""
    xpos = x0 + (mvx >> 2)
    ypos = y0 + (mvy >> 2)
    fx = mvx & 3
    fy = mvy & 3
    # window rows/cols: sample + (-3..+4) for 4 samples -> -3..+7 (11)
    ar11 = xp.arange(-3, 8)
    ys = xp.clip(ypos[:, None] + ar11[None, :], 0, pic_h - 1)
    xs = xp.clip(xpos[:, None] + ar11[None, :], 0, pic_w - 1)
    s = xp.clip(slot, 0, refs.shape[0] - 1)
    g = refs[s[:, None, None], ys[:, :, None], xs[:, None, :]]
    g = g.astype(xp.int32)  # [B,11,11]
    tapx = xp.asarray(_LTAP)[fx]  # [B,8]
    tapy = xp.asarray(_LTAP)[fy]
    # horizontal: hv[b, r, dx] = sum_j g[b, r, dx+j] * tapx[b, j]
    hv = xp.zeros(g.shape[:2] + (4,), xp.int32)
    for j in range(8):
        hv = hv + g[:, :, j : j + 4] * tapx[:, j, None, None]
    out = xp.zeros((g.shape[0], 4, 4), xp.int32)
    for j in range(8):
        out = out + hv[:, j : j + 4, :] * tapy[:, j, None, None]
    return out


_CTAP = np.array([
    (0, 64, 0, 0), (2, 58, 10, 2), (4, 54, 16, 2), (6, 46, 28, 4),
    (4, 36, 36, 4), (4, 28, 46, 6), (2, 16, 54, 4), (2, 10, 58, 2),
], np.int32)

_U32 = None  # set lazily per xp


def _chroma_cell_mc(refs_cb, refs_cr, slot, cx0, cy0, mvx, mvy, cw, ch,
                    xp):
    """[B] cells -> (cb, cr) [B,2,2] signed lane values before the
    store shift, replicating interp_chroma's packed-uint64 arithmetic
    (h265.cpp:3475-3551) with two uint32 lanes + explicit carries."""
    u32 = xp.uint32
    i32 = xp.int32
    cxpos = cx0 + (mvx >> 3)
    cypos = cy0 + (mvy >> 3)
    fx = mvx & 7
    fy = mvy & 7
    c = xp.asarray(_CTAP)[fx].astype(u32)  # [B,4]
    d = xp.asarray(_CTAP)[fy].astype(u32)
    bx = cxpos - 1
    by = cypos - 1
    ar5 = xp.arange(5)
    ys = xp.clip(by[:, None] + ar5[None, :], 0, ch - 1)
    xs = xp.clip(bx[:, None] + ar5[None, :], 0, cw - 1)
    s = xp.clip(slot, 0, refs_cb.shape[0] - 1)
    # ONE packed gather serves both components (the gather unit is
    # issue-rate-bound per ELEMENT; two byte gathers cost 2x)
    ilv = (refs_cb.astype(xp.uint16) << 8) | refs_cr.astype(xp.uint16)
    if xp is not np:
        from m2dec_tpu.codecs.h264.reconstruct import _fuse_break
        ilv = _fuse_break(ilv)
    g = ilv[s[:, None, None], ys[:, :, None], xs[:, None, :]]
    hi = (g >> 8).astype(u32)   # [B,5,5] cb lane
    lo = (g & 0xFF).astype(u32)  # cr lane
    bias = xp.asarray(np.uint32(0x80000000))
    lomask = xp.asarray(np.uint32(0x07FFFFFF))

    # pass 1: per row r (5), sample x (2): cols x..x+3
    def pack1(x):
        lo_a = (c[:, 1, None] * lo[:, :, x + 1]
                + c[:, 2, None] * lo[:, :, x + 2])
        hi_a = (c[:, 1, None] * hi[:, :, x + 1]
                + c[:, 2, None] * hi[:, :, x + 2])
        lo_b = (c[:, 0, None] * lo[:, :, x]
                + c[:, 3, None] * lo[:, :, x + 3])
        hi_b = (c[:, 0, None] * hi[:, :, x]
                + c[:, 3, None] * hi[:, :, x + 3])
        lo_r = (lo_a | bias) - lo_b  # no borrow possible
        hi_r = hi_a - hi_b  # mod 2^32
        return hi_r, lo_r & lomask  # [B,5]

    p1 = [pack1(x) for x in range(2)]
    h_hi = xp.stack([p1[0][0], p1[1][0]], axis=-1)  # [B,5,2]
    h_lo = xp.stack([p1[0][1], p1[1][1]], axis=-1)

    # pass 2: per output y (2): rows y..y+3; lo < 2^27, d < 128:
    # exact lo->hi carry via 16-bit split of the lo lane
    def mulsum(dk0, h0, dk1, h1):
        hi0, lo0 = h0
        hi1, lo1 = h1
        uu = dk0[:, None] * (lo0 >> 16) + dk1[:, None] * (lo1 >> 16)
        vv = dk0[:, None] * (lo0 & 0xFFFF) + dk1[:, None] * (lo1 & 0xFFFF)
        lo_s = (uu << 16) + vv  # mod 2^32
        carry = (uu + (vv >> 16)) >> 16
        hi_s = dk0[:, None] * hi0 + dk1[:, None] * hi1 + carry
        return hi_s, lo_s

    outs = []
    for y in range(2):
        hA, lA = mulsum(d[:, 1], (h_hi[:, y + 1], h_lo[:, y + 1]),
                        d[:, 2], (h_hi[:, y + 2], h_lo[:, y + 2]))
        hB, lB = mulsum(d[:, 0], (h_hi[:, y], h_lo[:, y]),
                        d[:, 3], (h_hi[:, y + 3], h_lo[:, y + 3]))
        lA = lA | bias
        borrow = (lA < lB).astype(u32)
        wv_lo = lA - lB
        wv_hi = hA - hB - borrow
        cb = wv_hi.astype(i32)
        cr = (wv_lo ^ bias).astype(i32)
        outs.append((cb, cr))
    cb = xp.stack([outs[0][0], outs[1][0]], axis=1)  # [B,2,2]
    cr = xp.stack([outs[0][1], outs[1][1]], axis=1)
    return cb, cr


def _clip255(v, xp):
    return xp.clip(v, 0, 255)


def inter_pass(slot, mv, pool_y, pool_cb, pool_cr, pic_w, pic_h, xp,
               mc_used=None, mc_remap=None):
    """Dense whole-picture MC from the plan's per-cell slot/mv tensors.

    Returns (mask_cell [ch,cw] bool, mc_y [H,W], mc_cb/[Hc,Wc], mc_cr)
    with mc values already store-rounded+clipped (store_pix semantics,
    h265.cpp:3161-3178).

    mc_used/mc_remap (host-derived per picture): the used ref slot
    list + slot->index remap — luma prediction then rides dense
    quarter-pel PHASE PLANES built for just those slots
    (_luma_phase_planes) instead of per-cell 11x11 window gathers."""
    ch, cw = slot.shape[:2]
    B = ch * cw
    cell = xp.arange(B, dtype=xp.int32)
    x0 = (cell % cw) * 4
    y0 = (cell // cw) * 4
    s0 = slot[:, :, 0].reshape(B).astype(xp.int32)
    s1 = slot[:, :, 1].reshape(B).astype(xp.int32)
    mvf = mv.reshape(B, 2, 2).astype(xp.int32)
    both = (s0 >= 0) & (s1 >= 0)
    p0s = xp.where(s0 >= 0, s0, s1)
    p0mv = xp.where((s0 >= 0)[:, None], mvf[:, 0], mvf[:, 1])
    p1s = xp.where(both, s1, p0s)
    p1mv = xp.where(both[:, None], mvf[:, 1], p0mv)

    planes = None
    if mc_used is not None:
        from m2dec_tpu.codecs.h264.reconstruct import _fuse_break
        refs_u = _fuse_break(pool_y[mc_used, :pic_h, :pic_w])
        planes = _fuse_break(_luma_phase_planes(refs_u, xp))

    def one(sl, mvv):
        if planes is not None:
            ly = _luma_cell_mc_pp(planes, mc_remap, sl, x0, y0,
                                  mvv[:, 0], mvv[:, 1], pic_w, pic_h,
                                  xp)
        else:
            ly = _luma_cell_mc(pool_y, sl, x0, y0, mvv[:, 0],
                               mvv[:, 1], pic_w, pic_h, xp)
        cb, cr = _chroma_cell_mc(pool_cb, pool_cr, sl, x0 >> 1, y0 >> 1,
                                 mvv[:, 0], mvv[:, 1], pic_w >> 1,
                                 pic_h >> 1, xp)
        return ly, cb, cr

    y_a, cb_a, cr_a = one(p0s, p0mv)
    y_b, cb_b, cr_b = one(p1s, p1mv)

    both3 = both[:, None, None]

    def store(a, b):
        uni = _clip255((a + 2048) >> 12, xp)
        bi = _clip255(((a >> 6) + (b >> 6) + 64) >> 7, xp)
        return xp.where(both3, bi, uni)

    out_y = store(y_a, y_b)        # [B,4,4]
    out_cb = store(cb_a, cb_b)     # [B,2,2]
    out_cr = store(cr_a, cr_b)
    mask = (s0 >= 0) | (s1 >= 0)
    H, W = ch * 4, cw * 4
    mc_y = out_y.reshape(ch, cw, 4, 4).transpose(0, 2, 1, 3).reshape(H, W)
    mc_cb = (out_cb.reshape(ch, cw, 2, 2).transpose(0, 2, 1, 3)
             .reshape(H >> 1, W >> 1))
    mc_cr = (out_cr.reshape(ch, cw, 2, 2).transpose(0, 2, 1, 3)
             .reshape(H >> 1, W >> 1))
    return mask.reshape(ch, cw), mc_y, mc_cb, mc_cr


# =====================================================================
# deblocking: whole-frame vertical-then-horizontal passes
# =====================================================================


def _clip3d(v, lim, xp):
    return xp.minimum(xp.maximum(v, -lim), lim)


def _deblock_luma_windows(win, s, beta, tc, xp):
    """win [..., 4, 8] (rows x p3 p2 p1 p0 q0 q1 q2 q3), recorded
    strength/beta/tc [...]. Port of deblocking_edge_luma_block
    (h265.cpp:4220-4299 / deblock.py:_edge_luma_block)."""
    s = s.astype(xp.int32)
    beta = beta.astype(xp.int32)
    tc = tc.astype(xp.int32)

    def g(r, c):
        return win[..., r, c]

    dp0 = xp.abs(g(0, 1) - 2 * g(0, 2) + g(0, 3))
    dq0 = xp.abs(g(0, 4) - 2 * g(0, 5) + g(0, 6))
    dp3 = xp.abs(g(3, 1) - 2 * g(3, 2) + g(3, 3))
    dq3 = xp.abs(g(3, 4) - 2 * g(3, 5) + g(3, 6))
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    act = (s > 0) & ((dpq0 + dpq3) < beta)

    def dsam(dpq, p3, p0, q0, q3):
        return ((dpq * 2) < (beta >> 2)) \
            & (xp.abs(p0 - q0) < ((5 * tc + 1) >> 1)) \
            & ((xp.abs(p3 - p0) + xp.abs(q0 - q3)) < (beta >> 3))

    strong = act & dsam(dpq0, g(0, 0), g(0, 3), g(0, 4), g(0, 7)) \
        & dsam(dpq3, g(3, 0), g(3, 3), g(3, 4), g(3, 7))
    weak = act & ~strong

    p3, p2, p1, p0 = (win[..., 0], win[..., 1], win[..., 2], win[..., 3])
    q0, q1, q2, q3 = (win[..., 4], win[..., 5], win[..., 6], win[..., 7])
    tc2 = (tc * 2)[..., None]
    # strong (all 4 rows, 6 samples, & 0xFF stores)
    sp2 = (p2 + _clip3d(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2,
                        tc2, xp)) & 0xFF
    sp1 = (p1 + _clip3d(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, tc2, xp)) \
        & 0xFF
    sp0 = (p0 + _clip3d(
        ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, tc2, xp)) \
        & 0xFF
    sq0 = (q0 + _clip3d(
        ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0, tc2, xp)) \
        & 0xFF
    sq1 = (q1 + _clip3d(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, tc2, xp)) \
        & 0xFF
    sq2 = (q2 + _clip3d(
        ((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3) - q2, tc2, xp)) & 0xFF
    # weak
    beta2 = (beta + (beta >> 1)) >> 3
    de_p = ((dp0 + dp3) < beta2)[..., None]
    de_q = ((dq0 + dq3) < beta2)[..., None]
    tcb = tc[..., None]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wrow = xp.abs(delta) < tcb * 10
    delta = _clip3d(delta, tcb, xp)
    wp0 = _clip255(p0 + delta, xp)
    wq0 = _clip255(q0 - delta, xp)
    wp1 = _clip255(p1 + _clip3d(
        ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1), tcb >> 1, xp), xp)
    wq1 = _clip255(q1 + _clip3d(
        ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1), tcb >> 1, xp), xp)

    sm = strong[..., None]
    wm = weak[..., None] & wrow
    np2_ = xp.where(sm, sp2, p2)
    np1_ = xp.where(sm, sp1, xp.where(wm & de_p, wp1, p1))
    np0_ = xp.where(sm, sp0, xp.where(wm, wp0, p0))
    nq0_ = xp.where(sm, sq0, xp.where(wm, wq0, q0))
    nq1_ = xp.where(sm, sq1, xp.where(wm & de_q, wq1, q1))
    nq2_ = xp.where(sm, sq2, q2)
    return xp.stack([p3, np2_, np1_, np0_, nq0_, nq1_, nq2_, q3], axis=-1)


def _deblock_chroma_windows(win, tc, xp):
    """win [..., 2, 4] (p1 p0 q0 q1), tc [...] (-1 = off)."""
    act = (tc >= 0)[..., None]
    tcb = tc.astype(xp.int32)[..., None]
    p1, p0 = win[..., 0], win[..., 1]
    q0, q1 = win[..., 2], win[..., 3]
    delta = _clip3d(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, tcb, xp)
    np0_ = xp.where(act, _clip255(p0 + delta, xp), p0)
    nq0_ = xp.where(act, _clip255(q0 - delta, xp), q0)
    return xp.stack([p1, np0_, nq0_, q1], axis=-1)


def _deblock_dir_luma(plane, dmap, xp):
    """One direction of luma deblocking on [H, W]: windows at columns
    8k+4 (vertical edges; call on the transposed plane + transposed
    map for horizontal)."""
    H, W = plane.shape
    K = W // 8 - 1
    if K <= 0:
        return plane
    body = plane[:, 4 : 4 + 8 * K]
    win = body.reshape(H // 4, 4, K, 8).transpose(0, 2, 1, 3)
    prm = dmap[: H // 4, :K].astype(xp.int32)
    out = _deblock_luma_windows(win, prm[..., 0], prm[..., 1],
                                prm[..., 2], xp)
    out = out.transpose(0, 2, 1, 3).reshape(H, 8 * K)
    if xp is np:
        plane = plane.copy()
        plane[:, 4 : 4 + 8 * K] = out
        return plane
    return plane.at[:, 4 : 4 + 8 * K].set(out)


def _deblock_dir_chroma(plane, cmap, xp):
    """One direction of chroma deblocking: 2x4 windows at columns
    8k+6 (chroma samples)."""
    Hc, Wc = plane.shape
    K = (Wc - 10) // 8 + 1
    if K <= 0:
        return plane
    body = plane[:, 6 : 6 + 8 * K]
    win = body.reshape(Hc // 2, 2, K, 8).transpose(0, 2, 1, 3)
    sub = win[..., :4]
    out4 = _deblock_chroma_windows(sub, cmap[: Hc // 2, :K].astype(
        xp.int32), xp)
    out = xp.concatenate([out4, win[..., 4:]], axis=-1)
    out = out.transpose(0, 2, 1, 3).reshape(Hc, 8 * K)
    if xp is np:
        plane = plane.copy()
        plane[:, 6 : 6 + 8 * K] = out
        return plane
    return plane.at[:, 6 : 6 + 8 * K].set(out)


def deblock_frame(y, cb, cr, dbv, dbh, dbcv, dbch, xp):
    y = _deblock_dir_luma(y, dbv, xp)
    y = _deblock_dir_luma(y.T, xp.swapaxes(dbh, 0, 1), xp).T
    cb = _deblock_dir_chroma(cb, dbcv[..., 0], xp)
    cb = _deblock_dir_chroma(cb.T, xp.swapaxes(dbch[..., 0], 0, 1), xp).T
    cr = _deblock_dir_chroma(cr, dbcv[..., 1], xp)
    cr = _deblock_dir_chroma(cr.T, xp.swapaxes(dbch[..., 1], 0, 1), xp).T
    return y, cb, cr


# =====================================================================
# SAO: pure per-pixel map over the pre-SAO plane
# =====================================================================

_EO_IDX_T = np.array(
    [-1, 2, 1, -1, 2, 3, -1, 2, 1, -1, 0, 1, -1, 2, 1, -1], np.int32)

#: (sign0 dy,dx), (sign2 dy,dx) per edge class (sao.py:_eo_block)
_EO_NBR = np.array([
    [[0, -1], [0, 1]],
    [[-1, 0], [1, 0]],
    [[-1, -1], [1, 1]],
    [[-1, 1], [1, -1]],
], np.int32)


def _signe(a, b, xp):
    return xp.where(a > b, 1, xp.where(a < b, 2, 0))


def _shift2d(plane, dy, dx, xp):
    """plane shifted so out[y,x] = plane[y+dy, x+dx] (edge-replicated;
    boundary pixels are masked out before use).  Static pad+slice —
    the previous clipped-index double gather cost two full-plane
    gather kernels per call on the element-rate-bound backend (x16
    calls per SAO pass, the dominant SAO cost — r5)."""
    H, W = plane.shape
    p = xp.pad(plane, ((1, 1), (1, 1)), mode="edge")
    return p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


def sao_plane(plane, idx_c, opt_c, off_c, csl2, pic_w, pic_h, xp):
    """One plane's SAO: idx/opt/off per CTU ([rows, cols], [rows,
    cols], [rows, cols, 4]); csl2 = CTU size log2 in this plane's
    sample units; pic_w/pic_h in this plane's units."""
    H, W = plane.shape
    s = 1 << csl2

    def up(m):
        return xp.repeat(xp.repeat(m, s, axis=0), s, axis=1)[:H, :W]

    idx = up(idx_c.astype(xp.int32))
    opt = up(opt_c.astype(xp.int32))
    offs = [up(off_c[:, :, k].astype(xp.int32)) for k in range(4)]

    def sel4(code):
        # value select instead of a full-plane take_along gather
        v = offs[0]
        for k in (1, 2, 3):
            v = xp.where(code == k, offs[k], v)
        return v

    yy = xp.arange(H, dtype=xp.int32)[:, None]
    xx = xp.arange(W, dtype=xp.int32)[None, :]
    inpic = (yy < pic_h) & (xx < pic_w)
    d = plane.astype(xp.int32)
    # band offset
    dif = d - (opt << 3)
    bmask = (idx == 1) & (0 <= dif) & (dif < 32) & inpic
    bval = sel4(xp.clip(dif >> 3, 0, 3))
    # edge offset
    nbr = xp.asarray(_EO_NBR)
    s0 = xp.zeros((H, W), xp.int32)
    s2 = xp.zeros((H, W), xp.int32)
    for cls in range(4):
        m = opt == cls
        n0 = _shift2d(d, int(_EO_NBR[cls, 0, 0]), int(_EO_NBR[cls, 0, 1]),
                      xp)
        n1 = _shift2d(d, int(_EO_NBR[cls, 1, 0]), int(_EO_NBR[cls, 1, 1]),
                      xp)
        s0 = xp.where(m, _signe(d, n0, xp), s0)
        s2 = xp.where(m, _signe(d, n1, xp), s2)
    del nbr
    # 16-entry class table as a select chain (a [H,W]-indexed table
    # lookup is a full-plane gather kernel)
    code = s2 * 4 + s0
    eidx = xp.full((H, W), -1, xp.int32)
    for v in range(16):
        t = int(_EO_IDX_T[v])
        if t != -1:
            eidx = xp.where(code == v, t, eidx)
    xtrim = (opt == 0) | (opt == 2) | (opt == 3)
    ytrim = (opt == 1) | (opt == 2) | (opt == 3)
    etrim = (~xtrim | ((1 <= xx) & (xx <= pic_w - 2))) \
        & (~ytrim | ((1 <= yy) & (yy <= pic_h - 2)))
    emask = (idx == 2) & (eidx >= 0) & etrim & inpic
    eval_ = sel4(xp.clip(eidx, 0, 3))
    out = xp.where(bmask, _clip255(d + bval, xp),
                   xp.where(emask, _clip255(d + eval_, xp), d))
    return out


# =====================================================================
# intra: angular host tables (derived from intrapos_tables exactly as
# intra_angular.py walks them)
# =====================================================================

_REFCAP = 66
_FILTER_THR = (56, 48, 48, 48, 48, 48, 48, 32, 0, 32, 48, 48, 48, 48,
               48, 48)


def _build_ang_tables():
    n_m = 33
    sel = np.full((n_m, 4, _REFCAP), 2, np.int32)  # 1 extra, 0 main, 2 pad
    pos = np.zeros((n_m, 4, _REFCAP), np.int32)
    fix_on = np.zeros((n_m, 4), np.int32)
    fix_idx = np.zeros((n_m, 4), np.int32)
    fix_pos = np.zeros((n_m, 4), np.int32)
    row_start = np.zeros((n_m, 4, 32), np.int32)
    coef_c1 = np.zeros((n_m, 32), np.int32)
    filt_kind = np.zeros((n_m, 4), np.int32)
    transp = np.zeros(n_m, np.int32)
    for m in range(n_m):
        coef, inc = _ACOEF[m]
        coef_c1[m] = coef
        transp[m] = int(m < 16 and (m & 7) != 0)
        for s in range(4):
            sl2 = s + 2
            pt = _APOS[m][s]
            el = pt[0]
            extras = pt[1 : 1 + el]
            bp = pt[1 + el]
            bl = pt[2 + el]
            assert all(p >= 0 for p in extras)
            for k in range(el):
                sel[m, s, k] = 1
                pos[m, s, k] = extras[k]
            for i in range(bl):
                sel[m, s, el + i] = 0
                pos[m, s, el + i] = bp + i
            if bp + bl == (2 << sl2):
                fix_on[m, s] = 1
                fix_idx[m, s] = el + bl - 1
                fix_pos[m, s] = bp + bl
            filt_kind[m, s] = int((_FILTER_THR[m & 15] & (1 << sl2)) != 0)
            src = inc[0] >> (3 - s)
            step = inc[1]
            for yy in range(1 << sl2):
                row_start[m, s, yy] = src
                if m & 7:
                    if 1 + yy < len(inc):
                        src += inc[1 + yy]
                else:
                    src += step
    return (sel, pos, fix_on, fix_idx, fix_pos, row_start, coef_c1,
            filt_kind, transp)


_ANG = _build_ang_tables()


def _build_ang_fused():
    """All per-(mode,size) angular tables fused into ONE [132, K] int32
    row table so the core does a single constant-table gather per op
    slot instead of nine (each gather is a separate kernel on the
    dispatch-bound backend).  Column layout (RC = _REFCAP):
    [0:RC) SEL | [RC:2RC) POSA | [2RC:2RC+32) ROWST |
    [2RC+32:2RC+64) COEFC1 | then FIXON, FIXIDX, FIXPOS, FILTK,
    TRANSP."""
    (SEL, POSA, FIXON, FIXIDX, FIXPOS, ROWST, COEFC1, FILTK,
     TRANSP) = _ANG
    RC = _REFCAP
    n = 33 * 4
    tbl = np.zeros((n, 2 * RC + 64 + 5), np.int32)
    fl = np.arange(n)
    mm = fl >> 2
    tbl[:, 0:RC] = SEL.reshape(n, RC)
    tbl[:, RC : 2 * RC] = POSA.reshape(n, RC)
    tbl[:, 2 * RC : 2 * RC + 32] = ROWST.reshape(n, 32)
    tbl[:, 2 * RC + 32 : 2 * RC + 64] = COEFC1[mm]
    base = 2 * RC + 64
    tbl[:, base + 0] = FIXON.reshape(n)
    tbl[:, base + 1] = FIXIDX.reshape(n)
    tbl[:, base + 2] = FIXPOS.reshape(n)
    tbl[:, base + 3] = FILTK.reshape(n)
    tbl[:, base + 4] = TRANSP[mm]
    return tbl


_ANG_FUSED = _build_ang_fused()


def _sel_at(arr, idx, xp):
    """arr[l, idx[l]] as a masked reduce (one fused kernel instead of a
    gather kernel); idx must be in-range."""
    iota = xp.arange(arr.shape[1])
    return xp.sum(arr * (iota[None, :] == idx[:, None]), axis=1)


# =====================================================================
# intra: per-op neighbour pipelines + mode families
# =====================================================================


def _side_arrays(RAW, omin, om, corner_param, NV, xp):
    """Dense raw/filtered/strong neighbour values at logical positions
    p = -1..NV-1 from an unclamped source vector RAW [L, NV+2]
    (RAW[:, i] = src[i-1]).  omin in {-1,0}, om = clamped offset_max.
    corner_param patches the filtered run's E[-2] (the reference's
    get_ref corner quirk, h265.cpp:2590).

    Gather-free: the index-clamped reads collapse to elementwise
    selects (below omin -> the value AT omin; above hi -> the value AT
    hi, one masked reduce) and the +/-1 shifted reads to edge-dup
    shifts of the clamped vector — bit-identical to take_along with
    clipped indices, at a fraction of the kernel count."""
    P = np.arange(-1, NV)  # NV+1 positions
    Pj = xp.asarray(P)
    hi = xp.maximum(om - 1, omin)
    lo_v = xp.where(omin == -1, RAW[:, 0], RAW[:, 1])  # value at omin
    hi_v = _sel_at(RAW, hi + 1, xp)                    # value at hi
    base = RAW[:, : NV + 1]                            # p = -1..NV-1
    rawc = xp.where(Pj[None, :] < omin[:, None], lo_v[:, None],
                    xp.where(Pj[None, :] > hi[:, None], hi_v[:, None],
                             base))
    # clamp_at(P-1): rawc shifted right one, edge-dup (clamping at both
    # ends makes the shifted-clamped read equal the clamped-shifted one)
    e_prev = xp.concatenate([rawc[:, :1], rawc[:, :-1]], axis=1)
    use_cp = (Pj[None, :] == -1) & (omin[:, None] == -1)
    e_prev = xp.where(use_cp, corner_param[:, None], e_prev)
    e_next = xp.concatenate([rawc[:, 1:], rawc[:, -1:]], axis=1)
    filt = (e_prev + 2 * rawc + e_next + 2) >> 2
    c0s = lo_v
    c1i = xp.minimum(63, hi) + 1
    c1s = _sel_at(RAW, c1i, xp)
    strong = ((63 - Pj[None, :]) * c0s[:, None]
              + (Pj[None, :] + 1) * c1s[:, None] + 32) >> 6
    return rawc, filt, strong


def _extra_vals(RAW, pos, omin, valid, kind, NV, xp):
    """Pointwise get_pix_{raw,filtered,strong} at extras positions
    (intra_angular.py:25-45); pos [L, K] >= 0; kind [L] 0/1/2.

    Gather-free: one onehot mask over RAW's index space serves the
    pos/pos-1/pos+1 reads (via edge-dup shifted copies of RAW — table
    positions satisfy pos+1 <= cap-1, so index arithmetic before/after
    the clip agrees); the per-lane scalar reads are masked reduces."""
    cap = RAW.shape[1] - 1
    iota = xp.arange(RAW.shape[1])
    M = iota[None, None, :] == xp.clip(pos + 1, 0, cap)[:, :, None]

    def msel(src):
        return xp.sum(src[:, None, :] * M, axis=2)

    RAW_m1 = xp.concatenate([RAW[:, :1], RAW[:, :-1]], axis=1)
    RAW_p1 = xp.concatenate([RAW[:, 1:], RAW[:, -1:]], axis=1)
    c1 = msel(RAW)
    prev = msel(RAW_m1)
    nxt = msel(RAW_p1)
    fir = (prev + 2 * c1 + nxt + 2) >> 2
    tail = (prev + 3 * c1 + 2) >> 2
    head = (3 * c1 + nxt + 2) >> 2
    filt = xp.where(pos <= omin[:, None], head,
                    xp.where(pos >= (valid - 1)[:, None], tail, fir))
    ridx = xp.clip(xp.clip(pos, omin[:, None],
                           xp.maximum(valid - 1, omin)[:, None]) + 1,
                   0, cap)
    Mr = iota[None, None, :] == ridx[:, :, None]
    raw = xp.sum(RAW[:, None, :] * Mr, axis=2)
    c0 = xp.where(omin == -1, RAW[:, 0], RAW[:, 1])[:, None]
    c1v = _sel_at(RAW, xp.clip(
        xp.minimum(63, xp.maximum(valid - 1, 0)) + 1, 0, cap), xp)
    strg = ((63 - pos) * c0 + (pos + 1) * c1v[:, None] + 32) >> 6
    return xp.where((kind == 0)[:, None], raw,
                    xp.where((kind == 1)[:, None], filt, strg))


def _intra_core(RAWL, RAWT, sl2, mode, vx, vy, S, is_luma, strong_en,
                consts, xp):
    """Mode math for one intra op across lanes, fetch-agnostic.

    RAWL/RAWT [L, NV+2] are the unclamped left/top source vectors
    (RAW[:, i] = src[i-1], NV = 2*S+2) — fetched by the caller either
    from the padded plane (level path, _apply_intra_op) or as static
    slices of a CTU tile (tile path, _apply_slot).  Evaluates
    planar/DC/H/V/angular exactly as intra.py / intra_angular.py;
    positions beyond the per-lane valid counts (vx/vy) are never read
    (all accesses clamp to [omin, om-1]), so don't-care values in RAW
    beyond the valid region cannot propagate.  Returns
    (grid [L, S, S], dc1v [L] — the DC stray-pixel value).

    consts: the fused angular table (_ANG_FUSED as a device array) —
    ONE constant-table gather per call; every other indexed read is a
    masked reduce or an edge-dup shift (see _side_arrays), keeping the
    per-op kernel count low on the dispatch-bound backend."""
    TBL = consts
    Lb = sl2.shape[0]
    size = xp.left_shift(1, sl2)
    two_sz = xp.left_shift(2, sl2)
    NV = 2 * S + 2
    corner = RAWT[:, 0]
    L0 = RAWL[:, 1]
    T0 = RAWT[:, 1]
    omin_L = xp.where(vx > 0, -1, 0)
    omin_T = xp.where(vy > 0, -1, 0)
    omL = xp.minimum(two_sz, vy)
    omT = xp.minimum(two_sz, vx)
    rawcL, filtL, strongL = _side_arrays(RAWL, omin_L, omL, T0, NV, xp)
    rawcT, filtT, strongT = _side_arrays(RAWT, omin_T, omT, L0, NV, xp)

    ys = xp.arange(S)
    xs = xp.arange(S)
    gy = ys[None, :, None]
    gx = xs[None, None, :]
    sz3 = size[:, None, None]

    # ---- strong-smoothing detect (h265.cpp:2435-2456) ----
    if is_luma and strong_en:
        def onedir(lt, RAW, vl):
            d64 = lt + RAW[:, 64] - 2 * RAW[:, 32]
            d32 = lt - RAW[:, 32]
            return xp.where(vl >= 64, d64 * d64 < 64,
                            xp.where(vl >= 32, d32 * d32 < 64, True))

        dflag = xp.where(
            vx > 0,
            xp.where(vy > 0,
                     onedir(corner, RAWT, vx) & onedir(corner, RAWL, vy),
                     onedir(T0, RAWT, vx)),
            xp.where(vy > 0, onedir(L0, RAWL, vy), False))
        dflag = dflag & (sl2 == 5)
    else:
        dflag = xp.zeros((Lb,), bool)

    # ---- planar (h265.cpp:2411-2430) ----
    if is_luma:
        pl_filt = sl2 >= 3
        lineL = xp.where((pl_filt & dflag)[:, None], strongL,
                         xp.where(pl_filt[:, None], filtL, rawcL))
        lineT = xp.where((pl_filt & dflag)[:, None], strongT,
                         xp.where(pl_filt[:, None], filtT, rawcT))
    else:
        lineL, lineT = rawcL, rawcT
    left_bn = xp.where((vy > 0)[:, None], lineL[:, 1 : S + 2],
                       T0[:, None])
    top_bn = xp.where((vx > 0)[:, None], lineT[:, 1 : S + 2],
                      L0[:, None])
    lb = _sel_at(left_bn, size, xp)
    rt = _sel_at(top_bn, size, xp)
    lv = left_bn[:, :S]
    tbn = top_bn[:, :S]
    planar = ((xp.left_shift(lv, sl2[:, None])[:, :, None]
               + (ys + 1)[None, :, None] * lb[:, None, None]
               + (xs + 1)[None, None, :]
               * (rt[:, None, None] - lv[:, :, None])
               + tbn[:, None, :] * (sz3 - 1 - gy)
               + sz3) >> (sl2[:, None, None] + 1))
    planar = xp.where(((vx <= 0) & (vy <= 0))[:, None, None], 128,
                      planar)

    # ---- DC (h265.cpp:2348-2410) ----
    TT = RAWT[:, 1 : S + 1]
    LL = RAWL[:, 1 : S + 1]
    idxS = xp.arange(S)

    def edge_sum(vec, vm, vs, fb):
        msk = idxS[None, :] < xp.minimum(size, xp.maximum(vm, 0))[:, None]
        sfull = xp.sum(vec * msk, axis=1)
        lastv = _sel_at(vec, xp.clip(vm - 1, 0, S - 1), xp)
        return xp.where(size <= vm, sfull,
                        xp.where(vm > 0, sfull + lastv * (size - vm),
                                 xp.where(vs > 0, fb * size, 128 * size)))

    st = edge_sum(TT, vx, vy, L0)
    slf = edge_sum(LL, vy, vx, T0)
    dc = (st + slf + size) >> (sl2 + 1)
    dcg = xp.broadcast_to(dc[:, None, None], (Lb, S, S))
    dc1v = (T0 + 3 * dc + 2) >> 2
    if is_luma:
        both = (vx > 0) & (vy > 0)
        ton = (vx > 0) & (vy <= 0)
        lon = (vy > 0) & (vx <= 0)
        dcb = dc[:, None]
        row0 = xp.where((both | ton)[:, None], (TT + 3 * dcb + 2) >> 2,
                        ((L0 + 3 * dc + 2) >> 2)[:, None])
        col0 = xp.where(ton[:, None], dc1v[:, None],
                        (LL + 3 * dcb + 2) >> 2)
        pix00 = xp.where(both, (T0 + L0 + 2 * dc + 2) >> 2,
                         xp.where(ton, (T0 + dc + 1) >> 1,
                                  (L0 + dc + 1) >> 1))
        dcf = xp.where((gx >= 1) & (gy == 0), row0[:, None, :], dcg)
        dcf = xp.where((gy >= 1) & (gx == 0),
                       col0[:, :, None] * xp.ones((1, 1, S), xp.int32),
                       dcf)
        dcf = xp.where((gy == 0) & (gx == 0),
                       pix00[:, None, None], dcf)
        apply_f = (sl2 < 5) & (both | ton | lon)
        dcg = xp.where(apply_f[:, None, None], dcf, dcg)

    # ---- horizontal / vertical (h265.cpp:2822-2885) ----
    dcv_h = xp.where(vx > 0, T0, 128)
    hbase = xp.where((vy > 0)[:, None], LL, dcv_h[:, None])
    hg = xp.broadcast_to(hbase[:, :, None], (Lb, S, S))
    dcv_v = xp.where(vy > 0, L0, 128)
    vbase = xp.where((vx > 0)[:, None], TT, dcv_v[:, None])
    vg = xp.broadcast_to(vbase[:, None, :], (Lb, S, S))
    if is_luma:
        c0h = xp.where(vy > 0, corner, dcv_h)
        d0h = xp.where(vy > 0, L0, dcv_h)
        row0h = _clip255(d0h[:, None] + ((TT - c0h[:, None]) >> 1), xp)
        condh = ((sl2 < 5) & (vx > 0))[:, None, None]
        hg = xp.where(condh & (gy == 0), row0h[:, None, :], hg)
        c0v = xp.where(vx > 0, corner, dcv_v)
        d0v = xp.where(vx > 0, T0, dcv_v)
        col0v = _clip255(d0v[:, None] + ((LL - c0v[:, None]) >> 1), xp)
        condv = ((sl2 < 5) & (vy > 0))[:, None, None]
        vg = xp.where(condv & (gx == 0),
                      col0v[:, :, None] * xp.ones((1, 1, S), xp.int32),
                      vg)

    # ---- angular (h265.cpp:2663-2812) ----
    mm = xp.clip(mode - 2, 0, 32)
    flat = mm * 4 + (sl2 - 2)
    RC = _REFCAP
    B0 = 2 * RC + 64
    # the assembled ref vector only needs indices 0..2S-1 (max table
    # idxa = 2S-2, max populated SEL/POSA entry = 2S-1 — verified from
    # _build_ang_tables), so all angular work runs at width RCW
    RCW = min(2 * S, RC)
    row = TBL[flat]                       # ONE fused-table gather
    selr = row[:, :RCW]
    posr = row[:, RC : RC + RCW]
    if is_luma:
        kf = row[:, B0 + 3]
        kind = xp.where(kf == 0, 0, xp.where(dflag, 2, 1))
    else:
        kind = xp.zeros((Lb,), xp.int32)
    horiz = (mm < 16)
    vmain = xp.where(horiz, vy, vx)
    vsub = xp.where(horiz, vx, vy)
    omin_sub = xp.where(horiz[:, None], omin_T[:, None],
                        omin_L[:, None])[:, 0]
    h3 = horiz[:, None]
    mainRAWC = xp.where(h3, rawcL, rawcT)
    mainF = xp.where(h3, filtL, filtT)
    mainS = xp.where(h3, strongL, strongT)
    main_arr = xp.where((kind == 0)[:, None], mainRAWC,
                        xp.where((kind == 1)[:, None], mainF, mainS))
    subRAW = xp.where(h3, RAWT, RAWL)
    sub_single = xp.where(horiz, L0, T0)
    iota_nv = xp.arange(main_arr.shape[1])
    Mp = iota_nv[None, None, :] == xp.clip(posr + 1, 0, NV)[:, :, None]
    mainvals = xp.sum(main_arr[:, None, :] * Mp, axis=2)
    fixval = _sel_at(mainRAWC, xp.clip(row[:, B0 + 2] + 1, 0, NV), xp)
    karr = xp.arange(RCW)
    fixmask = (karr[None, :] == row[:, B0 + 1][:, None]) \
        & ((row[:, B0 + 0] == 1) & (vmain >= two_sz))[:, None]
    mainvals = xp.where(fixmask, fixval[:, None], mainvals)
    mainvals = xp.where((vmain > 0)[:, None], mainvals,
                        xp.where((vsub > 0)[:, None],
                                 subRAW[:, 1][:, None], 128))
    ev = _extra_vals(subRAW, posr, omin_sub, vsub, kind, NV, xp)
    ev = xp.where((vsub > 0)[:, None], ev,
                  xp.where((vmain > 0)[:, None], sub_single[:, None],
                           128))
    ref = xp.where(selr == 1, ev, xp.where(selr == 0, mainvals, 0))
    r0 = row[:, 2 * RC : 2 * RC + S]
    c1 = row[:, 2 * RC + 32 : 2 * RC + 32 + S]
    # a = ref[r0[y] + x], b = ref[r0[y] + x + 1] as ONE shared onehot
    # masked reduce (a take_along here is a separate gather kernel,
    # ~0.35 ms/step at S=16 on the dispatch-bound backend; the reduce
    # fuses). idxa <= 2S-2 = RCW-2 keeps both in range.
    idxa = r0[:, :, None] + xs[None, None, :]
    Mab = karr[None, None, None, :] == idxa[:, :, :, None]
    refs1 = xp.concatenate([ref[:, 1:], ref[:, -1:]], axis=1)
    a = xp.sum(ref[:, None, None, :] * Mab, axis=3)
    b = xp.sum(refs1[:, None, None, :] * Mab, axis=3)
    c13 = c1[:, :, None]
    ang = (a * (32 - c13) + b * c13 + 16) >> 5
    tr = (row[:, B0 + 4] == 1)[:, None, None]
    ang = xp.where(tr, xp.swapaxes(ang, 1, 2), ang)

    # ---- select ----
    m3 = mode[:, None, None]
    grid = xp.where(m3 == 0, planar,
                    xp.where(m3 == 1, dcg,
                             xp.where(m3 == 10, hg,
                                      xp.where(m3 == 26, vg, ang))))
    return grid, dc1v


def _apply_intra_op(plane, resid, op, S, is_luma, strong_en, H, W,
                    consts, xp, ybase=None, write_plane=None):
    """Apply one z-order intra op slot across all wavefront lanes.

    write_plane: optional accumulation target — all READS (neighbour
    lines, region, residual) come from `plane` while the delta scatters
    into `write_plane`, letting several size-class banks of ONE level
    read the same pre-level state and accumulate disjoint writes.

    plane/resid: padded int32 planes (content at [0:H, 0:W], pad >=
    S+1 below/right); op [L, 7] = (used, y0, x0, sl2, mode, vx, vy).
    Evaluates planar/DC/H/V/angular exactly as intra.py /
    intra_angular.py (via _intra_core) and writes the masked
    (size x size [+ DC stray pixel]) region fused with the residual
    plane.

    ybase: vertical-stacking support (the cb and cr planes ride ONE
    stacked plane so each wavefront step runs a single chroma apply):
    lanes with y0 >= ybase belong to the second segment and clip their
    neighbour reads to [ybase, ybase+H-1] instead of [0, H-1]."""
    used = op[:, 0]
    y0, x0 = op[:, 1], op[:, 2]
    sl2 = xp.clip(op[:, 3], 2, 5)
    mode = op[:, 4]
    vx, vy = op[:, 5], op[:, 6]
    Lb = op.shape[0]
    size = xp.left_shift(1, sl2)
    NV = 2 * S + 2
    ar = xp.arange(-1, NV + 1)
    if ybase is None:
        ylo = xp.zeros_like(y0)
    else:
        ylo = xp.where(y0 >= ybase, ybase, 0)
    yhi = ylo + (H - 1)
    ly = xp.clip(y0[:, None] + ar[None, :], ylo[:, None], yhi[:, None])
    lxc = xp.clip(x0 - 1, 0, W - 1)
    RAWL = plane[ly, lxc[:, None]]                       # src_L[-1..NV]
    tyc = xp.clip(y0 - 1, ylo, yhi)
    tx = xp.clip(x0[:, None] + ar[None, :], 0, W - 1)
    RAWT = plane[tyc[:, None], tx]                       # src_T[-1..NV]
    grid, dc1v = _intra_core(RAWL, RAWT, sl2, mode, vx, vy, S,
                             is_luma, strong_en, consts, xp)
    sz3 = size[:, None, None]
    arS1 = xp.arange(S + 1)
    ry = (y0[:, None] + arS1)[:, :, None]
    rx = (x0[:, None] + arS1)[:, None, :]
    rgn = plane[ry, rx]
    rres = resid[ry, rx]
    gpad = xp.concatenate(
        [xp.concatenate([grid, xp.zeros((Lb, S, 1), xp.int32)], 2),
         xp.zeros((Lb, 1, S + 1), xp.int32)], 1)
    gy1 = arS1[None, :, None]
    gx1 = arS1[None, None, :]
    inb = (gy1 < sz3) & (gx1 < sz3)
    newv = _clip255(gpad + rres, xp)
    out = xp.where(inb, newv, rgn)
    if is_luma:
        stray = (gy1 == sz3) & (gx1 == 0) \
            & (((used >> 1) & 1) == 1)[:, None, None]
        out = xp.where(stray, dc1v[:, None, None], out)
    act = ((used & 1) == 1)
    # duplicate-safe write: out == rgn outside the op's block (+ stray
    # pixel), so the delta vanishes there and overlapping windows of
    # same-level lanes never conflict — scatter-ADD is well-defined for
    # duplicate indices, unlike .set
    delta = xp.where(act[:, None, None], out - rgn, 0)
    BIG = plane.shape[0] + plane.shape[1]
    sy = xp.where(act, y0, BIG)
    wy = (sy[:, None] + arS1)[:, :, None]
    tgt = plane if write_plane is None else write_plane
    return tgt.at[wy, rx].add(delta, mode="drop")


# =====================================================================
# whole-picture graph + drivers
# =====================================================================


#: lane-capacity cap for the level schedule: bounds the packed lane
#: count (the per-step tensor width of the device wavefront) at the
#: price of a few extra levels on capacity-bound pictures. Tuned on the
#: original accelerator; not yet re-tuned on the GPU (ROADMAP).
_LEVEL_CAP = 32
#: big-TU (sl2>=4) lane cap: one big lane costs ~16 small ones on the
#: S=32 apply, so the big bank stays narrow
_LEVEL_CAP_BIG = 4


def _schedule_levels(flat_ops, chg, cwg, stray, cap=_LEVEL_CAP,
                     cap_big=_LEVEL_CAP_BIG):
    """Dependency-level schedule for decode-ordered intra ops.

    Replaces the per-CTU-diagonal z-order replay (the reference's CTU
    walk, h265.cpp:4752-4799) with the minimal sequential structure the
    data actually requires: each op gets a level such that applying all
    ops of a level in one lane-batched step — reads from the plane
    state left by earlier levels, disjoint writes — produces planes
    identical to the sequential z-order replay.

    Dependencies are tracked on the 4x4-cell grid [chg, cwg]:
    * flow (read-after-write): an op reads its own block (residual
      merge), the column left of it down to y0+2*size (left neighbour
      line incl. the strong-filter one-past-valid read), and the row
      above it right to x0+2*size (top line incl. top-right) — its
      level must exceed every earlier writer of those cells;
    * anti (write-after-read): a z-later writer of a cell some earlier
      op read must not land on an EARLIER level (the reader would see
      the new value where z-order saw the old) — same level is fine
      because reads gather before the level's writes scatter;
    * output (write-after-write, e.g. the DC stray pixel overwritten
      by the block below): strictly increasing levels.

    flat_ops [n, 7] int32 rows (used, y0, x0, sl2, mode, vx, vy) in
    decode order; returns per-op levels [n] int32 (0 = inactive).

    The native scheduler (native/oplevel.cpp, identical algorithm) runs
    when available — the Python loop costs ~700 ms per 1080p I-picture;
    it remains as the executable spec / fallback."""
    import ctypes

    from m2dec_tpu.native import load_oplevel

    lib = load_oplevel()
    if lib is not None and len(flat_ops):
        ops = np.ascontiguousarray(flat_ops, np.int32)
        lv = np.zeros(len(ops), np.int32)
        lib.h265_schedule_levels(
            ops.ctypes.data_as(ctypes.c_void_p), len(ops),
            np.int32(chg), np.int32(cwg), np.int32(bool(stray)),
            np.int32(cap), np.int32(cap_big),
            lv.ctypes.data_as(ctypes.c_void_p))
        return lv
    lw = np.zeros((chg, cwg), np.int32)  # last writer's level per cell
    lr = np.zeros((chg, cwg), np.int32)  # latest reader's level
    lv = np.zeros(len(flat_ops), np.int32)
    occ: dict = {}   # small-bank per-level occupancy
    occb: dict = {}  # big-bank (sl2>=4) occupancy
    for i, op in enumerate(flat_ops):
        used = int(op[0])
        if not (used & 1):
            continue
        y0, x0, sl2 = int(op[1]), int(op[2]), int(op[3])
        s = 1 << sl2
        c0, c1 = x0 >> 2, (x0 + s - 1) >> 2
        r0, r1 = y0 >> 2, (y0 + s - 1) >> 2
        rr0, rc0 = max(0, r0 - 1), max(0, c0 - 1)
        rr1 = min(chg - 1, (y0 + 2 * s) >> 2)
        rc1 = min(cwg - 1, (x0 + 2 * s) >> 2)
        blk_w = lw[r0 : r1 + 1, c0 : c1 + 1]
        m = int(blk_w.max())
        m = max(m, int(lw[rr0 : rr1 + 1, rc0].max()),
                int(lw[rr0, rc0 : rc1 + 1].max()))
        a = int(lr[r0 : r1 + 1, c0 : c1 + 1].max())
        sy = (y0 + s) >> 2 if (stray and (used & 2)) else -1
        if sy >= chg:
            sy = -1
        if sy >= 0:
            m = max(m, int(lw[sy, c0]))
            a = max(a, int(lr[sy, c0]))
        level = max(m + 1, a)
        if cap > 0:
            # see oplevel.cpp: delaying past the minimum level is safe
            # because later ops' constraints read the ASSIGNED levels
            o, c = (occb, cap_big) if sl2 >= 4 else (occ, cap)
            while o.get(level, 0) >= c:
                level += 1
            o[level] = o.get(level, 0) + 1
        lv[i] = level
        np.maximum(lr[rr0 : rr1 + 1, rc0], level,
                   out=lr[rr0 : rr1 + 1, rc0])
        np.maximum(lr[rr0, rc0 : rc1 + 1], level,
                   out=lr[rr0, rc0 : rc1 + 1])
        np.maximum(lr[r0 : r1 + 1, c0 : c1 + 1], level,
                   out=lr[r0 : r1 + 1, c0 : c1 + 1])
        lw[r0 : r1 + 1, c0 : c1 + 1] = level
        if sy >= 0:
            lw[sy, c0] = level
            lr[sy, c0] = max(int(lr[sy, c0]), level)
    return lv


#: max ops per wavefront step row.  A level with more ops than this is
#: split into consecutive rows (decode order preserved inside the
#: level, which keeps write-after-read anti-dependencies correct: the
#: earlier-decode-order reader runs in an earlier-or-equal row than the
#: later writer).  Without the cap, one wide level (e.g. the first
#: level of an inter-heavy picture: thousands of independent ops)
#: multiplied by a deep picture's level count when batch-padding —
#: a [2048, 2048, 7] per-plane tensor that ran the device out of
#: memory.
_LANE_CAP = 128


def _level_pack(flat_ops, lv):
    """Row-pack decode-ordered ops by level, split per row into SIZE
    BANKS -> (small [rows, Ls, 7], big [rows, Lb, 7]) int32.

    A row's small (sl2<=3) and big (sl2>=4) ops apply as two separate
    device passes whose tensor extents match their block sizes (8 vs
    32/16) — the apply cost scales with lanes x S^2, and big TUs are
    rare. Safe because both passes READ the pre-level plane state
    (write_plane accumulation in _apply_intra_op) and a level's writes
    are disjoint by construction."""
    idx = np.flatnonzero(lv)  # decode order within equal levels
    if len(idx) == 0:
        z = np.zeros((1, 1, 7), np.int32)
        return z, z.copy()
    order = idx[np.argsort(lv[idx], kind="stable")]
    levels = lv[order]
    rows = []
    i = 0
    n = len(order)
    while i < n:
        j = i
        cur = levels[i]
        while j < n and levels[j] == cur and j - i < _LANE_CAP:
            j += 1
        r = order[i:j]
        big = flat_ops[r][:, 3] >= 4
        rows.append((r[~big], r[big]))
        i = j
    Ls = _ceil_pow2(max(1, max(len(s) for s, _ in rows)))
    Lb = _ceil_pow2(max(1, max(len(b) for _, b in rows)))
    out_s = np.zeros((len(rows), Ls, 7), np.int32)
    out_b = np.zeros((len(rows), Lb, 7), np.int32)
    for d, (s, b) in enumerate(rows):
        out_s[d, : len(s)] = flat_ops[s]
        out_b[d, : len(b)] = flat_ops[b]
    return out_s, out_b


def _plan_levels(plan):
    """Level-packed intra op tensors for one plan (cached on the plan):
    (lv_ls, lv_lb, lv_cs, lv_cb) size-bank tensors [D, L, 7]."""
    cached = getattr(plan, "_levels", None)
    if cached is not None:
        return cached
    flat_l = np.asarray(plan.ops_l, np.int32).reshape(-1, 7)
    flat_c = np.asarray(plan.ops_c, np.int32).reshape(-1, 7)
    lvl = _schedule_levels(flat_l, plan.H >> 2, plan.W >> 2, True)
    lvc = _schedule_levels(flat_c, plan.H >> 3, plan.W >> 3, False)
    pk_cs, pk_cb = _level_pack(flat_c, lvc)

    # double the chroma lanes: the second copy targets the cr segment
    # of the stacked chroma plane (see _wavefront)
    def dbl(pk):
        cr_ops = pk.copy()
        cr_ops[:, :, 1] += _CR0(plan.H >> 1)
        return np.concatenate([pk, cr_ops], axis=1)

    pk_ls, pk_lb = _level_pack(flat_l, lvl)
    plan._levels = (pk_ls, pk_lb, dbl(pk_cs), dbl(pk_cb))
    return plan._levels


def _pad_levels(lv_ls, lv_lb, lv_cs, lv_cb, buckets=None):
    """Pad the four level bank tensors to shared pow2-bucketed shapes;
    returns (ls, lb, cs, cb, n_lvl [2]) where n_lvl holds the true luma
    and chroma level counts (the wavefront runs separate luma/chroma
    loops)."""
    if buckets is None:
        buckets = (_ceil_pow2(max(lv_ls.shape[0], lv_cs.shape[0])),
                   _ceil_pow2(lv_ls.shape[1]), _ceil_pow2(lv_lb.shape[1]),
                   _ceil_pow2(lv_cs.shape[1]), _ceil_pow2(lv_cb.shape[1]))
    Db, Lsb, Lbb, Csb, Cbb = buckets

    def pad(t, L):
        out = np.zeros((Db, L, 7), np.int32)
        out[: t.shape[0], : t.shape[1]] = t
        return out

    return (pad(lv_ls, Lsb), pad(lv_lb, Lbb), pad(lv_cs, Csb),
            pad(lv_cb, Cbb),
            np.array([lv_ls.shape[0], lv_cs.shape[0]], np.int32))


def _wavefront(y, cbcr, res_y, res_cbcr, lv_ls, lv_lb, lv_cs, lv_cb,
               n_lvl, strong_en, H, W):
    """Intra reconstruction as while_loops over dependency levels.

    Separate luma and chroma loops (the planes are independent — DM
    chroma inherits the luma MODE, never luma pixels — and chroma trees
    are ~half as deep), each running only its picture's true depth
    (n_lvl). Every level applies as two SIZE BANKS — small (<=8, the
    common case, S=8 tensors) and big (16/32, rare, their own narrow
    lane bank) — both reading the pre-level plane and accumulating
    disjoint writes via _apply_intra_op's write_plane."""
    import jax
    import jax.numpy as jnp

    consts = jnp.asarray(_ANG_FUSED)
    Hc, Wc = H >> 1, W >> 1

    def row(t, i):
        return jax.lax.dynamic_slice(t, (i, 0, 0),
                                     (1,) + t.shape[1:])[0]

    def body_l(state):
        i, y_ = state
        # strong smoothing exists only for 32x32 TUs -> big bank
        y1 = _apply_intra_op(y_, res_y, row(lv_ls, i), 8, True, False,
                             H, W, consts, jnp)
        y1 = _apply_intra_op(y_, res_y, row(lv_lb, i), 32, True,
                             strong_en, H, W, consts, jnp,
                             write_plane=y1)
        return i + 1, y1

    def body_c(state):
        i, c_ = state
        c1 = _apply_intra_op(c_, res_cbcr, row(lv_cs, i), 8, False,
                             False, Hc, Wc, consts, jnp,
                             ybase=_CR0(Hc))
        c1 = _apply_intra_op(c_, res_cbcr, row(lv_cb, i), 16, False,
                             False, Hc, Wc, consts, jnp,
                             ybase=_CR0(Hc), write_plane=c1)
        return i + 1, c1

    _, y = jax.lax.while_loop(
        lambda s: s[0] < n_lvl[0], body_l, (jnp.int32(0), y))
    _, cbcr = jax.lax.while_loop(
        lambda s: s[0] < n_lvl[1], body_c, (jnp.int32(0), cbcr))
    return y, cbcr


def _CR0(Hc):
    """Row base of the cr segment in the stacked chroma plane (cb
    content + its 17-row write pad)."""
    return Hc + 17


# =====================================================================
# CTU-tile wavefront (the H.264 slab design at CTU granularity)
# =====================================================================
#
# Instead of ~O(picture-depth) dependency levels each touching the full
# plane (_wavefront above), run one step per CTU anti-diagonal
# d = cx + 2*cy (the reference's own CTU wavefront order,
# h265.cpp:4752-4799) and STATICALLY UNROLL the CTU-local z-order as
# slots over the 4x4 cell grid: the op whose top-left cell is z-cell j
# applies at unroll position j.  Each slot reads its neighbour lines as
# STATIC slices of a small gathered CTU tile and writes a STATIC
# (S+1)x(S+1) region — no per-op plane gathers/scatters — so the whole
# chain fuses; the plane is touched twice per diagonal (tile gather +
# write-back).  k = 2 in d = cx + k*cy is sufficient because valid
# neighbour reads reach at most C+S-1 < 2C pixels right of the CTU
# origin (top lines clamp at om-1 <= 2*size-1 with x0 <= C-size) and
# never below the CTU row (left-column validity ends at the CTU
# bottom), i.e. only CTUs on strictly earlier diagonals.

#: packed z-slot op fields: used(2) | (sl2-2)(2) | mode(6) | vx(7) | vy(7)
_ZF_USED, _ZF_SL2, _ZF_MODE, _ZF_VX, _ZF_VY = 0, 2, 4, 10, 17


@functools.lru_cache(maxsize=16)
def _zslot_table(cb_log2):
    """Z-ordered (oy, ox, Smax) slots over a CTB's 4x4 cell grid.
    Smax = the largest block size a slot's alignment admits (an op's
    top-left cell determines its slot; quad-tree alignment makes the
    mapping unique and z-monotonic)."""
    n = 1 << (cb_log2 - 2)
    out = []
    for z in range(n * n):
        r = c = 0
        for k in range(cb_log2 - 2):
            c |= ((z >> (2 * k)) & 1) << k
            r |= ((z >> (2 * k + 1)) & 1) << k
        oy, ox = r << 2, c << 2
        smax = 4
        while (smax < 32 and smax < (1 << cb_log2)
               and oy % (smax * 2) == 0 and ox % (smax * 2) == 0):
            smax *= 2
        out.append((oy, ox, smax))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _tile_lanes_band(cols, rows):
    """Band-indexed lane table: ctu_of [D, rows] int32 — the CTU of
    band (CTU row) cy on diagonal d, or -1 (band idle on d)."""
    D = cols + 2 * (rows - 1)
    out = np.full((D, rows), -1, np.int32)
    for d in range(D):
        for cy in range(rows):
            cx = d - 2 * cy
            if 0 <= cx < cols:
                out[d, cy] = cy * cols + cx
    return out


def _pack_zslots(ops, n_slots, cb_log2):
    """Pack a per-CTU op array [n_ctu, CAP, 7] into z-slot field words
    [n_ctu, n_slots] int32 (0 = no op)."""
    flat = np.asarray(ops, np.int32)
    n_ctu = flat.shape[0]
    zl = np.zeros((n_ctu, n_slots), np.int32)
    ic, io = np.nonzero((flat[..., 0] & 1) == 1)
    if len(ic) == 0:
        return zl, ic
    y0, x0 = flat[ic, io, 1], flat[ic, io, 2]
    cb = 1 << cb_log2
    r, c = (y0 % cb) >> 2, (x0 % cb) >> 2
    slot = np.zeros(len(ic), np.int64)
    for k in range(cb_log2 - 2):
        slot |= ((c >> k) & 1) << (2 * k)
        slot |= ((r >> k) & 1) << (2 * k + 1)
    packed = ((flat[ic, io, 0] & 3)
              | ((flat[ic, io, 3] - 2) << _ZF_SL2)
              | (flat[ic, io, 4] << _ZF_MODE)
              | (np.clip(flat[ic, io, 5], 0, 127) << _ZF_VX)
              | (np.clip(flat[ic, io, 6], 0, 127) << _ZF_VY))
    zl[ic, slot] = packed
    return zl, ic


def _plan_zslots(plan):
    """Tile-wavefront tensors for one plan (cached):
    (fzl [D, rows, SL], fzc [D, rows, SC], actm [D, 2]) — per-diagonal
    per-band packed z-slot words (0 for idle bands) plus the
    per-diagonal any-luma-op / any-chroma-op flags (the scan body
    cond-skips the unrolled slot chain on op-free diagonals — P/B
    pictures have few)."""
    cached = getattr(plan, "_zslots", None)
    if cached is not None:
        return cached
    cl2 = plan.size_log2
    cols, rows = plan.columns, plan.rows
    nsl = 1 << (2 * (cl2 - 2))
    nsc = 1 << (2 * (cl2 - 3))
    zl, icl = _pack_zslots(plan.ops_l, nsl, cl2)
    zc, icc = _pack_zslots(plan.ops_c, nsc, cl2 - 1)
    lanes = _tile_lanes_band(cols, rows)          # [D, rows]
    safe = np.maximum(lanes, 0)
    live = (lanes >= 0)[:, :, None]
    fzl = np.where(live, zl[safe], 0).astype(np.int32)
    fzc = np.where(live, zc[safe], 0).astype(np.int32)
    actm = np.stack([(fzl & 1).any(axis=(1, 2)),
                     (fzc & 1).any(axis=(1, 2))], 1)
    plan._zslots = (fzl, fzc, actm)
    return plan._zslots


def _apply_slot(T, R, f, oy, ox, S, is_luma, strong_en, consts, xp):
    """Apply the op at z-cell slot (oy, ox) of every lane's CTU tile.

    T: [L, C+2, TC] int32 recon band-slab tiles (tile index dy+1 <->
    CTU-local row dy; index 0 = the -1 halo row/col; row C+1 = the
    stray row).  R: [L, C+2, C+2] residual tiles, same row convention.
    f [L]: packed op field words; S = the slot's max block size.
    Neighbour lines are STATIC tile slices and the update a STATIC
    region write, so the unrolled z-chain fuses without
    gathers/scatters; values past the per-lane valid counts are never
    read (_intra_core clamps) — including the zero-padded tail of the
    left line where it would extend below the band (valid left reads
    end at the CTU bottom row)."""
    used = f & 3
    sl2 = xp.clip(((f >> _ZF_SL2) & 3) + 2, 2, 5)
    mode = (f >> _ZF_MODE) & 63
    vx = (f >> _ZF_VX) & 127
    vy = (f >> _ZF_VY) & 127
    NV = 2 * S + 2
    take = min(NV + 2, T.shape[1] - oy)
    RAWL = T[:, oy : oy + take, ox]
    if take < NV + 2:
        RAWL = xp.concatenate(
            [RAWL, xp.zeros((T.shape[0], NV + 2 - take), xp.int32)], 1)
    RAWT = T[:, oy, ox : ox + NV + 2]
    grid, dc1v = _intra_core(RAWL, RAWT, sl2, mode, vx, vy, S,
                             is_luma, strong_en, consts, xp)
    size = xp.left_shift(1, sl2)
    sz3 = size[:, None, None]
    arS1 = xp.arange(S + 1)
    Lb = f.shape[0]
    rgn = T[:, oy + 1 : oy + S + 2, ox + 1 : ox + S + 2]
    rres = R[:, oy + 1 : oy + S + 2, ox + 1 : ox + S + 2]
    gpad = xp.concatenate(
        [xp.concatenate([grid, xp.zeros((Lb, S, 1), xp.int32)], 2),
         xp.zeros((Lb, 1, S + 1), xp.int32)], 1)
    gy1 = arS1[None, :, None]
    gx1 = arS1[None, None, :]
    inb = (gy1 < sz3) & (gx1 < sz3)
    newv = _clip255(gpad + rres, xp)
    out = xp.where(inb, newv, rgn)
    if is_luma:
        stray = (gy1 == sz3) & (gx1 == 0) \
            & (((used >> 1) & 1) == 1)[:, None, None]
        out = xp.where(stray, dc1v[:, None, None], out)
    out = xp.where((((used & 1) == 1))[:, None, None], out, rgn)
    return T.at[:, oy + 1 : oy + S + 2, ox + 1 : ox + S + 2].set(out)


def _skew_bands(plane, nb, row0s, C, SW, width, xp):
    """Skewed band-slab storage: band b holds `plane` rows
    [row0s[b]-1, row0s[b]+C] (C+2 rows: top halo, C content, stray
    row) placed at column offset 2*(b % R)*C + 1 — so every CTU
    anti-diagonal d's tiles are ONE contiguous slab at column d*C.
    All offsets are static per band (cheap pads + stack)."""
    bands = []
    nbands = len(row0s)
    for b in range(nbands):
        r0 = row0s[b] - 1
        if r0 < 0:
            rows_ = xp.concatenate([plane[0:1, :width],
                                    plane[0 : C + 1, :width]], 0)
        else:
            rows_ = plane[r0 : r0 + C + 2, :width]
        off = 2 * (b % nb) * C + 1
        bands.append(xp.pad(rows_, ((0, 0), (off, SW - off - width))))
    return xp.stack(bands)


def _unskew_bands(sk, nb, C, width, xp):
    """Inverse of _skew_bands for the content rows: [nbands*C, width]."""
    outs = []
    for b in range(sk.shape[0]):
        off = 2 * (b % nb) * C + 1
        outs.append(sk[b, 1 : C + 1, off : off + width])
    return xp.concatenate(outs, 0)


def _win_step(Tw, R, fz, C, TC, slots, is_luma, strong_en, consts,
              xp, seg, anyop):
    """One diagonal step on the rolling window: unrolled z-slots on the
    leading TC columns, then two STATIC write-backs — U1 (content +
    stray rows at cols [1, C+1)) and U2 (the duplicate halo/stray rows
    of the band below at cols [2C+1, 3C+1); every plane row near a
    band boundary has two copies and U2 keeps the second consistent).
    seg = bands per segment: each segment's first band has no band
    above, so its duplicate rows are preserved.  anyop cond-skips the
    whole chain on op-free diagonals (cheap for P/B pictures)."""
    import jax

    nb = Tw.shape[0]

    def go(Tw):
        T = Tw[:, :, :TC]
        for j, (oy, ox, sm) in enumerate(slots):
            T = _apply_slot(T, R, fz[:, j], oy, ox, sm, is_luma,
                            strong_en, consts, xp)
        Tw = Tw.at[:, 1 : C + 2, 1 : C + 1].set(T[:, 1 : C + 2,
                                                  1 : C + 1])
        old2 = Tw[:, 0:2, 2 * C + 1 : 3 * C + 1]
        dup = xp.concatenate([old2[:1], T[:-1, C : C + 2, 1 : C + 1]],
                             0)
        if nb != seg:
            keep = np.zeros(nb, bool)
            keep[::seg] = True
            dup = xp.where(xp.asarray(keep)[:, None, None], old2, dup)
        return Tw.at[:, 0:2, 2 * C + 1 : 3 * C + 1].set(dup)

    return jax.lax.cond(anyop, go, lambda t: t, Tw)


def _win_streams(plane, nb, row0s, C, D, width, xp):
    """Rolling-window streams from a plane: returns (init window
    [nbands, C+2, 4C], xs cols [D, nbands, C+2, C], xs residual
    windows [D, nbands, C+2, C+2]) — all built with static band
    slices + reshapes (no gathers).  The skewed slab (band b at column
    offset 2*(b%nb)*C+1) is never materialized per step: the scan
    carries only the window and streams the rest."""
    SW = (D + 4) * C
    sk = _skew_bands(plane, nb, row0s, C, SW, width, xp)
    nbands = sk.shape[0]
    blk = sk.reshape(nbands, C + 2, D + 4, C).transpose(2, 0, 1, 3)
    init = sk[:, :, : 4 * C]
    xs_cols = blk[4 : 4 + D]
    xs_res = xp.concatenate([blk[:D], blk[1 : D + 1][..., :2]], -1)
    return init, xs_cols, xs_res


def _wavefront_tile(y, cbcr, res_y, res_cbcr, fzl, fzc, actm,
                    strong_en, H, W, ctb_log2):
    """Intra reconstruction as ONE lax.scan over CTU anti-diagonals
    with the CTU-local z-order statically unrolled on a ROLLING
    WINDOW of skewed band slabs.

    Why a rolling window: any per-step update of a large while-loop
    carry copies the whole buffer on this backend (measured 4.7 ms
    per dynamic_update_slice on a 20 MB carry — r5 micro-probe), so
    the carry holds only the active 4C columns (~300 KB); baseline
    columns stream in as scan xs (pure reshapes of the skewed planes)
    and finalized columns stream out as scan ys (stacked in place by
    the scan).  All slices are static.  Chroma bands are doubled
    (cb then cr segments of the stacked plane; one op word per CTU
    serves both — HEVC has a single chroma mode)."""
    import jax
    import jax.numpy as jnp

    consts = jnp.asarray(_ANG_FUSED)
    C = 1 << ctb_log2
    Cc = C >> 1
    cols, rows = W >> ctb_log2, H >> ctb_log2
    Hc = H >> 1
    D = cols + 2 * (rows - 1)
    slots_l = _zslot_table(ctb_log2)
    slots_c = _zslot_table(ctb_log2 - 1)
    TCl = C + min(C, 32) + 5
    TCc = Cc + min(Cc, 16) + 5
    Wp = y.shape[1]
    Wcp = cbcr.shape[1]
    lrow0 = [cy * C for cy in range(rows)]
    crow0 = ([cy * Cc for cy in range(rows)]
             + [_CR0(Hc) + cy * Cc for cy in range(rows)])
    il, cl_, _ = _win_streams(y, rows, lrow0, C, D, Wp, jnp)
    _, _, rlr = _win_streams(res_y, rows, lrow0, C, D, Wp, jnp)
    ic, cc_, _ = _win_streams(cbcr, rows, crow0, Cc, D, Wcp, jnp)
    _, _, rcr = _win_streams(res_cbcr, rows, crow0, Cc, D, Wcp, jnp)

    def step(carry, x):
        Twl, Twc = carry
        Twl = _win_step(Twl, x["rl"], x["fl"], C, TCl, slots_l, True,
                        strong_en, consts, jnp, rows, x["a"][0])
        f2 = jnp.concatenate([x["fc"], x["fc"]], 0)
        Twc = _win_step(Twc, x["rc"], f2, Cc, TCc, slots_c, False,
                        False, consts, jnp, rows, x["a"][1])
        outl, outc = Twl[:, :, :C], Twc[:, :, :Cc]
        Twl = jnp.concatenate([Twl[:, :, C:], x["cl"]], 2)
        Twc = jnp.concatenate([Twc[:, :, Cc:], x["cc"]], 2)
        return (Twl, Twc), (outl, outc)

    xs = {"fl": fzl, "fc": fzc, "a": actm, "cl": cl_, "cc": cc_,
          "rl": rlr, "rc": rcr}
    (Twl, Twc), (ysl, ysc) = jax.lax.scan(step, (il, ic), xs)
    # finalized slab = streamed-out columns + the final window tail
    slab_l = jnp.concatenate(
        [ysl.transpose(1, 2, 0, 3).reshape(rows, C + 2, D * C), Twl],
        2)
    slab_c = jnp.concatenate(
        [ysc.transpose(1, 2, 0, 3).reshape(2 * rows, Cc + 2, D * Cc),
         Twc], 2)
    y = y.at[: rows * C, :].set(
        _unskew_bands(slab_l, rows, C, Wp, jnp))
    cb_cr = _unskew_bands(slab_c, rows, Cc, Wcp, jnp)
    Hcb = rows * Cc
    cbcr = cbcr.at[:Hcb].set(cb_cr[:Hcb])
    cbcr = cbcr.at[_CR0(Hc) : _CR0(Hc) + Hcb].set(cb_cr[Hcb:])
    return y, cbcr


def _pad_plane(p, pad, xp):
    H, W = p.shape
    out = xp.zeros((H + pad, W + pad), xp.int32)
    return out.at[:H, :W].set(p.astype(xp.int32)) if xp is not np else (
        _np_pad(p, pad))


def _np_pad(p, pad):
    H, W = p.shape
    out = np.zeros((H + pad, W + pad), np.int32)
    out[:H, :W] = p
    return out


def wf_mode_for(ctb_log2):
    """Intra-wavefront backend for a geometry: 'tile' (CTU-diagonal
    scan with statically-unrolled z-slots — the fast path) or 'level'
    (dependency-level schedule — the general fallback). Auto picks
    tile for CTB 16 (16-slot unrolled body); CTB 32's 64+16-slot body
    is byte-exact too (env-forced test) but costs ~150 s of XLA:CPU
    compile per geometry, so the CPU suite keeps level there.
    M2DEC_TPU_H265_WF overrides."""
    import os

    m = os.environ.get("M2DEC_TPU_H265_WF", "auto")
    if m in ("tile", "level"):
        return m
    return "tile" if ctb_log2 <= 4 else "level"


def plan_wf(plan, mode):
    """The plan's wavefront tensors for the given mode (dict)."""
    if mode == "tile":
        fzl, fzc, actm = _plan_zslots(plan)
        return {"fzl": fzl, "fzc": fzc, "actm": actm}
    lv_ls, lv_lb, lv_cs, lv_cb, n_lvl = _pad_levels(*_plan_levels(plan))
    return {"lv_ls": lv_ls, "lv_lb": lv_lb, "lv_cs": lv_cs,
            "lv_cb": lv_cb, "n_lvl": n_lvl}


def _run_wavefront(wf, wf_mode, yp, cbcrp, ryp, rcp, strong_en, H, W,
                   ctb_log2):
    if wf_mode == "tile":
        return _wavefront_tile(yp, cbcrp, ryp, rcp, wf["fzl"],
                               wf["fzc"], wf["actm"],
                               strong_en, H, W, ctb_log2)
    return _wavefront(yp, cbcrp, ryp, rcp, wf["lv_ls"], wf["lv_lb"],
                      wf["lv_cs"], wf["lv_cb"], wf["n_lvl"], strong_en,
                      H, W)


def _plan_mcu(plan, K=None):
    """Host-derived MC aux for one plan: (mc_used [K] — the picture's
    used ref slots, padded; mc_remap [16] — slot value -> used index).
    K pads to a shared bucket for batch stacking."""
    used = plan.used_slots()
    if K is None:
        K = max(1, len(used))
    u = np.zeros(K, np.int32)
    remap = np.zeros(16, np.int32)
    for i, s in enumerate(used[:K]):
        u[i] = s
        remap[s] = i
    return u, remap


def _recon_picture(coef_y, tu_y, coef_cb, tu_cb, coef_cr, tu_cr, slot,
                   mv, mc_used, mc_remap, wf, dbv, dbh,
                   dbcv, dbch, sao_idx,
                   sao_opt, sao_off, pool_y, pool_cb, pool_cr, cur_idx,
                   *, H, W, strong_en, has_sao, deblock, ctb_log2,
                   pic_w, pic_h, slices=None, wf_mode="level"):
    """One picture's Phase-B graph (jit-keyed on geometry + op caps)."""
    import jax.numpy as jnp

    xp = jnp
    res_y = residual_plane(coef_y, tu_y.astype(xp.int32), (4, 8, 16, 32),
                           xp, True)
    res_cb = residual_plane(coef_cb, tu_cb.astype(xp.int32), (4, 8, 16),
                            xp, False)
    res_cr = residual_plane(coef_cr, tu_cr.astype(xp.int32), (4, 8, 16),
                            xp, False)
    prior_y = pool_y[cur_idx].astype(xp.int32)
    prior_cb = pool_cb[cur_idx].astype(xp.int32)
    prior_cr = pool_cr[cur_idx].astype(xp.int32)
    # cond-gate the dense MC pass: intra pictures have no inter cells
    # and the window gathers are the dominant per-picture device cost
    # (r5; same gating as the MPEG-2 engine)
    import jax

    def _mc(_):
        return inter_pass(slot, mv, pool_y, pool_cb, pool_cr, pic_w,
                          pic_h, xp, mc_used=mc_used,
                          mc_remap=mc_remap)

    def _no_mc(_):
        ch, cw = H >> 2, W >> 2
        return (xp.zeros((ch, cw), bool), xp.zeros((H, W), xp.int32),
                xp.zeros((H >> 1, W >> 1), xp.int32),
                xp.zeros((H >> 1, W >> 1), xp.int32))

    mask, mc_y, mc_cb, mc_cr = jax.lax.cond(
        (slot >= 0).any(), _mc, _no_mc, None)
    mp = xp.repeat(xp.repeat(mask, 4, 0), 4, 1)
    y = xp.where(mp, _clip255(mc_y + res_y, xp), prior_y)
    mpc = xp.repeat(xp.repeat(mask, 2, 0), 2, 1)
    cb = xp.where(mpc, _clip255(mc_cb + res_cb, xp), prior_cb)
    cr = xp.where(mpc, _clip255(mc_cr + res_cr, xp), prior_cr)
    # intra wavefront over padded planes; cb/cr vertically stacked so
    # each step runs ONE chroma apply for both components
    Hc = H >> 1
    yp = _pad_plane(y, 33, xp)
    cbcrp = xp.concatenate([_pad_plane(cb, 17, xp),
                            _pad_plane(cr, 17, xp)], axis=0)
    ryp = _pad_plane(res_y, 33, xp)
    rcp = xp.concatenate([_pad_plane(res_cb, 17, xp),
                          _pad_plane(res_cr, 17, xp)], axis=0)
    yp, cbcrp = _run_wavefront(wf, wf_mode, yp, cbcrp, ryp, rcp,
                               strong_en, H, W, ctb_log2)
    y = yp[:H, :W]
    cb = cbcrp[:Hc, : W >> 1]
    cr = cbcrp[_CR0(Hc) : _CR0(Hc) + Hc, : W >> 1]
    if slices is None:
        if deblock:
            y, cb, cr = deblock_frame(y, cb, cr, dbv, dbh, dbcv, dbch, xp)
        if has_sao:
            y = sao_plane(y, sao_idx[:, :, 0], sao_opt[:, :, 0],
                          sao_off[:, :, 0], ctb_log2, pic_w, pic_h, xp)
            cb = sao_plane(cb, sao_idx[:, :, 1], sao_opt[:, :, 1],
                           sao_off[:, :, 1], ctb_log2 - 1, pic_w >> 1,
                           pic_h >> 1, xp)
            cr = sao_plane(cr, sao_idx[:, :, 1], sao_opt[:, :, 2],
                           sao_off[:, :, 2], ctb_log2 - 1, pic_w >> 1,
                           pic_h >> 1, xp)
        return (y.astype(xp.uint8), cb.astype(xp.uint8),
                cr.astype(xp.uint8))
    # multi-slice (row-aligned segments): the reference decodes each
    # slice, deblocks its (-4,-4)-shifted CTU windows, then runs the
    # WHOLE-frame SAO pass with the SAO params parsed so far
    # (slice_layer, h265.cpp:4849-4866) — so earlier slices' rows are
    # SAO-filtered once per remaining slice. Cross-slice intra is
    # unavailable (idx_in_slice gate, h265.cpp CTU availability), so the
    # pre-deblock reconstruction above is slice-order independent; only
    # the filter sequence below replays per slice. The edge maps and SAO
    # maps carry a leading slice axis (host-masked snapshots).
    ctb = 1 << ctb_log2
    st_y, st_cb, st_cr = prior_y, prior_cb, prior_cr
    for s, (ra, rb) in enumerate(slices):
        ly0, ly1 = ra * ctb, min(rb * ctb, H)
        st_y = st_y.at[ly0:ly1].set(y[ly0:ly1])
        st_cb = st_cb.at[ly0 >> 1 : ly1 >> 1].set(cb[ly0 >> 1 : ly1 >> 1])
        st_cr = st_cr.at[ly0 >> 1 : ly1 >> 1].set(cr[ly0 >> 1 : ly1 >> 1])
        if deblock:
            st_y, st_cb, st_cr = deblock_frame(
                st_y, st_cb, st_cr, dbv[s], dbh[s], dbcv[s], dbch[s], xp)
        if has_sao:
            st_y = sao_plane(st_y, sao_idx[s, :, :, 0], sao_opt[s, :, :, 0],
                             sao_off[s, :, :, 0], ctb_log2, pic_w, pic_h,
                             xp)
            st_cb = sao_plane(st_cb, sao_idx[s, :, :, 1],
                              sao_opt[s, :, :, 1], sao_off[s, :, :, 1],
                              ctb_log2 - 1, pic_w >> 1, pic_h >> 1, xp)
            st_cr = sao_plane(st_cr, sao_idx[s, :, :, 1],
                              sao_opt[s, :, :, 2], sao_off[s, :, :, 2],
                              ctb_log2 - 1, pic_w >> 1, pic_h >> 1, xp)
    return (st_y.astype(xp.uint8), st_cb.astype(xp.uint8),
            st_cr.astype(xp.uint8))


@functools.lru_cache(maxsize=64)
def _jitted_recon(H, W, strong_en, has_sao, deblock,
                  ctb_log2, pic_w, pic_h, slices=None,
                  wf_mode="level"):
    import jax

    fn = functools.partial(_recon_picture, H=H, W=W,
                           strong_en=strong_en, has_sao=has_sao,
                           deblock=deblock, ctb_log2=ctb_log2,
                           pic_w=pic_w, pic_h=pic_h, slices=slices,
                           wf_mode=wf_mode)
    return jax.jit(fn)


def _slice_masked_maps(plan):
    """Per-slice deblock edge maps + SAO snapshots (leading slice axis).

    Slice s's deblock pass covers exactly the edges its CTUs process
    through the (-4,-4)-shifted window (deblock_ctu): luma edge rows
    y in [ra*CTB-4, rb*CTB-4) (the last slice extends to the plane
    tail), chroma y_c in [ra*CTB/2-2, rb*CTB/2-2). SAO snapshot s keeps
    the final params for CTU rows < rb (parsed by slices <= s) and
    zeroes the not-yet-parsed rows (sao_map starts zeroed)."""
    starts = plan.slice_rows
    S = len(starts)
    bounds = list(starts[1:]) + [plan.rows]
    ctb = 1 << plan.size_log2
    dbv = np.zeros((S,) + plan.dbv.shape, np.int32)
    dbh = np.zeros((S,) + plan.dbh.shape, np.int32)
    dbcv = np.full((S,) + plan.dbcv.shape, -1, np.int32)
    dbch = np.full((S,) + plan.dbch.shape, -1, np.int32)
    sao_idx = np.zeros((S,) + plan.sao_idx.shape, plan.sao_idx.dtype)
    sao_opt = np.zeros((S,) + plan.sao_opt.shape, plan.sao_opt.dtype)
    sao_off = np.zeros((S,) + plan.sao_off.shape, plan.sao_off.dtype)
    for s, (ra, rb) in enumerate(zip(starts, bounds)):
        last = s == S - 1
        # dbv rows r hold edge y = 4r
        lo = max(0, (ra * ctb - 4) // 4)
        hi = plan.dbv.shape[0] if last else max(0, (rb * ctb - 4) // 4)
        dbv[s, lo:hi] = plan.dbv[lo:hi]
        # dbh rows r hold edge y = 8r + 4
        lo = max(0, (ra * ctb - 8) // 8)
        hi = plan.dbh.shape[0] if last else max(0, (rb * ctb - 8) // 8)
        dbh[s, lo:hi] = plan.dbh[lo:hi]
        # dbcv rows r hold chroma edge y_c = 2r
        lo = max(0, (ra * (ctb >> 1) - 2) // 2)
        hi = (plan.dbcv.shape[0] if last
              else max(0, (rb * (ctb >> 1) - 2) // 2))
        dbcv[s, lo:hi] = plan.dbcv[lo:hi]
        # dbch rows r hold chroma edge y_c = 8r + 6
        lo = max(0, (ra * (ctb >> 1) - 8) // 8)
        hi = (plan.dbch.shape[0] if last
              else max(0, (rb * (ctb >> 1) - 8) // 8))
        dbch[s, lo:hi] = plan.dbch[lo:hi]
        sao_idx[s, :rb] = plan.sao_idx[:rb]
        sao_opt[s, :rb] = plan.sao_opt[:rb]
        sao_off[s, :rb] = plan.sao_off[:rb]
    return dbv, dbh, dbcv, dbch, sao_idx, sao_opt, sao_off


def recon_plan(plan, pool_y, pool_cb, pool_cr):
    """Reconstruct one plan against the pool stacks; returns device
    (y, cb, cr) uint8 planes."""
    multi = plan.multi_slice and len(plan.slice_rows) > 1
    if plan.multi_slice and (not plan.slice_aligned or not multi):
        raise NotImplementedError(
            "mid-row slice-segment starts keep the Python path "
            "(reference chroma-base domain)")
    wf_mode = wf_mode_for(plan.size_log2)
    wf = plan_wf(plan, wf_mode)
    deblock = bool(plan.dbv[..., 0].any() or plan.dbh[..., 0].any()
                   or (plan.dbcv >= 0).any() or (plan.dbch >= 0).any())
    if multi:
        slices = tuple(zip(plan.slice_rows,
                           list(plan.slice_rows[1:]) + [plan.rows]))
        (dbv, dbh, dbcv, dbch, sao_idx, sao_opt,
         sao_off) = _slice_masked_maps(plan)
    else:
        slices = None
        dbv = plan.dbv.astype(np.int32)
        dbh = plan.dbh.astype(np.int32)
        dbcv = plan.dbcv.astype(np.int32)
        dbch = plan.dbch.astype(np.int32)
        sao_idx, sao_opt, sao_off = (plan.sao_idx, plan.sao_opt,
                                     plan.sao_off)
    fn = _jitted_recon(plan.H, plan.W,
                       bool(plan.strong_intra), bool(plan.has_sao),
                       deblock, plan.size_log2, plan.pic_width,
                       plan.pic_height, slices, wf_mode)
    mcu, mcr = _plan_mcu(plan)
    return fn(plan.coef_y, plan.tu_y, plan.coef_cb, plan.tu_cb,
              plan.coef_cr, plan.tu_cr,
              plan.slot.astype(np.int32), plan.mv.astype(np.int32),
              mcu, mcr, wf, dbv, dbh, dbcv, dbch,
              sao_idx, sao_opt,
              sao_off, pool_y, pool_cb, pool_cr,
              np.int32(plan.cur_idx))


def replay_plans(plans, pool_size=8):
    """Replay recorded plans through Phase B over a fresh pool (the
    decoder's zero-initialized 8-frame pool); returns per-picture
    (y, cb, cr) uint8 numpy planes in decode order."""
    if not plans:
        return []
    H, W = plans[0].H, plans[0].W
    pool_y = np.zeros((pool_size, H, W), np.uint8)
    pool_cb = np.zeros((pool_size, H >> 1, W >> 1), np.uint8)
    pool_cr = np.zeros((pool_size, H >> 1, W >> 1), np.uint8)
    outs = []
    for p in plans:
        y, cb, cr = recon_plan(p, pool_y, pool_cb, pool_cr)
        y, cb, cr = np.asarray(y), np.asarray(cb), np.asarray(cr)
        pool_y[p.cur_idx] = y
        pool_cb[p.cur_idx] = cb
        pool_cr[p.cur_idx] = cr
        outs.append((y, cb, cr))
    return outs


def _recon_seq(pool_y, pool_cb, pool_cr, xs, *, H, W, strong_en,
               has_sao, deblock, ctb_log2, pic_w, pic_h,
               wf_mode="level"):
    """A picture sequence (GOP) as ONE graph: lax.scan over pictures
    with the frame pool carried device-resident; each step runs the
    whole-picture Phase-B graph and writes its pool slot."""
    import jax

    wf_keys = (("fzl", "fzc", "actm")
               if wf_mode == "tile"
               else ("lv_ls", "lv_lb", "lv_cs", "lv_cb", "n_lvl"))

    def step(pool, x):
        py, pcb, pcr = pool
        y, cb, cr = _recon_picture(
            x["coef_y"], x["tu_y"], x["coef_cb"], x["tu_cb"],
            x["coef_cr"], x["tu_cr"], x["slot"], x["mv"],
            x["mc_used"], x["mc_remap"],
            {k: x[k] for k in wf_keys},
            x["dbv"], x["dbh"], x["dbcv"],
            x["dbch"],
            x["sao_idx"], x["sao_opt"], x["sao_off"], py, pcb, pcr,
            x["cur_idx"], H=H, W=W, strong_en=strong_en,
            has_sao=has_sao, deblock=deblock, ctb_log2=ctb_log2,
            pic_w=pic_w, pic_h=pic_h, wf_mode=wf_mode)
        idx = x["cur_idx"]
        # masked-select pool write (see the pool-write note in
        # codecs/h264/reconstruct._recon_batch)
        from m2dec_tpu.codecs.h264.reconstruct import (
            _fuse_break,
            _pool_write,
        )
        import jax.numpy as jnp

        y, cb, cr = _fuse_break(y, cb, cr)
        py = _pool_write(py, y, idx, jnp)
        pcb = _pool_write(pcb, cb, idx, jnp)
        pcr = _pool_write(pcr, cr, idx, jnp)
        return (py, pcb, pcr), (y, cb, cr)

    pool, outs = jax.lax.scan(step, (pool_y, pool_cb, pool_cr), xs)
    return pool, outs


_SEQ_KEYS = ("coef_y", "tu_y", "coef_cb", "tu_cb", "coef_cr", "tu_cr",
             "slot", "mv", "dbv", "dbh", "dbcv", "dbch", "sao_idx",
             "sao_opt", "sao_off")


def stack_plans(plans, wf_mode=None):
    """Host prep: stacked per-picture tensors [N, ...] for _recon_seq.

    Tile-mode wavefront tensors have geometry-fixed shapes, so batches
    stack directly.  Level-mode per-picture tensor shapes are unified
    to the batch max, rounded up to a power of two so successive
    batches of the same stream reuse one executable; n_lvl keeps each
    picture's true depth so the wavefront while_loop never runs padded
    levels."""
    xs = {}
    for k in _SEQ_KEYS:
        xs[k] = np.stack([np.asarray(getattr(p, k), np.int32)
                          for p in plans])
    if wf_mode is None:
        wf_mode = wf_mode_for(plans[0].size_log2)
    if wf_mode == "tile":
        wfs = [_plan_zslots(p) for p in plans]
        for i, k in enumerate(("fzl", "fzc", "actm")):
            xs[k] = np.stack([t[i] for t in wfs])
    else:
        lvs = [_plan_levels(p) for p in plans]
        buckets = (
            _ceil_pow2(max(max(t[0].shape[0], t[2].shape[0])
                           for t in lvs)),
            _ceil_pow2(max(t[0].shape[1] for t in lvs)),
            _ceil_pow2(max(t[1].shape[1] for t in lvs)),
            _ceil_pow2(max(t[2].shape[1] for t in lvs)),
            _ceil_pow2(max(t[3].shape[1] for t in lvs)),
        )
        padded = [_pad_levels(*t, buckets=buckets) for t in lvs]
        xs["lv_ls"] = np.stack([p[0] for p in padded])
        xs["lv_lb"] = np.stack([p[1] for p in padded])
        xs["lv_cs"] = np.stack([p[2] for p in padded])
        xs["lv_cb"] = np.stack([p[3] for p in padded])
        xs["n_lvl"] = np.array([p[4] for p in padded], np.int32)
    K = _ceil_pow2(max(1, max(len(p.used_slots()) for p in plans)))
    mcu = [_plan_mcu(p, K) for p in plans]
    xs["mc_used"] = np.stack([t[0] for t in mcu])
    xs["mc_remap"] = np.stack([t[1] for t in mcu])
    xs["cur_idx"] = np.array([p.cur_idx for p in plans], np.int32)
    return xs


def _ceil_pow2(v):
    r = 1
    while r < v:
        r *= 2
    return r


@functools.lru_cache(maxsize=16)
def _jitted_recon_seq(H, W, strong_en, has_sao, deblock, ctb_log2,
                      pic_w, pic_h, wf_mode="level"):
    import jax

    fn = functools.partial(_recon_seq, H=H, W=W, strong_en=strong_en,
                           has_sao=has_sao, deblock=deblock,
                           ctb_log2=ctb_log2, pic_w=pic_w, pic_h=pic_h,
                           wf_mode=wf_mode)
    return jax.jit(fn, donate_argnums=(0, 1, 2))


class H265SeqPhaseB:
    """Device-resident frame pool + batched multi-picture H.265 Phase B
    (the H.264 BatchedPhaseB analog): each run_async dispatches one
    lax.scan graph over the batch with the pool carried on device."""

    def __init__(self, H, W, pool_size, ctb_log2, pic_w, pic_h):
        import jax
        import jax.numpy as jnp

        self.H, self.W = H, W
        self.ctb_log2, self.pic_w, self.pic_h = ctb_log2, pic_w, pic_h

        @jax.jit
        def _mk():
            return (jnp.zeros((pool_size, H, W), jnp.uint8),
                    jnp.zeros((pool_size, H >> 1, W >> 1), jnp.uint8),
                    jnp.zeros((pool_size, H >> 1, W >> 1), jnp.uint8))

        self.pool = _mk()

    def run_async(self, plans):
        if any(p.multi_slice for p in plans):
            raise NotImplementedError(
                "multi-slice pictures dispatch via run_async_one")
        wf_mode = wf_mode_for(self.ctb_log2)
        xs = stack_plans(plans, wf_mode)
        deblock = bool(xs["dbv"][..., 0].any() or xs["dbh"][..., 0].any()
                       or (xs["dbcv"] >= 0).any()
                       or (xs["dbch"] >= 0).any())
        strong_en = any(bool(p.strong_intra) for p in plans)
        has_sao = any(bool(p.has_sao) for p in plans)
        fn = _jitted_recon_seq(self.H, self.W, strong_en, has_sao,
                               deblock, self.ctb_log2, self.pic_w,
                               self.pic_h, wf_mode)
        self.pool, outs = fn(self.pool[0], self.pool[1], self.pool[2],
                             xs)
        return outs

    def run_async_one(self, plan):
        """One MULTI-SLICE picture against the device pool (the per-
        segment deblock+SAO replay is jit-keyed on the slice-row
        tuple, so it cannot ride the batched scan; the reference
        replays the whole-frame SAO pass once per slice segment,
        h265.cpp:4849-4866). Returns outs shaped like a batch of 1."""
        multi = plan.multi_slice and len(plan.slice_rows) > 1
        if plan.multi_slice and (not plan.slice_aligned or not multi):
            raise NotImplementedError(
                "mid-row slice-segment starts keep the Python path "
                "(reference chroma-base domain)")
        wf_mode = wf_mode_for(self.ctb_log2)
        wf = plan_wf(plan, wf_mode)
        (dbv, dbh, dbcv, dbch, sao_idx, sao_opt,
         sao_off) = _slice_masked_maps(plan)
        slices = tuple(zip(plan.slice_rows,
                           list(plan.slice_rows[1:]) + [plan.rows]))
        deblock = bool(dbv[..., 0].any() or dbh[..., 0].any()
                       or (dbcv >= 0).any() or (dbch >= 0).any())
        fn = _jitted_recon_one(self.H, self.W, bool(plan.strong_intra),
                               bool(plan.has_sao), deblock,
                               self.ctb_log2, self.pic_w, self.pic_h,
                               slices, wf_mode)
        mcu, mcr = _plan_mcu(plan)
        self.pool, outs = fn(
            self.pool[0], self.pool[1], self.pool[2], plan.coef_y,
            plan.tu_y, plan.coef_cb, plan.tu_cb, plan.coef_cr,
            plan.tu_cr, plan.slot.astype(np.int32),
            plan.mv.astype(np.int32), mcu, mcr, wf,
            dbv.astype(np.int32), dbh.astype(np.int32),
            dbcv.astype(np.int32), dbch.astype(np.int32), sao_idx,
            sao_opt, sao_off, np.int32(plan.cur_idx))
        return outs


@functools.lru_cache(maxsize=32)
def _jitted_recon_one(H, W, strong_en, has_sao, deblock, ctb_log2,
                      pic_w, pic_h, slices, wf_mode="level"):
    """Single-picture Phase B against the DEVICE pool (multi-slice
    pictures inside a turbo stream; jit-keyed on the slice-row
    tuple)."""
    import jax

    def fn(pool_y, pool_cb, pool_cr, coef_y, tu_y, coef_cb, tu_cb,
           coef_cr, tu_cr, slot, mv, mc_used, mc_remap, wf, dbv, dbh,
           dbcv, dbch, sao_idx, sao_opt, sao_off, cur_idx):
        import jax.numpy as jnp

        from m2dec_tpu.codecs.h264.reconstruct import (
            _fuse_break,
            _pool_write,
        )

        y, cb, cr = _recon_picture(
            coef_y, tu_y, coef_cb, tu_cb, coef_cr, tu_cr, slot, mv,
            mc_used, mc_remap, wf, dbv, dbh, dbcv, dbch,
            sao_idx, sao_opt,
            sao_off, pool_y, pool_cb, pool_cr, cur_idx, H=H, W=W,
            strong_en=strong_en, has_sao=has_sao, deblock=deblock,
            ctb_log2=ctb_log2, pic_w=pic_w, pic_h=pic_h, slices=slices,
            wf_mode=wf_mode)
        y, cb, cr = _fuse_break(y, cb, cr)
        py = _pool_write(pool_y, y, cur_idx, jnp)
        pcb = _pool_write(pool_cb, cb, cur_idx, jnp)
        pcr = _pool_write(pool_cr, cr, cur_idx, jnp)
        return (py, pcb, pcr), (y[None], cb[None], cr[None])

    return jax.jit(fn, donate_argnums=(0, 1, 2))
