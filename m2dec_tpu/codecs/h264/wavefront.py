"""Skewed-storage wavefront scheduling for the H.264 Phase-B intra and
deblocking passes.

The reference decodes MBs strictly raster-sequentially (slice_data loop,
src/lib/h264.cpp:10210-10251; deblock_pb, h264.cpp:10540-10663). The
left/top/top-right dependence structure licenses an anti-diagonal
wavefront d = mbx + 2*mby (SURVEY §5.7). reconstruct.py's original scan
gathered each lane's neighbor window with per-lane index math — dozens
of device ops per step, all latency-bound.

This module stores the picture SKEWED: MB (mbx, mby) lives at column
block d = mbx + 2*mby (pixel column d*16 + margin) of a wide plane.
Under that layout one whole diagonal — and everything it reads —
is a CONTIGUOUS slab:

* the MBs of diagonal d occupy rows mby*16..mby*16+16 (contiguous over
  the diagonal's contiguous mby range) at columns d*16..d*16+16;
* the left neighbor (mbx-1, mby) has the same row skew, so it sits at
  columns (d-1)*16 immediately left;
* the top / top-left / top-right neighbors' bottom rows land at fixed
  column offsets (d-2)*16 / (d-3)*16+15 / (d-1)*16 one pixel row up.

Each scan step is then ONE dynamic slice + reshapes (lane l's window is
rows l*16.. of the slab) + the mode/filter math + ONE (luma; three for
deblock) dynamic update, instead of per-lane gathers.

Slab layouts (margins chosen so every read/write of every diagonal is
in bounds; dead band cells hold zeros and are written back unchanged):

  luma plane  [16 + H + 16, 48 + nd*16 + 64]
  chroma      [ 8 + H/2 + 8, 24 + nd*8 + 16]

Per-diagonal metadata (modes, residuals, deblock params) is gathered
once per picture into diagonal-major [nd, Lmax, ...] tensors, so scan
steps slice instead of gather. Lanes are numbered from a clamped base
row mby0[d] = min(first mby of d, mb_h - Lmax + 1) so the fixed-height
slab never leaves the plane.
"""

from __future__ import annotations

import functools

import numpy as np

#: bottom margins cover the clamped lane base: the last diagonal's
#: lanes may run one MB row past the picture
ML, MR, MT, MB_ = 48, 64, 16, 16       # luma margins
MLC, MRC, MTC, MBC = 24, 16, 8, 8      # chroma margins


@functools.lru_cache(maxsize=32)
def get_geom(mb_w, mb_h):
    """Host-side skew geometry for one picture shape."""
    nd = mb_w + 2 * mb_h - 2
    n = mb_w * mb_h
    mbymin = np.maximum(0, -(-(np.arange(nd) - mb_w + 1) // 2))
    mbymax = np.minimum(mb_h - 1, np.arange(nd) // 2)
    lmax = int((mbymax - mbymin + 1).max())
    mby0 = np.minimum(mbymin, mb_h - lmax + 1).astype(np.int32)
    lanes = mby0[:, None] + np.arange(lmax)[None, :]   # [nd, L] mby
    mbx = np.arange(nd)[:, None] - 2 * lanes
    valid = (mbx >= 0) & (mbx < mb_w) & (lanes < mb_h)
    lane2mb = np.where(valid, lanes * mb_w + mbx, n).astype(np.int32)
    # skew/unskew tile index tables
    dblk = np.arange(nd)[None, :]
    mbyv = np.arange(mb_h)[:, None]
    sx = dblk - 2 * mbyv
    gidx = np.where((sx >= 0) & (sx < mb_w), mbyv * mb_w + sx,
                    n).astype(np.int32)                 # [mb_h, nd]
    uidx = (np.arange(mb_w)[None, :]
            + 2 * np.arange(mb_h)[:, None]).astype(np.int32)  # [mb_h,mb_w]
    d = np.arange(nd, dtype=np.int32)
    bases = {
        # intra slabs: [Lmax*16+1, 57] luma / [Lmax*8+1, 25] chroma
        "irY": mby0 * 16 + (MT - 1), "icY": d * 16 + (ML - 33),
        "irC": mby0 * 8 + (MTC - 1), "icC": d * 8 + (MLC - 17),
        # deblock own slabs: [Lmax*16, 20] luma / [Lmax*8, 10] chroma
        "orY": mby0 * 16 + MT, "ocY": d * 16 + (ML - 4),
        "orC": mby0 * 8 + MTC, "occ": d * 8 + (MLC - 2),
        # deblock top slabs: [Lmax*16, 16] luma / [Lmax*8, 8] chroma
        "trY": mby0 * 16, "tcY": d * 16 + (ML - 32),
        "trC": mby0 * 8, "tcC": d * 8 + (MLC - 16),
    }
    return {"nd": nd, "lmax": lmax, "lane2mb": lane2mb, "gidx": gidx,
            "uidx": uidx, "mb_h": mb_h,
            "bases": {k: v.astype(np.int32)
                      for k, v in bases.items()}}


# ---------------------------------------------------------------------
# skew / unskew (tile-granular gathers; dead cells zero)
# ---------------------------------------------------------------------


def _gb(xp, *xs):
    """Materialization barrier around gather operands/results (see
    reconstruct._fuse_break). Identity on numpy."""
    if xp is np:
        return xs[0] if len(xs) == 1 else xs
    import jax

    out = jax.lax.optimization_barrier(xs)
    return out[0] if len(xs) == 1 else out


def skew_plane(plane, gidx, blk, margins, xp):
    """[H, W] -> skewed [mt + H + mb, ml + nd*blk + mr]."""
    mt, mb_, ml, mr = margins
    mb_h = gidx.shape[0]
    nd = gidx.shape[1]
    H, W = plane.shape
    tiles = plane.reshape(mb_h, blk, W // blk, blk).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(-1, blk, blk)
    tiles = xp.concatenate(
        [tiles, xp.zeros((1, blk, blk), tiles.dtype)], axis=0)
    tiles = _gb(xp, tiles)
    sk = _gb(xp, tiles[gidx.reshape(-1)]).reshape(mb_h, nd, blk, blk)
    sk = sk.transpose(0, 2, 1, 3).reshape(mb_h * blk, nd * blk)
    return xp.pad(sk, ((mt, mb_), (ml, mr)))


def unskew_plane(sk, uidx, blk, margins, xp):
    """Inverse of skew_plane -> [H, W]."""
    mt, mb_, ml, mr = margins
    mb_h, mb_w = uidx.shape
    core = sk[mt : mt + mb_h * blk, ml : sk.shape[1] - mr]
    nd = core.shape[1] // blk
    tiles = core.reshape(mb_h, blk, nd, blk).transpose(0, 2, 1, 3)
    tiles = _gb(xp, tiles)
    out = _gb(xp, tiles[np.arange(mb_h)[:, None], uidx])  # [mb_h,mb_w,b,b]
    return out.transpose(0, 2, 1, 3).reshape(mb_h * blk, mb_w * blk)


def skew_luma(plane, g, xp):
    return skew_plane(plane, g["gidx"], 16, (MT, MB_, ML, MR), xp)


def skew_chroma(plane, g, xp):
    return skew_plane(plane, g["gidx"], 8, (MTC, MBC, MLC, MRC), xp)


def unskew_luma(sk, g, xp):
    return unskew_plane(sk, g["uidx"], 16, (MT, MB_, ML, MR), xp)


def unskew_chroma(sk, g, xp):
    return unskew_plane(sk, g["uidx"], 8, (MTC, MBC, MLC, MRC), xp)


# ---------------------------------------------------------------------
# diagonal-major metadata
# ---------------------------------------------------------------------

_INTRA_KEYS = ("kind", "res_y", "res_c", "i4_modes", "i4_avail",
               "i16_mode", "chroma_mode", "mb_avail")
_I8_KEYS = ("i8_modes", "i8_avail")
_DEB_KEYS = ("deb_str", "deb_str4", "deb_ab")


def diag_gather(P, g, has_i8, deblock, xp):
    """Gather plan tensors into diagonal-major [nd, Lmax, ...] (invalid
    lanes -> appended zero row: kind 0 skips intra writes, zero deblock
    strengths skip filtering)."""
    tab = g["lane2mb"]
    idx = tab.reshape(-1)
    lmax = tab.shape[1]
    keys = _INTRA_KEYS + (_I8_KEYS if has_i8 else ()) + (
        _DEB_KEYS if deblock else ())
    out = {}
    for k in keys:
        v = P[k]
        ext = xp.concatenate(
            [v, xp.zeros((1,) + v.shape[1:], v.dtype)], axis=0)
        ext = _gb(xp, ext)
        out[k] = _gb(xp, ext[idx]).reshape((g["nd"], lmax) + v.shape[1:])
    return out


# ---------------------------------------------------------------------
# window assembly from slabs
# ---------------------------------------------------------------------


def _slab_windows(slab, lmax, rows, xp):
    """[Lmax*rows+1, C] slab -> [Lmax, rows+1, C] per-lane windows
    (window row 0 = the row above the lane's tile; adjacent windows
    share that row)."""
    C = slab.shape[1]
    body = slab[: lmax * rows].reshape(lmax, rows, C)
    # row `rows` of each window (= next window's row 0) by a shifted
    # reshape instead of a strided slice
    tail = xp.concatenate(
        [slab[rows:], xp.zeros((rows - 1, C), slab.dtype)], axis=0)
    last = tail.reshape(lmax, rows, C)[:, 0:1]
    return xp.concatenate([body, last], axis=1)


def intra_windows_luma(slab, lmax, xp):
    """[Lmax*16+1, 57] -> Ty [Lmax, 17, 25] in reconstruct._intra_step's
    window layout (row 0: corner+top+topright; rows 1..16: left+tile).

    _slab_windows row 0 is already the row above the tile (the slab
    starts one pixel row above lane 0's MB)."""
    win = _slab_windows(slab, lmax, 16, xp)
    a, b = win[:, 0:1, 0:25], win[:, 1:17, 32:57]
    return xp.concatenate([a, b], axis=1)


def intra_windows_chroma(slab, lmax, xp):
    """[Lmax*8+1, 25] -> Tc [Lmax, 9, 9]."""
    win = _slab_windows(slab, lmax, 8, xp)
    a, b = win[:, 0:1, 0:9], win[:, 1:9, 16:25]
    return xp.concatenate([a, b], axis=1)


# ---------------------------------------------------------------------
# scan drivers
# ---------------------------------------------------------------------


def _intra_step_skewed(carry, xs, lmax, has_i8, xp, P_const=None,
                       stream_offs=((0, 0),)):
    """One diagonal of the intra wavefront on skewed planes.

    stream_offs: per-stream (luma_row_offset, chroma_row_offset) for
    vertically stacked streams; lanes of all streams concatenate so the
    mode math runs once per step."""
    import jax

    y, cb, cr = carry
    P = xs["P"] if P_const is None else P_const
    S = len(stream_offs)
    # slab planes may be carried as uint8 (quarter the scan's
    # read/write traffic); window math runs in int32 locally
    slabs_y, slabs_c = [], []
    for oy, oc in stream_offs:
        slabs_y.append(jax.lax.dynamic_slice(
            y, (xs["irY"] + oy, xs["icY"]),
            (lmax * 16 + 1, 57)).astype(xp.int32))
        slabs_c.append((jax.lax.dynamic_slice(
            cb, (xs["irC"] + oc, xs["icC"]),
            (lmax * 8 + 1, 25)).astype(xp.int32),
            jax.lax.dynamic_slice(
                cr, (xs["irC"] + oc, xs["icC"]),
                (lmax * 8 + 1, 25)).astype(xp.int32)))
    Ty = xp.concatenate(
        [intra_windows_luma(s, lmax, xp) for s in slabs_y], axis=0)
    Tcb = xp.concatenate(
        [intra_windows_chroma(s[0], lmax, xp) for s in slabs_c], axis=0)
    Tcr = xp.concatenate(
        [intra_windows_chroma(s[1], lmax, xp) for s in slabs_c], axis=0)

    tile, out_cb, out_cr, is_intra = intra_compute(
        Ty, Tcb, Tcr, P, has_i8, xp)

    tile = xp.where(is_intra[:, None, None], tile, Ty[:, 1:17, 1:17])
    out_cb = xp.where(is_intra[:, None, None], out_cb, Tcb[:, 1:9, 1:9])
    out_cr = xp.where(is_intra[:, None, None], out_cr, Tcr[:, 1:9, 1:9])

    L = lmax
    for s, (oy, oc) in enumerate(stream_offs):
        ty = tile[s * L : (s + 1) * L].reshape(L * 16, 16)
        y = jax.lax.dynamic_update_slice(
            y, ty.astype(y.dtype), (xs["irY"] + oy + 1, xs["icY"] + 33))
        tb = out_cb[s * L : (s + 1) * L].reshape(L * 8, 8)
        cb = jax.lax.dynamic_update_slice(
            cb, tb.astype(cb.dtype), (xs["irC"] + oc + 1,
                                      xs["icC"] + 17))
        tr = out_cr[s * L : (s + 1) * L].reshape(L * 8, 8)
        cr = jax.lax.dynamic_update_slice(
            cr, tr.astype(cr.dtype), (xs["irC"] + oc + 1,
                                      xs["icC"] + 17))
    return (y, cb, cr), None


def upd(a, v, starts, xp):
    """Static-slice functional update of a [L, h, w] value by slice
    concatenation (XLA folds it back into an in-place update)."""
    s0, s1, s2 = starts
    assert s0 == 0 and v.shape[0] == a.shape[0]
    h, w = v.shape[1], v.shape[2]
    if v.dtype != a.dtype:
        v = v.astype(a.dtype)
    band = a[:, s1 : s1 + h]
    parts = []
    if s2:
        parts.append(band[:, :, :s2])
    parts.append(v)
    if s2 + w < a.shape[2]:
        parts.append(band[:, :, s2 + w :])
    band = xp.concatenate(parts, axis=2) if len(parts) > 1 else v
    parts = []
    if s1:
        parts.append(a[:, :s1])
    parts.append(band)
    if s1 + h < a.shape[1]:
        parts.append(a[:, s1 + h :])
    return xp.concatenate(parts, axis=1) if len(parts) > 1 else band


def intra_compute(Ty, Tcb, Tcr, P, has_i8, xp):
    """The per-diagonal intra mode math on assembled windows.

    Ty [L,17,25], Tcb/Tcr [L,9,9]; P fields [L, ...]. Returns
    (luma tile [L,16,16], cb [L,8,8], cr [L,8,8], is_intra [L])."""
    tile, is_intra = intra_luma_compute(Ty, P, has_i8, xp)
    ocb, ocr = intra_chroma_compute(Tcb, Tcr, P, xp)
    return tile, ocb, ocr, is_intra


def intra_luma_compute(Ty, P, has_i8, xp):
    """Luma half of the intra mode math -> (tile [L,16,16],
    is_intra [L])."""
    from .reconstruct import (
        _ZORDER,
        intra4_modes,
        intra8_modes,
        intra16_modes,
    )

    kind = P["kind"]
    res = P["res_y"]
    mb_avail = P["mb_avail"]

    def clip(v):
        return xp.clip(v, 0, 255)

    T4 = Ty
    i4m = P["i4_modes"]
    i4a = P["i4_avail"]
    for oy, ox in _ZORDER:
        blk = (oy >> 2) * 4 + (ox >> 2)
        t = T4[:, oy, 1 + ox : 9 + ox]
        ll = T4[:, 1 + oy : 5 + oy, ox]
        c = T4[:, oy, ox]
        out = intra4_modes(ll, t, c, i4a[:, blk], i4m[:, blk], xp)
        out = clip(out + res[:, oy : oy + 4, ox : ox + 4])
        T4 = upd(T4, out, (0, 1 + oy, 1 + ox), xp)
    tile = T4[:, 1:17, 1:17]

    if has_i8:
        i8m = P["i8_modes"]
        i8a = P["i8_avail"]
        T8 = Ty
        for b in range(4):
            oy, ox = (b >> 1) * 8, (b & 1) * 8
            t = T8[:, oy, 1 + ox : 9 + ox]
            tr = T8[:, oy, 9 + ox : 17 + ox]
            ll = T8[:, 1 + oy : 9 + oy, ox]
            c = T8[:, oy, ox]
            out = intra8_modes(t, ll, c, tr, i8a[:, b], i8m[:, b], xp)
            out = clip(out + res[:, oy : oy + 8, ox : ox + 8])
            T8 = upd(T8, out, (0, 1 + oy, 1 + ox), xp)
        tile = xp.where((kind == 2)[:, None, None], T8[:, 1:17, 1:17],
                        tile)

    t16 = Ty[:, 0, 1:17]
    l16 = Ty[:, 1:17, 0]
    c16 = Ty[:, 0, 0]
    out16 = clip(intra16_modes(l16, t16, c16, mb_avail,
                               P["i16_mode"], xp) + res)
    tile = xp.where((kind == 3)[:, None, None], out16, tile)
    return tile, (kind >= 1) & (kind <= 3)


def intra_chroma_compute(Tcb, Tcr, P, xp):
    """Chroma half of the intra mode math -> (cb, cr) [L,8,8]."""
    from .reconstruct import intra_chroma_modes

    res_c = P["res_c"]
    mb_avail = P["mb_avail"]
    cmode = P["chroma_mode"]
    outs = []
    for ci, Tc in enumerate((Tcb, Tcr)):
        t8 = Tc[:, 0, 1:9]
        l8 = Tc[:, 1:9, 0]
        cc = Tc[:, 0, 0]
        outs.append(xp.clip(
            intra_chroma_modes(l8, t8, cc, mb_avail, cmode, xp)
            + res_c[:, ci], 0, 255))
    return outs[0], outs[1]


def deblock_compute(Wy, Wcb, Wcr, P, xp, tabs):
    """The per-diagonal deblock edge loops on assembled [L,20,20] /
    [L,12,12] windows (reference edge order: all vertical edges then all
    horizontal edges per MB, h264.cpp:10540-10663)."""
    Wy = deblock_luma_compute(Wy, P, xp, tabs)
    Wcb, Wcr = deblock_chroma_compute(Wcb, Wcr, P, xp, tabs)
    return Wy, Wcb, Wcr


def deblock_luma_compute(Wy, P, xp, tabs):
    from .reconstruct import _edge_params, _filter_lines_luma

    alpha_t, beta_t, tc0_t = tabs
    dstr = P["deb_str"]
    dab = P["deb_ab"]
    d4 = P["deb_str4"]
    for axis in (0, 1):
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
                Wy = upd(Wy, _filter_lines_luma(cols, s, al, be, tc0,
                                                xp), (0, 4, c0), xp)
            else:
                rows = xp.swapaxes(Wy[:, c0 : c0 + 8, 4:20], 1, 2)
                out = _filter_lines_luma(rows, s, al, be, tc0, xp)
                Wy = upd(Wy, xp.swapaxes(out, 1, 2), (0, c0, 4), xp)
    return Wy


def deblock_chroma_compute(Wcb, Wcr, P, xp, tabs):
    from .reconstruct import _edge_params, _filter_lines_chroma

    alpha_t, beta_t, tc0_t = tabs
    dstr = P["deb_str"]
    dab = P["deb_ab"]
    d4 = P["deb_str4"]
    for axis in (0, 1):
        sb = dstr[:, axis]
        ab = dab[:, axis]
        zero = xp.zeros_like(d4[:, axis])
        for e in (0, 2):
            abrow = 1 if e == 0 else 4
            str4c = d4[:, axis] if e == 0 else zero
            for ci in range(2):
                Wc = Wcb if ci == 0 else Wcr
                s, al, be, tc0 = _edge_params(
                    sb[:, e], str4c, ab[:, abrow + ci], 8, 1,
                    alpha_t, beta_t, tc0_t, xp)
                cc0 = 2 + 4 * (e >> 1)
                if axis == 0:
                    cols = Wc[:, 4:12, cc0 : cc0 + 4]
                    Wc = upd(Wc, _filter_lines_chroma(
                        cols, s, al, be, tc0, xp), (0, 4, cc0), xp)
                else:
                    rows = xp.swapaxes(Wc[:, cc0 : cc0 + 4, 4:12],
                                       1, 2)
                    out = _filter_lines_chroma(rows, s, al, be, tc0,
                                               xp)
                    Wc = upd(Wc, xp.swapaxes(out, 1, 2),
                             (0, cc0, 4), xp)
                if ci == 0:
                    Wcb = Wc
                else:
                    Wcr = Wc
    return Wcb, Wcr



def _deblock_step_skewed(carry, xs, lmax, xp, tabs, P_const=None,
                         stream_offs=((0, 0),)):
    """One diagonal of the deblocking wavefront on skewed planes.

    Reads per stream: the own slab (left strip + tile, contiguous
    because the left neighbor shares the row skew) and the top slab
    (the top neighbor's tile column two blocks left)."""
    import jax

    y, cb, cr = carry
    P = xs["P"] if P_const is None else P_const
    L = lmax
    owns, tops, ownsc, topsc = [], [], [], []
    for oy, oc in stream_offs:
        owns.append(jax.lax.dynamic_slice(
            y, (xs["orY"] + oy, xs["ocY"]), (L * 16, 20))
            .astype(xp.int32))
        tops.append(jax.lax.dynamic_slice(
            y, (xs["trY"] + oy, xs["tcY"]), (L * 16, 16))
            .astype(xp.int32))
        ownsc.append((jax.lax.dynamic_slice(
            cb, (xs["orC"] + oc, xs["occ"]), (L * 8, 10))
            .astype(xp.int32),
            jax.lax.dynamic_slice(
                cr, (xs["orC"] + oc, xs["occ"]), (L * 8, 10))
            .astype(xp.int32)))
        topsc.append((jax.lax.dynamic_slice(
            cb, (xs["trC"] + oc, xs["tcC"]), (L * 8, 8))
            .astype(xp.int32),
            jax.lax.dynamic_slice(
                cr, (xs["trC"] + oc, xs["tcC"]), (L * 8, 8))
            .astype(xp.int32)))

    def luma_window(own, top):
        ownr = own.reshape(L, 16, 20)
        topr = top.reshape(L, 16, 16)
        hdr = xp.concatenate(
            [xp.zeros((L, 4, 4), own.dtype), topr[:, 12:16]], axis=2)
        return xp.concatenate([hdr, ownr], axis=1), topr

    def chroma_window(own, top):
        ownr = own.reshape(L, 8, 10)
        ownr = xp.concatenate(
            [xp.zeros((L, 8, 2), own.dtype), ownr], axis=2)
        topr = top.reshape(L, 8, 8)
        hdr = xp.concatenate(
            [xp.zeros((L, 2, 4), own.dtype), topr[:, 6:8]], axis=2)
        hdr = xp.concatenate(
            [xp.zeros((L, 2, 12), own.dtype), hdr], axis=1)
        return xp.concatenate([hdr, ownr], axis=1), topr

    wys, typs, wcbs, wcrs, tcbs, tcrs = [], [], [], [], [], []
    for s in range(len(stream_offs)):
        wy, ty = luma_window(owns[s], tops[s])
        wcb, tcb = chroma_window(ownsc[s][0], topsc[s][0])
        wcr, tcr = chroma_window(ownsc[s][1], topsc[s][1])
        wys.append(wy)
        typs.append(ty)
        wcbs.append(wcb)
        wcrs.append(wcr)
        tcbs.append(tcb)
        tcrs.append(tcr)
    Wy = xp.concatenate(wys, axis=0)
    Wcb = xp.concatenate(wcbs, axis=0)
    Wcr = xp.concatenate(wcrs, axis=0)

    Wy, Wcb, Wcr = deblock_compute(Wy, Wcb, Wcr, P, xp, tabs)

    for s, (oy, oc) in enumerate(stream_offs):
        wy = Wy[s * L : (s + 1) * L]
        y = jax.lax.dynamic_update_slice(
            y, wy[:, 4:20].reshape(L * 16, 20).astype(y.dtype),
            (xs["orY"] + oy, xs["ocY"]))
        ty = upd(typs[s], wy[:, 0:4, 4:20], (0, 12, 0), xp)
        y = jax.lax.dynamic_update_slice(
            y, ty.reshape(L * 16, 16).astype(y.dtype),
            (xs["trY"] + oy, xs["tcY"]))
        for ci, (pl, tp) in enumerate(((Wcb, tcbs), (Wcr, tcrs))):
            wc = pl[s * L : (s + 1) * L]
            tgt = cb if ci == 0 else cr
            tgt = jax.lax.dynamic_update_slice(
                tgt, wc[:, 4:12, 2:12].reshape(L * 8, 10)
                .astype(tgt.dtype), (xs["orC"] + oc, xs["occ"]))
            tc = upd(tp[s], wc[:, 2:4, 4:12], (0, 6, 0), xp)
            tgt = jax.lax.dynamic_update_slice(
                tgt, tc.reshape(L * 8, 8).astype(tgt.dtype),
                (xs["trC"] + oc, xs["tcC"]))
            if ci == 0:
                cb = tgt
            else:
                cr = tgt
    return (y, cb, cr), None


def intra_scan(sky, skcb, skcr, Pd, g, has_i8, xp, stream_offs=((0, 0),)):
    """Run the intra wavefront over skewed planes (lax.scan over
    diagonals)."""
    import jax

    b = g["bases"]
    xs = {"P": Pd, "irY": xp.asarray(b["irY"]),
          "icY": xp.asarray(b["icY"]), "irC": xp.asarray(b["irC"]),
          "icC": xp.asarray(b["icC"])}

    def step(carry, x):
        return _intra_step_skewed(carry, x, g["lmax"], has_i8, xp,
                                  stream_offs=stream_offs)

    (sky, skcb, skcr), _ = jax.lax.scan(step, (sky, skcb, skcr), xs)
    return sky, skcb, skcr


def deblock_scan(sky, skcb, skcr, Pd, g, xp, tabs,
                 stream_offs=((0, 0),)):
    import jax

    b = g["bases"]
    xs = {"P": Pd, "orY": xp.asarray(b["orY"]),
          "ocY": xp.asarray(b["ocY"]), "orC": xp.asarray(b["orC"]),
          "occ": xp.asarray(b["occ"]), "trY": xp.asarray(b["trY"]),
          "tcY": xp.asarray(b["tcY"]), "trC": xp.asarray(b["trC"]),
          "tcC": xp.asarray(b["tcC"])}

    def step(carry, x):
        return _deblock_step_skewed(carry, x, g["lmax"], xp, tabs,
                                    stream_offs=stream_offs)

    (sky, skcb, skcr), _ = jax.lax.scan(step, (sky, skcb, skcr), xs)
    return sky, skcb, skcr
