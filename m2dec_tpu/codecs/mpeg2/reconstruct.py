"""MPEG-1/2 Phase-B reconstruction: batched IDCT + MC + assembly.

Consumes a PicturePlan (codecs/mpeg2/entropy.py) and the two reference
frames, reconstructs the full picture with dense batched integer kernels —
the data-parallel replacement for the reference's per-macroblock interleaved
reconstruction (reference: src/lib/mpeg2.cpp:1136-1396 block parse+idct+MC
call sites; kernels in idct.cpp / motioncomp.cpp).

Everything here is shape-static per sequence (N = mb_w*mb_h macroblocks),
runs under `jax.jit`, and is bit-exact with the reference:
* IDCT semantics from kernels/mpeg2_idct.py;
* half-pel MC semantics from kernels/mpeg2_mc.py;
* store rules: intra = clip(idct) (ClipStore, idct.cpp:364-370), inter =
  clip(pred + idct) (AddStore, idct.cpp:375-382); non-coded inter blocks
  have all-zero coefficients, whose IDCT is identically zero, so a single
  fused formula covers coded and non-coded blocks;
* field-DCT luma row interleave (LUMA_BLOCK_OFFSET, mpeg2.cpp:1120).
"""

from __future__ import annotations

import functools

import numpy as np

from m2dec_tpu.kernels.mpeg2_idct import idct8x8
from m2dec_tpu.kernels import mpeg2_mc as mc


def reconstruct_arrays(
    intra, fwd, bwd, mvf, mvb, dct_type, coef,
    ref0_y, ref0_cb, ref0_cr, ref1_y, ref1_cb, ref1_cr,
    *, mb_w, mb_h, xp,
    mvf2=None, mvb2=None, fsel=None, fieldmc=None,
):
    """Pure-array reconstruction; runs under numpy or jax.numpy.

    Frame planes are uint8 [H, W] (luma) / [H/2, W/2] (chroma), already
    padded to macroblock multiples. Returns (y, cb, cr) uint8 planes.
    """
    n = mb_w * mb_h
    i32 = xp.int32
    idx = xp.arange(n, dtype=i32)
    mbx = idx % mb_w
    mby = idx // mb_w

    fwd3 = fwd[:, None, None]
    bwd3 = bwd[:, None, None]

    has_field = fieldmc is not None

    def combine(pf, pb):
        both = mc.combine_bidir(pf, pb)
        return xp.where(fwd3 & bwd3, both, xp.where(bwd3, pb, pf))

    if xp is np:
        # per-pixel gather path: the executable spec
        def pad1(p):
            return xp.pad(p.astype(i32), ((0, 1), (0, 1)), mode="edge")

        r0y, r0cb, r0cr = pad1(ref0_y), pad1(ref0_cb), pad1(ref0_cr)
        r1y, r1cb, r1cr = pad1(ref1_y), pad1(ref1_cb), pad1(ref1_cr)

        def pred_plane(rf, rb, predfn, fieldfn):
            pf = predfn(rf, mvf[:, 0], mvf[:, 1], mbx, mby, xp)
            pb = predfn(rb, mvb[:, 0], mvb[:, 1], mbx, mby, xp)
            if has_field:
                # field MC in frame pictures (motion_type=1)
                pf_f = fieldfn(rf, mvf, mvf2, fsel & 3, mbx, mby, xp)
                pb_f = fieldfn(rb, mvb, mvb2, (fsel >> 2) & 3, mbx,
                               mby, xp)
                fm3 = fieldmc[:, None, None]
                pf = xp.where(fm3, pf_f, pf)
                pb = xp.where(fm3, pb_f, pb)
            return combine(pf, pb)

        pred_y = pred_plane(r0y, r1y, mc.luma_pred, mc.luma_pred_field)
        pred_cb = pred_plane(r0cb, r1cb, mc.chroma_pred,
                             mc.chroma_pred_field)
        pred_cr = pred_plane(r0cr, r1cr, mc.chroma_pred,
                             mc.chroma_pred_field)
    else:
        # device path: one uint32-word window per (MB, ref) instead of
        # 4 gathered elements per pixel (see mpeg2_mc's word-window
        # variants).
        # Conformant-MV assumption (advisor r4): the window path clamps
        # only the window BASE to the picture, whereas the numpy spec
        # path clamps per pixel — MVs referencing outside the picture
        # (non-conformant per ISO 13818-2 7.6.3.8, and UB in the
        # reference, which reads out of its frame heap) may diverge
        # from the spec path here; in-picture MVs are bit-identical
        from m2dec_tpu.codecs.h264.reconstruct import _fuse_break

        def padw(p):
            H, W = p.shape
            pr = ((W + 17 + 3) // 4) * 4 - W
            return xp.pad(p, ((0, 17), (0, pr)), mode="edge")[None]

        (r0y, r0cb, r0cr, r1y, r1cb, r1cr) = _fuse_break(
            padw(ref0_y), padw(ref0_cb), padw(ref0_cr),
            padw(ref1_y), padw(ref1_cb), padw(ref1_cr))

        import jax

        Hy, Wy = ref0_y.shape
        Hc, Wc = ref0_cb.shape

        # Direction gating (r5): the window gathers are the dominant
        # per-picture device cost (gather-unit issue-rate bound), and a
        # GOP-batched scan would pay both directions + the field
        # variants on EVERY picture — cond-skip whole prediction
        # directions (I/P pictures have no backward MVs) and the field
        # variants (rare) at run time instead.
        def mk_dir(ry, rcb, rcr, mvd, mvd2, selb, dmask):
            def plain(_):
                return (mc.luma_pred_win(ry, Hy, Wy, mvd[:, 0],
                                         mvd[:, 1], mbx, mby, xp),
                        mc.chroma_pred_win(rcb, Hc, Wc, mvd[:, 0],
                                           mvd[:, 1], mbx, mby, xp),
                        mc.chroma_pred_win(rcr, Hc, Wc, mvd[:, 0],
                                           mvd[:, 1], mbx, mby, xp))

            def with_field(_):
                p = plain(None)
                fv = (mc.luma_pred_field_win(ry, Hy, Wy, mvd, mvd2,
                                             selb, mbx, mby, xp),
                      mc.chroma_pred_field_win(rcb, Hc, Wc, mvd, mvd2,
                                               selb, mbx, mby, xp),
                      mc.chroma_pred_field_win(rcr, Hc, Wc, mvd, mvd2,
                                               selb, mbx, mby, xp))
                fm3 = fieldmc[:, None, None]
                return tuple(xp.where(fm3, a, b)
                             for a, b in zip(fv, p))

            def body(_):
                if not has_field:
                    return plain(None)
                return jax.lax.cond((fieldmc & dmask).any(),
                                    with_field, plain, None)

            z = (xp.zeros((n, 16, 16), i32), xp.zeros((n, 8, 8), i32),
                 xp.zeros((n, 8, 8), i32))
            return jax.lax.cond(dmask.any(), body, lambda _: z, None)

        pfy, pfcb, pfcr = mk_dir(r0y, r0cb, r0cr, mvf, mvf2,
                                 (fsel & 3) if has_field else None,
                                 fwd)
        pby, pbcb, pbcr = mk_dir(r1y, r1cb, r1cr, mvb, mvb2,
                                 ((fsel >> 2) & 3) if has_field
                                 else None, bwd)
        pred_y = combine(pfy, pby)
        pred_cb = combine(pfcb, pbcb)
        pred_cr = combine(pfcr, pbcr)

    # --- residuals ---------------------------------------------------------
    res = idct8x8(coef.reshape(n, 6, 8, 8), xp)  # [N, 6, 8, 8] int32

    # luma assembly: frame DCT = 2x2 block grid; field DCT interleaves rows
    # of the top (blocks 0,1) and bottom (blocks 2,3) half-MB pairs
    # (LUMA_BLOCK_OFFSET semantics, mpeg2.cpp:1120, :1144-1146)
    lb = res[:, :4]  # [N, 4, 8, 8]
    frame_asm = (
        lb.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    )
    top = lb[:, 0:2].transpose(0, 2, 1, 3).reshape(n, 8, 16)
    bot = lb[:, 2:4].transpose(0, 2, 1, 3).reshape(n, 8, 16)
    field_asm = xp.stack([top, bot], axis=2).reshape(n, 16, 16)
    res_y = xp.where((dct_type == 1)[:, None, None], field_asm, frame_asm)
    res_cb = res[:, 4]
    res_cr = res[:, 5]

    # --- combine -----------------------------------------------------------
    def clip(v):
        return xp.clip(v, 0, 255)

    intra3 = intra[:, None, None]
    out_y = xp.where(intra3, clip(res_y), clip(pred_y + res_y))
    out_cb = xp.where(intra3, clip(res_cb), clip(pred_cb + res_cb))
    out_cr = xp.where(intra3, clip(res_cr), clip(pred_cr + res_cr))

    # --- scatter MBs into planes ------------------------------------------
    def assemble(mbs, blk):
        return (
            mbs.reshape(mb_h, mb_w, blk, blk)
            .transpose(0, 2, 1, 3)
            .reshape(mb_h * blk, mb_w * blk)
            .astype(xp.uint8)
        )

    return assemble(out_y, 16), assemble(out_cb, 8), assemble(out_cr, 8)


@functools.lru_cache(maxsize=8)
def _jitted(mb_w, mb_h):
    import jax
    import jax.numpy as jnp

    fn = functools.partial(reconstruct_arrays, mb_w=mb_w, mb_h=mb_h, xp=jnp)
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _jitted_field(mb_w, mb_h):
    """Variant with field-MC plan inputs. Kept separate so pictures
    without field macroblocks reuse the (cached) plain executable."""
    import jax
    import jax.numpy as jnp

    def fn(intra, fwd, bwd, mvf, mvb, dct_type, coef,
           r0y, r0cb, r0cr, r1y, r1cb, r1cr, mvf2, mvb2, fsel, fieldmc):
        return reconstruct_arrays(
            intra, fwd, bwd, mvf, mvb, dct_type, coef,
            r0y, r0cb, r0cr, r1y, r1cb, r1cr,
            mb_w=mb_w, mb_h=mb_h, xp=jnp,
            mvf2=mvf2, mvb2=mvb2, fsel=fsel, fieldmc=fieldmc)
    return jax.jit(fn)


def reconstruct_picture(plan, ref0, ref1, backend="jax"):
    """Reconstruct one picture from its plan.

    plan: PicturePlan. ref0/ref1: dicts with 'y', 'cb', 'cr' uint8 planes
    (forward/backward references per the reference's diff_to_ref rotation,
    mpeg2.cpp:159-194). Returns dict of planes.
    """
    args = (
        plan.intra, plan.fwd, plan.bwd,
        plan.mvf.astype(np.int32), plan.mvb.astype(np.int32),
        plan.dct_type.astype(np.int32), plan.coef,
        ref0["y"], ref0["cb"], ref0["cr"],
        ref1["y"], ref1["cb"], ref1["cr"],
    )
    has_field = plan.fieldmc is not None and bool(plan.fieldmc.any())
    fargs = (plan.mvf2.astype(np.int32), plan.mvb2.astype(np.int32),
             plan.fsel.astype(np.int32), plan.fieldmc) if has_field else None
    if backend == "numpy":
        kw = {}
        if has_field:
            kw = dict(mvf2=fargs[0], mvb2=fargs[1], fsel=fargs[2],
                      fieldmc=fargs[3])
        y, cb, cr = reconstruct_arrays(*args, mb_w=plan.mb_w,
                                       mb_h=plan.mb_h, xp=np, **kw)
        return {"y": y, "cb": cb, "cr": cr}
    if has_field:
        y, cb, cr = _jitted_field(plan.mb_w, plan.mb_h)(*args, *fargs)
        return {"y": np.asarray(y), "cb": np.asarray(cb),
                "cr": np.asarray(cr)}
    y, cb, cr = _jitted(plan.mb_w, plan.mb_h)(*args)
    return {"y": np.asarray(y), "cb": np.asarray(cb), "cr": np.asarray(cr)}


# ---------------------------------------------------------------------
# batched multi-picture Phase B (device-resident pool): the MPEG-2
# analog of codecs/h264 BatchedPhaseB / codecs/h265 H265SeqPhaseB
# ---------------------------------------------------------------------


def _masked_plane(pool, idx, xp):
    """pool[idx] on the leading axis WITHOUT a dynamic slice (runtime-
    index slices codegen ~size bytes of machine code on this backend;
    uint8 planes make an exact masked max)."""
    import jax

    iota = jax.lax.broadcasted_iota(xp.int32, pool.shape, 0)
    return xp.where(iota == idx, pool, xp.zeros((), pool.dtype)).max(0)


def _recon_seq_m2(pool_y, pool_cb, pool_cr, xs, *, mb_w, mb_h,
                  has_field):
    """GOP as ONE graph: lax.scan over pictures, 4-slot pool carried on
    device; each step reads its forward/backward references by slot
    index and writes its own slot (m2d_update_frames pointer rotation,
    mpeg2.cpp:159-194, resolved host-side into the idx triples)."""
    import jax
    import jax.numpy as jnp

    from m2dec_tpu.codecs.h264.reconstruct import _fuse_break, _pool_write

    def step(pool, x):
        py, pcb, pcr = pool
        r0 = (_masked_plane(py, x["r0"], jnp),
              _masked_plane(pcb, x["r0"], jnp),
              _masked_plane(pcr, x["r0"], jnp))
        r1 = (_masked_plane(py, x["r1"], jnp),
              _masked_plane(pcb, x["r1"], jnp),
              _masked_plane(pcr, x["r1"], jnp))
        kw = {}
        if has_field:
            kw = dict(mvf2=x["mvf2"], mvb2=x["mvb2"], fsel=x["fsel"],
                      fieldmc=x["fieldmc"])
        y, cb, cr = reconstruct_arrays(
            x["intra"], x["fwd"], x["bwd"], x["mvf"], x["mvb"],
            x["dct_type"], x["coef"], r0[0], r0[1], r0[2], r1[0],
            r1[1], r1[2], mb_w=mb_w, mb_h=mb_h, xp=jnp, **kw)
        y, cb, cr = _fuse_break(y, cb, cr)
        py = _pool_write(py, y, x["cur"], jnp)
        pcb = _pool_write(pcb, cb, x["cur"], jnp)
        pcr = _pool_write(pcr, cr, x["cur"], jnp)
        return (py, pcb, pcr), (y, cb, cr)

    import jax

    pool, outs = jax.lax.scan(step, (pool_y, pool_cb, pool_cr), xs)
    return pool, outs


@functools.lru_cache(maxsize=8)
def _jitted_seq_m2(mb_w, mb_h, has_field):
    import jax

    fn = functools.partial(_recon_seq_m2, mb_w=mb_w, mb_h=mb_h,
                           has_field=has_field)
    return jax.jit(fn, donate_argnums=(0, 1, 2))


class Mpeg2SeqPhaseB:
    """Device-resident 4-slot pool + batched MPEG-1/2 Phase B."""

    def __init__(self, mb_w, mb_h, pool_size):
        import jax
        import jax.numpy as jnp

        self.mb_w, self.mb_h = mb_w, mb_h
        H, W = mb_h * 16, mb_w * 16

        @jax.jit
        def _mk():
            return (jnp.zeros((pool_size, H, W), jnp.uint8),
                    jnp.zeros((pool_size, H >> 1, W >> 1), jnp.uint8),
                    jnp.zeros((pool_size, H >> 1, W >> 1), jnp.uint8))

        self.pool = _mk()

    def run_async(self, items):
        """items: list of (plan, cur, r0, r1). Returns device outs."""
        plans = [it[0] for it in items]
        has_field = any(p.fieldmc is not None and bool(p.fieldmc.any())
                        for p in plans)
        xs = {
            "intra": np.stack([p.intra for p in plans]),
            "fwd": np.stack([p.fwd for p in plans]),
            "bwd": np.stack([p.bwd for p in plans]),
            "mvf": np.stack([p.mvf.astype(np.int32) for p in plans]),
            "mvb": np.stack([p.mvb.astype(np.int32) for p in plans]),
            "dct_type": np.stack([p.dct_type.astype(np.int32)
                                  for p in plans]),
            "coef": np.stack([p.coef for p in plans]),
            "cur": np.array([it[1] for it in items], np.int32),
            "r0": np.array([it[2] for it in items], np.int32),
            "r1": np.array([it[3] for it in items], np.int32),
        }
        if has_field:
            z2 = np.zeros_like(plans[0].mvf.astype(np.int32))
            xs["mvf2"] = np.stack(
                [p.mvf2.astype(np.int32) if p.fieldmc is not None else z2
                 for p in plans])
            xs["mvb2"] = np.stack(
                [p.mvb2.astype(np.int32) if p.fieldmc is not None else z2
                 for p in plans])
            zf = np.zeros(plans[0].intra.shape, np.int32)
            xs["fsel"] = np.stack(
                [p.fsel.astype(np.int32) if p.fieldmc is not None else zf
                 for p in plans])
            zb = np.zeros(plans[0].intra.shape, bool)
            xs["fieldmc"] = np.stack(
                [p.fieldmc if p.fieldmc is not None else zb
                 for p in plans])
        fn = _jitted_seq_m2(self.mb_w, self.mb_h, has_field)
        self.pool, outs = fn(self.pool[0], self.pool[1], self.pool[2],
                             xs)
        return outs
