"""Multi-chip decode sharding over a jax.sharding.Mesh.

The scale-out model (SURVEY.md §2.4/§5.8): video decode parallelism lives at
three levels —

1. **GOP/frame data-parallelism** ("frame" mesh axis): independent pictures
   (different streams, or B pictures sharing the same two references, or
   GOPs split at IDR/closed-GOP boundaries) reconstruct on different chips.
   Reference frames needed by a remote picture travel by collective
   (all-gather of DPB pages over the interconnect, NVLink on GPUs).
2. **Spatial tile parallelism** (future "tile" axis): slices/tile rows of
   one picture across chips with halo exchange for MC windows.
3. **Wavefront entropy parallelism**: Phase A engines per slice/row (host
   now, native C++ today).

This module implements level 1: a pjit'd batched reconstruction step where
the picture batch is sharded across the mesh and reference planes are
replicated (broadcast once per GOP, amortized across its B pictures).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from m2dec_tpu.codecs.mpeg2.reconstruct import reconstruct_arrays


def make_mesh(n_devices=None, axis="frame"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def batched_reconstruct(mb_w, mb_h):
    """Reconstruction over a batch of pictures: vmap of the single-picture
    Phase-B kernel. All arrays gain a leading batch axis; reference planes
    are per-picture (callers may broadcast shared refs)."""
    single = functools.partial(reconstruct_arrays, mb_w=mb_w, mb_h=mb_h, xp=jnp)
    return jax.vmap(single)


def sharded_decode_step(mesh, mb_w, mb_h, axis="frame"):
    """pjit'd multi-chip batched reconstruction: batch axis sharded over the
    mesh, outputs sharded the same way. The jitted function is the
    multi-chip "decode step" used by __graft_entry__.dryrun_multichip."""
    fn = batched_reconstruct(mb_w, mb_h)
    shard = NamedSharding(mesh, P(axis))
    return jax.jit(
        fn,
        in_shardings=(shard,) * 7 + (shard,) * 6,
        out_shardings=(shard, shard, shard),
    )


def example_batch(n, mb_w, mb_h, seed=0):
    """Synthetic plan batch + refs for compile checks and benchmarks."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    h, w = mb_h * 16, mb_w * 16
    plans = dict(
        intra=rng.random((n, nmb)) < 0.2,
        fwd=np.ones((n, nmb), bool),
        bwd=rng.random((n, nmb)) < 0.5,
        mvf=rng.integers(-8, 8, (n, nmb, 2)).astype(np.int32),
        mvb=rng.integers(-8, 8, (n, nmb, 2)).astype(np.int32),
        dct_type=np.zeros((n, nmb), np.int32),
        coef=(rng.integers(-64, 64, (n, nmb, 6, 64)) *
              (rng.random((n, nmb, 6, 64)) < 0.1)).astype(np.int16),
    )
    # keep MV interpolation windows inside the frame: zero MVs on border MBs
    mbx = np.arange(nmb) % mb_w
    mby = np.arange(nmb) // mb_w
    interior = (mbx >= 1) & (mbx < mb_w - 1) & (mby >= 1) & (mby < mb_h - 1)
    plans["mvf"] *= interior[None, :, None]
    plans["mvb"] *= interior[None, :, None]
    refs = [
        rng.integers(0, 256, (n, h, w)).astype(np.uint8),
        rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
        rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
    ] * 2
    args = (
        plans["intra"], plans["fwd"], plans["bwd"],
        plans["mvf"], plans["mvb"], plans["dct_type"], plans["coef"],
        *refs,
    )
    return args


# ---------------------------------------------------------------- H.264 --

def h264_gop_step(mesh, mb_w, mb_h, axis="frame"):
    """Multi-chip H.264 decode: each mesh shard reconstructs its own GOP
    (independent picture group / stream) with a device-resident frame
    pool — level-1 data parallelism where throughput scales with chips.

    Input: per-GOP pools [G, P, H, W] and stacked plan tensors with a
    leading [G, N_pics, ...] axis, G sharded over the mesh."""
    from m2dec_tpu.codecs.h264.reconstruct import _recon_batch

    def fn(py, pcb, pcr, stacked, cur_idx, diag):
        return _recon_batch(py, pcb, pcr, stacked, {}, cur_idx, diag,
                            mb_w=mb_w, mb_h=mb_h, has_i8=True,
                            deblock=True)

    vf = jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, None))
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    return jax.jit(
        vf,
        in_shardings=(shard, shard, shard, shard, shard, repl),
        out_shardings=((shard, shard, shard), (shard, shard, shard)),
    )


def h264_example_gops(n_gops, n_pics, mb_w, mb_h, pool_size=4, seed=0):
    """Tiny synthetic plan batch for the multi-chip dry run."""
    from m2dec_tpu.codecs.h264.plan import PicturePlan
    from m2dec_tpu.codecs.h264.reconstruct import _PLAN_KEYS, _diag_lanes

    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(n_gops * n_pics):
        p = PicturePlan(mb_w, mb_h)
        p.kind[:] = rng.integers(0, 2, p.n)  # mix of inter / intra4x4
        p.i4_avail[:] = 0
        p.mv[:] = rng.integers(-8, 8, p.mv.shape)
        p.slot[:, :, 0] = 0
        p.wp[:, :, :, 0] = 1
        plans.append(p)
    stacked = {
        k: np.stack([getattr(p, k) for p in plans]).reshape(
            (n_gops, n_pics) + getattr(plans[0], k).shape)
        for k in _PLAN_KEYS
    }
    cur_idx = np.tile(np.arange(n_pics, dtype=np.int32) % pool_size,
                      (n_gops, 1))
    H, W = mb_h * 16, mb_w * 16
    pools = (np.zeros((n_gops, pool_size, H, W), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8))
    return pools, stacked, cur_idx, _diag_lanes(mb_w, mb_h)


# ---------------------------------------------------------------- H.265 --

def h265_gop_step(mesh, H, W, ctb_log2, axis="frame"):
    """Multi-chip H.265 decode: each mesh shard reconstructs its own
    GOP with a device-resident frame pool (level-1 data parallelism,
    same shape as h264_gop_step). The whole-picture Phase-B graph —
    residual matmuls, dense MC, intra wavefront, deblock, SAO — runs
    per shard under one pjit."""
    from m2dec_tpu.codecs.h265.reconstruct import _recon_seq, wf_mode_for

    def fn(py, pcb, pcr, xs):
        return _recon_seq(py, pcb, pcr, xs, H=H, W=W, strong_en=False,
                          has_sao=True, deblock=True, ctb_log2=ctb_log2,
                          pic_w=W, pic_h=H, wf_mode=wf_mode_for(ctb_log2))

    vf = jax.vmap(fn, in_axes=(0, 0, 0, 0))
    shard = NamedSharding(mesh, P(axis))
    return jax.jit(
        vf,
        in_shardings=(shard, shard, shard, shard),
        out_shardings=((shard, shard, shard), (shard, shard, shard)),
    )


def h265_example_gops(n_gops, n_pics, H, W, ctb_log2=4, pool_size=4,
                      seed=0):
    """Tiny synthetic H.265 plan batch for the multi-chip dry run."""
    import types

    from m2dec_tpu.codecs.h265.plan import H265Plan
    from m2dec_tpu.codecs.h265.reconstruct import stack_plans

    rng = np.random.default_rng(seed)
    cols, rows = W >> ctb_log2, H >> ctb_log2
    sps = types.SimpleNamespace(pic_width=W, pic_height=H,
                                strong_intra_smoothing=0)
    plans = []
    for gi in range(n_gops * n_pics):
        p = H265Plan(sps, cols, rows, ctb_log2)
        # an intra DC op + a residual TU per CTU, inter cells elsewhere
        for cy in range(rows):
            for cx in range(cols):
                ci = cy * cols + cx
                y0, x0 = cy << ctb_log2, cx << ctb_log2
                p._ops_l[ci].append([1, y0, x0, 2, 1, -1, -1])
                p._ops_c[ci].append([1, y0 >> 1, x0 >> 1, 2, 1, -1, -1])
                p.tu_y[y0 >> 2, x0 >> 2] = 1 | (3 << 3)
                p.coef_y[y0 : y0 + 4, x0 : x0 + 4] = rng.integers(
                    -40, 40, (4, 4))
        p.slot[rows << 1 :, :, 0] = 0  # lower cells inter, zero MV
        p.has_sao = True
        p.cur_idx = gi % pool_size
        p.ops_l = p.ops_c = None
        from m2dec_tpu.codecs.h265.plan import PlanRecorder  # noqa: F401

        # finalize op packing without a recorder
        def pack(lists):
            cap = max(1, max((len(o) for o in lists), default=0))
            b = 1
            while b < cap:
                b *= 2
            arr = np.zeros((len(lists), b, 7), np.int32)
            for i, ops in enumerate(lists):
                if ops:
                    arr[i, : len(ops)] = ops
            return arr

        p.ops_l = pack(p._ops_l)
        p.ops_c = pack(p._ops_c)
        plans.append(p)
    xs_all = stack_plans(plans)
    xs = {k: v.reshape((n_gops, n_pics) + v.shape[1:])
          for k, v in xs_all.items()}
    pools = (np.zeros((n_gops, pool_size, H, W), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8))
    return pools, xs


# ------------------------------------------------------- H.264 tiles --

def h264_tile_step(mesh, mb_w, mb_h, has_i8=False, axis="frame"):
    """Level-2 spatial tile parallelism (SURVEY §2.4/§5.8): ONE
    picture's Phase B banded across devices by MB rows, with halo
    exchange over the interconnect.

    - residual + quarter-pel MC: embarrassingly parallel per band — the
      reference frames are replicated, MVs gather in global coordinates
      (``inter_pass(y_off=...)``)
    - intra wavefront: the left/top dependence chains through the whole
      picture, so bands execute in sequence; each band's bottom pixel
      row (the next band's top-neighbor line) travels down by
      ``lax.ppermute``
    - deblock wavefront: the band-boundary horizontal edges read the 4
      post-filter pixel rows above (ppermute down) and write 3 of them
      back (one ppermute up after the last band)

    Returns a jitted ``fn(P_tiled, refs_y, refs_cb, refs_cr) -> (y, cb,
    cr)`` over full planes, bit-exact with the single-device graph
    (tests/test_parallel.py). ``P_tiled`` leaves carry a leading
    ``[n_bands, nmb_local, ...]`` axis (see ``h264_tile_plan``)."""
    import m2dec_tpu.codecs.h264.reconstruct as R
    from m2dec_tpu.codecs.h264 import tables as T

    nb = int(np.prod(mesh.devices.shape))
    if mb_h % nb:
        raise ValueError(f"mb_h={mb_h} not divisible by {nb} bands")
    bh = mb_h // nb
    Hl, W = bh * 16, mb_w * 16
    Hcl, Wc = Hl >> 1, W >> 1
    diag_local = jnp.asarray(R._diag_lanes(mb_w, bh))
    tabs_np = (np.asarray(T.DEBLOCK_ALPHA, np.int32),
               np.asarray(T.DEBLOCK_BETA, np.int32),
               np.asarray(T.DEBLOCK_TC0, np.int32))
    perm_down = [(i, i + 1) for i in range(nb - 1)]
    perm_up = [(i, i - 1) for i in range(1, nb)]

    def band_fn(P, refs_y, refs_cb, refs_cr):
        P = {k: v[0] for k, v in P.items()}  # strip the shard axis
        band = jax.lax.axis_index(axis)
        kind = P["kind"]
        res_y = R.residual_mb(P["coef_luma"], P["t8x8"], jnp)
        res_c = R.residual_chroma(P["coef_chroma"], jnp)
        pred_y, pred_cb, pred_cr = R.inter_pass(
            P["mv"], P["slot"], P["wp"], refs_y, refs_cb, refs_cr,
            mb_w, bh, jnp, y_off=band * Hl)
        is_inter = (kind == 0)[:, None, None]
        y_plane = R._assemble(
            jnp.where(is_inter, jnp.clip(pred_y + res_y, 0, 255), 0),
            16, mb_w, bh, jnp)
        cb_plane = R._assemble(
            jnp.where(is_inter, jnp.clip(pred_cb + res_c[:, 0], 0, 255),
                      0), 8, mb_w, bh, jnp)
        cr_plane = R._assemble(
            jnp.where(is_inter, jnp.clip(pred_cr + res_c[:, 1], 0, 255),
                      0), 8, mb_w, bh, jnp)

        # ---- intra wavefront, pipelined across bands ----
        Q = dict(P)
        Q["res_y"] = res_y
        Q["res_c"] = res_c
        ypad = jnp.zeros((1 + Hl, 1 + W + 8), jnp.int32)
        ypad = ypad.at[1:, 1 : 1 + W].set(y_plane)
        cbpad = jnp.zeros((1 + Hcl, 1 + Wc), jnp.int32)
        cbpad = cbpad.at[1:, 1:].set(cb_plane)
        crpad = jnp.zeros((1 + Hcl, 1 + Wc), jnp.int32)
        crpad = crpad.at[1:, 1:].set(cr_plane)

        def istep(carry, lanes):
            return R._intra_step(carry, lanes, Q, mb_w, has_i8, jnp)

        def intra_iter(s, state):
            yp, cbp, crp, hy, hcb, hcr = state

            def run(t):
                yp, cbp, crp = t
                # install the halo: the band above's bottom pixel line
                yp = yp.at[0].set(hy)
                cbp = cbp.at[0].set(hcb)
                crp = crp.at[0].set(hcr)
                return jax.lax.scan(istep, (yp, cbp, crp),
                                    diag_local)[0]

            yp, cbp, crp = jax.lax.cond(band == s, run, lambda t: t,
                                        (yp, cbp, crp))
            hy = jax.lax.ppermute(yp[Hl], axis, perm_down)
            hcb = jax.lax.ppermute(cbp[Hcl], axis, perm_down)
            hcr = jax.lax.ppermute(crp[Hcl], axis, perm_down)
            return (yp, cbp, crp, hy, hcb, hcr)

        def _vary(a):  # device-varying carry type for the halo lines
            return jax.lax.pcast(a, axis, to="varying")

        state = (ypad, cbpad, crpad,
                 _vary(jnp.zeros((1 + W + 8,), jnp.int32)),
                 _vary(jnp.zeros((1 + Wc,), jnp.int32)),
                 _vary(jnp.zeros((1 + Wc,), jnp.int32)))
        ypad, cbpad, crpad = jax.lax.fori_loop(0, nb, intra_iter,
                                               state)[:3]
        y_plane = ypad[1:, 1 : 1 + W]
        cb_plane = cbpad[1:, 1:]
        cr_plane = crpad[1:, 1:]

        # ---- deblock wavefront, pipelined across bands ----
        tabs = tuple(jnp.asarray(t) for t in tabs_np)
        ydb = jnp.zeros((4 + Hl, 4 + W), jnp.int32)
        ydb = ydb.at[4:, 4:].set(y_plane)
        cbdb = jnp.zeros((4 + Hcl, 4 + Wc), jnp.int32)
        cbdb = cbdb.at[4:, 4:].set(cb_plane)
        crdb = jnp.zeros((4 + Hcl, 4 + Wc), jnp.int32)
        crdb = crdb.at[4:, 4:].set(cr_plane)

        def dstep(carry, lanes):
            return R._deblock_step(carry, lanes, P, mb_w, jnp, tabs)

        def db_iter(s, state):
            yd, cbd, crd, hy, hcb, hcr = state

            def run(t):
                yd, cbd, crd = t
                # top halo: the band above's bottom 4 post-filter rows
                yd = yd.at[0:4].set(hy)
                cbd = cbd.at[0:4].set(hcb)
                crd = crd.at[0:4].set(hcr)
                return jax.lax.scan(dstep, (yd, cbd, crd),
                                    diag_local)[0]

            yd, cbd, crd = jax.lax.cond(band == s, run, lambda t: t,
                                        (yd, cbd, crd))
            hy = jax.lax.ppermute(yd[Hl : Hl + 4], axis, perm_down)
            hcb = jax.lax.ppermute(cbd[Hcl : Hcl + 4], axis, perm_down)
            hcr = jax.lax.ppermute(crd[Hcl : Hcl + 4], axis, perm_down)
            return (yd, cbd, crd, hy, hcb, hcr)

        state = (ydb, cbdb, crdb,
                 _vary(jnp.zeros((4, 4 + W), jnp.int32)),
                 _vary(jnp.zeros((4, 4 + Wc), jnp.int32)),
                 _vary(jnp.zeros((4, 4 + Wc), jnp.int32)))
        ydb, cbdb, crdb = jax.lax.fori_loop(0, nb, db_iter, state)[:3]
        # fix-up: my pad rows hold the band above's bottom rows as my
        # boundary edges left them — send them back up
        fy = jax.lax.ppermute(ydb[0:4], axis, perm_up)
        fcb = jax.lax.ppermute(cbdb[0:4], axis, perm_up)
        fcr = jax.lax.ppermute(crdb[0:4], axis, perm_up)
        have_below = band < nb - 1
        ydb = jnp.where(have_below, ydb.at[Hl : Hl + 4].set(fy), ydb)
        cbdb = jnp.where(have_below, cbdb.at[Hcl : Hcl + 4].set(fcb),
                         cbdb)
        crdb = jnp.where(have_below, crdb.at[Hcl : Hcl + 4].set(fcr),
                         crdb)
        return (ydb[4:, 4:].astype(jnp.uint8),
                cbdb[4:, 4:].astype(jnp.uint8),
                crdb[4:, 4:].astype(jnp.uint8))

    shard = P(axis)
    repl = P()
    fn = jax.shard_map(
        band_fn, mesh=mesh,
        in_specs=({k: shard for k in _h264_tile_keys()}, repl, repl,
                  repl),
        out_specs=(shard, shard, shard),
    )
    return jax.jit(fn)


def _h264_tile_keys():
    from m2dec_tpu.codecs.h264.reconstruct import _PLAN_KEYS

    return _PLAN_KEYS


def h264_tile_plan(plan, n_bands):
    """Split a PicturePlan's tensors into [n_bands, nmb_local, ...] for
    h264_tile_step (MB-row bands)."""
    from m2dec_tpu.codecs.h264.reconstruct import _PLAN_KEYS

    out = {}
    for k in _PLAN_KEYS:
        v = np.asarray(getattr(plan, k))
        out[k] = v.reshape((n_bands, v.shape[0] // n_bands)
                           + v.shape[1:])
    return out


# ------------------------------------------- cross-GOP DPB exchange --

def h264_gop_xchg_step(mesh, mb_w, mb_h, pool_size, handoff_slot=0,
                       has_i8=True, deblock=True, axis="frame"):
    """Open-GOP data parallelism WITH cross-shard references (SURVEY
    §5.8): each shard decodes its own GOP, but its pictures may also
    reference the PREVIOUS shard's DPB handoff page — the anchor frame
    a leading B picture of an open GOP predicts from.

    The handoff page (pool slot ``handoff_slot`` as of step entry — the
    pipelined-decode model where shard g consumes what shard g-1
    produced in the previous round) travels one hop over the mesh
    interconnect via ``lax.ppermute`` and is appended to the local pool
    as slot ``pool_size``; plan slot values == pool_size address it.
    Shard 0 receives zeros (its plans must not use the extra slot).
    Writes stay local: cur_idx < pool_size."""
    from m2dec_tpu.codecs.h264.reconstruct import _recon_batch

    n = int(np.prod(mesh.devices.shape))
    perm = [(i, i + 1) for i in range(n - 1)]

    def fn(py, pcb, pcr, stacked, cur_idx):
        py, pcb, pcr = py[0], pcb[0], pcr[0]
        st = jax.tree.map(lambda v: v[0], stacked)

        def fetch(p):
            return jax.lax.ppermute(p[handoff_slot], axis, perm)[None]

        extra = (fetch(py), fetch(pcb), fetch(pcr))
        from m2dec_tpu.codecs.h264.reconstruct import _diag_lanes

        pool, outs = _recon_batch(
            py, pcb, pcr, st, {}, cur_idx[0], _diag_lanes(mb_w, mb_h),
            mb_w=mb_w, mb_h=mb_h, has_i8=has_i8, deblock=deblock,
            extra=extra)
        add = jax.tree.map(lambda v: v[None], pool)
        return add, jax.tree.map(lambda v: v[None], outs)

    shard = P(axis)
    fn_sm = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(shard, shard, shard, shard, shard),
        out_specs=((shard, shard, shard), (shard, shard, shard)),
    )
    return jax.jit(fn_sm)
