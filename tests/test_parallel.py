"""Multi-chip sharding: the pjit decode step on the virtual 8-device CPU
mesh must be numerically identical to the single-device batched path, and
its outputs must carry the frame-axis sharding."""

import numpy as np

import jax

from m2dec_tpu.parallel.mesh import (
    batched_reconstruct,
    example_batch,
    make_mesh,
    sharded_decode_step,
)


def test_sharded_decode_matches_single_device():
    n, mb_w, mb_h = 8, 4, 3
    args = example_batch(n, mb_w, mb_h, seed=3)
    single = batched_reconstruct(mb_w, mb_h)(*args)
    mesh = make_mesh(8)
    step = sharded_decode_step(mesh, mb_w, mb_h)
    sharded = step(*args)
    for a, b in zip(single, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    shard_spec = sharded[0].sharding.spec
    assert tuple(shard_spec) and tuple(shard_spec)[0] == "frame"


def test_h265_gop_step_sharded():
    """The H.265 GOP-parallel step (full Phase-B graph per shard) runs
    on the 8-device mesh, outputs carry the frame-axis sharding, and
    every shard's pictures match an independent single-shard run."""
    from m2dec_tpu.parallel.mesh import h265_example_gops, h265_gop_step

    H = W = 32
    pools, xs = h265_example_gops(4, 2, H, W, ctb_log2=4, seed=7)
    mesh = make_mesh(4)
    step = h265_gop_step(mesh, H, W, 4)
    pool, outs = step(pools[0], pools[1], pools[2], xs)
    assert np.asarray(outs[0]).shape == (4, 2, H, W)
    spec = outs[0].sharding.spec
    assert tuple(spec) and tuple(spec)[0] == "frame"
    # cross-check one shard against the unsharded sequence runner
    from m2dec_tpu.codecs.h265.reconstruct import _recon_seq, wf_mode_for

    g = 2
    xs_g = {k: v[g] for k, v in xs.items()}
    _, ref = _recon_seq(pools[0][g], pools[1][g], pools[2][g], xs_g,
                        H=H, W=W, strong_en=False, has_sao=True,
                        deblock=True, ctb_log2=4, pic_w=W, pic_h=H,
                        wf_mode=wf_mode_for(4))
    for a, b in zip(ref, outs):
        assert np.array_equal(np.asarray(a), np.asarray(b)[g])


def test_h264_tile_step_bit_exact():
    """Level-2 spatial tile parallelism: one picture banded over the
    8-device mesh with intra/deblock halo exchange must equal the
    trusted host reconstruction on a REAL stream (intra MBs inside P
    pictures exercise the cross-band top-neighbor line; deblocking
    exercises the 4-row boundary halo + write-back)."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from streamgen.h264_enc import H264InterGen

    from m2dec_tpu.codecs.h264.decoder import Frame, H264Decoder
    from m2dec_tpu.codecs.h264.recon_ref import reconstruct_plan_np
    from m2dec_tpu.parallel.mesh import h264_tile_plan, h264_tile_step

    data = H264InterGen(48, 128, seed=3, intra_prob=0.35,
                        num_ref_frames=2,
                        disable_deblock=False).generate("IPPP")
    dec = H264Decoder(record_plans=True)
    dec.set_data(data)
    mesh = make_mesh(8)
    step = None
    shadow = None
    npic = 0
    while dec.decode_picture() == 1:
        if shadow is None:
            h, w = dec.frames[0].y.shape
            shadow = [Frame(w, h) for _ in dec.frames]
        plan = dec.plans[-1]
        refs_y = np.stack([f.y for f in shadow])
        refs_cb = np.stack([f.cb for f in shadow])
        refs_cr = np.stack([f.cr for f in shadow])
        if step is None:
            step = h264_tile_step(mesh, plan.mb_w, plan.mb_h)
        tiled = h264_tile_plan(plan, 8)
        y, cb, cr = step(tiled, refs_y, refs_cb, refs_cr)
        reconstruct_plan_np(plan, shadow)  # trusted host recon
        f = shadow[plan.cur_idx]
        assert np.array_equal(np.asarray(y), f.y), f"pic {npic} luma"
        assert np.array_equal(np.asarray(cb), f.cb), f"pic {npic} cb"
        assert np.array_equal(np.asarray(cr), f.cr), f"pic {npic} cr"
        # band sharding actually applied
        spec = tuple(y.sharding.spec)
        assert spec and spec[0] == "frame"
        npic += 1
    assert npic == 4


def test_h264_gop_xchg_cross_shard_reference():
    """Cross-GOP DPB exchange (SURVEY §5.8): a shard's picture predicts
    from the PREVIOUS shard's handoff frame fetched over ppermute —
    bit-exact vs the single-device graph given the same extra page."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from m2dec_tpu.codecs.h264.plan import PicturePlan
    from m2dec_tpu.codecs.h264.reconstruct import (
        _diag_lanes,
        _recon_batch,
    )
    from m2dec_tpu.parallel.mesh import h264_gop_xchg_step, make_mesh

    n_shards, pool_size = 4, 2
    mb_w, mb_h = 3, 2
    H, W = mb_h * 16, mb_w * 16
    mesh = make_mesh(n_shards)
    rng = np.random.default_rng(7)

    pools_y = rng.integers(0, 256, (n_shards, pool_size, H, W)).astype(
        np.uint8)
    pools_cb = rng.integers(
        0, 256, (n_shards, pool_size, H >> 1, W >> 1)).astype(np.uint8)
    pools_cr = rng.integers(
        0, 256, (n_shards, pool_size, H >> 1, W >> 1)).astype(np.uint8)

    plans = []
    for _ in range(n_shards):
        p = PicturePlan(mb_w, mb_h)
        p.kind[:] = 0
        p.slot[:, :, 0] = pool_size     # the cross-shard page
        p.mv[:] = rng.integers(-6, 6, p.mv.shape)
        p.wp[:, :, :, 0] = 1
        plans.append(p)
    from m2dec_tpu.codecs.h264.reconstruct import _PLAN_KEYS

    stacked = {k: np.stack([getattr(p, k) for p in plans])[:, None]
               for k in _PLAN_KEYS}   # [G, 1 pic, ...]
    cur_idx = np.ones((n_shards, 1), np.int32)

    step = h264_gop_xchg_step(mesh, mb_w, mb_h, pool_size,
                              handoff_slot=0, has_i8=False,
                              deblock=False)
    pool, outs = step(pools_y, pools_cb, pools_cr, stacked, cur_idx)
    outs = [np.asarray(o) for o in outs]

    diag = _diag_lanes(mb_w, mb_h)
    for g in range(1, n_shards):
        extra = (jnp.asarray(pools_y[g - 1, 0:1]),
                 jnp.asarray(pools_cb[g - 1, 0:1]),
                 jnp.asarray(pools_cr[g - 1, 0:1]))
        st = {k: jnp.asarray(v[g]) for k, v in stacked.items()}
        _, ref_outs = jax.jit(
            lambda py, pcb, pcr, st: _recon_batch(
                py, pcb, pcr, st, {}, cur_idx[g], diag, mb_w=mb_w,
                mb_h=mb_h, has_i8=False, deblock=False, extra=extra)
        )(pools_y[g], pools_cb[g], pools_cr[g], st)
        for a, b in zip(outs, [np.asarray(o) for o in ref_outs]):
            assert (a[g] == b).all()


def test_gop_scaling_overhead():
    """Adding GOP shards to the virtual mesh must cost far less than a
    full per-shard replay (the sharded graph's overhead structure; the
    virtual devices share this host's 2 cores, so wall-clock here
    cannot show real interconnect scaling — see tools/scaling_report.py)."""
    import tools.scaling_report as SR

    t1 = SR.measure(1, reps=2)
    t8 = SR.measure(8, reps=2)
    # 8x the work in well under 8x the time (currently ~2.5x)
    assert t8 < 5 * t1, (t1, t8)
