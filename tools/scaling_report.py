#!/usr/bin/env python3
"""GOP-parallel scaling on the virtual 8-device CPU mesh: per-shard
work is constant, so ideal scaling keeps wall time flat as shards are
added. Efficiency = T(1) / T(G).

NOTE: virtual devices share this host's physical cores, so these
numbers measure the sharded graph's overhead structure (collectives,
per-shard dispatch), not interconnect scaling. On real multi-card
hosts each shard owns a card and the same graph partitions 1:1.
"""

import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from m2dec_tpu.parallel.mesh import (  # noqa: E402
    h264_example_gops,
    h264_gop_step,
    make_mesh,
)


def measure(n_shards, mb_w=8, mb_h=6, n_pics=4, reps=3):
    mesh = make_mesh(n_shards)
    step = h264_gop_step(mesh, mb_w, mb_h)
    pools, stacked, cur_idx, diag = h264_example_gops(
        n_shards, n_pics, mb_w, mb_h)
    out = step(*pools, stacked, cur_idx, diag)  # compile
    jax.block_until_ready(out)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = step(*pools, stacked, cur_idx, diag)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    return best


def main():
    t1 = measure(1)
    rows = [(1, t1, 1.0)]
    for g in (2, 4, 8):
        tg = measure(g)
        rows.append((g, tg, g * t1 / tg))
    print(f"{'shards':>6} {'ms/step':>10} {'thrpt x':>9}")
    for g, t, e in rows:
        print(f"{g:>6} {t * 1e3:>10.1f} {e:>8.2f}x")
    marg = (rows[-1][1] - rows[0][1]) / (rows[-1][0] - rows[0][0])
    print(f"marginal cost per added shard: {marg * 1e3:.1f} ms "
          f"({marg / t1 * 100:.0f}% of a 1-shard step)")
    return rows


if __name__ == "__main__":
    main()
