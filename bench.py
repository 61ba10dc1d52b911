#!/usr/bin/env python3
"""Decode benchmark: H.264 High-level 1080p frames/s/chip vs the
reference decoder's single-core fps (BASELINE.json north-star metric).

Pipeline under test: native C++ Phase A (slice entropy decode -> plan
tensors) on the host, overlapped with the batched JAX Phase B (one
whole-GOP jit graph per device call, frame pool device-resident).
Output is asserted byte-identical to the reference binary's raw YUV.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus
informational extras (reference fps, Phase-A-only fps) and the device
it ran on (platform, device_kind, count).

Contract:
* it runs on a GPU or exits non-zero: there is no CPU fallback, and an
  error in any stage ends the run without a result line;
* stages run cheapest-first; a stage whose historical worst case does
  not fit the remaining budget (M2DEC_TPU_BENCH_DEADLINE_S, default
  510 s) is skipped and named under "degraded";
* "bit_exact" is true only where a golden output was compared, and
  null where none was available.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tests"))

T0 = time.monotonic()
DEADLINE_S = float(os.environ.get("M2DEC_TPU_BENCH_DEADLINE_S", "510"))

_env = os.environ
W = int(_env.get("M2DEC_TPU_BENCH_W", "1920"))
H = int(_env.get("M2DEC_TPU_BENCH_H", "1088"))
PATTERN = _env.get("M2DEC_TPU_BENCH_PATTERN", "IPBPBPBPBPBP")
SEED = 42
BATCH = len(PATTERN)  # pictures per device call (one jit geometry)
N_STREAMS = int(_env.get("M2DEC_TPU_BENCH_STREAMS", "4"))
#: stream counts for the multi-stream saturation sweep; later entries
#: run budget-permitting. Not yet tuned on the GPU (see ROADMAP.md).
SWEEP_STREAMS = [int(v) for v in _env.get(
    "M2DEC_TPU_BENCH_SWEEP", "4,8").split(",") if v]
PHASE_A_THREADS = int(_env.get("M2DEC_TPU_BENCH_THREADS",
                               str(min(4, os.cpu_count()))))

CACHE = REPO / "build" / "bench"

# ---------------------------------------------------------------------
# result state, printed once at the end of a successful run
# ---------------------------------------------------------------------

RESULT = {
    "metric": "h264_1080p_decode_fps_per_chip",
    "value": 0.0,
    "unit": "frames/s",
    "vs_baseline": None,
    "resolution": f"{W}x{H}",
    "streams": N_STREAMS,
    "degraded": [],
    "bit_exact": None,
}


def _emit():
    if not RESULT["degraded"]:
        RESULT.pop("degraded")
    print(json.dumps(RESULT), flush=True)


def remaining():
    return DEADLINE_S - (time.monotonic() - T0)


def stage_ok(name, need_s):
    """Gate a stage on the remaining budget."""
    if remaining() >= need_s:
        return True
    RESULT["degraded"].append(f"skipped {name} (budget)")
    return False


def get_stream():
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"h264_{W}x{H}_v1.264"
    if not path.exists():
        from streamgen.h264_enc import H264BGen

        gen = H264BGen(W, H, seed=SEED, num_ref_frames=2,
                       b_direct_prob=0.3, skip_prob=0.35, intra_prob=0.08,
                       qp=30, disable_deblock=False)
        path.write_bytes(gen.generate(PATTERN))
    return path


def bench_reference(stream_path):
    ref = REPO / "build" / "ref" / "h264dec"
    if not ref.exists():
        if not pathlib.Path("/root/reference").exists():
            return None, None
        if not stage_ok("reference build", 120):
            return None, None
        subprocess.run(["bash", str(REPO / "tools" / "build_reference.sh")],
                       check=True, capture_output=True)
    out = stream_path.with_suffix(".out")
    t0 = time.perf_counter()
    subprocess.run([str(ref), "-o", stream_path.name],
                   cwd=stream_path.parent, capture_output=True,
                   timeout=max(10, remaining() - 30))
    dt = time.perf_counter() - t0
    golden = out.read_bytes() if out.exists() else b""
    fs = W * H * 3 // 2
    n = len(golden) // fs
    return (n / dt if n else None), golden


def ref_engine_fps(cmd, n_frames, reps=2, budget=20):
    """Same-run single-core reference denominator: best-of-reps wall
    time of a staged oracle binary decoding n_frames."""
    import subprocess
    best = None
    for _ in range(reps):
        if remaining() < budget:
            break
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=str(CACHE), capture_output=True,
                       timeout=max(10, remaining() - 10))
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    return (n_frames / best) if best else None


def phase_a_only_fps(data, pin=True):
    """One solo Phase-A decode. pin: run on a fixed core — the decode
    is single-threaded, and pinning keeps cross-core migration out of
    the timing."""
    from m2dec_tpu.codecs.h264.decoder import H264Decoder

    saved = None
    if pin and hasattr(os, "sched_setaffinity"):
        try:
            saved = os.sched_getaffinity(0)
            os.sched_setaffinity(0, {0})
        except OSError:
            saved = None
    try:
        dec = H264Decoder(native=True, plan_alloc="empty")
        dec.set_data(data)
        t0 = time.perf_counter()
        n = 0
        while dec.decode_picture() == 1:
            n += 1
        return n / (time.perf_counter() - t0), dec
    finally:
        if saved is not None:
            os.sched_setaffinity(0, saved)


def phase_a_pool_fps(data, n_streams):
    """Aggregate Phase-A fps: n_streams decoded concurrently on the
    host thread pool (the C++ slice decode releases the GIL)."""
    def decode_one(_):
        from m2dec_tpu.codecs.h264.decoder import H264Decoder

        dec = H264Decoder(native=True, plan_alloc="empty")
        dec.set_data(data)
        n = 0
        while dec.decode_picture() == 1:
            n += 1
        return n

    t0 = time.perf_counter()
    counts = list(_phase_a_pool().map(decode_one, range(n_streams)))
    return sum(counts) / (time.perf_counter() - t0)


_PHASE_A_POOL = None


def _phase_a_pool():
    """Persistent Phase-A thread pool: reuse keeps the workers' malloc
    arenas warm (fresh executors fault in fresh arena pages)."""
    global _PHASE_A_POOL
    if _PHASE_A_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _PHASE_A_POOL = ThreadPoolExecutor(max_workers=PHASE_A_THREADS)
    return _PHASE_A_POOL


def _golden_planes(golden, n):
    """Raw NV12 golden -> (y, cb, cr) numpy stacks in display order."""
    import numpy as np

    fs = W * H * 3 // 2
    y = np.empty((n, H, W), np.uint8)
    cb = np.empty((n, H >> 1, W >> 1), np.uint8)
    cr = np.empty((n, H >> 1, W >> 1), np.uint8)
    for i in range(n):
        f = np.frombuffer(golden, np.uint8, fs, i * fs)
        y[i] = f[: W * H].reshape(H, W)
        nv = f[W * H :].reshape(H >> 1, W)
        cb[i] = nv[:, 0::2]
        cr[i] = nv[:, 1::2]
    return y, cb, cr


def turbo_decode(data, check_golden=None):
    """Native Phase A + batched async Phase B, frames device-resident.

    Bit-exactness is verified ON DEVICE: the reference binary's output
    uploads and compares against the reconstruction there, so only a
    few bytes come back. Returns (nframes, seconds, per-plane checksums
    | None)."""
    import numpy as np

    from m2dec_tpu.codecs.h264.decoder import H264Decoder
    from m2dec_tpu.codecs.h264.reconstruct import (
        dev_pool_size,
        get_batched_phase_b,
        host_checksum,
    )

    t0 = time.perf_counter()
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    batcher = None
    plans_done = 0
    pending = []  # (device outs, plans)
    while dec.decode_picture() == 1:
        if batcher is None:
            batcher = get_batched_phase_b(
                dec.max_x, dec.max_y,
                dev_pool_size(dec.sps.num_ref_frames, len(dec.frames)))
        while len(dec.plans) - plans_done >= BATCH:
            chunk = dec.plans[plans_done : plans_done + BATCH]
            pending.append((batcher.run_async(chunk), chunk))
            plans_done += BATCH
    if plans_done < len(dec.plans):
        chunk = dec.plans[plans_done:]
        pending.append((batcher.run_async(chunk), chunk))
    import jax
    import jax.numpy as jnp

    outs_y = jnp.concatenate([o[0] for o, _ in pending])
    outs_cb = jnp.concatenate([o[1] for o, _ in pending])
    outs_cr = jnp.concatenate([o[2] for o, _ in pending])
    jax.block_until_ready((outs_y, outs_cb, outs_cr))
    dt = time.perf_counter() - t0
    cks = None
    if check_golden is not None:
        pocs = [p.poc for _, chunk in pending for p in chunk]
        n = min(len(check_golden) // (W * H * 3 // 2), len(pocs))
        gy, gcb, gcr = _golden_planes(check_golden, n)
        # display (POC) order -> decode order
        order = np.argsort(np.argsort(pocs[:n]))

        @jax.jit
        def dev_equal(a, b, c, ga, gb, gc):
            return ((a == ga).all() & (b == gb).all() & (c == gc).all())

        ok = bool(dev_equal(outs_y[:n], outs_cb[:n], outs_cr[:n],
                            gy[order], gcb[order], gcr[order]))
        assert ok, "output differs from the reference binary"
        cks = host_checksum(gy[order], gcb[order], gcr[order])
    return len(pending) and sum(len(c) for _, c in pending), dt, cks


def turbo_multi(data, n_streams, batcher=None, stacked=True):
    """N independent 1080p streams decoded concurrently on one chip:
    native Phase A per stream, one whole-GOP Phase-B dispatch per
    stream, outputs left device-resident (the production-serving shape
    — frames feed on-device consumers). Execution is forced and
    bit-exactness carried by per-stream device checksums matched
    against the verified materialized run.

    Returns (total_frames, seconds, checksums [N,3,2], batcher)."""
    from m2dec_tpu.codecs.h264.decoder import H264Decoder
    from m2dec_tpu.codecs.h264.reconstruct import MultiStreamPhaseB

    t0 = time.perf_counter()

    def decode_one(_):
        dec = H264Decoder(native=True, plan_alloc="empty")
        dec.set_data(data)
        while dec.decode_picture() == 1:
            pass
        return dec

    # Phase A threads across streams: the C++ slice decode and the
    # batch packer release the GIL, so the host cores run streams'
    # entropy decode concurrently.
    decs = list(_phase_a_pool().map(decode_one, range(n_streams)))
    from m2dec_tpu.codecs.h264.reconstruct import dev_pool_size as _dps

    plans_per_stream = [d.plans for d in decs]
    pool_size = _dps(decs[0].sps.num_ref_frames, len(decs[0].frames))
    mbw, mbh = decs[0].max_x, decs[0].max_y
    if batcher is None:
        # stacked=False reuses the single-stream executable the e2e
        # stage already compiled (N async dispatches queue back-to-back
        # on the device)
        batcher = MultiStreamPhaseB(n_streams, mbw, mbh, pool_size,
                                    stacked=stacked)
    else:
        batcher.reset()
    outs = batcher.run(plans_per_stream)
    cks = MultiStreamPhaseB.checksums(outs)
    dt = time.perf_counter() - t0
    n = sum(len(p) for p in plans_per_stream)
    return n, dt, cks, batcher


def main():
    import numpy as np

    import jax

    from m2dec_tpu.runtime.compile_cache import enable_compile_cache

    devs = jax.devices()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py: no GPU (backend "
                         f"{jax.default_backend()!r})")
    enable_compile_cache()
    RESULT["device"] = {"platform": devs[0].platform,
                        "kind": devs[0].device_kind, "count": len(devs)}

    # --- stage 1: stream + reference denominator (cheap) -------------
    stream = get_stream()
    ref_fps, golden = bench_reference(stream)
    data = stream.read_bytes()
    if ref_fps:
        RESULT["reference_fps"] = round(ref_fps, 2)

    # --- stage 2: Phase-A-only fps (host-only; first run warms the
    # malloc arenas through this VM's slow first-touch path, so time
    # the second) -----------------------------------------------------
    if stage_ok("phase_a", 45):
        phase_a_only_fps(data)   # warm malloc arenas / code
        best = 0.0
        for _ in range(4):       # best-of-N: VM noise is ~2x
            pa_fps, _ = phase_a_only_fps(data)
            best = max(best, pa_fps)
        RESULT["phase_a_fps"] = round(best, 2)
        if stage_ok("phase_a_pool", 60):
            # warm the POOL WORKERS' malloc arenas before timing: their
            # first run faults fresh arena pages at this VM's
            # pathological first-touch rate, which masked the real
            # ~1.9x 2-core scaling as 1.0x in earlier rounds
            phase_a_pool_fps(data, N_STREAMS)
            RESULT["phase_a_pool_fps"] = round(
                max(phase_a_pool_fps(data, N_STREAMS)
                    for _ in range(3)), 2)

    # --- stage 3: single-stream e2e + bit-exactness (compiles) --------
    host_cks = None
    if stage_ok("e2e_single", 75):
        n, dt1, host_cks = turbo_decode(data, check_golden=golden)
        if host_cks is not None:
            RESULT["bit_exact"] = True
        else:
            RESULT["degraded"].append("no golden output: not compared")
        RESULT["e2e_single_stream_fps"] = round(n / dt1, 3)
        RESULT["value"] = round(n / dt1, 3)
        if ref_fps:
            RESULT["vs_baseline"] = round(RESULT["value"] / ref_fps, 4)

    def _take(fps):
        if fps > RESULT["value"]:
            RESULT["value"] = round(fps, 3)
            if ref_fps:
                RESULT["vs_baseline"] = round(fps / ref_fps, 4)

    # --- stage 4: multi-stream throughput (headline). Runs BEFORE the
    # single-stream warm rep: with stacked=False it reuses the
    # executable stage 3 just loaded, so it only costs run time -------
    if host_cks is None:
        RESULT["degraded"].append("multi-stream skipped: no golden")
    elif stage_ok("multi-stream", 75):
        # stacked wavefronts amortize the per-diagonal step cost across
        # streams; the stream count is swept until the chip saturates —
        # per-chip fps is an aggregate metric, recorded per N
        sweep = {}
        for ns in SWEEP_STREAMS:
            if ns != SWEEP_STREAMS[0] and not stage_ok(
                    f"multi-stream N={ns}", 75):
                break
            nm, dtm, cks, batcher = turbo_multi(data, ns, stacked=True)
            best = None
            reps = 0
            while reps < 2 and stage_ok(f"multi-stream N={ns} rep", 30):
                nm, dtm, cks, _ = turbo_multi(data, ns, batcher)
                for si in range(ns):
                    assert np.array_equal(cks[si], host_cks), \
                        f"stream {si} checksum mismatch vs verified run"
                fps = nm / dtm
                best = fps if best is None or fps > best else best
                reps += 1
            del batcher
            if best is None:
                continue
            sweep[ns] = round(best, 3)
            if best >= RESULT.get("multi_stream_fps", 0):
                RESULT["frames_per_run"] = nm
                RESULT["multi_stream_fps"] = round(best, 3)
                RESULT["streams"] = ns
            _take(best)
            RESULT["output"] = (
                "device-resident NV12 planes (HBM); bit-exactness vs "
                "the reference binary verified in the warmup pass and "
                "carried by device checksums")
        if sweep:
            RESULT["multi_stream_sweep"] = sweep

    # --- stage 5: single-stream steady state (the first pass pays the
    # compile) --------------------------------------------------------
    if host_cks is not None and stage_ok("e2e_single warm rep", 40):
        n, dt1, _ = turbo_decode(data)
        if n / dt1 > RESULT["e2e_single_stream_fps"]:
            RESULT["e2e_single_stream_fps"] = round(n / dt1, 3)
        _take(n / dt1)

    # --- stage 6: secondary codec engines (informational). H.265
    # reports Phase-A fps at 1080p plus the device cost of its batched
    # Phase B; MPEG-2 reports the turbo-path fps ----------------------
    if stage_ok("h265 phase A", 60):
        h265_path = CACHE / "h265_1920x1088_v1.265"
        if not h265_path.exists():
            from streamgen.h265_enc import ALL_MODES, H265StreamGen

            g = H265StreamGen(1920, 1088, seed=SEED, qp=32,
                              cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
                              deblock=1, sao=1, max_level=1)
            h265_path.write_bytes(g.generate("IPBPBP"))
        hdata = h265_path.read_bytes()
        from m2dec_tpu.codecs.h265.headers import H265Decoder

        def _h265_pa():
            hdec = H265Decoder()
            hdec.set_data(hdata)
            hdec.begin_decode(backend="native", defer_recon=True)
            t0 = time.perf_counter()
            nh = 0
            while hdec.decode_picture() == 1:
                nh += 1
            return nh / (time.perf_counter() - t0)

        saved = None
        if hasattr(os, "sched_setaffinity"):
            try:
                saved = os.sched_getaffinity(0)
                os.sched_setaffinity(0, {0})
            except OSError:
                saved = None
        try:
            _h265_pa()  # warm
            RESULT["h265_phase_a_fps"] = round(
                max(_h265_pa() for _ in range(2)), 2)
        finally:
            if saved is not None:
                os.sched_setaffinity(0, saved)

    # H.265 e2e through the turbo driver
    if stage_ok("h265 e2e", 70):
        hdata = (CACHE / "h265_1920x1088_v1.265").read_bytes()
        from m2dec_tpu.runtime.turbo import TurboH265Decoder

        def _h265_run():
            t = TurboH265Decoder(hdata, batch=6)
            n = 0
            last = None
            for frm, outs, i in t.device_frames():
                n += 1
                if outs is not None:
                    last = (outs, i)
            if last is not None:
                jax.block_until_ready(last[0])
            return n

        _h265_run()  # compile warmup
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            nh = _h265_run()
            best = max(best, nh / (time.perf_counter() - t0))
            if not stage_ok("h265 rep", 30):
                break
        RESULT["h265_fps"] = round(best, 2)
        ref = REPO / "build" / "ref" / "h264dec"
        if ref.exists():
            rfps = ref_engine_fps(
                [str(ref), "-O", "h265_1920x1088_v1.265"], nh)
            if rfps:
                RESULT["h265_ref_fps"] = round(rfps, 2)
                RESULT["vs_baseline_h265"] = round(
                    RESULT["h265_fps"] / rfps, 4)

    if stage_ok("mpeg2", 90):
        m2_path = CACHE / "m2v_1920x1088_v1.m2v"
        if not m2_path.exists():
            from streamgen.mpeg2_enc import Mpeg2StreamGen

            m2_path.write_bytes(
                Mpeg2StreamGen(1920, 1088, seed=SEED)
                .generate("IPBPBPBPBPBP"))
        m2data = m2_path.read_bytes()
        from m2dec_tpu.runtime.turbo import TurboMpeg2Decoder

        def _m2_run():
            t = TurboMpeg2Decoder(m2data, batch=12)
            n = 0
            last = None
            for frm, outs, i in t.device_frames():
                n += 1
                if outs is not None:
                    last = (outs, i)
            if last is not None:
                jax.block_until_ready(last[0])
            return n

        _m2_run()  # compile warmup
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            nm2 = _m2_run()
            best = max(best, nm2 / (time.perf_counter() - t0))
            if not stage_ok("mpeg2 rep", 20):
                break
        RESULT["mpeg2_fps"] = round(best, 2)
        # m2dec_hd: capacity-patched staging of the reference m2dec
        # app (its stock frame heap is 720x576 and segfaults on
        # 1080p input; decode logic identical). -n <count> stops
        # before the reference's crashing EOS-drain call.
        refhd = REPO / "build" / "ref" / "m2dec_hd"
        if refhd.exists():
            rfps = ref_engine_fps(
                [str(refhd), "-n", str(nm2), "-o", "/dev/null",
                 "m2v_1920x1088_v1.m2v"], nm2)
            if rfps:
                RESULT["mpeg2_ref_fps"] = round(rfps, 2)
                RESULT["vs_baseline_mpeg2"] = round(
                    RESULT["mpeg2_fps"] / rfps, 4)


if __name__ == "__main__":
    main()
    _emit()
