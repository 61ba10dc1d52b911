#!/usr/bin/env python3
"""Run the decoder's main path once on one GPU at 1080p, bit-exact.

    python chip_smoke.py            # phases 0-5 on one card
    python chip_smoke.py --chips 4  # only the parallel/mesh.py steps

Phases, one JSON line each, in this order:

0. device: the JAX backend is a GPU, the card's name and power limit
   (nvidia-smi), and the native Phase-A libraries loaded;
1. H.264 1920x1088 IPBPBPBPBPBP through ``h264dec --turbo -o``;
2. H.264 High (intra 8x8, 8x8 transform) I/P/B through TurboH264Decoder;
3. four copies of stream 1 through MultiStreamPhaseB(stacked=True),
   outputs left on the device and compared by checksum;
4. H.265 through TurboH265Decoder.device_frames();
5. MPEG-2 through TurboMpeg2Decoder.device_frames().

Every plane of every picture is compared with the repo's plain
reference: H.264 = native Phase A + the numpy Phase B (recon_ref.py),
H.265 = the pure-Python decoder, MPEG-2 = the serial decoder with the
numpy Phase B. Streams and references are computed on the host by
worker processes that never import JAX, so one process uses the card.
Both are cached under build/smoke/, keyed by the generator's class,
arguments and seed.

``--chips 4`` runs h264_gop_step, h264_gop_xchg_step, h264_tile_step
and h265_gop_step on four cards with plans of the 1080p streams'
native Phase A, each compared byte for byte with the one-device graph
of the same plans.

The last line is ``{"ok": true, "device": {...}}``. Any mismatch or
error exits non-zero without it; nothing is caught and carried on.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]
CACHE = REPO / "build" / "smoke"
W, H = 1920, 1088
SEED = 42

#: stream name -> (codec, generator "module.Class", kwargs, pattern)
STREAMS = {
    # bench.py's H.264 settings: CAVLC, 2 refs, B-direct, deblocking
    "h264": ("h264", "h264_enc.H264BGen",
             dict(seed=SEED, num_ref_frames=2, b_direct_prob=0.3,
                  skip_prob=0.35, intra_prob=0.08, qp=30,
                  disable_deblock=False), "IPBPBPBPBPBP"),
    "h264_high": ("h264", "h264_enc.H264HighBGen",
                  dict(seed=SEED, num_ref_frames=2, b_direct_prob=0.3,
                       skip_prob=0.35, intra_prob=0.08, qp=30,
                       disable_deblock=False, i8x8_prob=0.5,
                       t8_prob=0.5), "IPBPBP"),
    "h265": ("h265", "h265_enc.H265StreamGen",
             dict(seed=SEED, qp=32, cbf_prob=0.4, modes="ALL_MODES",
                  tmvp=1, deblock=1, sao=1, max_level=1), "IPBPBP"),
    "mpeg2": ("mpeg2", "mpeg2_enc.Mpeg2StreamGen", dict(seed=SEED),
              "IPBPBPBPBPBP"),
}


# ---------------------------------------------------------------------
# host side: streams and plain references (worker processes, no JAX)
# ---------------------------------------------------------------------


def _key(name, w, h):
    codec, gen, kw, pattern = STREAMS[name]
    blob = json.dumps([gen, kw, pattern, w, h], sort_keys=True)
    return f"{name}_{w}x{h}_{hashlib.sha256(blob.encode()).hexdigest()[:12]}"


def stream_path(name, w=W, h=H):
    return CACHE / f"{_key(name, w, h)}.bin"


def _write_atomic(path, data: bytes):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def make_stream(name, w=W, h=H) -> bytes:
    """The generated stream (cached)."""
    path = stream_path(name, w, h)
    if path.exists():
        return path.read_bytes()
    import importlib

    _, gen, kw, pattern = STREAMS[name]
    mod, cls = gen.rsplit(".", 1)
    module = importlib.import_module(f"streamgen.{mod}")
    kw = {k: getattr(module, v) if k == "modes" else v
          for k, v in kw.items()}
    data = getattr(module, cls)(w, h, **kw).generate(pattern)
    _write_atomic(path, data)
    return data


def digest(a) -> str:
    import numpy as np

    a = np.ascontiguousarray(np.asarray(a), dtype=np.uint8)
    return hashlib.sha256(a.tobytes()).hexdigest()[:32]


def _frame_entry(frm):
    from m2dec_tpu.runtime.output import cropped_nv12_bytes

    return {"planes": [digest(frm.y), digest(frm.cb), digest(frm.cr)],
            "nv12": hashlib.sha256(
                cropped_nv12_bytes(frm)).hexdigest()[:32]}


def _drain(dec, step, out):
    """The decode_all pull loop, digesting each frame as it is output."""
    while True:
        ready, frm = dec.peek_decoded_frame()
        while ready:
            dec.get_decoded_frame()
            out.append(_frame_entry(frm))
            ready, frm = dec.peek_decoded_frame()
        if step() < 0:
            ready, frm = dec.peek_decoded_frame(True)
            while ready:
                dec.get_decoded_frame(True)
                out.append(_frame_entry(frm))
                ready, frm = dec.peek_decoded_frame(True)
            return out


def reference(codec, data: bytes) -> dict:
    """Digests of the plain reference decode: per output frame the
    y/cb/cr planes and the cropped NV12 bytes; for H.264 also the
    decode-order host_checksum that MultiStreamPhaseB.checksums
    reproduces on the device."""
    import numpy as np

    frames: list = []
    golden = {"frames": frames}
    if codec == "h264":
        from m2dec_tpu.codecs.h264.decoder import H264Decoder
        from m2dec_tpu.codecs.h264.reconstruct import host_checksum

        dec = H264Decoder(native=True, phase_b="np")
        dec.set_data(data)
        decoded = []

        def step():
            err = dec.decode_picture()
            if err == 1:
                f = dec.frames[dec.cur_idx]
                decoded.append((f.y.copy(), f.cb.copy(), f.cr.copy()))
            return err

        _drain(dec, step, frames)
        golden["decode_checksum"] = host_checksum(
            *(np.stack(p) for p in zip(*decoded))).tolist()
    elif codec == "h265":
        from m2dec_tpu.codecs.h265.headers import H265Decoder

        dec = H265Decoder()
        dec.set_data(data)
        dec.begin_decode()
        _drain(dec, dec.decode_picture, frames)
    else:
        from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder

        dec = Mpeg2Decoder(backend="numpy")
        dec.set_data(data)
        _drain(dec, dec.decode_data, frames)
    return golden


def host_job(name, w=W, h=H, with_reference=True):
    """Worker process: the stream, then its reference digests (both
    cached). Refuses to have imported JAX: the card is the parent's."""
    data = make_stream(name, w, h)
    golden = None
    if with_reference:
        path = CACHE / f"{_key(name, w, h)}.golden.json"
        if path.exists():
            golden = json.loads(path.read_text())
        else:
            golden = reference(STREAMS[name][0], data)
            _write_atomic(path, json.dumps(golden).encode())
    if "jax" in sys.modules:
        raise RuntimeError(f"host job {name} imported jax")
    return golden


def _worker_init():
    # a worker must never open the card; were JAX imported by mistake,
    # it stays on the CPU and host_job fails loudly
    os.environ["JAX_PLATFORMS"] = "cpu"


class HostJobs:
    """Streams and references computed in parallel by spawned workers
    while the parent drives the card. A worker that dies breaks the
    pool, and waiting on it raises."""

    #: longest wait for any host job
    TIMEOUT_S = 1000.0

    def __init__(self, names, with_reference=True, w=W, h=H):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.w, self.h = w, h
        self.deadline = time.monotonic() + self.TIMEOUT_S
        self.pool = ProcessPoolExecutor(
            len(names), mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
        self.jobs = {n: self.pool.submit(host_job, n, w, h,
                                         with_reference) for n in names}

    def _left(self):
        return max(0.0, self.deadline - time.monotonic())

    def stream(self, name) -> bytes:
        """Wait for the stream file (written before the reference)."""
        path = stream_path(name, self.w, self.h)
        job = self.jobs[name]
        while not path.exists():
            if job.done():
                job.result()  # re-raises the worker's error
            if not self._left():
                raise TimeoutError(f"stream {name} not generated")
            time.sleep(0.2)
        return path.read_bytes()

    def golden(self, name) -> dict:
        return self.jobs[name].result(timeout=self._left())

    def check(self):
        """Read every job's result, so no worker error goes unseen."""
        for job in self.jobs.values():
            job.result(timeout=self._left())

    def close(self):
        procs = list((self.pool._processes or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            p.terminate()
            p.join()


# ---------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return "; ".join(ln.strip() for ln in out.splitlines())


def check_native():
    """The C++ Phase-A libraries, built and loaded: the pure-Python
    Phase A the library falls back to would decode far too slowly."""
    from concurrent.futures import ThreadPoolExecutor

    from m2dec_tpu import native as N

    loaders = {"m2v": N.load_m2v, "h264": N.load_h264,
               "h265": N.load_h265, "oplevel": N.load_oplevel}
    with ThreadPoolExecutor(len(loaders)) as ex:  # g++ runs in parallel
        libs = dict(zip(loaders, ex.map(lambda f: f(), loaders.values())))
    missing = [k for k, v in libs.items() if v is None]
    if missing:
        raise RuntimeError(f"native Phase A not loaded: {missing}")
    return sorted(libs)


def _block(outs_list):
    import jax

    for outs in outs_list:
        jax.block_until_ready(outs)


def _device_digests(it):
    """(frm, outs, i) events -> output-order digests; returns (digests,
    distinct outs) so callers can wait on the batches."""
    frames, batches = [], {}
    for frm, outs, i in it:
        if outs is None:
            planes = (frm.y, frm.cb, frm.cr)
        else:
            batches[id(outs)] = outs
            planes = (outs[0][i], outs[1][i], outs[2][i])
        frames.append([digest(p) for p in planes])
    return frames, list(batches.values())


def _drive(it):
    """Consume (frm, outs, i) events with planes left on the device;
    returns (pictures, seconds) once every batch finished."""
    t0 = time.perf_counter()
    n, batches = 0, {}
    for _, outs, _ in it:
        n += 1
        if outs is not None:
            batches[id(outs)] = outs
    _block(batches.values())
    return n, time.perf_counter() - t0


def _compare(got, golden, what):
    want = [f["planes"] for f in golden["frames"]]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} frames, reference "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        for p, (x, y) in enumerate(zip(a, b)):
            if x != y:
                raise AssertionError(
                    f"{what}: picture {i} plane {'y cb cr'.split()[p]} "
                    f"differs from the reference")


def phase_h264_cli(data: bytes, golden: dict, workdir: pathlib.Path):
    """h264dec --turbo -o through its main(), in process."""
    from m2dec_tpu.apps import h264dec

    workdir.mkdir(parents=True, exist_ok=True)
    src = workdir / "smoke.264"
    src.write_bytes(data)
    out = workdir / "smoke.out"
    cwd = os.getcwd()
    os.chdir(workdir)  # the CLI writes <basename>.out to the CWD
    try:
        times = []
        for _ in range(2):  # cold (compiles), then warm
            t0 = time.perf_counter()
            if h264dec.main(["--turbo", "-o", str(src)]) != 0:
                raise RuntimeError("h264dec --turbo failed")
            times.append(time.perf_counter() - t0)
    finally:
        os.chdir(cwd)
    raw = out.read_bytes()
    want = [f["nv12"] for f in golden["frames"]]
    fs = len(raw) // max(1, len(want))
    if fs * len(want) != len(raw) or not want:
        raise AssertionError(f"h264dec wrote {len(raw)} bytes for "
                             f"{len(want)} reference frames")
    for i, w in enumerate(want):
        if hashlib.sha256(raw[i * fs:(i + 1) * fs]).hexdigest()[:32] != w:
            raise AssertionError(f"h264dec: picture {i} differs from "
                                 f"the reference")
    return {"pictures": len(want), "bit_exact": True,
            "cold_s": times[0], "warm_fps": len(want) / times[1]}


def phase_turbo(make, golden: dict, what: str):
    """A turbo driver's device_frames(): cold run compared plane by
    plane, then a warm run timed with the planes left on the device."""
    t0 = time.perf_counter()
    got, batches = _device_digests(make().device_frames())
    _block(batches)
    cold = time.perf_counter() - t0
    _compare(got, golden, what)
    n, dt = _drive(make().device_frames())
    return {"pictures": len(got), "bit_exact": True, "cold_s": cold,
            "warm_fps": n / dt}


def phase_h264_multi(data: bytes, golden: dict, n_streams=4):
    """n_streams copies through MultiStreamPhaseB(stacked=True); the
    frames stay on the device and per-stream checksums come back."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from m2dec_tpu.codecs.h264.decoder import H264Decoder
    from m2dec_tpu.codecs.h264.reconstruct import (
        MultiStreamPhaseB,
        dev_pool_size,
    )

    def phase_a(_):
        dec = H264Decoder(native=True, plan_alloc="empty")
        dec.set_data(data)
        while dec.decode_picture() == 1:
            pass
        return dec

    want = np.asarray(golden["decode_checksum"], np.int32)
    batcher = None
    times = []
    with ThreadPoolExecutor(n_streams) as ex:
        for _ in range(2):  # cold (compiles), then warm
            t0 = time.perf_counter()
            decs = list(ex.map(phase_a, range(n_streams)))
            if batcher is None:
                d0 = decs[0]
                batcher = MultiStreamPhaseB(
                    n_streams, d0.max_x, d0.max_y,
                    dev_pool_size(d0.sps.num_ref_frames, len(d0.frames)),
                    stacked=True)
            else:
                batcher.reset()
            cks = MultiStreamPhaseB.checksums(
                batcher.run([d.plans for d in decs]))
            times.append(time.perf_counter() - t0)
            for s in range(n_streams):
                if not np.array_equal(cks[s], want):
                    raise AssertionError(
                        f"multi-stream: stream {s} checksum differs "
                        f"from the reference")
    n = n_streams * len(decs[0].plans)
    return {"streams": n_streams, "pictures": n, "bit_exact": True,
            "cold_s": times[0], "warm_fps": n / times[1]}


def run_single(gpu: str, jobs: HostJobs):
    from m2dec_tpu.runtime.turbo import (
        TurboH264Decoder,
        TurboH265Decoder,
        TurboMpeg2Decoder,
    )

    def emit(name, rec):
        rec = {"phase": name, "geometry": f"{jobs.w}x{jobs.h}", **rec,
               "gpu": gpu}
        print(json.dumps(rec), flush=True)

    data = jobs.stream("h264")
    emit("h264_cli_turbo", phase_h264_cli(
        data, jobs.golden("h264"), CACHE / "work"))
    high = jobs.stream("h264_high")
    emit("h264_high", phase_turbo(lambda: TurboH264Decoder(high),
                                  jobs.golden("h264_high"), "h264_high"))
    emit("h264_multi_stacked", phase_h264_multi(data, jobs.golden("h264")))
    h265 = jobs.stream("h265")
    emit("h265", phase_turbo(lambda: TurboH265Decoder(h265, batch=6),
                             jobs.golden("h265"), "h265"))
    m2v = jobs.stream("mpeg2")
    emit("mpeg2", phase_turbo(lambda: TurboMpeg2Decoder(m2v, batch=12),
                              jobs.golden("mpeg2"), "mpeg2"))


# ---------------------------------------------------------------------
# four cards: the parallel/mesh.py steps against one device
# ---------------------------------------------------------------------


def _h264_dense_plans(data):
    """Decode-order dense plans with device-slot remapping, stacked."""
    import numpy as np

    from m2dec_tpu.codecs.h264.decoder import H264Decoder
    from m2dec_tpu.codecs.h264.reconstruct import (
        _PLAN_KEYS,
        _DevSlotMap,
        _remap_batch,
        dev_pool_size,
    )

    dec = H264Decoder(native=True)
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    plans = dec.plans
    pool = dev_pool_size(dec.sps.num_ref_frames, len(dec.frames))
    stacked = {k: np.stack([getattr(p, k) for p in plans])
               for k in _PLAN_KEYS}
    cur = np.zeros(len(plans), np.int32)
    _remap_batch(stacked["slot"], cur, plans, _DevSlotMap(pool))
    return dec, plans, pool, stacked, cur


def _equal(a, b, what):
    import numpy as np

    if not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError(f"{what}: differs from one device")


def _done(step, t0):
    dt = time.perf_counter() - t0
    print(f"chip_smoke: {step} matches one device ({dt:.1f} s)",
          file=sys.stderr, flush=True)
    return dt


def phase_mesh(h264: bytes, h265: bytes, n_dev: int):
    """Each mesh step at the streams' geometry on n_dev devices against
    the one-device graph of the same plans. Returns per-step seconds
    (compile included)."""
    import functools

    import jax
    import numpy as np

    from m2dec_tpu.codecs.h264.reconstruct import _diag_lanes, _recon_batch
    from m2dec_tpu.parallel import mesh as M

    mesh = M.make_mesh(n_dev)
    G = n_dev
    secs = {}
    dec, plans, pool, st, cur = _h264_dense_plans(h264)
    mb_w, mb_h = dec.max_x, dec.max_y
    Hh, Wh = mb_h * 16, mb_w * 16
    diag = _diag_lanes(mb_w, mb_h)

    def pools(g, p, hh, ww):
        z = np.zeros
        return (z((g, p, hh, ww), np.uint8),
                z((g, p, hh >> 1, ww >> 1), np.uint8),
                z((g, p, hh >> 1, ww >> 1), np.uint8))

    single = jax.jit(functools.partial(
        _recon_batch, mb_w=mb_w, mb_h=mb_h, has_i8=True, deblock=True))
    p1 = pools(1, pool, Hh, Wh)
    _, ref = single(p1[0][0], p1[1][0], p1[2][0], st, {}, cur, diag)
    ref = [np.asarray(o) for o in ref]

    def tile(a):  # the same GOP on every shard
        return np.broadcast_to(a, (G,) + a.shape).copy()

    stg = {k: tile(v) for k, v in st.items()}

    t0 = time.perf_counter()
    step = M.h264_gop_step(mesh, mb_w, mb_h)
    pg = pools(G, pool, Hh, Wh)
    _, outs = step(*pg, stg, tile(cur), diag)
    for o, r in zip(outs, ref):
        for g in range(G):
            _equal(np.asarray(o)[g], r, f"h264_gop_step shard {g}")
    secs["h264_gop_step"] = _done("h264_gop_step", t0)

    t0 = time.perf_counter()
    step = M.h264_gop_xchg_step(mesh, mb_w, mb_h, pool, handoff_slot=0)
    _, outs = step(*pools(G, pool, Hh, Wh), stg, tile(cur))
    for o, r in zip(outs, ref):
        for g in range(G):
            _equal(np.asarray(o)[g], r, f"h264_gop_xchg_step shard {g}")
    secs["h264_gop_xchg_step"] = _done("h264_gop_xchg_step", t0)

    # one picture banded over the mesh: host-slot plans against a
    # host-side shadow pool, picture by picture in decode order
    t0 = time.perf_counter()
    has_i8 = any(bool((p.kind == 2).any()) for p in plans)
    step = M.h264_tile_step(mesh, mb_w, mb_h, has_i8=has_i8)
    n_host = len(dec.frames)
    sy, scb, scr = (a[0] for a in pools(1, n_host, Hh, Wh))
    for k, p in enumerate(plans[:3]):  # I, P, B
        y, cb, cr = step(M.h264_tile_plan(p, G), sy, scb, scr)
        for a, r, pl in zip((y, cb, cr), ref, "y cb cr".split()):
            _equal(a, r[k], f"h264_tile_step picture {k} {pl}")
        sy[p.cur_idx], scb[p.cur_idx], scr[p.cur_idx] = (
            np.asarray(y), np.asarray(cb), np.asarray(cr))
    secs["h264_tile_step"] = _done("h264_tile_step", t0)

    t0 = time.perf_counter()
    from m2dec_tpu.codecs.h265.headers import H265Decoder
    from m2dec_tpu.codecs.h265.reconstruct import (
        _jitted_recon_seq,
        stack_plans,
        wf_mode_for,
    )

    hdec = H265Decoder()
    hdec.set_data(h265)
    hdec.begin_decode(backend="native", defer_recon=True)
    while hdec.decode_picture() == 1:
        pass
    hplans = [p for p in hdec.plans if p is not None]
    p0 = hplans[0]
    wf_mode = wf_mode_for(p0.size_log2)
    xs = stack_plans(hplans, wf_mode)
    hp = pools(1, len(hdec.pool), p0.H, p0.W)
    _, href = _jitted_recon_seq(p0.H, p0.W, False, True, True,
                                p0.size_log2, p0.W, p0.H, wf_mode)(
        hp[0][0], hp[1][0], hp[2][0], xs)
    step = M.h265_gop_step(mesh, p0.H, p0.W, p0.size_log2)
    _, outs = step(*pools(G, len(hdec.pool), p0.H, p0.W),
                   {k: tile(v) for k, v in xs.items()})
    for o, r in zip(outs, href):
        for g in range(G):
            _equal(np.asarray(o)[g], r, f"h265_gop_step shard {g}")
    secs["h265_gop_step"] = _done("h265_gop_step", t0)
    return {"devices": n_dev, "h264_pictures": len(plans),
            "h265_pictures": len(hplans), "bit_exact": True,
            "seconds_cold": secs}


# ---------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: only the mesh steps, on four cards")
    args = ap.parse_args(argv)

    import jax

    from m2dec_tpu.runtime.compile_cache import enable_compile_cache

    devs = jax.devices()
    if jax.default_backend() != "gpu" or any(
            d.platform != "gpu" for d in devs):
        print(f"chip_smoke: no GPU (backend {jax.default_backend()!r}, "
              f"devices {[d.platform for d in devs]})", file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: {args.chips} cards asked, {len(devs)} found",
              file=sys.stderr)
        return 1
    cache_dir = enable_compile_cache()
    gpu = gpu_name_power()
    print(gpu, flush=True)
    names = (["h264", "h265"] if args.chips == 4 else list(STREAMS))
    jobs = HostJobs(names, with_reference=args.chips == 1)
    try:
        print(json.dumps({
            "phase": "device", "backend": jax.default_backend(),
            "kind": devs[0].device_kind, "count": len(devs),
            "jax": jax.__version__, "native": check_native(),
            "compile_cache": cache_dir, "gpu": gpu}), flush=True)
        if args.chips == 4:
            rec = phase_mesh(jobs.stream("h264"), jobs.stream("h265"),
                             args.chips)
            print(json.dumps({"phase": "mesh", "geometry": f"{W}x{H}",
                              **rec, "gpu": gpu}), flush=True)
        else:
            run_single(gpu, jobs)
        jobs.check()
    finally:
        jobs.close()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
