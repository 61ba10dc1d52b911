"""General decoder CLI (reference src/app/h264dec.cpp parity).

Flags mirror the reference tool (h264dec.cpp:88-147):
  -b           bypass DPB (parsed + range-checked, then unused — the
               reference parses dpb_ but never passes it to the decoder,
               h264dec.cpp:114,170)
  -d <size>    DPB size 0..32 (same dead variable as -b)
  -e           emptify DPB before next frames (m2decoder.h:149-150)
  -f <skip>    frame-skip scan + header replay; see runtime/skip.py for
               why the reference (and therefore this tool) still decodes
               the full stream afterwards
  -m           force MPEG-2 elementary-stream input
  -o / -O      raw NV12 / per-frame-MD5 output to <basename>.out in CWD
  -s           force MPEG-2 program-stream input
  -x           trap decode errors and force exit code 0
Extensions beyond the reference: -n <max frames>, --jax (device Phase B),
--turbo (overlapped Phase A / batched async Phase B, runtime/turbo.py).

Codec auto-detection by extension replicates detect_file
(m2decoder.h:236-260): m2v->MPEG-2, vob->PS, 264/jsv->H.264, 265->H.265,
anything else MPEG-2.
"""

from __future__ import annotations

import getopt
import pathlib
import sys

USAGE = """Usage:
\th264dec [-b] [-d <dpb_size>] [-o|O ] <infile>
\t\t-b: Bypass DPB
\t\t-d <dpb_size>: Specify number of DPB frames -1, 1..16 (default: -1(auto))
\t\t-e: emptifiy DPB before next frames
\t\t-f <skip_num>: Specify number of frames to be skipped
\t\t-m: MPEG2 elementary input
\t\t-o: RAW output
\t\t-O: MD5 output
\t\t-s: MPEG2 PS input
\t\t-x: Mask SIGABRT on error."""


def _blame():
    sys.stderr.write(USAGE)  # no trailing newline (h264dec.cpp:89-101)
    return 1


def _detect(path: str) -> str:
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    return {"m2v": "mpeg2", "vob": "ps", "264": "h264", "jsv": "h264",
            "265": "h265", "hevc": "h265", "h265": "h265"}.get(ext, "mpeg2")


def _out_path(infile: str) -> pathlib.Path:
    """<basename minus extension>.out in the current directory
    (h264dec.cpp outfilename, :31-48)."""
    base = pathlib.Path(infile).name
    stem = base.rsplit(".", 1)[0] if "." in base else base
    return pathlib.Path(stem + ".out")


class _Sink:
    def __init__(self, fileobj, mode, limit):
        from m2dec_tpu.runtime.output import cropped_nv12_bytes, \
            frame_md5_line

        self._fmt = frame_md5_line if mode == "md5" else cropped_nv12_bytes
        self.f = fileobj
        self.n = 0
        self.limit = limit

    def __call__(self, frame):
        if self.limit and self.n >= self.limit:
            return
        if self.f is not None:
            self.f.write(self._fmt(frame))
        self.n += 1

    @property
    def done(self):
        return bool(self.limit) and self.n >= self.limit


def _announce(dec, codec, state):
    """SetFrames' reconfig banner (m2decoder.h:75): printed once when the
    frame pool is first sized from the headers."""
    if state.get("announced"):
        return
    if codec == "h264":
        if not dec.inited:
            return
        sps = next(iter(dec.sps_store.values()))
        c = sps.frame_crop
        print(f"{sps.pic_width - c[0] - c[1]} x "
              f"{sps.pic_height - c[2] - c[3]} x "
              f"{sps.num_ref_frames + 1}", file=sys.stderr)
    elif codec == "mpeg2":
        if not dec.seq.width:
            return
        # m2d_get_info (mpeg2.cpp:1664-1683): crop == align16 - raw size
        print(f"{dec.seq.width} x {dec.seq.height} x 3", file=sys.stderr)
    else:  # h265
        if not dec.sps_store:
            return
        sps = next(iter(dec.sps_store.values()))
        log2 = sps.log2_ctb
        w = ((sps.pic_width + (1 << log2) - 1) >> log2) << log2
        h = ((sps.pic_height + (1 << log2) - 1) >> log2) << log2
        crop = (sps.cropping[0], w - sps.pic_width + sps.cropping[1],
                sps.cropping[2], h - sps.pic_height + sps.cropping[3])
        nfrm = min(len(sps.short_term_rps)
                   + getattr(sps, "num_long_term_ref_pics_sps", 0), 8)
        print(f"{w - crop[0] - crop[1]} x {h - crop[2] - crop[3]} x "
              f"{nfrm}", file=sys.stderr)
    state["announced"] = True


def _decode_once(dec, post, emptify, step, announce):
    """M2Decoder::decode (m2decoder.h:132-150): pull one frame (or all
    pending ones under -e), then decode one more picture."""
    ready, frm = dec.peek_decoded_frame()
    while ready <= 0:
        err = step()
        announce()
        if err < 0:
            ready, frm = dec.peek_decoded_frame(True)
            while ready:
                dec.get_decoded_frame(True)
                post(frm)
                ready, frm = dec.peek_decoded_frame(True)
            return err
        ready, frm = dec.peek_decoded_frame()
    while True:
        ready, frm = dec.get_decoded_frame()
        post(frm)
        if not emptify:
            break
        ready, frm = dec.peek_decoded_frame()
        if ready <= 0:
            break
    err = step()
    announce()
    return err


def _run_pull_loop(dec, post, emptify, step, announce, stop):
    """h264dec main decode loop (h264dec.cpp:251-257) + decode_residual
    drain (m2decoder.h:151-157)."""
    while True:
        err = _decode_once(dec, post, emptify, step, announce)
        if err < 0 or stop():
            ready, frm = dec.peek_decoded_frame(True)
            while ready:
                dec.get_decoded_frame(True)
                post(frm)
                ready, frm = dec.peek_decoded_frame(True)
            return


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    try:
        opts, args = getopt.gnu_getopt(argv, "bd:ef:moOsxn:C",
                                       ["jax", "turbo"])
    except getopt.GetoptError:
        return _blame()
    codec = None
    dpb = -1
    emptify = False
    skip_num = 0
    out_mode = None
    force_exec = False
    limit = 0
    use_jax = False
    for flag, val in opts:
        if flag == "-b":
            dpb = 1
        elif flag == "-d":
            dpb = int(val, 0)
            if dpb > 32 or dpb < 0:  # 32 < (unsigned)dpb_ (h264dec.cpp:118)
                return _blame()
        elif flag == "-e":
            emptify = True
        elif flag == "-f":
            skip_num = int(val, 0)
        elif flag == "-m":
            codec = "mpeg2"
        elif flag == "-C":
            out_mode = "cks"
        elif flag == "-o":
            out_mode = "raw"
        elif flag == "-O":
            out_mode = "md5"
        elif flag == "-s":
            codec = "ps"
        elif flag == "-x":
            force_exec = True
        elif flag == "-n":
            limit = int(val)
        elif flag == "--jax":
            use_jax = True
        elif flag == "--turbo":
            use_jax = "turbo"
    del dpb  # parsed + validated like the reference, then unused there too
    if not args:
        return _blame()
    infile = args[0]
    try:
        data = pathlib.Path(infile).read_bytes()
    except OSError:
        return _blame()
    if codec is None:
        codec = _detect(infile)
    try:
        return _decode_main(infile, data, codec, emptify, skip_num,
                            out_mode, limit, use_jax)
    except Exception as e:
        if force_exec:
            print(f"trap {e.__class__.__name__}", file=sys.stderr)
            return 0
        raise


def _decode_main(infile, data, codec, emptify, skip_num, out_mode, limit,
                 use_jax):
    if codec == "ps":
        from m2dec_tpu.containers.ps import PsDemuxer

        data = PsDemuxer(data).video_stream()
        codec = "mpeg2"

    if out_mode == "cks":
        # device-resident golden mode (runtime/golden.py): per-frame
        # strong checksums computed ON DEVICE, frames never ride the
        # d2h path — the full-speed analog of -O (FileWriterMd5,
        # filewrite.h:91-125) for the HBM serving contract
        from m2dec_tpu.runtime.golden import CksWriter
        from m2dec_tpu.runtime.turbo import TurboH264Decoder

        if codec != "h264":
            return _blame()
        state = {}
        w = CksWriter(_out_path(infile))
        turbo = TurboH264Decoder(data)
        n = 0
        for frm, outs, i in turbo.device_frames():
            _announce(turbo.dec, codec, state)
            if outs is None:
                from m2dec_tpu.runtime.output import cropped_nv12_bytes

                w.write_host_frame(cropped_nv12_bytes(frm))
            else:
                w.write_device_frame(outs[0][i], outs[1][i], outs[2][i],
                                     frm.crop)
            n += 1
            if limit and n >= limit:
                break
        w.close()
        return 0

    out_f = open(_out_path(infile), "wb") if out_mode else None
    sink = _Sink(out_f, out_mode, limit)
    state: dict = {}
    try:
        if codec == "h264" and use_jax == "turbo" and not skip_num:
            # overlapped Phase A / batched async Phase B
            # (runtime/turbo.py); output-identical to the serial loop
            from m2dec_tpu.runtime.turbo import TurboH264Decoder

            turbo = TurboH264Decoder(data)
            for frame in turbo.frames():
                _announce(turbo.dec, codec, state)
                sink(frame)
                if sink.done:
                    break
        elif codec == "h264":
            from m2dec_tpu.codecs.h264.decoder import H264Decoder

            if use_jax:
                # the full two-phase engine: C++ Phase A (entropy ->
                # plan tensors) + the jitted Phase-B reconstruction
                # (no plan_alloc="empty" here: the per-picture Phase B
                # reads plans densely, not through the coded-map pack)
                dec = H264Decoder(native=True, phase_b="jax")
            else:
                dec = H264Decoder()
            if skip_num:
                from m2dec_tpu.runtime.skip import h264_skip_scan

                skipped, nbytes, headers = h264_skip_scan(data, skip_num)
                # header replay (m2decoder.h:121-124): parses SPS/PPS and
                # sizes the frame pool (banner) before the Skip report
                dec.set_data(b"".join(data[a:b] for a, b in headers))
                dec.decode_picture()
                _announce(dec, codec, state)
                print(f"Skip {skipped} frames({nbytes} bytes).",
                      file=sys.stderr)
            # full-stream decode regardless of -f (reference bug chain;
            # see runtime/skip.py)
            dec.set_data(data)
            _run_pull_loop(dec, sink, emptify, dec.decode_picture,
                           lambda: _announce(dec, codec, state),
                           lambda: sink.done)
        elif codec == "mpeg2":
            from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder

            dec = Mpeg2Decoder()
            dec.set_data(data)
            _run_pull_loop(dec, sink, emptify, dec.decode_data,
                           lambda: _announce(dec, codec, state),
                           lambda: sink.done)
        else:  # h265: decode_all drain (no picture-at-a-time API yet)
            from m2dec_tpu.codecs.h265.headers import H265Decoder

            dec = H265Decoder()
            dec.set_data(data)
            kw = {"backend": "jax"} if use_jax else {}
            for frame in dec.decode_all(**kw):
                _announce(dec, codec, state)
                sink(frame)
                if sink.done:
                    break
    finally:
        if out_f is not None:
            out_f.close()
    return 0


def cli():
    """Console entry point: main() with the persistent compile cache."""
    from m2dec_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    return main()


if __name__ == "__main__":
    sys.exit(cli())
