"""Threaded pipeline player CLI (reference src/app/threadplayer.cpp parity).

Reference flags (threadplayer.cpp:393-523, getopt "ef:hlmor:st:"):
  -e            DPB emptify mode
  -f <3..256>   output-queue depth before display (outbuf_)
  -l            dump the busy/idle stage timeline CSV at exit
  -m            per-frame-MD5 writer -> <basename>.out per input file
  -o            raw NV12 writer     -> <basename>.out per input file
  -r <n>        repeat the playlist n times
  -t <ms>       frame display interval in milliseconds
  -h / -s       accepted by the reference's optstring but unhandled ->
                usage error (replicated)
Multiple input files play back-to-back with codec re-detection per file
(the reference's M2DecoderUnit mid-stream codec switch,
threadplayer.cpp:334-351); each -m/-o writer re-targets <next>.out on
file change (FileWriterUnit::change, :422-431).

Extensions beyond the reference (long options only): --display
ansi|ascii|none (terminal display tier standing in for the SDL window),
--trace FILE (write the CSV to a file instead of stdout), --turbo
(H.264 decodes through the overlapped two-phase driver,
runtime/turbo.py).
"""

from __future__ import annotations

import getopt
import pathlib
import sys

USAGE = """Usage: srview [-m] [-o] [-r] [-t interval] infile [infile ...]
\t-m : outfile(MD5)
\t-o : outfile(Raw)
\t-r : repeat
\t-l : log dump
\t-f frame_num(3-256) : specify number of frames before display.
\t-e : DPB emptify mode
\t-t interval : specify interval of each frame in ms unit
"""


def _blame():
    sys.stderr.write(USAGE)
    return 1


class _WriterUnit:
    """FileWriterUnit (threadplayer.cpp:418-463): a list of writers,
    each re-opening <basename>.out when the input file changes."""

    def __init__(self):
        self.modes: list[str] = []
        self._files: list = []

    def set_mode(self, mode):
        self.modes.append(mode)

    def change(self, infile):
        from m2dec_tpu.runtime.output import cropped_nv12_bytes, \
            frame_md5_line

        self.close()
        base = pathlib.Path(infile).name
        stem = base.rsplit(".", 1)[0] if "." in base else base
        self._files = [
            (open(stem + ".out", "wb"),
             frame_md5_line if m == "md5" else cropped_nv12_bytes)
            for m in self.modes
        ]

    def write(self, frame):
        for f, fmt in self._files:
            f.write(fmt(frame))

    def close(self):
        for f, _ in self._files:
            f.close()
        self._files = []


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    try:
        opts, args = getopt.gnu_getopt(
            argv, "ef:hlmor:st:", ["display=", "trace=", "turbo"])
    except getopt.GetoptError:
        return _blame()
    emptify = False
    outbuf = 3
    logdump = False
    repeat = 1
    interval_ms = 0
    writers = _WriterUnit()
    display = "none"
    trace_out = None
    two_phase = False
    for flag, val in opts:
        if flag == "-e":
            emptify = True
        elif flag == "-f":
            outbuf = int(val, 0)
            if not (3 <= outbuf <= 256):  # 253U < (unsigned)(outbuf-3)
                return _blame()
        elif flag == "-l":
            logdump = True
        elif flag == "-m":
            writers.set_mode("md5")
        elif flag == "-o":
            writers.set_mode("raw")
        elif flag == "-r":
            repeat = int(val, 0)
        elif flag == "-t":
            interval_ms = max(int(val, 0), 1)
        elif flag == "--display":
            display = val
        elif flag == "--trace":
            trace_out = val
        elif flag == "--turbo":
            two_phase = True  # overlapped Phase A/B (runtime/turbo.py)
        else:  # -h, -s: in the reference optstring but unhandled
            return _blame()
    if not args:
        return _blame()

    from m2dec_tpu.runtime.display import make_display
    from m2dec_tpu.runtime.pipeline import Pipeline

    disp = make_display(display)
    n_total = 0
    csv_rows = []
    for _ in range(max(repeat, 1)):
        for infile in args:
            data = pathlib.Path(infile).read_bytes()
            pipe = Pipeline(data, queue_depth=outbuf, emptify=emptify,
                            two_phase=two_phase)
            writers.change(infile)

            def sink(frame):
                writers.write(frame)
                if disp:
                    disp.show(frame)
                if interval_ms:
                    import time

                    time.sleep(interval_ms / 1000.0)

            n_total += pipe.run(sink)
            csv_rows.append(pipe.timeline_csv())
    writers.close()
    if trace_out:
        pathlib.Path(trace_out).write_text("".join(csv_rows))
    elif logdump:
        sys.stdout.write("".join(csv_rows))
    print(f"{n_total} frames", file=sys.stderr)
    return 0


def cli():
    """Console entry point: main() with the persistent compile cache."""
    from m2dec_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    return main()


if __name__ == "__main__":
    sys.exit(cli())
