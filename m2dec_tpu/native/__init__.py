"""Native (C++) Phase-A front ends.

The bit-serial entropy decode is the host-side half of the two-phase
engine; these modules build and load the C++ implementations with a
transparent fallback to the pure-Python Phase A when no toolchain is
available. Build artifacts land in build/native/.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

_HERE = pathlib.Path(__file__).resolve().parent
_REPO = _HERE.parent.parent


def _cpu_tag():
    """Host-CPU cache key: -march=native binaries built on one host
    can SIGILL on another ISA if the build dir is shared/copied
    (advisor r4) — key the cache directory on the CPU identity."""
    import hashlib
    import platform

    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith(("model name", "flags")):
                    tag += ln
                    if ln.startswith("flags"):
                        break
    except OSError:
        pass
    return hashlib.sha1(tag.encode()).hexdigest()[:8]


_BUILD = _REPO / "build" / "native" / _cpu_tag()


def _compile(src, out, flags=("-march=native",)):
    """g++ src -> out, written under a temporary name and renamed into
    place, so processes that build the same library at once never load
    a half-written file."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", *flags, "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(src)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)

_m2v_lib = None
_m2v_tried = False


class M2vPicParams(ctypes.Structure):
    _fields_ = [
        ("mb_w", ctypes.c_int32),
        ("mb_h", ctypes.c_int32),
        ("is_mpeg2", ctypes.c_int32),
        ("coding_type", ctypes.c_int32),
        ("r_size", ctypes.c_int32 * 4),
        ("intra_dc_precision", ctypes.c_int32),
        ("frame_pred_frame_dct", ctypes.c_int32),
        ("concealment_motion_vectors", ctypes.c_int32),
        ("q_scale_type", ctypes.c_int32),
        ("intra_vlc_format", ctypes.c_int32),
        ("alternate_scan", ctypes.c_int32),
        ("picture_structure", ctypes.c_int32),
        ("qmat_intra", ctypes.c_int32 * 64),
        ("qmat_nonintra", ctypes.c_int32 * 64),
    ]


def _build_m2v():
    _BUILD.mkdir(parents=True, exist_ok=True)
    src = _HERE / "m2vparse.cpp"
    out = _BUILD / "libm2vparse.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    inc = _HERE / "mpeg2_tables.inc"
    if not inc.exists():
        subprocess.run(
            ["python3", str(_REPO / "tools" / "gen_mpeg2_tables_c.py")],
            check=True,
        )
    _compile(src, out)
    return out


def load_m2v():
    """Return the m2v Phase-A library handle, or None (Python fallback)."""
    global _m2v_lib, _m2v_tried
    if _m2v_tried:
        return _m2v_lib
    _m2v_tried = True
    if os.environ.get("M2DEC_TPU_NO_NATIVE"):
        return None
    try:
        path = _build_m2v()
        lib = ctypes.CDLL(str(path))
        fn = lib.m2v_decode_picture
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(M2vPicParams),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _m2v_lib = lib
    except Exception:
        _m2v_lib = None
    return _m2v_lib


# ---------------------------------------------------------------- H.264 --

_h264_lib = None
_h264_tried = False


class H264SliceParams(ctypes.Structure):
    _fields_ = [
        ("slice_type", ctypes.c_int32),
        ("is_cabac", ctypes.c_int32),
        ("cabac_init_idc", ctypes.c_int32),
        ("qp", ctypes.c_int32),
        ("first_mb", ctypes.c_int32),
        ("num_ref_idx", ctypes.c_int32 * 2),
        ("constrained_intra", ctypes.c_int32),
        ("t8x8_mode", ctypes.c_int32),
        ("chroma_qp_index", ctypes.c_int32 * 2),
        ("direct_spatial", ctypes.c_int32),
        ("weighted_mode", ctypes.c_int32),
        ("deb_idc_plus1", ctypes.c_int32),
        ("alpha_ofs", ctypes.c_int32),
        ("beta_ofs", ctypes.c_int32),
        ("poc", ctypes.c_int32),
        ("is_field", ctypes.c_int32),
        ("bit_offset", ctypes.c_int64),
    ]


def _build_h264():
    _BUILD.mkdir(parents=True, exist_ok=True)
    src = _HERE / "h264parse.cpp"
    out = _BUILD / "libh264parse.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    inc = _HERE / "h264_tables.inc"
    if not inc.exists() or inc.stat().st_mtime < src.stat().st_mtime - 864000:
        subprocess.run(
            ["python3", str(_REPO / "tools" / "gen_h264_tables_c.py")],
            check=True,
        )
    _compile(src, out)
    return out


def load_h264():
    """Return the native H.264 Phase-A library, or None."""
    global _h264_lib, _h264_tried
    if _h264_tried:
        return _h264_lib
    _h264_tried = True
    if os.environ.get("M2DEC_TPU_NO_NATIVE"):
        return None
    try:
        path = _build_h264()
        lib = ctypes.CDLL(str(path))
        lib.h264p_new.restype = ctypes.c_void_p
        lib.h264p_new.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.h264p_free.argtypes = [ctypes.c_void_p]
        lib.h264p_begin_picture.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        lib.h264pack_new.restype = ctypes.c_void_p
        lib.h264pack_new.argtypes = []
        lib.h264pack_free.argtypes = [ctypes.c_void_p]
        lib.h264pack_measure.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        lib.h264pack_fill.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.h264p_set_refs.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p] * 10
        lib.h264p_finalize_deblock.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.h264p_slice.restype = ctypes.c_int
        lib.h264p_slice.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(H264SliceParams),
            ctypes.POINTER(ctypes.c_int32)]
        _h264_lib = lib
    except Exception:
        _h264_lib = None
    return _h264_lib


# ----------------------------------------------------------------- H.265 --

class H265SliceParams(ctypes.Structure):
    """Mirror of native/h265parse.cpp H265SliceParams (field order must
    match)."""

    _fields_ = [
        ("slice_type", ctypes.c_int32),
        ("slice_qpy", ctypes.c_int32),
        ("cabac_init_flag", ctypes.c_int32),
        ("sao_luma", ctypes.c_int32),
        ("sao_chroma", ctypes.c_int32),
        ("slice_addr", ctypes.c_int32),
        ("max_merge", ctypes.c_int32),
        ("mvd_l1_zero", ctypes.c_int32),
        ("temporal_mvp", ctypes.c_int32),
        ("colocated_from_l0", ctypes.c_int32),
        ("collocated_ref_idx", ctypes.c_int32),
        ("num_ref_idx_minus1", ctypes.c_int32 * 2),
        ("deblock_disabled", ctypes.c_int32),
        ("beta_offset_div2", ctypes.c_int32),
        ("tc_offset_div2", ctypes.c_int32),
        ("qpc_delta", ctypes.c_int32 * 2),
        ("sign_data_hiding", ctypes.c_int32),
        ("transform_skip", ctypes.c_int32),
        ("cu_qp_delta", ctypes.c_int32),
        ("max_hier_intra", ctypes.c_int32),
        ("max_hier_inter", ctypes.c_int32),
        ("amp", ctypes.c_int32),
        ("log2_parallel_merge", ctypes.c_int32),
        ("min_cb_log2", ctypes.c_int32),
        ("max_tb_log2", ctypes.c_int32),
        ("min_tb_log2", ctypes.c_int32),
        ("bit_offset", ctypes.c_int64),
        ("ref_poc", ctypes.c_int32 * 32),
        ("ref_fidx", ctypes.c_int32 * 32),
        ("col_page", ctypes.c_int32),
        ("lowdelay", ctypes.c_int32),
        ("colmv", ctypes.c_int32 * 64),
        ("tmv", ctypes.c_int32 * 64),
        ("fidx_curr", ctypes.c_int32 * 32),
        ("fidx_col", ctypes.c_int32 * 32),
        ("cb_qp_offset", ctypes.c_int32),
        ("cr_qp_offset", ctypes.c_int32),
    ]


_h265_lib = None
_h265_tried = False


def _build_h265():
    _BUILD.mkdir(parents=True, exist_ok=True)
    src = _HERE / "h265parse.cpp"
    out = _BUILD / "libh265parse.so"
    inc = _HERE / "h265_tables.inc"
    if not inc.exists():
        subprocess.run(
            ["python3", str(_REPO / "tools" / "gen_h265_tables_c.py")],
            check=True,
        )
    if out.exists() and out.stat().st_mtime >= max(
            src.stat().st_mtime, inc.stat().st_mtime):
        return out
    _compile(src, out)
    return out


def load_h265():
    """Build+load the native H.265 Phase A; None when unavailable."""
    global _h265_lib, _h265_tried
    if _h265_tried:
        return _h265_lib
    _h265_tried = True
    if os.environ.get("M2DEC_TPU_NO_NATIVE"):
        return None
    try:
        path = _build_h265()
        lib = ctypes.CDLL(str(path))
        lib.h265p_new.restype = ctypes.c_void_p
        lib.h265p_new.argtypes = [ctypes.c_int] * 5
        lib.h265p_free.argtypes = [ctypes.c_void_p]
        lib.h265p_begin_picture.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.h265p_slice.restype = ctypes.c_int
        lib.h265p_slice.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(H265SliceParams)]
        lib.h265p_finish.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p] * 3
        _h265_lib = lib
    except Exception:
        _h265_lib = None
    return _h265_lib


_oplevel_lib = None
_oplevel_tried = False


def _build_oplevel():
    _BUILD.mkdir(parents=True, exist_ok=True)
    src = _HERE / "oplevel.cpp"
    out = _BUILD / "liboplevel.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    _compile(src, out, flags=())
    return out


def load_oplevel():
    """H.265 intra-op level scheduler (oplevel.cpp), or None."""
    global _oplevel_lib, _oplevel_tried
    if _oplevel_tried:
        return _oplevel_lib
    _oplevel_tried = True
    if os.environ.get("M2DEC_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(_build_oplevel()))
        fn = lib.h265_schedule_levels
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_void_p]
        _oplevel_lib = lib
    except Exception:
        _oplevel_lib = None
    return _oplevel_lib
