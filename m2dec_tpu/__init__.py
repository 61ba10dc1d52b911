"""m2dec_tpu — a GPU video decode engine (MPEG-1/2, H.264/AVC, H.265/HEVC).

A from-scratch JAX/XLA re-design of the capabilities of the reference
decoder `wujs/m2dec` (fixed-point C/C++ decoder library; see SURVEY.md).

Architecture: a two-phase decoupled design.

* Phase A — entropy decode. NAL/slice headers and CAVLC/CABAC/VLC entropy
  decode run bit-serially (host reference engines, with a native C++ fast
  path and wavefront-parallel engines across slices/rows), producing a
  dense "decode plan": per-macroblock mode/MV/ref tensors plus dequantized
  coefficient tensors.
* Phase B — reconstruction. IDCT, intra prediction, fractional-pel motion
  compensation, and in-loop filters run as batched integer kernels over all
  macroblocks of a frame under `jax.jit`,
  sharded across a `jax.sharding.Mesh` for multi-chip scale-out.

Bit-exactness contract: decoded frames match the reference decoder's
reconstruction byte-for-byte (per-frame MD5, reference `test.sh:1-3`).
"""

__version__ = "0.1.0"


def _tune_host_allocator():
    """Keep large numpy/plan buffers in the malloc arena instead of
    per-allocation mmap/munmap: this environment's page-fault path is
    extremely slow (~16 MB/s for fresh pages), and glibc's default
    128KB mmap threshold makes every big temp refault. Retaining arena
    memory turns steady-state buffer churn into warm-page writes."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_host_allocator()
