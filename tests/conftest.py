"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-chip sharding paths
(m2dec_tpu/parallel) compile and execute without accelerator hardware.
Must run before the first `import jax` anywhere in the test process.
"""

import os

# FORCE cpu (not setdefault): subprocess-based tests inherit it, and a
# test process must not claim a GPU's memory
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import pathlib
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_BUILD = REPO / "build" / "ref"


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free compiled XLA:CPU executables between test modules.

    The full suite compiles 300+ distinct graphs; keeping them all
    loaded reproducibly SEGFAULTS XLA:CPU's JIT inside
    backend_compile_and_load on a late compilation (same site every
    run, plenty of free RAM — JIT code-arena exhaustion). Dropping the
    jit caches per module releases the executables; our lru-cached
    jit wrappers transparently recompile on next use."""
    yield
    jax.clear_caches()


#: modules whose tests each compile large distinct graphs (whole-GOP
#: turbo scans, the unrolled H.265 tile wavefront): r5's bigger
#: executables re-triggered the arena segfault WITHIN one module, so
#: these release per test (their graphs rarely share a geometry —
#: the recompile cost is near zero)
_HEAVY_MODULES = {"test_turbo", "test_resolution_switch",
                  "test_h265_tile"}


@pytest.fixture(autouse=True)
def _release_heavy_executables(request):
    yield
    if request.module.__name__ in _HEAVY_MODULES:
        jax.clear_caches()


@pytest.fixture(scope="session")
def reference_bins():
    """Build (if needed) and return paths of the reference oracle binaries."""
    h264dec = REF_BUILD / "h264dec"
    m2dec = REF_BUILD / "m2dec"
    h264dec_fast = REF_BUILD / "h264dec_fast"
    if not (h264dec.exists() and m2dec.exists() and h264dec_fast.exists()):
        if not pathlib.Path("/root/reference").exists():
            pytest.skip("reference tree not available")
        subprocess.run(["bash", str(REPO / "tools" / "build_reference.sh")], check=True)
    return {"h264dec": h264dec, "m2dec": m2dec, "h264dec_fast": h264dec_fast}
