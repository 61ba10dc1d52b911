"""Entry-point plumbing on the CPU: the persistent compile-cache
directory, and chip_smoke.py's refusals and H.264 phase at a tiny size
against its plain reference (the script itself runs on the GPU)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("case", ["env_set", "env_unset"])
def test_compile_cache_dir(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set and nothing else is set
    in code; otherwise the cache is <checkout>/build/jax_cache."""
    from m2dec_tpu.runtime.compile_cache import DEFAULT_DIR

    code = ("from m2dec_tpu.runtime.compile_cache import "
            "enable_compile_cache as e; import jax; p = e(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    if case == "env_set":
        want = str(tmp_path / "cc")
        r = _run(["-c", code], {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = str(DEFAULT_DIR)
        r = _run(["-c", code], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]
    assert DEFAULT_DIR == REPO / "build" / "jax_cache"


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_python_phase_a():
    r = _run(["-c", "import chip_smoke; chip_smoke.check_native()"],
             {"M2DEC_TPU_NO_NATIVE": "1"})
    assert r.returncode != 0
    assert "native Phase A not loaded" in r.stderr


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CACHE", tmp_path / "smoke")
    return chip_smoke


def test_chip_smoke_h264_phase_matches_reference(smoke, tmp_path):
    """Phase 1 (h264dec --turbo -o, in process) at 80x48 against the
    native Phase A + numpy Phase B reference; a corrupted reference
    digest must be caught."""
    data = smoke.make_stream("h264", 80, 48)
    golden = smoke.reference("h264", data)
    assert len(golden["frames"]) == 12
    rec = smoke.phase_h264_cli(data, golden, tmp_path / "work")
    assert rec["bit_exact"] and rec["pictures"] == 12
    json.dumps(rec)
    bad = json.loads(json.dumps(golden))
    bad["frames"][5]["nv12"] = "0" * 32
    with pytest.raises(AssertionError, match="picture 5"):
        smoke.phase_h264_cli(data, bad, tmp_path / "work")


def test_chip_smoke_multi_stream_phase(smoke):
    """Phase 3's device checksums against the reference's decode-order
    host_checksum, two streams at 80x48."""
    data = smoke.make_stream("h264", 80, 48)
    golden = smoke.reference("h264", data)
    rec = smoke.phase_h264_multi(data, golden, n_streams=2)
    assert rec["bit_exact"] and rec["pictures"] == 24
