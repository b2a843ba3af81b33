"""Platform set-up: the GPU smoke script's refusal to run elsewhere, the
peak-rate table, the persistent compile cache's directory and the forced
multi-host initialisation."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest

from boslam_tpu.utils import timing

ROOT = Path(__file__).resolve().parents[1]


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero within seconds, before
    compiling anything, and prints no result line."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        env=_cpu_env(), capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert r.stdout == ""
    assert "needs an NVIDIA GPU" in r.stderr
    assert time.perf_counter() - t0 < 60


class _Dev:
    def __init__(self, platform, device_kind):
        self.platform = platform
        self.device_kind = device_kind


def test_device_peaks_h100_row(monkeypatch):
    monkeypatch.setattr(
        jax, "devices", lambda *a: [_Dev("gpu", "NVIDIA H100 80GB HBM3")])
    assert timing.device_peaks() == (989e12, 3.35e12)


def test_device_peaks_unknown_gpu_raises(monkeypatch):
    monkeypatch.setattr(
        jax, "devices", lambda *a: [_Dev("gpu", "NVIDIA A100-SXM4-40GB")])
    with pytest.raises(ValueError, match="A100"):
        timing.device_peaks()


def test_device_peaks_none_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    assert timing.device_peaks() is None


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "checkout"])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins and the package sets nothing; without
    it the cache is the checkout's fixed .jax_cache directory."""
    env = _cpu_env(PYTHONPATH=str(ROOT))
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import jax, boslam_tpu;"
        "print(jax.config.jax_compilation_cache_dir);"
        "print(jax.config.jax_persistent_cache_min_compile_time_secs)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    cache_dir, min_secs = r.stdout.split()
    if from_env:
        assert cache_dir == str(tmp_path / "cache")
        assert float(min_secs) != 2.0  # JAX's own default, untouched
    else:
        assert cache_dir == str(ROOT / ".jax_cache")
        assert float(min_secs) == 2.0


def test_forced_distributed_init_raises():
    """``--distributed`` (force=True) without a reachable cluster is an
    error, not a silent single-process run."""
    code = (
        "from boslam_tpu.parallel.distributed import maybe_initialize;"
        "maybe_initialize(force=True)"
    )
    env = _cpu_env()
    for k in ("BOSLAM_COORDINATOR", "BOSLAM_DISTRIBUTED"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "continuing single-process" not in r.stderr
