"""Entry-point runtime: compile-cache placement, the no-GPU refusals of
the measuring scripts, and the device-count check of Session.mesh."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from slr import runtime

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == str(REPO / ".jax_cache")


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_enable_compile_cache_places_gpu_cache(monkeypatch):
    """On the GPU the cache goes to the fixed checkout path; on the CPU
    nothing is cached (XLA:CPU executables are host-specific)."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(runtime.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert runtime.enable_compile_cache() is None
    assert calls == []
    monkeypatch.setattr(runtime.jax, "default_backend", lambda: "gpu")
    assert runtime.enable_compile_cache() == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measuring_scripts_refuse_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no GPU found" in p.stderr
    for line in p.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_session_mesh_raises_without_devices(tmp_path):
    """A config asking for more devices than exist fails loudly instead
    of running single-device."""
    from slr.config import DistConfig, ScanConfig
    from slr.pipeline import Session

    n = len(jax.devices())
    sess = Session(tmp_path / "s",
                   ScanConfig(dist=DistConfig(pixel_tiles=n, map_blocks=2)))
    with pytest.raises(RuntimeError, match="devices"):
        sess.mesh
    ok = Session(tmp_path / "t",
                 ScanConfig(dist=DistConfig(pixel_tiles=2, map_blocks=2)))
    assert ok.mesh.shape == {"map_block": 2, "pixel_tile": 2}
