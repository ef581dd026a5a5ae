"""Process-level runtime setup for the entry points (CLI, bench, smoke).

Not run at ``import slr``: library users keep their own JAX settings.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# a fixed path inside the checkout, so every run from this checkout finds
# what earlier runs compiled
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: JAX's own
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache for GPU compiles and
    return its path (None on the CPU: an XLA:CPU executable is tied to
    the features of the host that compiled it). An environment setting
    is JAX's own and left alone. Call after any jax.distributed
    initialization, since this initializes the backend."""
    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Exit with a message unless JAX's default backend is the GPU: a
    measuring entry point never falls back to another device."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU found: JAX's default backend is "
                         f"{backend!r} ({jax.devices()})")


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
