"""Shared kernel utilities: the interpret-mode choice."""

from __future__ import annotations

import jax


def use_interpret() -> bool:
    """Pallas interpret mode: on for the CPU backend (tests), off on the
    GPU, where every kernel is compiled. Any other backend raises: the
    kernels name the Triton route, which exists only on the GPU."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas route for backend {backend!r}: slr's kernels run on "
        "the GPU (Triton) or interpreted on the CPU")
