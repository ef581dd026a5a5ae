"""Test configuration: the CPU test platform with 8 virtual devices.

Tests run on 8 virtual CPU devices so the shard_map/psum/ppermute code
paths (pixel-tile halo exchange, distributed Schur BA) are exercised
without several accelerators — SURVEY.md section 6 "Distributed tests
without a cluster". Pallas kernels run in interpret mode on the CPU
(slr.kernels.common.use_interpret). Card-only checks are phases of
chip_smoke.py, run on the GPU.

This must happen before any test module touches a backend.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# Fail loudly on NaNs in tests (SURVEY.md section 7, race/sanitizer analog).
jax.config.update("jax_debug_nans", False)  # enabled per-test where useful
