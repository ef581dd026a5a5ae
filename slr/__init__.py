"""slr — structured-light 3D reconstruction engine in JAX.

A JAX/XLA implementation of the capability surface of
DrawZeroPoint/Structure-Light-Reconstructor (see SURVEY.md; the reference
mount was empty, so the contract is BASELINE.json's north star):

- Gray-code + N-step phase-shift pattern generation and decoding
- per-pixel temporal + quality-guided phase unwrapping
- Zhang-style camera/projector calibration via batched least squares
- projector-camera triangulation into dense point clouds (a fused Pallas
  kernel on the hot path)
- multi-scan registration (features + RANSAC + ICP) and pose-graph /
  bundle-adjustment refinement, distributable over a device mesh with
  Schur-complement reduction.

Layer map (SURVEY.md section 2.2):
  T6 cli/api  T5 pipeline  T4 dist  T3 kernels  T2 codec/calib/geom/
  registration  T1 io/synth
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/phase math is precision-critical (sub-mm RMS contract, SURVEY.md
# section 6). On the GPU an f32 matmul/einsum may run in TF32 (~3
# decimal digits), which is too coarse for the 3x3 ray/pose contractions,
# so every f32 product in the process runs at full precision. Scoping
# this per call site is ROADMAP Speed 3.
_jax.config.update("jax_default_matmul_precision", "highest")
