"""Point-to-plane ICP, fully on-device (SURVEY.md component 15, 4.6).

Each iteration: (1) transform source points by the current pose,
(2) tiled-matmul nearest neighbours in the target (slr.registration.nn),
(3) distance-gated correspondence rejection, (4) closed-form 6-dof
point-to-plane Gauss-Newton update from 6x6 normal equations accumulated
with einsum. Fixed iteration count in lax.scan keeps one compiled graph;
the 6x6 accumulation is exactly the quantity a multi-device run psums
(slr.dist), so the distributed and single-chip paths share this code.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slr.geom.se3 import se3_compose, so3_exp
from slr.registration.nn import nearest_neighbors


class ICPResult(NamedTuple):
    R: jnp.ndarray          # (3,3) source -> target rotation
    t: jnp.ndarray          # (3,)
    rms: jnp.ndarray        # final inlier point-to-plane RMS
    inlier_frac: jnp.ndarray


def _solve_point_to_plane(src, tgt, nrm, w):
    """One GN step: minimize sum w ((R src + t - tgt) . n)^2, small-angle.

    Returns (xi (6,) = [tau, omega], mean abs residual). A_i = [n, src x n].
    """
    e = jnp.sum((src - tgt) * nrm, axis=1)          # residuals
    c = jnp.cross(src, nrm)
    A = jnp.concatenate([nrm, c], axis=1)            # (N,6) [t | omega]
    Aw = A * w[:, None]
    H = Aw.T @ A                                     # 6x6
    g = Aw.T @ e
    H = H + 1e-6 * jnp.eye(6, dtype=H.dtype)
    # SPD normal equations: Cholesky, no pivoting needed
    xi = -jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(H, lower=True), g)
    return xi, e


# Above this many query*target pairs the voxel-hash lookup replaces the
# exact tiled brute force. The crossover was measured on the CPU; the
# same rule applies on every backend (the GPU crossover is not measured).
_EXACT_NN_MAX_PAIRS = 24_000 ** 2


def _resolve_nn_method(nn_method: str, N: int, M: int) -> str:
    """Resolve "auto" from the problem size alone (static shapes, so the
    choice is the same inside and outside jit): exact below
    _EXACT_NN_MAX_PAIRS source*target pairs, voxel hash above."""
    if nn_method != "auto":
        return nn_method
    return "voxel" if N * M > _EXACT_NN_MAX_PAIRS else "exact"


def icp_point_to_plane(
    src,
    tgt,
    tgt_normals,
    src_valid=None,
    tgt_valid=None,
    R0=None,
    t0=None,
    iters: int = 20,
    max_corr_dist: float = 10.0,
    nn_tile: int = 2048,
    nn_method: str = "auto",
) -> ICPResult:
    """``nn_method``: "exact" = tiled-matmul brute force; "voxel" =
    static voxel-hash 27-neighbourhood lookup (exact whenever the true
    NN is within max_corr_dist, since the voxel edge equals that
    distance); "auto" = exact below ~24k^2 source*target pairs, voxel
    above."""
    nn_method = _resolve_nn_method(
        nn_method, int(src.shape[0]), int(tgt.shape[0]))
    return _icp_point_to_plane(
        src, tgt, tgt_normals, src_valid, tgt_valid, R0, t0,
        iters=iters, max_corr_dist=max_corr_dist, nn_tile=nn_tile,
        nn_method=nn_method)


@partial(jax.jit, static_argnames=("iters", "nn_tile", "nn_method"))
def _icp_point_to_plane(
    src,                     # (N,3) source points
    tgt,                     # (M,3) target points
    tgt_normals,             # (M,3)
    src_valid=None,          # (N,) bool
    tgt_valid=None,          # (M,) bool
    R0=None,
    t0=None,
    iters: int = 20,
    max_corr_dist: float = 10.0,
    nn_tile: int = 2048,
    nn_method: str = "exact",
) -> ICPResult:
    N = src.shape[0]
    M = tgt.shape[0]
    assert nn_method in ("exact", "voxel"), nn_method
    if src_valid is None:
        src_valid = jnp.ones((N,), bool)
    R0 = jnp.eye(3, dtype=jnp.float32) if R0 is None else R0
    t0 = jnp.zeros(3, jnp.float32) if t0 is None else t0
    max_d2 = max_corr_dist * max_corr_dist

    if nn_method == "voxel":
        from slr.registration.voxel import build_voxel_hash, voxel_hash_nn

        tv = (jnp.ones((M,), bool) if tgt_valid is None else tgt_valid)
        # voxel edge = correspondence radius: any target within
        # max_corr_dist lies in the query's 27-neighbourhood, so the
        # search REGION matches the exact path's gate. Buckets keep the
        # first ``bucket_cap`` points per voxel, so in clouds denser
        # than ~8 points per max_corr_dist^3 the match is a near-NN from
        # the bucket sample rather than the true NN — point-to-plane GN
        # only needs a valid surface correspondence, and the pose-parity
        # test (tests/test_registration.py) holds it to the exact path
        table, row_ids, lo = build_voxel_hash(tgt, tv, max_corr_dist)

    def body(carry, _):
        R, t = carry
        moved = src @ R.T + t
        if nn_method == "voxel":
            idx, d2 = voxel_hash_nn(moved, tgt, table, row_ids, lo,
                                    max_corr_dist)
            idx = jnp.maximum(idx, 0)  # -1 misses carry d2=inf (gated)
        else:
            idx, d2 = nearest_neighbors(moved, tgt, tgt_valid,
                                        tile=nn_tile)
        q = tgt[idx]
        n = tgt_normals[idx]
        w = (src_valid & (d2 < max_d2)).astype(jnp.float32)
        # robust (Huber/IRLS) reweighting: grazing-incidence and edge
        # points carry amplified depth noise that biases the plain L2
        # solve (measured ~0.4 mm systematic residual on a sphere+plane
        # scene); delta adapts to the current inlier residual scale.
        # Scale estimate is 1.3 * weighted mean |e| — for Gaussian
        # residuals that equals the 70th percentile of |e| (half-normal:
        # P70 = 1.036 sigma, mean = 0.798 sigma) without the full
        # device sort a per-iteration percentile would cost;
        # heavy outliers are already gated by max_corr_dist above.
        e_pre = jnp.sum((moved - q) * n, axis=1)
        abs_e = jnp.abs(e_pre)
        mean_abs = jnp.sum(w * abs_e) / jnp.maximum(jnp.sum(w), 1e-9)
        delta = jnp.maximum(1.3 * mean_abs, 1e-6)
        w = w * jnp.minimum(1.0, delta / jnp.maximum(abs_e, 1e-12))
        xi, e = _solve_point_to_plane(moved, q, n, w)
        dR = so3_exp(xi[3:])
        dt = xi[:3]
        # update: p -> dR @ p + dt applied after current pose
        R_new, t_new = se3_compose(dR, dt, R, t)
        wsum = jnp.sum(w)
        # no surviving correspondences = divergence, not a perfect fit
        rms = jnp.where(
            wsum > 1.0,
            jnp.sqrt(jnp.sum(w * e * e) / jnp.maximum(wsum, 1e-9)),
            jnp.inf,
        )
        inl = wsum / (jnp.sum(src_valid.astype(jnp.float32)) + 1e-9)
        return (R_new, t_new), (rms, inl)

    (R, t), (rms_hist, inl_hist) = jax.lax.scan(
        body, (R0, t0), None, length=iters
    )
    return ICPResult(R=R, t=t, rms=rms_hist[-1], inlier_frac=inl_hist[-1])
