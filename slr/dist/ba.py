"""Distributed Schur-complement bundle adjustment over scanner poses.

SURVEY.md section 4.7 / component 16, the [B:5] prescription: "distributed
bundle adjustment via Schur-complement reduction ... psum/all-gather
collectives for the camera/projector pose block".

Model: S scan poses T_s = (R_s, t_s) (scan -> world) and L fused
landmarks X_l (world). Observation (l, k): landmark l was measured at
position p in the local frame of scan s_k; residual

    r = R_s^T (X_l - t_s) - p                                 (3-vector)

Right-perturbation linearization (xi = [tau, omega], T <- T . Exp(xi)):

    J_pose = [-I3 | hat(x0)],   J_X = R_s^T,   x0 = R_s^T (X_l - t_s)

Landmarks couple poses only through the Schur complement: each residual
touches one pose, so H_pp is block-diagonal; eliminating the landmark
blocks (H_ll = (sum_k w_k) I3 + damping — rotations are orthonormal)
yields the reduced 6S x 6S pose system

    H_red = H_pp - sum_l W_l H_ll^-1 W_l^T,   g_red = g_p - W H_ll^-1 g_l.

Landmarks are sharded over the ``map_block`` mesh axis; every block
assembles its local (H_red, g_red) contribution, ONE psum crosses hosts,
the small pose solve is replicated, and landmark updates back-substitute
block-locally — exactly the "structure blocks strictly local, only the
pose block crosses hosts" layout (SURVEY.md section 9 hard parts).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from slr.geom.se3 import se3_exp, so3_exp


class BAResult(NamedTuple):
    R: jnp.ndarray        # (S,3,3) refined scan->world rotations
    t: jnp.ndarray        # (S,3)
    X: jnp.ndarray        # (L,3) refined landmarks (sharded layout preserved)
    cost: jnp.ndarray     # final weighted SSE
    rms: jnp.ndarray      # per-residual-component RMS


def _inv3x3(A):
    """Batched closed-form 3x3 inverse via the adjugate: for the (L,3,3)
    landmark blocks the cofactor form is a handful of fused elementwise
    multiplies instead of a batched pivoted LU (the H_ll blocks are SPD
    + Tikhonov, so the determinant is bounded away from zero)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], -1),
        jnp.stack([c10, c11, c12], -1),
        jnp.stack([c20, c21, c22], -1),
    ], -2)
    return adj / det[..., None, None]


def _hat(v):
    zeros = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -v[..., 2], v[..., 1]], -1),
            jnp.stack([v[..., 2], zeros, -v[..., 0]], -1),
            jnp.stack([-v[..., 1], v[..., 0], zeros], -1),
        ],
        -2,
    )


def _assemble_block(R, t, X, obs_s, obs_p, obs_w, S: int, damping: float,
                    huber_delta: float = 0.0, obs_n=None):
    """Local (per map block) Schur assembly.

    X (Lb,3); obs_s (Lb,K) int32; obs_p (Lb,K,3); obs_w (Lb,K) weights
    (0 = missing). ``huber_delta`` > 0 enables IRLS Huber robust weights:
    residuals beyond delta are down-weighted by delta/||r|| so a few bad
    correspondences cannot drag the pose block (VERDICT r2 next #4).

    ``obs_n`` (Lb,K,3), scan-frame surface normals at obs_p, switches the
    residual to POINT-TO-PLANE: r = n . (R^T(X - t) - p), one row per
    observation instead of three. NN correspondences between distinct
    random subsamples carry a lateral offset of ~one sample spacing;
    point-to-point BA floors there, while the plane residual is blind to
    in-plane offsets and converges to the true surface (same reasoning as
    point-to-plane ICP, SURVEY.md 4.6). The row axis ``a`` below carries
    both cases (A=3 point, A=1 plane) through identical Schur algebra.
    Returns (H_red (6S,6S), g_red (6S,), cost, nres).
    """
    Rs = R[obs_s]                                   # (Lb,K,3,3)
    ts = t[obs_s]                                   # (Lb,K,3)
    x0 = jnp.einsum("lkij,lki->lkj", Rs, X[:, None, :] - ts)  # R^T (X - t)
    if huber_delta > 0.0:
        if obs_n is None:
            rn = jnp.linalg.norm(x0 - obs_p, axis=-1)   # (Lb,K)
        else:
            rn = jnp.abs(jnp.einsum("lki,lki->lk", obs_n, x0 - obs_p))
        obs_w = obs_w * jnp.where(rn > huber_delta,
                                  huber_delta / jnp.maximum(rn, 1e-12), 1.0)
    w = obs_w[..., None]
    sw = jnp.sqrt(jnp.where(w > 0, w, 0.0))
    if obs_n is None:
        # J_pose (3x6) = [-I | hat(x0)] ; J_X = R^T; weights applied via
        # sqrt so H gets w and g gets w exactly once
        U = jnp.concatenate(
            [
                jnp.broadcast_to(-jnp.eye(3), x0.shape[:-1] + (3, 3)),
                _hat(x0),
            ],
            axis=-1,
        )                                           # (Lb,K,3,6)
        r1 = (x0 - obs_p) * sw                      # whitened residual
        U1 = U * sw[..., None]                      # whitened pose jac
        V1 = jnp.swapaxes(Rs, -1, -2) * sw[..., None]  # whitened J_X = R^T
        damping_ll = damping
        res_rows = 3.0
    else:
        # scalar rows: J_pose = [-n | (n x x0)], J_X = (R n)^T
        U = jnp.concatenate([-obs_n, jnp.cross(obs_n, x0)], axis=-1)
        U1 = (U * sw)[..., None, :]                 # (Lb,K,1,6)
        V1 = (jnp.einsum("lkij,lkj->lki", Rs, obs_n) * sw)[..., None, :]
        r1 = (jnp.einsum("lki,lki->lk", obs_n, x0 - obs_p)
              * sw[..., 0])[..., None]              # (Lb,K,1)
        # plane rows leave landmarks free in the tangent plane; a real
        # (not epsilon) Tikhonov keeps H_ll well-conditioned there
        damping_ll = max(damping, 1e-2)
        res_rows = 1.0

    UtU = jnp.einsum("lkai,lkaj->lkij", U1, U1)
    Utr = jnp.einsum("lkai,lka->lki", U1, r1)
    seg = obs_s.reshape(-1)
    # pose-indexed reductions as one-hot matmuls, not segment_sum: with
    # S poses the one-hot contraction is a tiny dense matmul
    onehot = jax.nn.one_hot(seg, S, dtype=U1.dtype)         # (N,S)
    H_pp = jnp.einsum("nij,ns->sij", UtU.reshape(-1, 6, 6), onehot)
    g_p = jnp.einsum("ni,ns->si", Utr.reshape(-1, 6), onehot)

    # landmark blocks
    H_ll = jnp.einsum("lkai,lkaj->lij", V1, V1)     # (Lb,3,3)
    H_ll = H_ll + damping_ll * jnp.eye(3)
    g_l = jnp.einsum("lkai,lka->li", V1, r1)        # (Lb,3)
    W = jnp.einsum("lkai,lkaj->lkij", U1, V1)       # (Lb,K,6,3) per-obs W

    H_ll_inv = _inv3x3(H_ll)                        # (Lb,3,3) tiny blocks
    # Schur cross terms: for each landmark, all (k1, k2) pose pairs
    WHW = jnp.einsum(
        "lkij,ljm,lqnm->lkqin", W, H_ll_inv, W
    )                                               # (Lb,K,K,6,6)
    pair_seg = (obs_s[:, :, None] * S + obs_s[:, None, :]).reshape(-1)
    pair_hot = jax.nn.one_hot(pair_seg, S * S, dtype=U1.dtype)
    H_cross = jnp.einsum(
        "nij,np->pij", WHW.reshape(-1, 6, 6), pair_hot
    ).reshape(S, S, 6, 6)
    Whg = jnp.einsum("lkij,ljm,lm->lki", W, H_ll_inv, g_l)  # (Lb,K,6)
    g_cross = jnp.einsum("ni,ns->si", Whg.reshape(-1, 6), onehot)

    H_red = -H_cross
    H_red = H_red.at[jnp.arange(S), jnp.arange(S)].add(H_pp)
    g_red = g_p - g_cross
    cost = jnp.sum(r1 * r1)
    nres = res_rows * jnp.sum((obs_w > 0).astype(jnp.float32))
    return (
        H_red.transpose(0, 2, 1, 3).reshape(6 * S, 6 * S),
        g_red.reshape(-1),
        cost,
        nres,
        (H_ll_inv, g_l, W),
    )


def _back_substitute(H_ll_inv, g_l, W, obs_s, dxi, S: int):
    """dX_l = -H_ll^-1 (g_l + sum_k W_k^T dxi_{s_k})."""
    dxi_b = dxi.reshape(S, 6)[obs_s]                # (Lb,K,6)
    Wtd = jnp.einsum("lkij,lki->lj", W, dxi_b)      # (Lb,3)
    return -jnp.einsum("lij,lj->li", H_ll_inv, g_l + Wtd)


def _ba_iteration(R, t, X, obs_s, obs_p, obs_w, S, damping, axis_name=None,
                  huber_delta: float = 0.0, obs_n=None):
    H_red, g_red, cost, nres, (H_ll_inv, g_l, W) = _assemble_block(
        R, t, X, obs_s, obs_p, obs_w, S, damping, huber_delta, obs_n
    )
    if axis_name is not None:
        H_red = jax.lax.psum(H_red, axis_name)
        g_red = jax.lax.psum(g_red, axis_name)
        cost = jax.lax.psum(cost, axis_name)
        nres = jax.lax.psum(nres, axis_name)
    # gauge fix: anchor pose 0; LM-style diagonal damping on the pose block
    anchor = jnp.concatenate([jnp.full(6, 1e12), jnp.zeros(6 * S - 6)])
    H_red = H_red + jnp.diag(anchor + damping)
    # H_red is SPD (Gauss-Newton + damping + anchor): Cholesky, no
    # pivoting needed for this small dense system
    chol = jax.scipy.linalg.cho_factor(H_red, lower=True)
    dxi = -jax.scipy.linalg.cho_solve(chol, g_red)
    dX = _back_substitute(H_ll_inv, g_l, W, obs_s, dxi, S)
    dR, dt = jax.vmap(se3_exp)(dxi.reshape(S, 6))
    R_new = jnp.einsum("sij,sjk->sik", R, dR)
    t_new = jnp.einsum("sij,sj->si", R, dt) + t
    return R_new, t_new, X + dX, cost, nres


def bundle_adjust_reference(R, t, X, obs_s, obs_p, obs_w, iters: int = 10,
                            damping: float = 1e-6,
                            huber_delta: float = 0.0, obs_n=None):
    """Single-device BA (no mesh) — the oracle for the distributed path."""
    S = R.shape[0]

    def body(carry, _):
        R, t, X = carry
        R, t, X, cost, nres = _ba_iteration(
            R, t, X, obs_s, obs_p, obs_w, S, damping,
            huber_delta=huber_delta, obs_n=obs_n
        )
        return (R, t, X), (cost, nres)

    (R, t, X), (costs, nres) = jax.lax.scan(
        body, (R, t, X), None, length=iters
    )
    return BAResult(R=R, t=t, X=X, cost=costs[-1],
                    rms=jnp.sqrt(costs[-1] / nres[-1]))


def distributed_bundle_adjust(
    R, t,                      # (S,3,3), (S,3) replicated pose block
    X,                         # (L,3) landmarks, L divisible by n map blocks
    obs_s, obs_p, obs_w,       # (L,K) int32, (L,K,3), (L,K)
    mesh: Mesh,
    iters: int = 10,
    damping: float = 1e-6,
    huber_delta: float = 0.0,
    obs_n=None,
) -> BAResult:
    """Landmarks sharded over map_block; ONE psum per GN iteration crosses
    blocks (the reduced 6S pose system); solve replicated; landmark
    updates block-local. Deterministic: psum over a fixed mesh order."""
    S = R.shape[0]

    def local(R, t, X_b, obs_s_b, obs_p_b, obs_w_b, obs_n_b):
        def body(carry, _):
            R, t, X_b = carry
            R, t, X_b, cost, nres = _ba_iteration(
                R, t, X_b, obs_s_b, obs_p_b, obs_w_b, S, damping,
                axis_name="map_block", huber_delta=huber_delta,
                obs_n=obs_n_b,
            )
            return (R, t, X_b), (cost, nres)

        (R, t, X_b), (costs, nres) = jax.lax.scan(
            body, (R, t, X_b), None, length=iters
        )
        return R, t, X_b, costs[-1], nres[-1]

    if obs_n is None:
        # shard_map cannot carry None leaves; a zero normal never selects
        # the plane path (the branch is static on the caller's obs_n)
        local_in = local
        def local(R, t, X_b, s_b, p_b, w_b):
            return local_in(R, t, X_b, s_b, p_b, w_b, None)
        args = (R, t, X, obs_s, obs_p, obs_w)
        in_specs = (P(), P(), P("map_block"), P("map_block"), P("map_block"),
                    P("map_block"))
    else:
        args = (R, t, X, obs_s, obs_p, obs_w, obs_n)
        in_specs = (P(), P(), P("map_block"), P("map_block"), P("map_block"),
                    P("map_block"), P("map_block"))
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P(), P("map_block"), P(), P()),
        check_vma=False,
    )
    R, t, X, cost, nres = fn(*args)
    return BAResult(R=R, t=t, X=X, cost=cost, rms=jnp.sqrt(cost / nres))
