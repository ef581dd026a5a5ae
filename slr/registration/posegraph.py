"""Pose-graph optimization over scanner poses (SURVEY.md component 16, 4.7).

Variables: per-scan rig poses T_s in SE(3) (world <- scan). Residuals: for
each edge (i, j) with measured relative pose Z_ij (from pairwise ICP),
r = log( Z_ij^{-1} . T_i^{-1} . T_j ) in R^6. Gauss-Newton with jacfwd
over the stacked tangent increments, gauge-fixed by anchoring pose 0.
Dense solve — the pose block is small (6S x 6S); the structure-block
elimination (Schur) only appears in the landmark BA of slr.dist.ba.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slr.geom.se3 import se3_compose, se3_exp, se3_inverse, se3_log


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray      # (S,3,3) world<-scan rotations
    t: jnp.ndarray      # (S,3)
    cost: jnp.ndarray   # final sum of squared residuals
    rms: jnp.ndarray    # per-residual-component RMS


def _edge_residuals(xi_all, R0, t0, edges_i, edges_j, Zr, Zt, rot_scale):
    """Residuals for all edges given tangent updates xi (S,6) applied on the
    right of the initial poses: T_s = T0_s . Exp(xi_s).

    The log residual mixes units: translation rows are scene units (mm),
    rotation rows radians — three orders of magnitude smaller for the
    same geometric impact. Unweighted, a REDUNDANT graph (loop closures)
    trades degrees of rotation error for millimetres of translation fit
    (measured: 0.3 deg chain errors exploding to 8-15 deg after adding
    mm-accurate closure edges). ``rot_scale`` (mm per radian; the typical
    surface distance from the scan origin) converts rotation rows to the
    point displacement they cause, making the two blocks commensurate.
    Chain-only graphs are exactly determined, so this is a no-op there.
    """
    dR, dt = jax.vmap(se3_exp)(xi_all)
    R = jnp.einsum("sij,sjk->sik", R0, dR)
    t = jnp.einsum("sij,sj->si", R0, dt) + t0

    Ri, ti = R[edges_i], t[edges_i]
    Rj, tj = R[edges_j], t[edges_j]
    Rii, tii = se3_inverse(Ri, ti)
    Rij, tij = se3_compose(Rii, tii, Rj, tj)        # T_i^{-1} T_j
    Zri, Zti = se3_inverse(Zr, Zt)
    Er, Et = se3_compose(Zri, Zti, Rij, tij)        # Z^{-1} (T_i^{-1} T_j)
    res = se3_log(Er, Et)                           # (E,6) [tau | omega]
    res = res * jnp.concatenate(
        [jnp.ones(3), jnp.full(3, rot_scale)])
    return res.reshape(-1)


@partial(jax.jit, static_argnames=("iters",))
def pose_graph_optimize(
    R_init,              # (S,3,3)
    t_init,              # (S,3)
    edges_i,             # (E,) int
    edges_j,             # (E,) int
    Z_R,                 # (E,3,3) measured relative poses scan_i -> scan_j
    Z_t,                 # (E,3)
    iters: int = 20,
    damping: float = 1e-6,
    rot_scale: float = 300.0,
) -> PoseGraphResult:
    S = R_init.shape[0]

    def gn_step(carry, _):
        R0, t0 = carry

        def res_of(xi_flat):
            return _edge_residuals(
                xi_flat.reshape(S, 6), R0, t0, edges_i, edges_j, Z_R, Z_t,
                rot_scale,
            )

        x0 = jnp.zeros(S * 6)
        r = res_of(x0)
        J = jax.jacfwd(res_of)(x0)
        H = J.T @ J
        g = J.T @ r
        # gauge fix: anchor pose 0 (huge diagonal on its block)
        anchor = jnp.concatenate([jnp.full(6, 1e12), jnp.zeros(S * 6 - 6)])
        H = H + jnp.diag(anchor + damping)
        # SPD (GN + anchor + damping): Cholesky, no pivoting needed
        dx = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(H, lower=True), g)
        dR, dt = jax.vmap(se3_exp)(dx.reshape(S, 6))
        R_new = jnp.einsum("sij,sjk->sik", R0, dR)
        t_new = jnp.einsum("sij,sj->si", R0, dt) + t0
        return (R_new, t_new), jnp.sum(r * r)

    (R, t), costs = jax.lax.scan(gn_step, (R_init, t_init), None, length=iters)
    # final cost after last update
    r_fin = _edge_residuals(
        jnp.zeros((S, 6)), R, t, edges_i, edges_j, Z_R, Z_t, rot_scale
    )
    cost = jnp.sum(r_fin * r_fin)
    rms = jnp.sqrt(cost / r_fin.shape[0])
    return PoseGraphResult(R=R, t=t, cost=cost, rms=rms)
