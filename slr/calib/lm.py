"""Generic Levenberg-Marquardt solver on jax.lax.while_loop.

Shared by camera/projector/stereo calibration (SURVEY.md components 9-11).
Jacobians come from jax.jacfwd, so any differentiable residual works; the
normal equations are damped multiplicatively (LM) and solved with
jnp.linalg.solve in f64 when enabled, else f32 with Tikhonov floor
(SURVEY.md section 9 "LM robustness in f32").
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LMState(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray
    lam: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def lm_solve(
    residual_fn: Callable,
    x0: jnp.ndarray,
    args=(),
    iters: int = 50,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    tol: float = 1e-12,
):
    """Minimize ||residual_fn(x, *args)||^2 over x.

    Returns (x_opt, final_cost). Fixed upper iteration bound + an early
    ``done`` flag keeps it a single compiled while_loop.
    """
    x0 = jnp.asarray(x0)

    def cost_of(x):
        r = residual_fn(x, *args)
        return jnp.sum(r * r)

    def step(state: LMState) -> LMState:
        r = residual_fn(state.x, *args)
        J = jax.jacfwd(lambda x: residual_fn(x, *args))(state.x)
        JtJ = J.T @ J
        g = J.T @ r
        n = JtJ.shape[0]
        # multiplicative (Marquardt) damping scales with the diagonal
        damp = state.lam * jnp.diag(jnp.diagonal(JtJ) + 1e-12)
        dx = jnp.linalg.solve(JtJ + damp, -g)
        x_new = state.x + dx
        c_new = cost_of(x_new)
        improved = c_new < state.cost
        x_next = jnp.where(improved, x_new, state.x)
        c_next = jnp.where(improved, c_new, state.cost)
        lam_next = jnp.where(improved, state.lam * lam_down, state.lam * lam_up)
        lam_next = jnp.clip(lam_next, 1e-12, 1e8)
        rel = jnp.abs(state.cost - c_next) / (state.cost + 1e-30)
        done = improved & (rel < tol)
        return LMState(x_next, c_next, lam_next, state.it + 1, done)

    def cond(state: LMState):
        return (state.it < iters) & jnp.logical_not(state.done)

    init = LMState(
        x=x0,
        cost=cost_of(x0),
        lam=jnp.asarray(lam0, x0.dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
    )
    out = jax.lax.while_loop(cond, step, init)
    return out.x, out.cost
