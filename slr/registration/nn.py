"""Tiled brute-force nearest-neighbour search as matrix products.

The reference's ICP uses per-query KD-tree lookups (SURVEY.md component
15); trees are pointer-chasing and serial per query. Instead the squared
distance ||q - t||^2 = |q|^2 + |t|^2 - 2 q.t is computed tile-by-tile with
a (Q_tile x 3) @ (3 x T_tile) matmul and a running (min, argmin) carried
over target tiles in a lax.scan — O(Q*T) FLOPs in dense matrix
products, exact results, fixed shapes. Masked (invalid) targets get
+inf distance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("tile",))
def nearest_neighbors(query, target, target_valid=None, tile: int = 2048):
    """For each query point return (index, squared distance) of its nearest
    target point.

    query (Q,3), target (T,3), target_valid optional (T,) bool.
    Returns (idx (Q,) int32, d2 (Q,) f32).
    """
    Q = query.shape[0]
    T = target.shape[0]
    tile = min(tile, T)
    pad = (-T) % tile
    if pad:
        target = jnp.concatenate(
            [target, jnp.zeros((pad, 3), target.dtype)], axis=0
        )
        pv = jnp.zeros((pad,), bool)
        target_valid = (
            jnp.concatenate([target_valid, pv])
            if target_valid is not None
            else jnp.concatenate([jnp.ones((T,), bool), pv])
        )
    elif target_valid is None:
        target_valid = jnp.ones((T,), bool)
    n_tiles = target.shape[0] // tile

    q2 = jnp.sum(query * query, axis=1)  # (Q,)
    tgt_tiles = target.reshape(n_tiles, tile, 3)
    val_tiles = target_valid.reshape(n_tiles, tile)

    def body(carry, inp):
        best_d2, best_idx = carry
        tgt, val, base = inp
        t2 = jnp.sum(tgt * tgt, axis=1)
        # (Q, tile) distances via a matmul: -2 q @ t^T
        cross = query @ tgt.T
        d2 = q2[:, None] + t2[None, :] - 2.0 * cross
        d2 = jnp.where(val[None, :], d2, jnp.inf)
        tile_min = jnp.min(d2, axis=1)
        tile_arg = jnp.argmin(d2, axis=1).astype(jnp.int32) + base
        take = tile_min < best_d2
        return (
            jnp.where(take, tile_min, best_d2),
            jnp.where(take, tile_arg, best_idx),
        ), None

    bases = (jnp.arange(n_tiles) * tile).astype(jnp.int32)
    init = (jnp.full((Q,), jnp.inf, jnp.float32), jnp.zeros((Q,), jnp.int32))
    (d2, idx), _ = jax.lax.scan(body, init, (tgt_tiles, val_tiles, bases))
    return idx, d2
