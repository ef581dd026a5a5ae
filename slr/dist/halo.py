"""Halo exchange over the pixel_tile axis (ring ppermute).

The spatial quality-guided unwrap couples neighbouring pixels; when the
image is row-sharded each tile needs its neighbours' border rows. Two
ppermutes (up + down) move ``halo`` rows each way per call — the image
analog of context-parallel halo exchange (SURVEY.md section 3.2,
[S:56-112] gather pattern).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def halo_exchange_rows(x, axis_name: str, halo: int):
    """x: (H_local, W) shard. Returns (H_local + 2*halo, W) with
    neighbours' rows attached (zeros at the global image borders).

    ppermute perms are full rotations (JAX requires a permutation); edge
    shards discard the wrapped-around rows by masking.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if n == 1:
        zeros = jnp.zeros((halo,) + x.shape[1:], x.dtype)
        return jnp.concatenate([zeros, x, zeros], axis=0)

    # send my TOP rows to my upper neighbour (they become its bottom halo);
    # full rotation i -> i-1 (mod n)
    top_rows = x[:halo]
    bot_halo = jax.lax.ppermute(
        top_rows, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    # send my BOTTOM rows to my lower neighbour (its top halo): i -> i+1
    bottom_rows = x[-halo:]
    top_halo = jax.lax.ppermute(
        bottom_rows, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    # zero out the wrapped halos at the global borders
    top_halo = jnp.where(idx == 0, jnp.zeros_like(top_halo), top_halo)
    bot_halo = jnp.where(idx == n - 1, jnp.zeros_like(bot_halo), bot_halo)
    return jnp.concatenate([top_halo, x, bot_halo], axis=0)
