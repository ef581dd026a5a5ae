"""Voxel-grid utilities: downsampling / fusion merge (SURVEY.md comp. 17)
and the voxel-hash bucketing used as the ICP alternative to brute-force NN
(SURVEY.md section 9 "static voxel-grid hashing with bounded bucket
occupancy").

All fixed-shape: under jit the number of occupied voxels is data-dependent,
so results come back as a fixed-capacity buffer + validity mask; hosts
compact on export.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# 10 bits per axis -> a 1024^3-voxel window anchored at the cloud's own
# minimum voxel coordinate (computed per call, so the window floats with
# the data). Coordinates outside the window are explicitly invalidated
# instead of silently wrapping around (the old fixed +-512 packing
# aliased any scene wider than 1024 voxels with no runtime check).
_VOX_BITS = 10
_VOX_N = 1 << _VOX_BITS
_INVALID_VID = 0x40000000  # bit 30: above the 30 coordinate bits


def _voxel_origin(v, valid):
    """Per-axis minimum voxel coordinate over the valid points — the
    anchor of the packing window."""
    big = jnp.int32(1 << 30)
    return jnp.min(jnp.where(valid[:, None], v, big), axis=0)


def _pack_vid(v, lo, valid):
    """Pack window-relative voxel coords into a 30-bit id.

    Out-of-window coordinates (beyond 1024 voxels from the anchor) map to
    the invalid sentinel — dropped/missed deterministically, never
    aliased onto another voxel.
    """
    w = v - lo
    inr = jnp.all((w >= 0) & (w < _VOX_N), axis=-1)
    vid = w[:, 0] | (w[:, 1] << _VOX_BITS) | (w[:, 2] << (2 * _VOX_BITS))
    return jnp.where(valid & inr, vid, jnp.int32(_INVALID_VID))


@partial(jax.jit, static_argnames=("bucket_cap",))
def build_voxel_hash(points, valid, voxel_size: float, bucket_cap: int = 8):
    """Static voxel-grid hash with bounded bucket occupancy.

    Returns (table (n_vox_capacity=N, bucket_cap) int32 point indices,
    -1 padded; row_ids: unique voxel ids as a sorted array for
    searchsorted lookup; lo (3,) int32: the packing-window anchor that
    queries must be packed against). All fixed shapes: the table has one
    row per *potential* voxel (= one per input point upper bound), rows
    addressed through searchsorted on the sorted unique ids.
    """
    N = points.shape[0]
    v = jnp.floor(points / voxel_size).astype(jnp.int32)
    lo = _voxel_origin(v, valid)
    vid = _pack_vid(v, lo, valid)
    order = jnp.argsort(vid)
    vid_s = vid[order]
    # rank of each point within its voxel run
    first = jnp.concatenate([jnp.array([True]), vid_s[1:] != vid_s[:-1]])
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    run_start = jax.lax.cummax(jnp.where(first, jnp.arange(N), 0), axis=0)
    pos_in_run = jnp.arange(N) - run_start
    # scatter point indices into (N, bucket_cap) table rows addressed by seg
    table = jnp.full((N, bucket_cap), -1, jnp.int32)
    keep = pos_in_run < bucket_cap
    rows = jnp.where(keep, seg, N - 1)
    cols = jnp.clip(pos_in_run, 0, bucket_cap - 1)
    table = table.at[rows, cols].set(
        jnp.where(keep, order.astype(jnp.int32), -1), mode="drop"
    )
    # unique sorted ids per row (pad rows beyond n_unique with sentinel)
    row_ids = jnp.where(first, vid_s, jnp.int32(0x7FFFFFFF))
    row_ids = jnp.sort(row_ids)
    # rows were scattered by seg (0..n_unique-1) which matches the sorted
    # unique order, so row k of `table` corresponds to row_ids[k]
    return table, row_ids, lo


@partial(jax.jit, static_argnames=("bucket_cap",))
def voxel_hash_nn(query, points, table, row_ids, lo, voxel_size: float,
                  bucket_cap: int = 8):
    """Approximate-NN lookup in the 27-neighbourhood of each query's voxel.

    Exact whenever the true NN lies within one voxel (choose voxel_size
    >= max correspondence distance). ``lo`` is the window anchor returned
    by build_voxel_hash. Returns (idx (Q,), d2 (Q,)); idx -1 when no
    candidate found (including queries outside the packing window). The
    KD-tree replacement of SURVEY.md section 9 (bounded buckets,
    gather-only inner loop).
    """
    Q = query.shape[0]
    vq = jnp.floor(query / voxel_size).astype(jnp.int32)
    ones = jnp.ones((Q,), bool)
    best_d2 = jnp.full((Q,), jnp.inf)
    best_i = jnp.full((Q,), -1, jnp.int32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                vv = vq + jnp.array([dx, dy, dz], jnp.int32)
                vid = _pack_vid(vv, lo, ones)
                row = jnp.searchsorted(row_ids, vid)
                row = jnp.clip(row, 0, row_ids.shape[0] - 1)
                # the invalid sentinel may itself be a row (run of masked
                # points) — an out-of-window query must not match it
                hit = (row_ids[row] == vid) & (vid != _INVALID_VID)
                cand = jnp.where(
                    hit[:, None], table[row], -1
                )                                    # (Q, bucket_cap)
                cpts = points[jnp.maximum(cand, 0)]  # (Q, cap, 3)
                d2 = jnp.sum((cpts - query[:, None, :]) ** 2, axis=-1)
                d2 = jnp.where(cand >= 0, d2, jnp.inf)
                j = jnp.argmin(d2, axis=1)
                dmin = jnp.take_along_axis(d2, j[:, None], 1)[:, 0]
                imin = jnp.take_along_axis(cand, j[:, None], 1)[:, 0]
                take = dmin < best_d2
                best_d2 = jnp.where(take, dmin, best_d2)
                best_i = jnp.where(take, imin, best_i)
    return best_i, best_d2


@partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(points, valid, voxel_size: float, capacity: int,
                     attrs=None):
    """Average points (and optional attrs) falling in the same voxel.

    points (N,3), valid (N,) bool -> (out_pts (capacity,3),
    out_valid (capacity,), out_attrs). Voxels are assigned slots by a
    sort-by-id + segment boundary trick: stable, deterministic, exact when
    the number of occupied voxels <= capacity (extra voxels are dropped,
    counted in the last return value). The packing window spans 1024
    voxels per axis from the cloud's own minimum; points beyond it are
    dropped (treated as invalid), never aliased onto another voxel.
    """
    N = points.shape[0]
    v = jnp.floor(points / voxel_size).astype(jnp.int32)
    lo = _voxel_origin(v, valid)
    vid = _pack_vid(v, lo, valid)
    valid = valid & (vid != _INVALID_VID)
    order = jnp.argsort(vid)
    vid_s = vid[order]
    pts_s = points[order]
    val_s = valid[order]
    # segment starts where the id changes
    first = jnp.concatenate([jnp.array([True]), vid_s[1:] != vid_s[:-1]])
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1          # (N,) segment idx
    seg = jnp.where(val_s, seg, capacity)                   # overflow bucket
    seg_c = jnp.clip(seg, 0, capacity)

    def segsum(x):
        return jax.ops.segment_sum(x, seg_c, num_segments=capacity + 1)[:capacity]

    cnt = segsum(val_s.astype(jnp.float32))
    out_pts = segsum(pts_s * val_s[:, None].astype(jnp.float32))
    out_valid = cnt > 0
    out_pts = out_pts / jnp.where(cnt[:, None] > 0, cnt[:, None], 1.0)
    out_attrs = None
    if attrs is not None:
        a_s = attrs[order]
        out_attrs = segsum(a_s * val_s[:, None].astype(jnp.float32))
        out_attrs = out_attrs / jnp.where(cnt[:, None] > 0, cnt[:, None], 1.0)
    n_voxels = jnp.sum(first & val_s)
    return out_pts, out_valid, out_attrs, n_voxels
