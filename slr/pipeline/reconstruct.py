"""Single-scan reconstruction pipelines (configs 1-3, SURVEY.md E4).

``reconstruct_scan`` is the general path (any pattern config, pure JAX
ops); ``reconstruct_dense`` is the flagship production path: the fused
Pallas kernel + optional spatial quality repair + color attach +
projector-pixel accumulation, one jit graph end-to-end.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from slr.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr.codec import decode_stack
from slr.codec.unwrap import quality_guided_repair, spatial_quality_unwrap
from slr.geom.camera import Camera
from slr.geom.triangulate import triangulate_plane, triangulate_rays
from slr.kernels import fused_decode_triangulate

TWO_PI = 2.0 * jnp.pi


def _white_color(frames):
    """White-frame intensity in [0,1] regardless of the stack dtype."""
    w = frames[0]
    if jnp.issubdtype(w.dtype, jnp.integer):
        return w.astype(jnp.float32) / float(jnp.iinfo(w.dtype).max)
    return w


class ScanCloud(NamedTuple):
    """Organized point cloud: one entry per camera pixel (fixed shape)."""
    points: jnp.ndarray     # (H, W, 3)
    mask: jnp.ndarray       # (H, W) bool
    colors: jnp.ndarray     # (H, W) intensity from the white frame
    quality: jnp.ndarray    # (H, W)
    x_p: jnp.ndarray        # (H, W)


@partial(jax.jit, static_argnames=("cfg", "dec", "rec"))
def reconstruct_scan(
    frames,
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
) -> ScanCloud:
    """General decode -> triangulate (configs 1-2; any pattern layout)."""
    res = decode_stack(frames, cfg, dec)
    H, W = res.x_p.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    if res.y_p is not None and rec.method in ("midpoint", "dlt"):
        pts, _ = triangulate_rays(cam, proj, u, v, res.x_p, res.y_p)
        depth = pts[..., 2]
    else:
        pts, depth = triangulate_plane(cam, proj, u, v, res.x_p)
    mask = res.mask & (depth > rec.min_depth) & (depth < rec.max_depth)
    pts = jnp.where(mask[..., None], pts, 0.0)
    return ScanCloud(
        points=pts, mask=mask, colors=_white_color(frames), quality=res.quality,
        x_p=res.x_p,
    )


@partial(jax.jit, static_argnames=("cfg", "dec", "rec", "saturation",
                                   "fuse"))
def reconstruct_scan_hdr(
    stacks,
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    saturation: float = 0.98,
    fuse: str = "sum",
) -> ScanCloud:
    """Exposure-bracketed reconstruction: (E, F, H, W) stacks fused by
    per-pixel best-valid-modulation selection, then triangulated.
    Colors come from the bracket's brightest unsaturated white frame.

    Production route (gray_phase + inverse codes): ONE Pallas kernel
    reads all E stacks, selects per pixel in registers and decodes once
    (fused_decode_triangulate_hdr) instead of E dense pure-JAX decodes
    plus a gather. ``fuse`` is the kernel's phase rule ("sum" fuses the
    usable exposures, "select" takes the best one as the plain route
    does). Other codings take slr.codec.decode_multi_exposure."""
    if (cfg.coding == "gray_phase" and cfg.use_inverse
            and cfg.phase_steps > 0):
        from slr.kernels.fused_scan import fused_decode_triangulate_hdr

        out = fused_decode_triangulate_hdr(
            stacks, cam, proj, cfg, dec, saturation=saturation,
            z_bounds=(rec.min_depth, rec.max_depth), fuse=fuse)
        whites = jax.vmap(_white_color)(stacks)       # (E, H, W)
        colors = jnp.max(jnp.where(whites < saturation, whites, 0.0),
                         axis=0)
        return ScanCloud(points=jnp.moveaxis(out.points, 0, -1),
                         mask=out.mask > 0.5, colors=colors,
                         quality=out.quality, x_p=out.x_p)
    return reconstruct_hdr_plain(stacks, cam, proj, cfg, dec, rec,
                                 saturation)


@partial(jax.jit, static_argnames=("cfg", "dec", "rec", "saturation"))
def reconstruct_hdr_plain(
    stacks,
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    saturation: float = 0.98,
) -> ScanCloud:
    """Plain-XLA bracket reconstruction: E vmapped decode_stack passes,
    best-single-exposure selection (slr.codec.decode_multi_exposure),
    then triangulation. The route for codings the HDR kernel does not
    cover, and the kernel's yardstick."""
    from slr.codec import decode_multi_exposure

    res = decode_multi_exposure(stacks, cfg, dec, saturation=saturation)
    H, W = res.x_p.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    if res.y_p is not None and rec.method in ("midpoint", "dlt"):
        pts, _ = triangulate_rays(cam, proj, u, v, res.x_p, res.y_p)
        depth = pts[..., 2]
    else:
        pts, depth = triangulate_plane(cam, proj, u, v, res.x_p)
    mask = res.mask & (depth > rec.min_depth) & (depth < rec.max_depth)
    pts = jnp.where(mask[..., None], pts, 0.0)
    whites = jax.vmap(_white_color)(stacks)           # (E, H, W)
    colors = jnp.max(jnp.where(whites < saturation, whites, 0.0), axis=0)
    return ScanCloud(points=pts, mask=mask, colors=colors,
                     quality=res.quality, x_p=res.x_p)


@partial(jax.jit, static_argnames=("cfg", "dec", "rec", "spatial_iters",
                                   "spatial_mode"))
def reconstruct_dense(
    frames,
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    spatial_iters: int = 0,
    spatial_mode: str = "voting",
) -> ScanCloud:
    """Flagship fused path (config 3): the fused Pallas kernel.

    Column-only coding triangulates via the projector-column plane;
    row+column coding uses the fused midpoint kernel. When
    ``spatial_iters`` > 0 the quality-guided repair runs on the absolute
    phase between decode and re-triangulation (only the repaired x_p
    re-enters the plane solve — no second pass over the frames;
    column-plane re-triangulation only).

    ``spatial_mode``: "voting" = strict-consensus sweeps
    (spatial_quality_unwrap: isolated order errors, conservative
    default); "wavefront" = quality-ordered threshold-lowering front
    (quality_guided_repair, two levels) which also repairs multi-pixel
    order-error blobs, with spatial_iters // 4 as its rounds-per-level.
    """
    out = fused_decode_triangulate(
        frames, cam, proj, cfg, dec, z_bounds=(rec.min_depth, rec.max_depth)
    )
    mask = out.mask > 0.5
    x_p = out.x_p
    pts = jnp.moveaxis(out.points, 0, -1)
    if spatial_iters:
        # finest fringe period: order errors are +/- one of these
        pitch = (cfg.mf_pitches[-1] if cfg.coding == "multifreq"
                 else cfg.fringe_pitch)
        Phi = x_p * (TWO_PI / pitch)
        if spatial_mode == "wavefront":
            Phi = quality_guided_repair(
                Phi, out.quality, mask, levels=2,
                rounds_per_level=max(1, spatial_iters // 4))
        else:
            Phi = spatial_quality_unwrap(Phi, out.quality, mask,
                                         iters=spatial_iters)
        x_p2 = Phi * (pitch / TWO_PI)
        changed = jnp.abs(x_p2 - x_p) > 1e-6
        H, W = x_p.shape
        v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
        u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
        pts2, depth2 = triangulate_plane(cam, proj, u, v, x_p2)
        ok2 = (depth2 > rec.min_depth) & (depth2 < rec.max_depth)
        pts = jnp.where((changed & ok2)[..., None], pts2, pts)
        mask = mask | (changed & ok2)
        x_p = jnp.where(changed, x_p2, x_p)
    return ScanCloud(
        points=pts, mask=mask, colors=_white_color(frames), quality=out.quality, x_p=x_p,
    )


@partial(jax.jit, static_argnames=("proj_width",))
def accumulate_by_projector(cloud: ScanCloud, proj_width: int):
    """Projector-pixel accumulation (SURVEY.md component 13).

    Camera pixels decoding to the same (camera row, projector column) cell
    are averaged — the reference's PointCloudImage-style accumulation that
    dedupes oversampled regions where several camera pixels see one
    projector column. Returns (points (H, proj_W, 3), mask, colors) on the
    projector-column grid (fixed shapes; device segment-sum).
    """
    H, W = cloud.mask.shape
    col = jnp.clip(jnp.round(cloud.x_p).astype(jnp.int32), 0, proj_width - 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    seg = jnp.where(cloud.mask, row * proj_width + col, H * proj_width)
    w = cloud.mask.astype(jnp.float32).reshape(-1)

    def segsum(x, d):
        flat = x.reshape(-1, d) * w[:, None]
        out = jax.ops.segment_sum(
            flat, seg.reshape(-1), num_segments=H * proj_width + 1
        )[:-1]
        return out.reshape(H, proj_width, d)

    cnt = segsum(jnp.ones((H, W, 1)), 1)
    pts = segsum(cloud.points, 3)
    colors = segsum(cloud.colors[..., None], 1)
    denom = jnp.where(cnt > 0, cnt, 1.0)
    return (
        pts / denom,
        cnt[..., 0] > 0,
        (colors / denom)[..., 0],
    )
