"""TSDF volume fusion + marching-tetrahedra surface extraction.

Upgrade over point-level voxel merging (SURVEY.md component 17, the
reference's ``MeshCreator``-style fusion/export): registered scans are
integrated into a truncated-signed-distance volume (Curless–Levoy style
weighted averaging) and a watertight-ish triangle mesh is extracted at
the zero crossing. Both stages are dense device work:

- ``tsdf_integrate`` is one jit over the dense voxel grid: every voxel is
  projected into the scan camera, the organized depth map is bilinearly
  sampled, and tsdf/weight/color are updated in place — pure data-parallel
  work, no scatter.
- ``extract_mesh`` is two stages: a jitted active-cube mask over the full
  grid, a host compaction of active cube indices (export-level, per the
  build plan), then a jitted marching-tetrahedra pass over the padded
  active set emitting a fixed-capacity triangle soup.

Marching tetrahedra (6 tets/cube) is used instead of marching cubes: it
needs only a 16-case table, has no ambiguous cases, and vectorizes
cleanly under jit.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slr.geom.camera import Camera, project
from slr.pipeline.reconstruct import ScanCloud


class TSDFVolume(NamedTuple):
    tsdf: jnp.ndarray     # (D, H, W) f32 in [-1, 1], init +1 (empty)
    weight: jnp.ndarray   # (D, H, W) f32 accumulated integration weight
    color: jnp.ndarray    # (D, H, W) f32 accumulated intensity
    origin: jnp.ndarray   # (3,) world position of voxel (0,0,0) centre
    voxel: jnp.ndarray    # () voxel edge length
    trunc: jnp.ndarray    # () truncation distance


def make_volume(origin, size_vox=(128, 128, 128), voxel: float = 2.0,
                trunc: float | None = None) -> TSDFVolume:
    """Empty volume; grid index order is (z, y, x) -> axes (D, H, W)."""
    D, H, W = size_vox
    if trunc is None:
        trunc = 3.0 * voxel
    return TSDFVolume(
        tsdf=jnp.ones((D, H, W), jnp.float32),
        weight=jnp.zeros((D, H, W), jnp.float32),
        color=jnp.zeros((D, H, W), jnp.float32),
        origin=jnp.asarray(origin, jnp.float32),
        voxel=jnp.asarray(voxel, jnp.float32),
        trunc=jnp.asarray(trunc, jnp.float32),
    )


def _voxel_centers(vol: TSDFVolume):
    D, H, W = vol.tsdf.shape
    z = jax.lax.broadcasted_iota(jnp.float32, (D, H, W), 0)
    y = jax.lax.broadcasted_iota(jnp.float32, (D, H, W), 1)
    x = jax.lax.broadcasted_iota(jnp.float32, (D, H, W), 2)
    return vol.origin + vol.voxel * jnp.stack([x, y, z], axis=-1)


def _bilinear_packed(packed, u, v, max_spread):
    """Valid-aware bilinear sample of a packed (H, W, 3) map of
    [depth, valid, color] at float pixel coords, with ONE gather per
    corner (see tsdf_integrate). Returns (depth, ok, color): ok when
    all four support pixels are valid, the coordinate is in bounds,
    and the corner depths span at most ``max_spread`` (no interpolating
    across silhouette jumps into phantom surface)."""
    H, W = packed.shape[:2]
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = jnp.clip(u, 0.0, W - 1.0)
    v = jnp.clip(v, 0.0, H - 1.0)
    x0 = jnp.floor(u).astype(jnp.int32)
    y0 = jnp.floor(v).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    s00 = packed[y0, x0]
    s01 = packed[y0, x1]
    s10 = packed[y1, x0]
    s11 = packed[y1, x1]
    ok = inb & ((s00[..., 1] * s01[..., 1] * s10[..., 1] * s11[..., 1])
                > 0.5)
    d_hi = jnp.maximum(jnp.maximum(s00[..., 0], s01[..., 0]),
                       jnp.maximum(s10[..., 0], s11[..., 0]))
    d_lo = jnp.minimum(jnp.minimum(s00[..., 0], s01[..., 0]),
                       jnp.minimum(s10[..., 0], s11[..., 0]))
    ok = ok & ((d_hi - d_lo) <= max_spread)
    s = (s00 * (1 - fx) * (1 - fy) + s01 * fx * (1 - fy)
         + s10 * (1 - fx) * fy + s11 * fx * fy)
    return s[..., 0], ok, s[..., 2]


@jax.jit
def tsdf_integrate(vol: TSDFVolume, cloud: ScanCloud, cam: Camera,
                   R_s, t_s) -> TSDFVolume:
    """Integrate one registered scan into the volume.

    ``cloud`` is the organized scan in its own rig (camera) frame;
    (R_s, t_s) maps scan frame -> volume (anchor/world) frame, i.e. the
    pose recovered by registration. ``cam`` is the scan camera (at the
    rig origin, per the scan frame convention).

    The depth/valid/color maps are PACKED into one (H, W, 3) array and
    sampled with a single 4-corner gather: 4 packed gathers per voxel
    instead of 16 scalar ones (separate depth + valid + color
    bilinears).
    """
    pts_w = _voxel_centers(vol)                        # (D,H,W,3) volume frame
    # volume frame -> scan camera frame
    pts_c = jnp.einsum("ji,...j->...i", R_s, pts_w - t_s)
    uv, z_vox = project(cam, pts_c)                    # cam extrinsics: scan frame
    packed = jnp.stack([cloud.points[..., 2],
                        cloud.mask.astype(jnp.float32),
                        cloud.colors], axis=-1)        # (H, W, 3)
    depth, ok, col = _bilinear_packed(packed, uv[..., 0], uv[..., 1],
                                      max_spread=vol.trunc)

    sdf = depth - z_vox                                # + in front of surface
    upd = ok & (z_vox > 0) & (sdf > -vol.trunc)
    tsdf_new = jnp.clip(sdf / vol.trunc, -1.0, 1.0)
    # weight tapers linearly behind the surface for a crisp zero crossing
    w_new = jnp.where(upd, jnp.clip(1.0 + sdf / vol.trunc, 0.05, 1.0), 0.0)

    w_tot = vol.weight + w_new
    denom = jnp.where(w_tot > 0, w_tot, 1.0)
    tsdf = jnp.where(
        w_tot > 0, (vol.tsdf * vol.weight + tsdf_new * w_new) / denom,
        vol.tsdf,
    )
    color = jnp.where(
        w_tot > 0, (vol.color * vol.weight + col * w_new) / denom, vol.color
    )
    return vol._replace(tsdf=tsdf, weight=w_tot, color=color)


def fuse_tsdf(clouds: List[ScanCloud], cam: Camera, Rs, ts,
              size_vox=(128, 128, 128), voxel: float = 2.0,
              origin=None, margin: float = 10.0) -> TSDFVolume:
    """Fuse registered scans into one TSDF volume.

    Rs/ts: per-scan poses (scan frame -> anchor frame), e.g. from
    ``register_scans``/``ba_refine``. If ``origin`` is None, the volume is
    placed around the anchor scan's valid points (host-side bounds).
    """
    if origin is None:
        p0 = np.asarray(clouds[0].points)[np.asarray(clouds[0].mask)]
        if p0.shape[0] == 0:
            raise ValueError(
                "fuse_tsdf: anchor scan has no valid points — cannot "
                "auto-place the volume (pass origin= explicitly)"
            )
        lo = p0.min(axis=0) - margin
        hi = p0.max(axis=0) + margin
        D, H, W = size_vox
        span = hi - lo
        need = np.array([W, H, D], np.float32) * voxel
        if np.any(span > need):
            # grow the voxel edge so the whole anchor scan fits instead of
            # silently cropping the model at the volume boundary
            grow = float(np.max(span / need))
            voxel = voxel * grow
            need = need * grow
            import warnings

            warnings.warn(
                f"fuse_tsdf: scene span {span} exceeds the "
                f"{size_vox} x {voxel / grow:.3g} volume; growing voxel "
                f"size to {voxel:.3g} to fit",
                stacklevel=2,
            )
        origin = lo - np.maximum(need - span, 0.0) / 2.0
    vol = make_volume(origin, size_vox=size_vox, voxel=voxel)
    for s, c in enumerate(clouds):
        vol = tsdf_integrate(vol, c, cam, jnp.asarray(Rs[s]), jnp.asarray(ts[s]))
    return vol


# --- marching tetrahedra ---------------------------------------------------

# cube corner offsets (x, y, z), standard order
_CUBE = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32
)
# 6-tetrahedra decomposition of the cube around the 0-6 diagonal
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32
)
# tet edges: pairs of tet-local corner indices
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
# case -> up to 2 triangles of edge indices (-1 = unused). Bit i of the
# case is set when tet corner i is inside (value < 0).
_TRI_TABLE = -np.ones((16, 2, 3), np.int32)
_TRI_TABLE[0b0001] = [[0, 1, 2], [-1, -1, -1]]
_TRI_TABLE[0b0010] = [[0, 4, 3], [-1, -1, -1]]
_TRI_TABLE[0b0100] = [[1, 3, 5], [-1, -1, -1]]
_TRI_TABLE[0b1000] = [[2, 5, 4], [-1, -1, -1]]
_TRI_TABLE[0b0011] = [[1, 2, 4], [1, 4, 3]]
_TRI_TABLE[0b0101] = [[0, 3, 5], [0, 5, 2]]
_TRI_TABLE[0b1001] = [[0, 1, 5], [0, 5, 4]]
_TRI_TABLE[0b0110] = [[0, 4, 5], [0, 5, 1]]
_TRI_TABLE[0b1010] = [[0, 2, 5], [0, 5, 3]]
_TRI_TABLE[0b1100] = [[1, 3, 4], [1, 4, 2]]
# 0b0111 is the complement of 0b1000 and must carry the reversed winding
# (same three edge points, opposite surface side): [2,4,5], not [2,5,4].
_TRI_TABLE[0b0111] = [[2, 4, 5], [-1, -1, -1]]
_TRI_TABLE[0b1011] = [[1, 5, 3], [-1, -1, -1]]
_TRI_TABLE[0b1101] = [[0, 3, 4], [-1, -1, -1]]
_TRI_TABLE[0b1110] = [[0, 2, 1], [-1, -1, -1]]


@jax.jit
def _active_cubes(vol: TSDFVolume):
    """Cubes whose 8 corners are all observed and not of one sign."""
    t = vol.tsdf
    w = vol.weight

    def corners(a):
        return jnp.stack(
            [a[dz:a.shape[0] - 1 + dz, dy:a.shape[1] - 1 + dy,
               dx:a.shape[2] - 1 + dx]
             for dx, dy, dz in _CUBE], axis=-1,
        )

    tc = corners(t)
    wc = corners(w)
    seen = jnp.all(wc > 0, axis=-1)
    lo = jnp.min(tc, axis=-1)
    hi = jnp.max(tc, axis=-1)
    return seen & (lo < 0.0) & (hi >= 0.0)


@partial(jax.jit, static_argnames=("cap",))
def _march_tets(vol: TSDFVolume, cube_idx, cube_ok, cap: int):
    """Marching tetrahedra over a padded list of active cube indices.

    cube_idx: (cap, 3) int32 (z, y, x) of the cube's low corner.
    Returns (tris (cap*12, 3, 3) world coords, valid (cap*12,)).
    """
    t = vol.tsdf
    cz, cy, cx = cube_idx[:, 0], cube_idx[:, 1], cube_idx[:, 2]
    # (cap, 8) corner values and (cap, 8, 3) voxel-index positions
    vals = jnp.stack(
        [t[cz + dz, cy + dy, cx + dx] for dx, dy, dz in _CUBE], axis=-1
    )
    pos = (
        jnp.stack([cx, cy, cz], axis=-1)[:, None, :].astype(jnp.float32)
        + jnp.asarray(_CUBE, jnp.float32)[None]
    )

    tets = jnp.asarray(_TETS)
    edges = jnp.asarray(_EDGES)
    table = jnp.asarray(_TRI_TABLE)

    tv = vals[:, tets]          # (cap, 6, 4)
    tp = pos[:, tets]           # (cap, 6, 4, 3)
    inside = (tv < 0.0).astype(jnp.int32)
    case = (
        inside[..., 0] + 2 * inside[..., 1]
        + 4 * inside[..., 2] + 8 * inside[..., 3]
    )                           # (cap, 6)

    va = jnp.take_along_axis(tv, jnp.broadcast_to(edges[None, None, :, 0],
                                                  tv.shape[:2] + (6,)), -1)
    vb = jnp.take_along_axis(tv, jnp.broadcast_to(edges[None, None, :, 1],
                                                  tv.shape[:2] + (6,)), -1)
    pa = tp[:, :, edges[:, 0]]  # (cap, 6, 6, 3)
    pb = tp[:, :, edges[:, 1]]
    denom = va - vb
    s = va / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    s = jnp.clip(s, 0.0, 1.0)
    xing = pa + s[..., None] * (pb - pa)          # (cap, 6, 6, 3) edge points

    tri_e = table[case]                            # (cap, 6, 2, 3)
    ok = cube_ok[:, None, None] & (tri_e[..., 0] >= 0)  # (cap, 6, 2)
    e = jnp.maximum(tri_e, 0)
    # gather the 3 edge points of each triangle
    cap_n = xing.shape[0]
    tris = jnp.take_along_axis(
        xing[:, :, None, :, :],                    # (cap, 6, 1, 6, 3)
        jnp.broadcast_to(e[..., None], (cap_n, 6, 2, 3, 3)).astype(jnp.int32),
        axis=3,
    )                                              # (cap, 6, 2, 3, 3)
    tris = vol.origin + vol.voxel * tris
    return tris.reshape(-1, 3, 3), ok.reshape(-1)


@jax.jit
def _sample_color(vol: TSDFVolume, verts):
    """Trilinear sample of the integrated intensity at world points."""
    g = (verts - vol.origin) / vol.voxel           # (N, 3) as (x, y, z)
    D, H, W = vol.color.shape
    x = jnp.clip(g[:, 0], 0.0, W - 1.0)
    y = jnp.clip(g[:, 1], 0.0, H - 1.0)
    z = jnp.clip(g[:, 2], 0.0, D - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32); x1 = jnp.minimum(x0 + 1, W - 1)
    y0 = jnp.floor(y).astype(jnp.int32); y1 = jnp.minimum(y0 + 1, H - 1)
    z0 = jnp.floor(z).astype(jnp.int32); z1 = jnp.minimum(z0 + 1, D - 1)
    fx, fy, fz = x - x0, y - y0, z - z0
    c = vol.color
    out = 0.0
    for zz, wz in ((z0, 1 - fz), (z1, fz)):
        for yy, wy in ((y0, 1 - fy), (y1, fy)):
            for xx, wx in ((x0, 1 - fx), (x1, fx)):
                out = out + c[zz, yy, xx] * (wz * wy * wx)
    return out


def extract_mesh(vol: TSDFVolume, with_colors: bool = False):
    """Zero-crossing triangle soup from the volume.

    Returns (verts (N, 3) np.float32, faces (N//3, 3) np.int32[, colors
    (N,) np.float32]): vertices are unwelded (each face owns its 3).
    Device computes the active-cube mask and the tet pass; the host only
    compacts indices (export-level).
    """
    act = np.asarray(_active_cubes(vol))
    idx = np.argwhere(act).astype(np.int32)        # (n, 3) as (z, y, x)
    n = idx.shape[0]
    if n == 0:
        empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
        return empty + (np.zeros((0,), np.float32),) if with_colors else empty
    cap = max(256, 1 << int(np.ceil(np.log2(n))))
    pad = np.zeros((cap, 3), np.int32)
    pad[:n] = idx
    ok_in = np.zeros((cap,), bool)
    ok_in[:n] = True
    tris, ok = _march_tets(vol, jnp.asarray(pad), jnp.asarray(ok_in), cap)
    tris = np.asarray(tris)[np.asarray(ok)]
    verts = tris.reshape(-1, 3).astype(np.float32)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    if with_colors:
        cols = np.asarray(_sample_color(vol, jnp.asarray(verts)))
        return verts, faces, cols.astype(np.float32)
    return verts, faces


def write_tsdf_mesh_obj(path, vol: TSDFVolume,
                        with_colors: bool = True) -> tuple[int, int]:
    """Extract and write the fused surface as OBJ; returns (n_verts, n_faces).
    Vertex colors (integrated white-frame intensity) ride along as the
    common 'v x y z r g b' OBJ extension."""
    if with_colors:
        verts, faces, cols = extract_mesh(vol, with_colors=True)
        cols = np.clip(cols, 0.0, 1.0)
    else:
        verts, faces = extract_mesh(vol)
        cols = None
    with open(path, "w") as fh:
        fh.write("# slr tsdf mesh export\n")
        if cols is None:
            for v in verts:
                fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        else:
            for v, c in zip(verts, cols):
                fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                         f"{c:.4f} {c:.4f} {c:.4f}\n")
        for f in faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")
    return int(verts.shape[0]), int(faces.shape[0])
