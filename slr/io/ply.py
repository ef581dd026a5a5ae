"""PLY / OBJ point-cloud IO.

Binary-little-endian PLY compatible with MeshLab/CloudCompare/Open3D.
Fast path: the native C++ writer (slr/native/plyio.cpp) — one interleave
pass + one fwrite; fallback: NumPy structured arrays. Reference analog:
the app's savePLY()-style writers (SURVEY.md L1/component 18).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from slr.native.build import load_native


def _as_compact(points, mask=None, colors=None, normals=None):
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    col = None if colors is None else np.asarray(colors).reshape(-1, 3)
    nrm = None if normals is None else np.asarray(normals, np.float32).reshape(-1, 3)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        pts = pts[m]
        col = None if col is None else col[m]
        nrm = None if nrm is None else nrm[m]
    if col is not None and col.dtype != np.uint8:
        col = np.clip(col * 255.0 if col.max() <= 1.0 + 1e-6 else col, 0, 255
                      ).astype(np.uint8)
    return np.ascontiguousarray(pts), col, nrm


def write_ply(path, points, mask=None, colors=None, normals=None) -> int:
    """Write a point cloud; returns the number of points written.

    points (N,3) or (H,W,3); mask optional (same leading shape) selects
    valid points; colors uint8/float (N,3); normals f32 (N,3).
    """
    pts, col, nrm = _as_compact(points, mask, colors, normals)
    n = pts.shape[0]
    lib = load_native()
    path = str(path)
    if lib is not None:
        col_c = (
            col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if col is not None else None
        )
        nrm_c = (
            np.ascontiguousarray(nrm).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
            if nrm is not None else None
        )
        rc = lib.slr_write_ply(
            path.encode(), n,
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), col_c, nrm_c,
        )
        if rc == 0:
            return n
    # NumPy fallback
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if nrm is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if col is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if nrm is not None:
        rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if col is not None:
        rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"comment slr structured-light engine\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if nrm is not None:
            f.write(b"property float nx\nproperty float ny\nproperty float nz\n")
        if col is not None:
            f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        rec.tofile(f)
    return n


def read_ply(path):
    """Read a PLY written by write_ply. Returns (points, colors, normals)
    with None for absent attributes."""
    path = str(path)
    lib = load_native()
    if lib is not None:
        has_rgb = ctypes.c_int(0)
        has_nrm = ctypes.c_int(0)
        n = lib.slr_ply_info(path.encode(), ctypes.byref(has_rgb),
                             ctypes.byref(has_nrm))
        if n >= 0:
            pts = np.empty((n, 3), np.float32)
            col = np.empty((n, 3), np.uint8) if has_rgb.value else None
            nrm = np.empty((n, 3), np.float32) if has_nrm.value else None
            rc = lib.slr_read_ply(
                path.encode(), n,
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                if col is not None else None,
                nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                if nrm is not None else None,
            )
            if rc == 0:
                return pts, col, nrm
    # NumPy fallback parser (same restricted layout)
    with open(path, "rb") as f:
        has_rgb = has_nrm = False
        n = 0
        while True:
            line = f.readline().decode("ascii", "ignore")
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float nx"):
                has_nrm = True
            elif line.startswith("property uchar red"):
                has_rgb = True
            elif line.startswith("end_header"):
                break
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if has_nrm:
            fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        if has_rgb:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        rec = np.fromfile(f, dtype=fields, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    nrm = (
        np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1) if has_nrm else None
    )
    col = (
        np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
        if has_rgb else None
    )
    return pts, col, nrm


def write_obj(path, points, mask=None, colors=None) -> int:
    """Minimal OBJ vertex export (v x y z [r g b])."""
    pts, col, _ = _as_compact(points, mask, colors)
    with open(path, "w") as f:
        f.write("# slr structured-light engine\n")
        if col is None:
            for p in pts:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            cf = col.astype(np.float32) / 255.0
            for p, c in zip(pts, cf):
                f.write(
                    f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n"
                )
    return pts.shape[0]
