"""Zhang calibration: closed-form init + batched LM refinement.

SURVEY.md section 4.4 / component 9. Closed-form: the B = K^{-T}K^{-1}
constraints from >=3 homographies give intrinsics; extrinsics follow per
view; distortion starts at 0. Refinement: one LM solve over
{fx, fy, cx, cy, k1, k2, p1, p2, k3, (rvec_i, tvec_i)} minimizing
reprojection error of every corner in every view, with all views batched
through vmap (the "batched least-squares Zhang calibration" of [B:5]).
Parity vs cv2.calibrateCamera is asserted in tests/test_calib.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slr.geom.camera import Camera, distort, make_camera
from slr.geom.se3 import so3_exp, so3_log
from slr.calib.homography import homography_dlt
from slr.calib.lm import lm_solve


class CalibrationResult(NamedTuple):
    camera: Camera          # intrinsics + distortion (R=I, t=0)
    rvecs: jnp.ndarray      # (V,3) per-view board rotations
    tvecs: jnp.ndarray      # (V,3)
    rms: jnp.ndarray        # reprojection RMS in px


def _v_ij(H, i, j):
    return jnp.array(
        [
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ]
    )


def zhang_init_intrinsics(Hs, img_points):
    """Closed-form K from stacked homographies (V,3,3), V >= 3.

    ``img_points`` (any shape (..., 2), pixels: the corners the
    homographies were fitted to) set a similarity that brings the image
    coordinates to unit scale before the solve, and K is mapped back
    after it. In pixel units the entries of b = K^-T K^-1 span ~6 orders
    of magnitude and the f32 null vector is noise on some backends (the
    GPU's symmetric eigensolver); normalized, it is well conditioned. The
    null vector comes from an SVD of the constraint matrix itself, not an
    eigh of its square.
    """
    pts = img_points.reshape(-1, 2).astype(jnp.float32)
    c = jnp.mean(pts, axis=0)
    s = jnp.sqrt(2.0) / (jnp.mean(jnp.linalg.norm(pts - c, axis=1)) + 1e-12)
    T = jnp.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]],
                   [0.0, 0.0, 1.0]])
    rows = []
    for H in Hs:  # V is static (python loop unrolls in trace)
        Hn = T @ H
        Hn = Hn / jnp.linalg.norm(Hn)
        rows.append(_v_ij(Hn, 0, 1))
        rows.append(_v_ij(Hn, 0, 0) - _v_ij(Hn, 1, 1))
    V = jnp.stack(rows)
    _, _, vt = jnp.linalg.svd(V, full_matrices=False)
    b = vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = jnp.sqrt(jnp.abs(lam / B11))
    beta = jnp.sqrt(jnp.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    # back to pixels: K = T^-1 K_normalized (skew dropped)
    return alpha / s, beta / s, u0 / s + c[0], v0 / s + c[1]


def extrinsics_from_homography(H, fx, fy, cx, cy):
    """Per-view (rvec, tvec) from H and K (Zhang), SVD-orthogonalized."""
    Kinv = jnp.array(
        [
            [1.0 / fx, 0.0, -cx / fx],
            [0.0, 1.0 / fy, -cy / fy],
            [0.0, 0.0, 1.0],
        ]
    )
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / (jnp.linalg.norm(Kinv @ h1) + 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = jnp.cross(r1, r2)
    R = jnp.stack([r1, r2, r3], axis=1)
    # nearest rotation matrix
    U, _, Vt = jnp.linalg.svd(R)
    Rn = U @ Vt
    det = jnp.linalg.det(Rn)
    Rn = Rn * jnp.sign(det)
    t = lam * (Kinv @ h3)
    # board must be in front of the camera
    flip = jnp.sign(t[2])
    t = t * flip
    # flipping t means flipping r1, r2 too (H defined up to sign)
    Rf = jnp.stack([r1 * flip, r2 * flip, jnp.cross(r1 * flip, r2 * flip)], axis=1)
    U, _, Vt = jnp.linalg.svd(Rf)
    Rn = U @ Vt
    return so3_log(Rn), t


def _project_residual(params, obj, img, n_views):
    """Packed params -> reprojection residual vector (whitened layout).

    params: [fx', fy', cx, cy, d0..d4, (rvec,tvec)*V] where focals are
    stored /100 to balance the Jacobian columns in f32.
    """
    fx, fy = params[0] * 100.0, params[1] * 100.0
    cx, cy = params[2], params[3]
    dist = params[4:9]
    pose = params[9:].reshape(n_views, 6)
    rvecs, tvecs = pose[:, :3], pose[:, 3:]

    def per_view(rv, tv, uv_obs):
        R = so3_exp(rv)
        pc = (R @ obj.T).T + tv
        z = pc[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        xn, yn = pc[:, 0] / zs, pc[:, 1] / zs
        xd, yd = distort(xn, yn, dist)
        u = fx * xd + cx
        v = fy * yd + cy
        return jnp.stack([u, v], axis=-1) - uv_obs

    res = jax.vmap(per_view)(rvecs, tvecs, img)
    return res.reshape(-1)


@partial(jax.jit, static_argnames=("lm_iters",))
def calibrate_camera(obj, img_views, lm_iters: int = 60) -> CalibrationResult:
    """obj (N,3) board points (z=0), img_views (V,N,2) detected corners.

    Full device-resident pipeline: batched DLT homographies -> closed-form
    intrinsics -> per-view extrinsics -> joint LM.
    """
    V = img_views.shape[0]
    Hs = jax.vmap(lambda uv: homography_dlt(obj[:, :2], uv))(img_views)
    fx, fy, cx, cy = zhang_init_intrinsics(Hs, img_views)
    rv, tv = jax.vmap(
        lambda H: extrinsics_from_homography(H, fx, fy, cx, cy)
    )(Hs)

    x0 = jnp.concatenate(
        [
            jnp.stack([fx / 100.0, fy / 100.0, cx, cy]),
            jnp.zeros(5),
            jnp.concatenate([rv, tv], axis=1).reshape(-1),
        ]
    )
    x, cost = lm_solve(
        _project_residual, x0, args=(obj, img_views, V), iters=lm_iters
    )
    # per-point Euclidean RMS in px (cv2.calibrateCamera convention)
    rms = jnp.sqrt(cost / (img_views.size / 2.0))
    pose = x[9:].reshape(V, 6)
    cam = make_camera(x[0] * 100.0, x[1] * 100.0, x[2], x[3], dist=x[4:9])
    return CalibrationResult(
        camera=cam, rvecs=pose[:, :3], tvecs=pose[:, 3:], rms=rms
    )
