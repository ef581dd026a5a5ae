"""Calibration tests: closed-form + LM vs ground truth and vs cv2.

SURVEY.md section 6 "parity tests vs OpenCV": cv2.calibrateCamera on the
same synthetic corners is the oracle; tolerances per SURVEY (intrinsics
relative ~1e-3..1e-4 depending on noise, sub-mm reprojection).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slr.calib import (
    board_object_points, synth_board_views, homography_dlt,
    calibrate_camera, stereo_calibrate, calibrate_projector,
)
from slr.geom.camera import make_camera, project
from slr.geom.se3 import so3_exp

FX, FY, CX, CY = 1150.0, 1120.0, 639.5, 511.5
DIST = [-0.18, 0.04, 0.0008, -0.0006, 0.0]


def _cam():
    return make_camera(FX, FY, CX, CY, dist=DIST)


def test_homography_exact():
    cam = make_camera(FX, FY, CX, CY)  # no distortion for pure homography
    obj, img, rv, tv = synth_board_views(cam, 9, 6, 20.0, 1, seed=2)
    H = homography_dlt(obj[:, :2], img[0])
    xy1 = jnp.concatenate([obj[:, :2], jnp.ones((obj.shape[0], 1))], axis=1)
    uvw = (H @ xy1.T).T
    uv = uvw[:, :2] / uvw[:, 2:3]
    assert float(jnp.max(jnp.abs(uv - img[0]))) < 1e-2


def test_calibrate_camera_noiseless_recovers_truth():
    cam = _cam()
    obj, img, rv, tv = synth_board_views(cam, 9, 6, 20.0, 8, seed=3)
    res = calibrate_camera(obj, img)
    assert float(res.rms) < 0.05, float(res.rms)
    np.testing.assert_allclose(float(res.camera.fx), FX, rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.fy), FY, rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.cx), CX, atol=2.0)
    np.testing.assert_allclose(float(res.camera.cy), CY, atol=2.0)
    np.testing.assert_allclose(
        np.asarray(res.camera.dist[:2]), DIST[:2], atol=5e-3
    )


def test_calibrate_camera_parity_with_cv2():
    cv2 = pytest.importorskip("cv2")
    cam = _cam()
    obj, img, rv, tv = synth_board_views(cam, 9, 6, 20.0, 10, seed=4,
                                         noise_px=0.1)
    objpts = [np.asarray(obj, np.float32)] * img.shape[0]
    imgpts = [np.asarray(v, np.float32).reshape(-1, 1, 2) for v in img]
    rms_cv, K_cv, dist_cv, _, _ = cv2.calibrateCamera(
        objpts, imgpts, (1280, 1024), None, None
    )
    res = calibrate_camera(obj, img)
    # both should land on the same optimum
    np.testing.assert_allclose(float(res.camera.fx), K_cv[0, 0], rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.fy), K_cv[1, 1], rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.cx), K_cv[0, 2], atol=1.5)
    np.testing.assert_allclose(float(res.camera.cy), K_cv[1, 2], atol=1.5)
    np.testing.assert_allclose(
        np.asarray(res.camera.dist[:2]), dist_cv.ravel()[:2], atol=2e-2
    )
    # reprojection quality within 20% of cv2's
    assert float(res.rms) < max(1.25 * rms_cv, 0.15), (float(res.rms), rms_cv)


def test_stereo_calibrate_recovers_relative_pose():
    cam = _cam()
    # ground-truth projector: offset + toe-in, own intrinsics
    th = np.deg2rad(10.0)
    R_rel = jnp.asarray(
        [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
        jnp.float32,
    )
    C = jnp.asarray([180.0, 10.0, 5.0], jnp.float32)
    t_rel = -R_rel @ C
    projector = make_camera(900.0, 890.0, 511.5, 383.5,
                            dist=[-0.05, 0.01, 0, 0, 0], R=R_rel, t=t_rel)

    obj, img_c, rvs, tvs = synth_board_views(cam, 9, 6, 20.0, 8, seed=5)
    # projector "sees" the same corners through the relative pose
    img_p = []
    for v in range(img_c.shape[0]):
        R = so3_exp(rvs[v])
        pts = (R @ obj.T).T + tvs[v]
        uv, _ = project(projector, pts)
        img_p.append(uv)
    img_p = jnp.stack(img_p)

    cam_res = calibrate_camera(obj, img_c)
    proj_res = calibrate_projector(obj, img_p)
    st = stereo_calibrate(obj, img_c, img_p, cam_res, proj_res)
    assert float(st.rms) < 0.05, float(st.rms)
    np.testing.assert_allclose(np.asarray(st.proj.R), np.asarray(R_rel),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(st.proj.t), np.asarray(t_rel),
                               rtol=0.02, atol=0.5)
    np.testing.assert_allclose(float(st.proj.fx), 900.0, rtol=5e-3)


# ---------------------------------------------------------------------------
# Image-based calibration front end (VERDICT r1 missing #2): corners are
# DETECTED from rendered board images and projector coords DECODED from a
# rendered pattern stack — no synthetic corner injection anywhere.

def _board_fixture():
    from slr.synth.render import default_rig

    CAM_W, CAM_H = 640, 512
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=512, proj_h=384)
    from slr.config import PatternConfig

    cfg = PatternConfig(proj_width=512, proj_height=384, gray_bits=6,
                        row_gray_bits=5, phase_steps=4, row_phase_steps=4)
    return cam, proj, cfg, CAM_H, CAM_W


def test_chessboard_detection_vs_cv2_and_truth():
    """Saddle detector + hull-homography ordering + sub-pixel refinement:
    parity with cv2.findChessboardCorners/cornerSubPix and < 0.5 px vs
    the rendered ground truth, across poses (incl. the 180-degree and
    mirror ordering ambiguities the hull search must reject)."""
    import cv2

    from slr.calib import detect_chessboard
    from slr.synth import render_board_view, board_poses

    cam, proj, cfg, CAM_H, CAM_W = _board_fixture()
    cols, rows, sq = 9, 6, 20.0
    for i, (R, t) in enumerate(board_poses(4, cols, rows, sq, seed=0)):
        bv = render_board_view(cam, proj, cfg, R, t, cols, rows, sq,
                               CAM_H, CAM_W, noise_std=0.005,
                               key=jax.random.PRNGKey(i))
        corners, grid_rms = detect_chessboard(bv.white_image, cols, rows)
        err = np.linalg.norm(
            corners - np.asarray(bv.corners_cam_true), axis=1)
        assert err.max() < 0.8, (i, err.max())
        assert err.mean() < 0.4, (i, err.mean())

        img8 = (np.asarray(bv.white_image) * 255).astype(np.uint8)
        ok, cv_c = cv2.findChessboardCorners(img8, (cols, rows))
        assert ok
        cv_c = cv2.cornerSubPix(
            img8, cv_c.astype(np.float32), (5, 5), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
        ).reshape(-1, 2)
        d = min(np.linalg.norm(corners - cv_c, axis=1).mean(),
                np.linalg.norm(corners - cv_c[::-1], axis=1).mean())
        assert d < 0.3, (i, d)


def test_projector_corners_from_decode_accuracy():
    """Decode-at-corners via local homographies recovers the true
    projector coordinates of the board corners to < 0.3 proj px."""
    from slr.codec import decode_stack
    from slr.config import DecodeConfig
    from slr.calib import detect_chessboard, projector_corners_from_decode
    from slr.synth import render_board_view, board_poses

    cam, proj, cfg, CAM_H, CAM_W = _board_fixture()
    cols, rows, sq = 9, 6, 20.0
    R, t = board_poses(1, cols, rows, sq, seed=2)[0]
    bv = render_board_view(cam, proj, cfg, R, t, cols, rows, sq,
                           CAM_H, CAM_W, noise_std=0.003,
                           key=jax.random.PRNGKey(0))
    corners, _ = detect_chessboard(bv.white_image, cols, rows)
    res = decode_stack(bv.scan.frames, cfg, DecodeConfig())
    pxy, ok = projector_corners_from_decode(
        res.x_p, res.y_p, res.mask, res.quality, jnp.asarray(corners))
    assert bool(jnp.all(ok))
    err = np.linalg.norm(np.asarray(pxy) - np.asarray(bv.corners_proj_true),
                         axis=1)
    assert err.mean() < 0.3, err.mean()
    assert err.max() < 1.0, err.max()


@pytest.mark.slow
def test_calibrate_from_images_golden():
    """Golden end-to-end: rendered board images only -> detected corners
    -> decoded projector corners -> Zhang + joint LM recovers the true
    rig (VERDICT r1 next-round item 2 'done' criterion)."""
    from slr.calib import calibrate_from_images
    from slr.synth import render_board_view, board_poses

    cam, proj, cfg, CAM_H, CAM_W = _board_fixture()
    cols, rows, sq = 9, 6, 20.0
    whites, stacks = [], []
    for i, (R, t) in enumerate(board_poses(8, cols, rows, sq, seed=0)):
        bv = render_board_view(cam, proj, cfg, R, t, cols, rows, sq,
                               CAM_H, CAM_W, noise_std=0.003,
                               key=jax.random.PRNGKey(i))
        whites.append(bv.white_image)
        stacks.append(bv.scan.frames)
    res = calibrate_from_images(whites, stacks, cols, rows, sq, cfg)
    st = res.stereo
    assert float(st.rms) < 0.5, float(st.rms)
    # intrinsics within 1% of truth
    for got, true in [(st.cam.fx, cam.fx), (st.cam.fy, cam.fy),
                      (st.proj.fx, proj.fx), (st.proj.fy, proj.fy)]:
        assert abs(float(got) - float(true)) / float(true) < 0.01
    assert abs(float(st.cam.cx) - float(cam.cx)) < 5.0
    assert abs(float(st.cam.cy) - float(cam.cy)) < 5.0
    # extrinsics: rotation to ~0.2 deg, baseline to ~1%
    assert np.abs(np.asarray(st.proj.R) - np.asarray(proj.R)).max() < 4e-3
    assert np.abs(np.asarray(st.proj.t) - np.asarray(proj.t)).max() < 2.0


def test_device_grid_ordering_matches_host():
    """order_corner_grid_device (r5: scipy hull + python assignment loop
    replaced by fixed-capacity jitted math) must order the same corners
    as the host path on rendered board views, with ok=True (no
    fallback)."""
    from slr.calib.corners import (corner_candidates, order_corner_grid,
                                   order_corner_grid_device)
    from slr.synth import render_board_view, board_poses

    cam, proj, cfg, CAM_H, CAM_W = _board_fixture()
    cols, rows, sq = 9, 6, 20.0
    K = cols * rows
    for i, (R, t) in enumerate(board_poses(3, cols, rows, sq, seed=4)):
        bv = render_board_view(cam, proj, cfg, R, t, cols, rows, sq,
                               CAM_H, CAM_W, noise_std=0.005,
                               key=jax.random.PRNGKey(50 + i))
        cand, score = corner_candidates(jnp.asarray(bv.white_image),
                                        K + 12)
        kth = jnp.sort(score)[::-1][K - 1]
        valid = (score > 0) & (score >= 0.5 * kth)
        ordered_d, rms_d, ok_d = order_corner_grid_device(
            cand, valid, cols, rows)
        assert bool(ok_d), i
        sub = np.asarray(cand)[np.asarray(valid)]
        ordered_h, rms_h = order_corner_grid(sub, cols, rows)
        # same grid assignment up to the 180-degree ambiguity (resolved
        # later by the checker colors, identically on both paths)
        d = min(np.abs(np.asarray(ordered_d) - ordered_h).max(),
                np.abs(np.asarray(ordered_d)[::-1] - ordered_h).max())
        assert d < 1e-3, (i, d)
        assert abs(float(rms_d) - rms_h) < 0.2, (i, float(rms_d), rms_h)


@pytest.mark.parametrize("wh", [(320, 256), (1280, 1024), (2448, 2048)])
def test_zhang_closed_form_is_conditioned(wh):
    """The closed-form intrinsics (before LM) land within 1 % of the truth
    at camera resolutions up to 5 MP: the solve runs in normalized image
    coordinates, so f32 keeps its null vector well separated."""
    from slr.calib.zhang import zhang_init_intrinsics

    W, H = wh
    cam = make_camera(fx=0.9 * W, fy=0.9 * W, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    obj, img, _, _ = synth_board_views(cam, 9, 6, 20.0 * W / 1280, 8,
                                       seed=6)
    Hs = jax.vmap(lambda uv: homography_dlt(obj[:, :2], uv))(img)
    fx, fy, cx, cy = zhang_init_intrinsics(Hs, img)
    np.testing.assert_allclose([float(fx), float(fy)], [0.9 * W] * 2,
                               rtol=1e-2)
    np.testing.assert_allclose([float(cx), float(cy)],
                               [W / 2 - 0.5, H / 2 - 0.5], atol=0.01 * W)
