"""Two-camera reconstruction (SURVEY.md section 1 "one or two cameras").

The load-bearing property: two-camera triangulation never reads the
projector's calibration, so projector optics errors (distortion that the
cam-projector model does NOT know about) leave it untouched while they
corrupt the cam-projector path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from slr.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr.pipeline import reconstruct_scan, reconstruct_two_camera
from slr.synth import render_scan, spheres_scene, two_camera_rig

CAM_H, CAM_W = 384, 512


def _cfg(**kw):
    base = dict(proj_width=512, proj_height=384, gray_bits=6,
                row_gray_bits=5, phase_steps=3, row_phase_steps=3)
    base.update(kw)
    return PatternConfig(**base)


def _render_pair(proj_dist=None, noise=0.003):
    cfg = _cfg()
    cam1, cam2, proj = two_camera_rig(cam_w=CAM_W, cam_h=CAM_H,
                                      proj_w=512, proj_h=384)
    if proj_dist is not None:
        proj = proj._replace(dist=jnp.asarray(proj_dist, jnp.float32))
    scans = []
    for i, cam in enumerate((cam1, cam2)):
        depth = spheres_scene(cam, CAM_H, CAM_W)
        # cast_shadows: without it a projector ray illuminates BOTH the
        # sphere and the plane behind it, so the same code legitimately
        # appears at two 3D points and correspondence is ambiguous
        scans.append(render_scan(cam, proj, depth, cfg, noise_std=noise,
                                 key=jax.random.PRNGKey(i),
                                 cast_shadows=True))
    return cfg, cam1, cam2, proj, scans


def _rms(points, mask, scan):
    valid = np.asarray(mask) & np.asarray(scan.mask_true)
    err = np.linalg.norm(
        np.asarray(points) - np.asarray(scan.points_true), axis=-1)[valid]
    return float(np.sqrt(np.mean(err ** 2))), int(valid.sum())


def _proj_truth(proj, cfg, scene=spheres_scene):
    """Ground-truth 3D points on the PROJECTOR grid — the organized grid
    of the default "merge" method. The projector is a Camera, so the
    scene depth from its viewpoint gives the first surface hit along
    each projector ray, which is exactly the point both cameras see
    coded with that ray's (x_p, y_p)."""
    from slr.geom.camera import pixel_to_ray

    h, w = cfg.proj_height, cfg.proj_width
    depth_p = scene(proj, h, w)
    v, u = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                        jnp.arange(w, dtype=jnp.float32), indexing="ij")
    o, d = pixel_to_ray(proj, u, v)
    dz = jnp.einsum("j,...j->...", proj.R[2], d)
    return np.asarray(o + (depth_p / dz)[..., None] * d)


def _rms_proj(cloud, pts_true):
    mask = np.asarray(cloud.mask)
    err = np.linalg.norm(np.asarray(cloud.points) - pts_true, axis=-1)[mask]
    return float(np.sqrt(np.mean(err ** 2))), int(mask.sum())


@pytest.mark.slow
def test_two_camera_submm():
    """Default (merge) method: projector-grid cloud, search-class accuracy
    (VERDICT r3 next #1 'search-class accuracy <= 0.1 mm RMS')."""
    cfg, cam1, cam2, proj, (s1, s2) = _render_pair()
    cloud = reconstruct_two_camera(s1.frames, s2.frames, cam1, cam2, cfg)
    assert cloud.mask.shape == (cfg.proj_height, cfg.proj_width)
    rms, n = _rms_proj(cloud, _proj_truth(proj, cfg))
    # both cameras must overlap on a solid share of the projector grid
    assert n > 0.4 * cfg.proj_height * cfg.proj_width, n
    assert rms < 0.1, rms


def test_two_camera_ignores_projector_optics():
    """Heavy projector distortion unknown to the calibration: the
    cam-projector path (which believes the projector is ideal) degrades,
    the two-camera path does not move."""
    dist = [-0.25, 0.1, 0.004, -0.004, 0.0]
    cfg, cam1, cam2, proj_true, (s1, s2) = _render_pair(proj_dist=dist)

    cloud2 = reconstruct_two_camera(s1.frames, s2.frames, cam1, cam2, cfg)
    # truth from the TRUE (distorted) projector: the merge grid indexes
    # by decoded code, which follows the real optics; the reconstruction
    # itself never reads any projector model
    rms2, n2 = _rms_proj(cloud2, _proj_truth(proj_true, cfg))
    assert rms2 < 0.1, rms2

    # cam-projector path with the IDEAL projector model (distortion unknown)
    proj_ideal = proj_true._replace(dist=jnp.zeros(5, jnp.float32))
    cloud1 = reconstruct_scan(s1.frames, cam1, proj_ideal, cfg,
                              rec=ReconstructConfig(method="midpoint"))
    rms1, n1 = _rms(cloud1.points, cloud1.mask, s1)
    assert rms1 > 4 * rms2, (rms1, rms2)


def test_two_camera_requires_row_coding():
    cfg = PatternConfig(proj_width=512, proj_height=384, gray_bits=6,
                        phase_steps=3)
    cam1, cam2, _ = two_camera_rig(cam_w=64, cam_h=64)
    frames = jnp.zeros((cfg.num_frames, 64, 64), jnp.float32)
    with pytest.raises(ValueError, match="row_gray_bits"):
        reconstruct_two_camera(frames, frames, cam1, cam2, cfg)


@pytest.mark.slow
def test_two_camera_session_roundtrip(tmp_path):
    """Product surface: a two-camera session persists cam2 + both stacks
    and reconstruct() routes through the rendezvous path."""
    from slr.config import ScanConfig
    from slr.pipeline import Session

    cfg, cam1, cam2, proj, (s1, s2) = _render_pair()
    sess = Session(tmp_path / "sess", ScanConfig(pattern=cfg))
    sess.set_calibration(cam1, proj, cam2=cam2)
    sess.add_scan(s1.frames, frames2=s2.frames)

    # calibration + scan survive a fresh Session load
    sess = Session(tmp_path / "sess")
    assert sess.cam2 is not None
    cloud = sess.reconstruct(0)
    rms, n = _rms_proj(cloud, _proj_truth(proj, cfg))
    assert n > 0.4 * cfg.proj_height * cfg.proj_width
    assert rms < 0.1, rms
    # stage file persisted for downstream register/fuse
    assert sess.cloud_count() == 1


@pytest.mark.slow
def test_session_route_matrix(tmp_path):
    """Route-combination contract (VERDICT r3 #10 / ADVICE r3 #4):
    an HDR bracket plus a second-camera stack is an explicit error (not a
    silent fallback to projector triangulation), and a two-camera scan
    under a pixel-tile mesh reconstructs unsharded with the same result
    as the meshless session."""
    from slr.config import DistConfig, ScanConfig
    from slr.pipeline import Session

    cfg, cam1, cam2, proj, (s1, s2) = _render_pair()

    # HDR bracket + frames2 -> error
    sess = Session(tmp_path / "bad", ScanConfig(pattern=cfg))
    sess.set_calibration(cam1, proj, cam2=cam2)
    bracket = jnp.stack([s1.frames, s1.frames * 0.5])
    sess.add_scan(bracket, frames2=s2.frames)
    with pytest.raises(ValueError, match="HDR"):
        sess.reconstruct(0)

    # two-camera + pixel-tile mesh -> rendezvous route, sharding skipped
    sess2 = Session(tmp_path / "mesh",
                    ScanConfig(pattern=cfg, dist=DistConfig(pixel_tiles=2)))
    sess2.set_calibration(cam1, proj, cam2=cam2)
    sess2.add_scan(s1.frames, frames2=s2.frames)
    cloud = sess2.reconstruct(0)
    ref = reconstruct_two_camera(s1.frames, s2.frames, cam1, cam2, cfg)
    assert np.array_equal(np.asarray(cloud.mask), np.asarray(ref.mask))
    np.testing.assert_allclose(np.asarray(cloud.points),
                               np.asarray(ref.points), atol=1e-5)


def test_two_camera_masks_single_view_occlusion():
    """Pixels cam 2 cannot see (no splat evidence at their projector
    coordinate) must be masked, not hallucinated."""
    cfg, cam1, cam2, proj, (s1, s2) = _render_pair()
    # erase the right half of cam 2's view: no evidence lands there
    frames2 = s2.frames.at[:, :, CAM_W // 2:].set(0.0)
    cloud = reconstruct_two_camera(s1.frames, frames2, cam1, cam2, cfg)
    full = reconstruct_two_camera(s1.frames, s2.frames, cam1, cam2, cfg)
    n_cut = int(np.asarray(cloud.mask).sum())
    n_full = int(np.asarray(full.mask).sum())
    assert n_cut < 0.8 * n_full, (n_cut, n_full)
    rms, _ = _rms_proj(cloud, _proj_truth(proj, cfg))
    assert rms < 0.1, rms


@pytest.mark.slow
def test_two_camera_multiscan_registration():
    """Two-camera clouds are ordinary ScanClouds: two rig poses of the
    world scene register through the standard ICP + pose-graph path and
    recover the rig motion. rocks_scene, not spheres_scene: this rig's
    two-view overlap crops the symmetry-breaking small spheres (both are
    tucked behind the big one from its viewpoints), leaving a near-
    symmetric sphere+plane orbit that ICP legitimately slides along."""
    from slr.config import RegistrationConfig
    from slr.geom.se3 import so3_exp
    from slr.pipeline import register_scans
    from slr.synth import move_rig, rocks_scene

    cfg = _cfg()
    cam1, cam2, proj = two_camera_rig(cam_w=CAM_W, cam_h=CAM_H,
                                      proj_w=512, proj_h=384)
    R_m = so3_exp(jnp.asarray([0.0, 0.04, 0.01], jnp.float32))
    t_m = jnp.asarray([10.0, -5.0, 3.0], jnp.float32)
    clouds = []
    for pose_i, (R_p, t_p) in enumerate(
            [(jnp.eye(3), jnp.zeros(3)), (R_m, t_m)]):
        scans = []
        for cam_i, cam in enumerate((cam1, cam2)):
            cam_s, proj_s = move_rig(cam, proj, R_p, t_p)
            depth = rocks_scene(cam_s, CAM_H, CAM_W)
            scans.append(render_scan(cam_s, proj_s, depth, cfg,
                                     noise_std=0.003,
                                     key=jax.random.PRNGKey(10 * pose_i
                                                            + cam_i),
                                     cast_shadows=True))
        clouds.append(reconstruct_two_camera(
            scans[0].frames, scans[1].frames, cam1, cam2, cfg))
    reg = register_scans(clouds, RegistrationConfig(icp_sample_points=2048),
                         use_features=False, loop_closures=False)
    rot_err = np.degrees(np.arccos(np.clip(
        (np.trace(np.asarray(reg.R[1]).T @ np.asarray(R_m)) - 1) / 2,
        -1, 1)))
    t_err = float(np.linalg.norm(np.asarray(reg.t[1]) - np.asarray(t_m)))
    assert rot_err < 0.5, rot_err
    assert t_err < 2.0, t_err


@pytest.mark.slow
def test_two_camera_search_matches_splat():
    """The epipolar depth-search fast path must agree with the
    splat/MLS-gather oracle wherever both claim validity."""
    from slr.config import ReconstructConfig

    cfg, cam1, cam2, proj, (s1, s2) = _render_pair()
    rec = ReconstructConfig(min_depth=300.0, max_depth=900.0)
    a = reconstruct_two_camera(s1.frames, s2.frames, cam1, cam2, cfg,
                               rec=rec, method="search")
    b = reconstruct_two_camera(s1.frames, s2.frames, cam1, cam2, cfg,
                               rec=rec, method="splat")
    both = np.asarray(a.mask) & np.asarray(b.mask)
    # search covers most of what splat covers inside the working volume
    assert both.sum() > 0.85 * np.asarray(b.mask).sum(), (
        int(both.sum()), int(np.asarray(b.mask).sum()))
    d = np.linalg.norm(
        np.asarray(a.points) - np.asarray(b.points), axis=-1)[both]
    assert np.percentile(d, 95) < 0.5, np.percentile(d, 95)


def test_invert_to_projector_flip_axes():
    """Mirrored rigs: flip_u / flip_v must make descending code maps
    invertible, returning camera coordinates in the FLIPPED image frame
    (u' = W-1-u, v' = H-1-v) — what ray lookup into the captured
    mirrored image needs."""
    from slr.pipeline.twocam import invert_to_projector

    H, W, PW, PH = 64, 96, 64, 48
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    x_p = 0.6 * u + 2.0 + 0.01 * v
    y_p = 0.7 * v + 1.0 + 0.005 * u
    mask = jnp.ones((H, W), bool)
    q = jnp.ones((H, W), jnp.float32)
    w = jnp.ones((H, W), jnp.float32)

    base = invert_to_projector(jnp.asarray(x_p), jnp.asarray(y_p), mask,
                               q, w, PW, PH)
    flip_u = invert_to_projector(jnp.asarray(x_p[:, ::-1]),
                                 jnp.asarray(y_p[:, ::-1]), mask, q, w,
                                 PW, PH, flip_u=True)
    flip_v = invert_to_projector(jnp.asarray(x_p[::-1, :]),
                                 jnp.asarray(y_p[::-1, :]), mask, q, w,
                                 PW, PH, flip_v=True)
    b_valid = np.asarray(base[0])
    assert (b_valid == np.asarray(flip_u[0])).all()
    assert (b_valid == np.asarray(flip_v[0])).all()
    np.testing.assert_allclose(
        (W - 1) - np.asarray(flip_u[1])[b_valid],
        np.asarray(base[1])[b_valid], atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(flip_u[2])[b_valid], np.asarray(base[2])[b_valid],
        atol=1e-3)
    np.testing.assert_allclose(
        (H - 1) - np.asarray(flip_v[2])[b_valid],
        np.asarray(base[2])[b_valid], atol=1e-3)


def _brute_crossings(code, valid, chans, K, gate, dmin=0.125, dmax=4.0):
    """Per-row crossing search: count and mean interpolated channels."""
    R, U = code.shape
    cnt = np.zeros((R, K))
    acc = np.zeros((chans.shape[0], R, K))
    for r in range(R):
        for u in range(U - 1):
            d = code[r, u + 1] - code[r, u]
            if not (valid[r, u] and valid[r, u + 1] and dmin < d < dmax
                    and gate[r, u]):
                continue
            for k in range(max(0, int(np.ceil(code[r, u]))), K):
                if not code[r, u] <= k < code[r, u + 1]:
                    break
                t = (k - code[r, u]) / d
                cnt[r, k] += 1
                acc[:, r, k] += chans[:, r, u] + t * (chans[:, r, u + 1]
                                                      - chans[:, r, u])
    return cnt, acc / np.maximum(cnt, 1)[None]


@pytest.mark.parametrize("gated", [0, 1])
def test_crossing_interp_continuity_gates(gated):
    """The plain crossing route with a continuity gate on a carried
    channel, as invert_to_projector applies one per pass (pass 1 gates
    on the carried y code, pass 2 on the carried camera u): vetoed pairs
    contribute nothing, every other crossing matches a brute-force
    search."""
    from slr.pipeline.crossing import crossing_interp

    rng = np.random.default_rng(3 + gated)
    R, U, K = 6, 120, 90
    code = np.cumsum(rng.uniform(0.2, 1.4, (R, U)), axis=1)
    code = (code - code[:, :1] + rng.uniform(-3, 3, (R, 1))).astype(
        np.float32)
    valid = rng.random((R, U)) > 0.05
    chans = (rng.normal(0, 1, (2, R, U)) * 10 + 50).astype(np.float32)
    chans[gated, :, 60:] += 25.0            # a silhouette in the carried
    gate = np.abs(chans[gated][:, 1:] - chans[gated][:, :-1]) < 20.0
    assert (~gate).sum() >= R               # the veto has work to do
    cnt, vals = crossing_interp(
        jnp.asarray(code), jnp.asarray(valid), jnp.asarray(chans), K,
        interp=(True, True), pair_gate=jnp.asarray(gate))
    cnt_ref, vals_ref = _brute_crossings(code, valid, chans, K, gate)
    np.testing.assert_array_equal(np.asarray(cnt), cnt_ref)
    np.testing.assert_allclose(np.asarray(vals), vals_ref, atol=2e-3)
