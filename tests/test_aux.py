"""Tests for auxiliary subsystems (SURVEY.md section 7): meshing, checks,
DP batch, elastic BA recovery, multi-frequency codec, observability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slr.config import DecodeConfig, PatternConfig
from slr.codec.multifreq import (
    decode_multifreq, default_pitches, generate_multifreq_stack,
)
from slr.dist import make_mesh
from slr.dist.batch import batched_reconstruct
from slr.dist.recovery import resume_ba
from slr.io.checkpoint import save_ba_state
from slr.observability import StageTimer, log_event, roofline, time_fn
from slr.pipeline.checks import checked_reconstruct
from slr.pipeline.meshing import grid_faces, write_mesh_obj
from slr.synth import spheres_scene
from slr.synth.render import default_rig, render_scan

CAM_W, CAM_H = 256, 128


def _scan(noise=0.0):
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        phase_steps=4)
    depth = spheres_scene(cam, CAM_H, CAM_W)
    return cam, proj, cfg, render_scan(cam, proj, depth, cfg, noise_std=noise)


def test_grid_faces_and_obj(tmp_path):
    cam, proj, cfg, scan = _scan()
    from slr.pipeline import reconstruct_dense
    cloud = reconstruct_dense(scan.frames, cam, proj, cfg)
    faces, fvalid = grid_faces(cloud.points, cloud.mask, max_edge=5.0)
    assert int(jnp.sum(fvalid)) > 1000
    nv, nf = write_mesh_obj(tmp_path / "m.obj", cloud.points, cloud.mask,
                            colors=cloud.colors)
    assert nv > 1000 and nf > 1000
    txt = (tmp_path / "m.obj").read_text()
    # face indices must be in-range 1..nv
    mx = max(
        int(t) for line in txt.splitlines() if line.startswith("f ")
        for t in line.split()[1:]
    )
    assert mx <= nv


def test_checked_reconstruct_ok_and_fail():
    cam, proj, cfg, scan = _scan()
    err, cloud = checked_reconstruct(scan.frames, cam, proj, cfg)
    assert err.get() is None
    # all-black frames -> empty mask -> located check error
    err2, _ = checked_reconstruct(jnp.zeros_like(scan.frames), cam, proj, cfg)
    assert err2.get() is not None
    assert "mask nearly empty" in str(err2.get())


def test_nan_guard_catches_injected_nan():
    """nan_guard (slr.pipeline.checks) must turn a NaN produced inside a
    guarded computation into an immediate FloatingPointError instead of
    letting it propagate silently."""
    import pytest
    from slr.pipeline.checks import nan_guard

    def bad(x):
        return jnp.log(x)  # log(-1) -> NaN

    with nan_guard():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jax.jit(bad)(jnp.asarray(-1.0)))
    # guard restored: the same computation is silent again outside
    assert bool(jnp.isnan(jax.jit(bad)(jnp.asarray(-1.0))))


def test_batched_reconstruct_dp():
    cam, proj, cfg, scan = _scan()
    B = 4
    batch = jnp.stack([scan.frames] * B)
    mesh = make_mesh(pixel_tiles=2, map_blocks=4)
    clouds = batched_reconstruct(batch, cam, proj, cfg, mesh=mesh)
    assert clouds.points.shape == (B, CAM_H, CAM_W, 3)
    # every batch element identical input -> identical output
    np.testing.assert_allclose(
        np.asarray(clouds.points[0]), np.asarray(clouds.points[-1]), atol=0
    )


def test_ba_elastic_recovery(tmp_path):
    """Fault injection: checkpoint mid-BA, drop one map block's fragments,
    resume on a smaller mesh, assert convergence (SURVEY.md section 7)."""
    from slr.dist import distributed_bundle_adjust
    from slr.geom.se3 import so3_exp

    rng = np.random.default_rng(3)
    S, L, K = 4, 64, 3
    R_true = [jnp.eye(3)]
    t_true = [jnp.zeros(3)]
    for s in range(1, S):
        R_true.append(so3_exp(jnp.asarray(rng.uniform(-0.2, 0.2, 3), jnp.float32)))
        t_true.append(jnp.asarray(rng.uniform(-30, 30, 3), jnp.float32))
    R_true, t_true = jnp.stack(R_true), jnp.stack(t_true)
    X = jnp.asarray(rng.uniform(-80, 80, (L, 3)), jnp.float32)
    obs_s = jnp.asarray(rng.integers(0, S, (L, K)), jnp.int32)
    p = jnp.einsum("lkij,lki->lkj", R_true[obs_s], X[:, None, :] - t_true[obs_s])
    w = jnp.ones((L, K), jnp.float32)
    t0 = t_true + jnp.asarray(rng.normal(0, 0.5, (S, 3)), jnp.float32).at[0].set(0.0)

    mesh8 = make_mesh(pixel_tiles=1, map_blocks=8)
    partial = distributed_bundle_adjust(R_true, t0, X + 0.5, obs_s, p, w,
                                        mesh8, iters=2)
    ckpt = tmp_path / "ba.npz"
    save_ba_state(ckpt, partial.R, partial.t, partial.X, iteration=2,
                  cost=float(partial.cost))

    # host failure: block 7 of 8 lost -> resume on 4 blocks with survivors
    lost = np.zeros(L, bool)
    lost[L // 8 * 7:] = True
    mesh4 = make_mesh(pixel_tiles=2, map_blocks=4)
    res = resume_ba(ckpt, obs_s, p, w, X + 0.5, ~lost, mesh4, iters=8)
    assert float(res.rms) < 1e-3
    np.testing.assert_allclose(np.asarray(res.t), np.asarray(t_true), atol=0.1)


def test_multifreq_roundtrip():
    W, H = 512, 4
    pitches = default_pitches(W, levels=3, ratio=8.0)
    stack = generate_multifreq_stack(W, H, pitches, steps=4)
    x_p, mask, q = decode_multifreq(stack, pitches, steps=4)
    x_true = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None], (H, W))
    err = jnp.where(mask, jnp.abs(x_p - x_true), 0.0)
    assert float(jnp.mean(mask.astype(jnp.float32))) > 0.95
    assert float(jnp.max(err)) < 0.05, float(jnp.max(err))


def test_multifreq_noise():
    W, H = 512, 32
    pitches = default_pitches(W, levels=3, ratio=8.0)
    stack = generate_multifreq_stack(W, H, pitches, steps=4)
    stack = stack + 0.01 * jax.random.normal(jax.random.PRNGKey(0), stack.shape)
    x_p, mask, q = decode_multifreq(stack, pitches, steps=4)
    x_true = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None], (H, W))
    # the coding is cyclic in the coarsest period: error is circular
    err = jnp.abs(x_p - x_true)
    err = jnp.minimum(err, W - err)
    err = jnp.where(mask, err, 0.0)
    n = jnp.sum(mask)
    rms = float(jnp.sqrt(jnp.sum(err * err) / n))
    assert rms < 0.5, rms


def test_observability():
    t = StageTimer()
    x = jnp.ones((64, 64))
    with t.stage("mul", result_to_block=x):
        y = x * 2
    assert "mul" in t.summary()
    r = roofline(bytes_accessed=1e9, flops=1e9, measured_ms=2.0,
                 device_kind="NVIDIA H100 80GB HBM3")
    assert r["bound"] == "memory"
    assert 0 < r["sol_fraction"] <= 1.0
    # a device without published peaks is an error, never a default
    with pytest.raises(KeyError, match="no published peaks"):
        roofline(bytes_accessed=1e9, flops=1e9, measured_ms=2.0)
    ms = time_fn(lambda a: a + 1, x, iters=3)
    assert ms >= 0.0


def test_checked_reconstruct_guards_fused_path():
    """The checkify gates wrap the PRODUCTION fused kernel, not just the
    pure-JAX reference path (VERDICT r2 weak #4): the checked cloud must
    be the reconstruct_dense cloud."""
    cam, proj, cfg, scan = _scan()
    err, cloud = checked_reconstruct(scan.frames, cam, proj, cfg)
    assert err.get() is None
    from slr.pipeline import reconstruct_dense

    ref = reconstruct_dense(scan.frames, cam, proj, cfg)
    # checkify reorders fusion: agreement to ~micron, not bit-exact
    np.testing.assert_allclose(np.asarray(cloud.points),
                               np.asarray(ref.points), atol=1e-2)
    agree = np.mean(np.asarray(cloud.mask) == np.asarray(ref.mask))
    assert agree > 0.999, agree


def test_session_checked_flag(tmp_path):
    """ReconstructConfig.checked=True gates the Session product path:
    a good scan passes, an all-black scan raises the located error."""
    from slr.config import ReconstructConfig, ScanConfig
    from slr.pipeline import Session

    cam, proj, cfg, scan = _scan()
    scfg = ScanConfig(pattern=cfg, cam_width=CAM_W, cam_height=CAM_H,
                      reconstruct=ReconstructConfig(checked=True))
    sess = Session(tmp_path / "chk", config=scfg)
    sess.set_calibration(cam, proj)
    sess.add_scan(scan.frames)
    sess.add_scan(jnp.zeros_like(scan.frames))
    cloud = sess.reconstruct(0)          # good scan: passes the gates
    assert int(jnp.sum(cloud.mask)) > 1000
    with pytest.raises(Exception, match="mask nearly empty"):
        sess.reconstruct(1)              # shadowed scan: located error


def test_union_of_device_intervals():
    from slr.observability import _union_ns

    assert _union_ns([]) == 0
    assert _union_ns([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17


def test_device_time_is_none_without_accelerator():
    """On the CPU backend the trace has no device plane: device time is
    'not measured', never a host number under a device name."""
    from slr.observability import device_time_ms

    assert device_time_ms(lambda a: a * 2, jnp.ones((8, 8)), n=2) is None
