"""slr on the GPU: the main path, kernel parity and kernel-vs-plain times.

    python chip_smoke.py             # one GPU, flagship width
    python chip_smoke.py --cards 4   # sharded paths on 4 GPUs vs one GPU

Default phases (one process, one card):
  1. identity: nvidia-smi name + power limit, jax.devices(), JAX version;
  2. main path through the CLI at the default ScanConfig (1280x1024
     camera, 1024x768 projector, 7 Gray bits + inverses + 4-step phase):
     ``demo --scans 3`` (calibration from rendered board images, fused
     reconstruction, registration, fusion), ``fuse --mesh`` (TSDF + mesh),
     ``stereo-demo`` at 1280x1024, and one HDR bracket (E=3) through a
     Session — each against its accuracy gate;
  3. parity of each kernel with its plain reference, f32 and uint8;
  4. each kernel's pipeline timed against the plain route (median of 21
     calls on device-resident inputs, after warm-up).
``--cards 4`` runs only the four-card phase: pixel-tile sharded
reconstruction, scan-level data parallelism and distributed Schur BA,
each compared with the same work on one card.

Any failed gate raises (non-zero exit). Without a GPU the script exits
non-zero before running anything. The last stdout line is one JSON object
naming the device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from functools import partial
from pathlib import Path

import numpy as np

# flagship rig (the default ScanConfig)
FLAGSHIP = dict(cam_w=1280, cam_h=1024, proj_w=1024, proj_h=768,
                gray_bits=7)
TIMING_ITERS = 21


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _gate(name: str, value: float, limit: float) -> None:
    print(f"  {name}: {value:.6g} (limit < {limit:g})")
    _check(value < limit, f"{name} {value} not < {limit}")


def _rms(points, mask, points_true, mask_true) -> float:
    valid = np.asarray(mask) & np.asarray(mask_true)
    _check(valid.sum() > 0, "no valid points to score")
    err = np.linalg.norm(np.asarray(points) - np.asarray(points_true),
                         axis=-1)[valid]
    return float(np.sqrt(np.mean(err ** 2)))


def _rig(cam_w, cam_h, proj_w, proj_h, gray_bits):
    from slr.config import PatternConfig
    from slr.synth.render import default_rig

    cam, proj = default_rig(cam_w=cam_w, cam_h=cam_h, proj_w=proj_w,
                            proj_h=proj_h)
    cfg = PatternConfig(proj_width=proj_w, proj_height=proj_h,
                        gray_bits=gray_bits, phase_steps=4)
    return cam, proj, cfg


def _flagship_scan(cam, proj, cfg, H, W, key=0):
    import jax

    from slr.synth import bumps_depth
    from slr.synth.render import render_scan

    depth = bumps_depth(H, W, base=480.0, amp=30.0)
    return render_scan(cam, proj, depth, cfg, noise_std=0.005,
                       key=jax.random.PRNGKey(key))


def _hdr_bracket(cam, proj, cfg, H, W):
    """A 21x-albedo scene captured at 3 exposures as uint8: dark cells
    need the long exposure, which clips the bright ones. Each capture
    has its own sensor noise."""
    import jax
    import jax.numpy as jnp

    from slr.synth import bumps_depth, checker_albedo
    from slr.synth.render import quantize_frames, render_scan

    albedo = checker_albedo(H, W, cells=6, lo=0.035, hi=0.75)
    scan = render_scan(cam, proj, bumps_depth(H, W, base=480.0, amp=30.0),
                       cfg, noise_std=0.0, albedo=albedo)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    bracket = quantize_frames(jnp.stack([
        jnp.clip(scan.frames * g
                 + 0.003 * jax.random.normal(k, scan.frames.shape), 0, 1)
        for g, k in zip((1.0, 3.0, 10.0), keys)]))
    return scan, bracket


def phase_identity() -> str:
    import jax

    from slr.runtime import gpu_identity

    card = gpu_identity()
    print(f"[1] card: {card}")
    print(f"    jax {jax.__version__}: {jax.devices()}")
    return card


def phase_main_path(workdir, cam_w, cam_h, proj_w, proj_h, gray_bits,
                    scans: int = 3, stereo_wh=(1280, 1024)) -> dict:
    """CLI demo + fuse --mesh + stereo-demo + an HDR Session scan."""
    import jax

    from slr import cli
    from slr.config import ScanConfig
    from slr.geom.se3 import so3_exp
    from slr.pipeline import Session
    from slr.synth import spheres_scene
    from slr.synth.render import move_rig, render_scan

    workdir = Path(workdir)
    demo = workdir / "demo"
    cam, proj, cfg = _rig(cam_w, cam_h, proj_w, proj_h, gray_bits)
    Session(demo, config=ScanConfig(pattern=cfg, cam_width=cam_w,
                                    cam_height=cam_h))
    print(f"[2] main path: demo --scans {scans} at {cam_w}x{cam_h}")
    cli.main(["demo", "--out", str(demo), "--scans", str(scans)])
    # ground truth of scan 0 (rig pose 0), rendered as `slr scan` does
    cam0, proj0 = move_rig(cam, proj, so3_exp(np.zeros(3, np.float32)),
                           np.zeros(3, np.float32))
    truth = render_scan(cam0, proj0, spheres_scene(cam0, cam_h, cam_w), cfg,
                        noise_std=0.005, key=jax.random.PRNGKey(0))
    sess = Session(demo)
    out = {"calib_rms_px": float(sess.calib_meta["rms"])}
    cloud = sess.load_cloud(0)
    out["scan_rms_calibrated_mm"] = _rms(cloud.points, cloud.mask,
                                         truth.points_true, truth.mask_true)
    print(f"  calibration joint RMS {out['calib_rms_px']:.4f} px; scan 0 "
          f"with the calibrated rig: RMS {out['scan_rms_calibrated_mm']:.4f}"
          " mm vs ground truth (calibration bias included; it predates "
          "the GPU port, so it is not gated; PERF.md)")
    _check(np.isfinite(out["scan_rms_calibrated_mm"]),
           "calibrated scan is not finite")
    # the repo's single-scan gate (bench.py): the same frames through a
    # Session that holds the true rig
    chk = Session(workdir / "true_rig", sess.config)
    chk.set_calibration(cam0, proj0)
    chk.add_scan(sess.load_scan(0))
    cloud = chk.reconstruct(0)
    out["scan_rms_mm"] = _rms(cloud.points, cloud.mask, truth.points_true,
                              truth.mask_true)
    _gate("single-scan RMS vs ground truth (mm)", out["scan_rms_mm"], 1.0)
    _check((demo / "fused.ply").stat().st_size > 0, "no fused.ply")

    cli.main(["fuse", "--session", str(demo), "--mesh"])
    _check((demo / "fused_mesh.obj").stat().st_size > 0, "no mesh")

    sw, sh = stereo_wh
    out["stereo_rms_mm"] = cli.main(
        ["stereo-demo", "--out", str(workdir / "stereo"),
         "--cam-w", str(sw), "--cam-h", str(sh)])
    _gate("two-camera RMS vs ground truth (mm)", out["stereo_rms_mm"], 0.1)

    out.update(phase_hdr(workdir, cam, proj, cfg, cam_w, cam_h))
    return out


def _hdr_parity(bracket, cam, proj, cfg) -> dict:
    """fuse="select" kernel vs decode_multi_exposure: the two choose an
    exposure by slightly different validity gates, hence the looser
    mask/percentile gates (tests/test_kernels.py HDR parity)."""
    from slr.codec import decode_multi_exposure
    from slr.config import DecodeConfig
    from slr.kernels import fused_decode_triangulate_hdr

    dec = DecodeConfig()
    out = fused_decode_triangulate_hdr(bracket, cam, proj, cfg, dec,
                                       fuse="select")
    ref = decode_multi_exposure(bracket, cfg, dec)
    m_k = np.asarray(out.mask) > 0.5
    m_r = np.asarray(ref.mask)
    both = m_k & m_r
    xerr = np.abs(np.asarray(out.x_p) - np.asarray(ref.x_p))[both]
    res = {"hdr_mask_xor": float((m_k ^ m_r).mean()),
           "hdr_xp_p99": float(np.percentile(xerr, 99))}
    _gate("HDR mask XOR vs plain select", res["hdr_mask_xor"], 0.02)
    _gate("HDR p99 |dx_p| (proj px)", res["hdr_xp_p99"], 0.1)
    return res


def phase_hdr(workdir, cam, proj, cfg, cam_w, cam_h) -> dict:
    from slr.config import ScanConfig
    from slr.pipeline import Session

    scan, bracket = _hdr_bracket(cam, proj, cfg, cam_h, cam_w)
    print(f"    HDR bracket {tuple(bracket.shape)} {bracket.dtype} "
          "through Session")
    sess = Session(Path(workdir) / "hdr",
                   ScanConfig(pattern=cfg, cam_width=cam_w,
                              cam_height=cam_h))
    sess.set_calibration(cam, proj)
    sess.add_scan(bracket)
    cloud = sess.reconstruct(0)
    res = {"hdr_rms_mm": _rms(cloud.points, cloud.mask, scan.points_true,
                              scan.mask_true)}
    _gate("HDR RMS vs ground truth (mm)", res["hdr_rms_mm"], 1.0)
    res.update(_hdr_parity(bracket, cam, proj, cfg))
    return res


def phase_parity(cam_w, cam_h, proj_w, proj_h, gray_bits) -> dict:
    """Kernel vs plain reference (decode_stack + triangulate_plane), the
    tolerances of tests/test_kernels.py, reference at full precision."""
    import jax
    import jax.numpy as jnp

    from slr.codec import decode_stack
    from slr.config import DecodeConfig
    from slr.geom.triangulate import triangulate_plane
    from slr.kernels import fused_decode_triangulate
    from slr.synth.render import quantize_frames

    cam, proj, cfg = _rig(cam_w, cam_h, proj_w, proj_h, gray_bits)
    scan = _flagship_scan(cam, proj, cfg, cam_h, cam_w)
    dec = DecodeConfig()
    print(f"[3] kernel parity at {cam_w}x{cam_h}, reference under "
          "jax.default_matmul_precision('highest')")
    res = {}
    for name, frames in (("f32", scan.frames),
                         ("uint8", quantize_frames(scan.frames))):
        out = fused_decode_triangulate(frames, cam, proj, cfg, dec)
        with jax.default_matmul_precision("highest"):
            ref = decode_stack(frames, cfg, dec)
            v, u = jnp.meshgrid(jnp.arange(cam_h, dtype=jnp.float32),
                                jnp.arange(cam_w, dtype=jnp.float32),
                                indexing="ij")
            pts_ref, _ = triangulate_plane(cam, proj, u, v, ref.x_p)
        m_k = np.asarray(out.mask) > 0.5
        m_r = np.asarray(ref.mask)
        both = m_k & m_r
        pts_k = np.moveaxis(np.asarray(out.points), 0, -1)
        r = {
            "mask_xor": float((m_k ^ m_r).mean()),
            "max_dxp": float(np.abs(np.asarray(out.x_p)
                                    - np.asarray(ref.x_p))[both].max()),
            "max_dquality": float(np.abs(np.asarray(out.quality)
                                         - np.asarray(ref.quality))[both]
                                  .max()),
            "max_dpoints_mm": float(np.abs(pts_k
                                           - np.asarray(pts_ref))[both]
                                    .max()),
        }
        print(f"  fused_decode_triangulate, {name} frames:")
        _gate("mask XOR", r["mask_xor"], 0.01)
        _gate("max |dx_p| (proj px)", r["max_dxp"], 1e-3)
        _gate("max |dquality|", r["max_dquality"], 1e-4)
        _gate("max |dpoints| (mm)", r["max_dpoints_mm"], 5e-2)
        res[name] = r
    print("  fused_decode_triangulate_hdr, f32 bracket:")
    _, bracket = _hdr_bracket(cam, proj, cfg, cam_h, cam_w)
    res["hdr_f32"] = _hdr_parity(bracket.astype(jnp.float32) / 255.0,
                                 cam, proj, cfg)
    print("  fused_decode_triangulate_hdr, uint8 bracket:")
    res["hdr_uint8"] = _hdr_parity(bracket, cam, proj, cfg)
    return res


def phase_timing(cam_w, cam_h, proj_w, proj_h, gray_bits,
                 stereo_wh=(1280, 1024), iters: int = TIMING_ITERS) -> dict:
    """Kernel pipeline vs plain route on device-resident inputs: median
    wall ms of ``iters`` calls after 3 warm-up calls (compilation
    excluded, host dispatch included), and device-busy ms per call from
    a profiler trace of 10 calls."""
    import jax

    from slr.config import DecodeConfig, ReconstructConfig
    from slr.observability import device_time_ms, time_fn
    from slr.pipeline.reconstruct import (
        reconstruct_dense, reconstruct_hdr_plain, reconstruct_scan,
        reconstruct_scan_hdr,
    )
    from slr.synth.render import quantize_frames

    cam, proj, cfg = _rig(cam_w, cam_h, proj_w, proj_h, gray_bits)
    scan = _flagship_scan(cam, proj, cfg, cam_h, cam_w)
    dec, rec = DecodeConfig(), ReconstructConfig()
    print(f"[4] kernel vs plain at {cam_w}x{cam_h}: median ms of {iters}")
    res = {}

    on_gpu = jax.default_backend() == "gpu"

    def busy(fn, *args):
        dev = device_time_ms(fn, *args)
        _check(dev is not None or not on_gpu, "no device events traced")
        return None if dev is None else dev["busy_ms"]

    def pair(label, kern, plain, *args):
        r = {"kernel_ms": time_fn(kern, *args, iters=iters, warmup=3),
             "plain_ms": time_fn(plain, *args, iters=iters, warmup=3),
             "kernel_device_ms": busy(kern, *args),
             "plain_device_ms": busy(plain, *args)}
        dev = ("not measured" if r["kernel_device_ms"] is None else
               f"{r['kernel_device_ms']:.4f} vs {r['plain_device_ms']:.4f}")
        print(f"  {label}: wall {r['kernel_ms']:.4f} vs "
              f"{r['plain_ms']:.4f} ms; device busy {dev} ms")
        res[label] = r

    for name, frames in (("f32", scan.frames),
                         ("uint8", quantize_frames(scan.frames))):
        frames = jax.block_until_ready(frames)
        pair(f"reconstruct_dense vs reconstruct_scan, {name}",
             reconstruct_dense, reconstruct_scan, frames, cam, proj, cfg,
             dec, rec)
    _, bracket = _hdr_bracket(cam, proj, cfg, cam_h, cam_w)
    bracket = jax.block_until_ready(bracket)
    # the same work on both sides: the kernel's best-exposure pick against
    # the plain route; then the production phase fusion against that pick
    select = partial(reconstruct_scan_hdr, fuse="select")
    pair("reconstruct_scan_hdr(fuse='select') vs reconstruct_hdr_plain, "
         "uint8 E=3", select, reconstruct_hdr_plain, bracket, cam, proj,
         cfg, dec, rec)
    pair("reconstruct_scan_hdr fuse='sum' (Session default) vs "
         "fuse='select', uint8 E=3", reconstruct_scan_hdr, select, bracket,
         cam, proj, cfg, dec, rec)
    res["two_camera"] = _time_two_camera(*stereo_wh, iters=iters)
    return res


def _time_two_camera(W, H, iters: int) -> dict:
    """The plain two-camera merge (one-hot crossing contractions): time
    and the compiled program's temporary memory."""
    import jax

    from slr.config import PatternConfig
    from slr.observability import time_fn
    from slr.pipeline import reconstruct_two_camera
    from slr.synth import render_scan, spheres_scene, two_camera_rig

    cfg = PatternConfig(proj_width=512, proj_height=384, gray_bits=6,
                        row_gray_bits=5, phase_steps=3, row_phase_steps=3)
    cam1, cam2, proj = two_camera_rig(cam_w=W, cam_h=H, proj_w=512,
                                      proj_h=384)
    f1, f2 = (jax.block_until_ready(render_scan(
        c, proj, spheres_scene(c, H, W), cfg, noise_std=0.003,
        key=jax.random.PRNGKey(i), cast_shadows=True).frames)
        for i, c in enumerate((cam1, cam2)))
    ms = time_fn(reconstruct_two_camera, f1, f2, cam1, cam2, cfg,
                 iters=iters, warmup=3)
    mem = reconstruct_two_camera.lower(
        f1, f2, cam1, cam2, cfg).compile().memory_analysis()
    temp = int(getattr(mem, "temp_size_in_bytes", -1))
    print(f"  reconstruct_two_camera (plain merge) {W}x{H}: {ms:.4f} ms, "
          f"compiled temp memory {temp / 2**20:.1f} MiB")
    return {"ms": ms, "temp_bytes": temp}


def _ba_problem(S=8, L=4096, K=3, noise=0.01, seed=0):
    """Synthetic BA problem (as tests/test_dist.py builds it)."""
    import jax.numpy as jnp

    from slr.geom.se3 import so3_exp

    rng = np.random.default_rng(seed)
    R_true = jnp.stack([jnp.eye(3)] + [
        so3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 3), jnp.float32))
        for _ in range(S - 1)])
    t_true = jnp.asarray(rng.uniform(-50, 50, (S, 3)), jnp.float32)
    t_true = t_true.at[0].set(0.0)
    X_true = jnp.asarray(rng.uniform(-100, 100, (L, 3)), jnp.float32)
    obs_s = jnp.asarray(rng.integers(0, S, (L, K)), jnp.int32)
    p = jnp.einsum("lkij,lki->lkj", R_true[obs_s],
                   X_true[:, None, :] - t_true[obs_s])
    p = p + jnp.asarray(rng.normal(0, noise, p.shape), jnp.float32)
    R0 = jnp.stack([
        R_true[s] @ so3_exp(jnp.asarray(rng.normal(0, 0.02, 3),
                                        jnp.float32))
        for s in range(S)]).at[0].set(jnp.eye(3))
    t0 = (t_true + jnp.asarray(rng.normal(0, 1.0, (S, 3)), jnp.float32)
          ).at[0].set(0.0)
    X0 = X_true + jnp.asarray(rng.normal(0, 1.0, (L, 3)), jnp.float32)
    return R0, t0, X0, obs_s, p, jnp.ones((L, K), jnp.float32)


def _spans(arr, n: int, label: str) -> None:
    k = len(arr.sharding.device_set)
    print(f"  {label}: sharded over {k} devices")
    _check(k == n, f"{label} spans {k} devices, expected {n}")


def phase_four_cards(workdir, n, cam_w, cam_h, proj_w, proj_h,
                     gray_bits) -> dict:
    """Each sharded path on n devices vs the same work on one device,
    with the tolerances of tests/test_dist.py."""
    import jax
    import jax.numpy as jnp

    from slr.config import DecodeConfig, DistConfig, ScanConfig
    from slr.dist import (
        bundle_adjust_reference, distributed_bundle_adjust, make_mesh,
        sharded_reconstruct,
    )
    from slr.dist.batch import batched_reconstruct
    from slr.pipeline import Session

    devs = jax.devices()
    _check(len(devs) >= n, f"need {n} devices, have {len(devs)}")
    cam, proj, cfg = _rig(cam_w, cam_h, proj_w, proj_h, gray_bits)
    dec = DecodeConfig()
    one = make_mesh(pixel_tiles=1, map_blocks=1, devices=devs[:1])
    print(f"[5] {n} cards vs one at {cam_w}x{cam_h}")
    res = {}

    # --- pixel-tile sharded reconstruction through Session ---
    scan = _flagship_scan(cam, proj, cfg, cam_h, cam_w)
    sess = Session(Path(workdir) / "tiles",
                   ScanConfig(pattern=cfg, cam_width=cam_w,
                              cam_height=cam_h,
                              dist=DistConfig(pixel_tiles=n)))
    sess.set_calibration(cam, proj)
    sess.add_scan(scan.frames)
    cloud = sess.reconstruct(0, spatial_iters=8)
    for label, arr in (("points", cloud.points), ("mask", cloud.mask),
                       ("x_p", cloud.x_p)):
        _spans(arr, n, f"pixel-tile {label}")
    ref_pts, ref_mask, ref_xp, _ = sharded_reconstruct(
        scan.frames, cam, proj, cfg, dec, one, spatial_iters=8)
    m = np.asarray(ref_mask)
    _check(np.array_equal(np.asarray(cloud.mask), m),
           "pixel-tile mask differs from one card")
    res["tiles_max_dxp"] = float(np.abs(np.asarray(cloud.x_p)
                                        - np.asarray(ref_xp))[m].max())
    res["tiles_max_dpoints_mm"] = float(np.abs(
        np.asarray(cloud.points) - np.asarray(ref_pts))[m].max())
    _gate("pixel-tile max |dx_p| vs one card", res["tiles_max_dxp"], 1e-5)
    _gate("pixel-tile max |dpoints| vs one card (mm)",
          res["tiles_max_dpoints_mm"], 5e-2)

    # --- scan-level data parallelism ---
    batch = jnp.stack([_flagship_scan(cam, proj, cfg, cam_h, cam_w,
                                      key=k).frames for k in range(n)])
    blocks = make_mesh(pixel_tiles=1, map_blocks=n, devices=devs[:n])
    out = batched_reconstruct(batch, cam, proj, cfg, dec, mesh=blocks)
    _spans(out.points, n, "DP batch points")
    ref = batched_reconstruct(jax.device_put(batch, devs[0]), cam, proj,
                              cfg, dec)
    _check(np.array_equal(np.asarray(out.mask), np.asarray(ref.mask)),
           "DP batch mask differs from one card")
    res["dp_max_dpoints_mm"] = float(np.abs(
        np.asarray(out.points) - np.asarray(ref.points)).max())
    _gate("DP batch max |dpoints| vs one card (mm)",
          res["dp_max_dpoints_mm"], 1e-5)

    # --- distributed Schur BA over map_block ---
    R0, t0, X0, obs_s, p, w = _ba_problem()
    ba = distributed_bundle_adjust(R0, t0, X0, obs_s, p, w, blocks,
                                   iters=8)
    _spans(ba.X, n, "BA landmarks")
    rb = bundle_adjust_reference(R0, t0, X0, obs_s, p, w, iters=8)
    res["ba_max_dt"] = float(np.abs(np.asarray(ba.t)
                                    - np.asarray(rb.t)).max())
    res["ba_max_dR"] = float(np.abs(np.asarray(ba.R)
                                    - np.asarray(rb.R)).max())
    res["ba_max_dX"] = float(np.abs(np.asarray(ba.X)
                                    - np.asarray(rb.X)).max())
    res["ba_rms_rel"] = abs(float(ba.rms) - float(rb.rms)) / float(rb.rms)
    _gate("BA max |dt| vs one card", res["ba_max_dt"], 1e-3)
    _gate("BA max |dR| vs one card", res["ba_max_dR"], 1e-5)
    _gate("BA max |dX| vs one card", res["ba_max_dX"], 1e-3)
    _gate("BA relative rms difference", res["ba_rms_rel"], 1e-3)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    from slr.runtime import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    card = phase_identity()
    with tempfile.TemporaryDirectory(prefix="slr_smoke_") as tmp:
        if args.cards == 4:
            phase_four_cards(tmp, 4, **FLAGSHIP)
        else:
            phase_main_path(tmp, **FLAGSHIP)
            phase_parity(**FLAGSHIP)
            phase_timing(**FLAGSHIP)
    dev = jax.devices()[0]
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.cards}}))


if __name__ == "__main__":
    main()
