"""slr command-line interface (SURVEY.md T6) — the build's replacement for
the reference's Qt GUI actions: calibrate, scan (synthetic capture),
reconstruct, register, fuse, bench, selftest.

Usage:
    python -m slr.cli demo --out /tmp/session       # full synthetic run
    python -m slr.cli scan --session S --scene bumps --pose 0
    python -m slr.cli calibrate --session S
    python -m slr.cli reconstruct --session S --index 0
    python -m slr.cli register --session S
    python -m slr.cli fuse --session S
    python -m slr.cli bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def cmd_scan(args):
    """Synthetic capture: render a pattern stack of a scene from a pose
    into the session (the build's stand-in for projector+camera IO)."""
    import jax
    import jax.numpy as jnp
    from slr.pipeline import Session
    from slr.synth import sphere_depth, spheres_scene
    from slr.synth.render import default_rig, move_rig, render_scan
    from slr.geom.se3 import so3_exp

    sess = Session(args.session)
    p = sess.config.pattern
    cam, proj = default_rig(
        cam_w=sess.config.cam_width, cam_h=sess.config.cam_height,
        proj_w=p.proj_width, proj_h=p.proj_height,
    )
    if sess.cam is None:
        sess.set_calibration(cam, proj, {"source": "default_rig"})
    H, W = sess.config.cam_height, sess.config.cam_width
    # rig moved per scan index (true rigid multi-scan ground truth)
    rv = jnp.asarray([0.0, 0.03 * args.pose, 0.01 * args.pose], jnp.float32)
    tv = jnp.asarray([8.0 * args.pose, -4.0 * args.pose, 0.0], jnp.float32)
    cam_s, proj_s = move_rig(cam, proj, so3_exp(rv), tv)
    if args.scene == "sphere":
        depth = sphere_depth(cam_s, H, W, center=[0, 0, 520.0], radius=120.0,
                             background=700.0)
    else:  # asymmetric plane + spheres scene (registration-friendly)
        depth = spheres_scene(cam_s, H, W)
    scan = render_scan(cam_s, proj_s, depth, p, noise_std=args.noise,
                       key=jax.random.PRNGKey(args.pose))
    idx = sess.add_scan(scan.frames)
    print(f"scan {idx} captured (rig pose {args.pose}) -> {args.session}/scans/")


def cmd_calibrate(args):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from slr.pipeline import Session

    sess = Session(args.session)
    c = sess.config.calib
    from slr.synth.render import default_rig

    cam_true, proj_true = default_rig(
        cam_w=sess.config.cam_width, cam_h=sess.config.cam_height,
        proj_w=sess.config.pattern.proj_width,
        proj_h=sess.config.pattern.proj_height,
    )

    if getattr(args, "synthetic_corners", False):
        # legacy fast path: corner coordinates injected analytically —
        # exercises the solvers only, not detection/decode
        from slr.calib import (
            calibrate_camera, calibrate_projector, stereo_calibrate,
            synth_board_views,
        )
        from slr.geom.camera import project
        from slr.geom.se3 import so3_exp

        obj, img_c, rvs, tvs = synth_board_views(
            cam_true, c.board_cols, c.board_rows, c.square_size,
            n_views=8, seed=0, noise_px=args.noise_px,
        )
        img_p = []
        for v in range(img_c.shape[0]):
            R = so3_exp(rvs[v])
            pts = (R @ obj.T).T + tvs[v]
            uv, _ = project(proj_true, pts)
            img_p.append(uv)
        img_p = jnp.stack(img_p)
        cam_res = calibrate_camera(obj, img_c, lm_iters=c.lm_iters)
        proj_res = calibrate_projector(obj, img_p, lm_iters=c.lm_iters)
        st = stereo_calibrate(obj, img_c, img_p, cam_res, proj_res)
    else:
        # full physical procedure (SURVEY.md E2): render the board under
        # white light + the pattern stack, detect corners, decode, solve
        from slr.calib import calibrate_from_images
        from slr.synth import board_poses, render_board_view

        p = sess.config.pattern
        if p.coding != "gray_phase":
            # calibration is its own capture: decode-at-corners needs
            # row+column gray_phase coding whatever the scan coding is
            p = dataclasses.replace(p, coding="gray_phase")
        if p.row_phase_steps == 0:
            # projector calibration needs sub-pixel rows: add row coding
            p = dataclasses.replace(p, row_gray_bits=max(p.row_gray_bits, 5),
                                    row_phase_steps=max(p.phase_steps, 4))
        whites, stacks = [], []
        for i, (R, t) in enumerate(board_poses(
                8, c.board_cols, c.board_rows, c.square_size, seed=0)):
            bv = render_board_view(
                cam_true, proj_true, p, R, t,
                c.board_cols, c.board_rows, c.square_size,
                sess.config.cam_height, sess.config.cam_width,
                noise_std=args.noise_px * 0.01,
                key=jax.random.PRNGKey(i))
            whites.append(bv.white_image)
            stacks.append(bv.scan.frames)
        res = calibrate_from_images(
            whites, stacks, c.board_cols, c.board_rows, c.square_size, p,
            lm_iters=c.lm_iters)
        st = res.stereo
    sess.set_calibration(st.cam, st.proj, {"rms": float(st.rms)})
    print(f"calibrated: joint rms {float(st.rms):.4f} px "
          f"-> {args.session}/calibration.json")


def cmd_reconstruct(args):
    from slr.pipeline import Session

    sess = Session(args.session)
    t0 = time.time()
    accumulate = getattr(args, "accumulate", False)
    cloud = sess.reconstruct(args.index, fused=not args.no_fused,
                             spatial_iters=args.spatial_iters,
                             accumulate=accumulate)
    import jax
    jax.block_until_ready(cloud.points)
    n = int(np.asarray(cloud.mask).sum())
    print(f"scan {args.index}: {n} valid points in "
          f"{(time.time()-t0)*1e3:.1f} ms -> {args.session}/clouds/")
    if accumulate:
        from slr.io import load_stage
        d = load_stage(sess.root / "clouds" / f"scan_{args.index:03d}.npz")
        print(f"projector-grid accumulation: "
              f"{int(d['acc_mask'].sum())} occupied cells")
    if args.ply:
        from slr.io import write_ply
        out = f"{args.session}/clouds/scan_{args.index:03d}.ply"
        write_ply(out, cloud.points, mask=cloud.mask,
                  colors=np.repeat(np.asarray(cloud.colors)[..., None], 3, -1))
        print(f"wrote {out}")


def cmd_register(args):
    from slr.pipeline import Session

    sess = Session(args.session)
    reg = sess.register(use_features=not args.no_features,
                        loop_closures=not getattr(args, "no_loop_closures",
                                                  False))
    print(f"registered {sess.cloud_count()} scans; "
          f"icp rms {np.asarray(reg.icp_rms).round(4).tolist()}, "
          f"pose-graph rms {float(reg.pg_rms):.5f}")


def cmd_fuse(args):
    from slr.pipeline import Session

    sess = Session(args.session)
    out = sess.fuse()
    print(f"fused model -> {out}")
    if getattr(args, "mesh", False):
        out = sess.fuse_mesh(voxel=args.voxel)
        print(f"fused TSDF mesh -> {out}")


def cmd_demo(args):
    """Full synthetic end-to-end: 3 scans -> reconstruct -> register -> fuse.

    --pixel-tiles/--map-blocks write a DistConfig into the session so the
    whole run takes the config-5 sharded product path [B:12]: pixel-tile
    sharded reconstruction, map-block-distributed Schur BA.
    """
    import dataclasses

    ns = argparse.Namespace
    coding = getattr(args, "coding", "gray_phase")
    pixel_tiles = getattr(args, "pixel_tiles", 1)
    map_blocks = getattr(args, "map_blocks", 1)
    if coding != "gray_phase" or pixel_tiles * map_blocks > 1:
        from slr.config import DistConfig, PatternConfig
        from slr.pipeline import Session

        cfg = Session(args.out).config
        if coding != "gray_phase":
            pat = (PatternConfig(coding="multifreq", phase_steps=4)
                   if coding == "multifreq"
                   else PatternConfig(phase_steps=0))   # "gray": code-only
            cfg = dataclasses.replace(cfg, pattern=pat)
        cfg = dataclasses.replace(
            cfg, dist=DistConfig(pixel_tiles=pixel_tiles,
                                 map_blocks=map_blocks))
        Session(args.out, config=cfg)
    cmd_calibrate(ns(session=args.out, noise_px=0.0))
    for pose in range(args.scans):
        cmd_scan(ns(session=args.out, scene="bumps", pose=pose, noise=0.005))
        cmd_reconstruct(ns(session=args.out, index=pose, no_fused=False,
                           spatial_iters=0, ply=False))
    cmd_register(ns(session=args.out, no_features=args.no_features))
    cmd_fuse(ns(session=args.out))


def cmd_stereo_demo(args):
    """Two-camera rig demo (SURVEY.md section 1 "one or two cameras"):
    render both views of the spheres scene, reconstruct by projector-space
    rendezvous (no projector calibration in the geometry), report RMS vs
    ground truth, write the PLY."""
    import jax

    from slr.config import PatternConfig, ScanConfig
    from slr.io import write_ply
    from slr.pipeline import Session
    from slr.synth import render_scan, spheres_scene, two_camera_rig

    H, W = args.cam_h, args.cam_w
    cfg = PatternConfig(proj_width=512, proj_height=384, gray_bits=6,
                        row_gray_bits=5, phase_steps=3, row_phase_steps=3)
    cam1, cam2, proj = two_camera_rig(cam_w=W, cam_h=H, proj_w=512,
                                      proj_h=384)
    sess = Session(args.out, ScanConfig(pattern=cfg, cam_width=W,
                                        cam_height=H))
    sess.set_calibration(cam1, proj, cam2=cam2)
    scans = []
    for i, cam in enumerate((cam1, cam2)):
        depth = spheres_scene(cam, H, W)
        scans.append(render_scan(cam, proj, depth, cfg, noise_std=0.003,
                                 key=jax.random.PRNGKey(i),
                                 cast_shadows=True))
    sess.add_scan(scans[0].frames, frames2=scans[1].frames)
    cloud = sess.reconstruct(0)
    # the merge method organizes the cloud on the PROJECTOR grid; the
    # projector is a Camera, so ground truth is the scene depth from its
    # viewpoint (first surface hit along each projector ray)
    from slr.geom.camera import pixel_to_ray
    import jax.numpy as jnp

    depth_p = spheres_scene(proj, cfg.proj_height, cfg.proj_width)
    vg, ug = jnp.meshgrid(
        jnp.arange(cfg.proj_height, dtype=jnp.float32),
        jnp.arange(cfg.proj_width, dtype=jnp.float32), indexing="ij")
    o_p, d_p = pixel_to_ray(proj, ug, vg)
    dz = jnp.einsum("j,...j->...", proj.R[2], d_p)
    pts_true = np.asarray(o_p + (depth_p / dz)[..., None] * d_p)
    valid = np.asarray(cloud.mask)
    err = np.linalg.norm(np.asarray(cloud.points) - pts_true,
                         axis=-1)[valid]
    rms = float(np.sqrt(np.mean(err ** 2))) if err.size else float("nan")
    out = Path(args.out) / "stereo.ply"
    write_ply(out, cloud.points.reshape(-1, 3),
              mask=cloud.mask.reshape(-1))
    print(f"two-camera cloud: {int(valid.sum())} px, RMS {rms:.4f} mm "
          f"-> {out}")
    return rms


def cmd_import_scan(args):
    """Ingest a reference-style scan folder (one image per pattern) into
    the session — the real-data entry point replacing camera capture."""
    from slr.io import load_scan_folder
    from slr.pipeline import Session

    frames = load_scan_folder(args.folder)
    sess = Session(args.session)
    idx = sess.add_scan(frames)
    print(f"imported {frames.shape[0]} frames "
          f"({frames.shape[1]}x{frames.shape[2]}) as scan {idx}")


def cmd_export_scan(args):
    from slr.io import save_scan_folder
    from slr.pipeline import Session

    sess = Session(args.session)
    frames = sess.load_scan(args.index)
    paths = save_scan_folder(args.folder, np.asarray(frames), fmt=args.format)
    print(f"wrote {len(paths)} frames -> {args.folder}")


def cmd_export_calib(args):
    """Write the session calibration as cv::FileStorage YAML (the
    reference's persistence format) for interop with OpenCV tooling."""
    from slr.io import save_calibration_opencv
    from slr.pipeline import Session

    sess = Session(args.session)
    if sess.cam is None:
        raise SystemExit("session has no calibration — run calibrate first")
    save_calibration_opencv(args.out, sess.cam, sess.proj, sess.calib_meta)
    print(f"wrote OpenCV YAML calibration -> {args.out}")


def cmd_import_calib(args):
    from slr.io import load_calibration_opencv
    from slr.pipeline import Session

    cam, proj, meta = load_calibration_opencv(args.yaml)
    sess = Session(args.session)
    sess.set_calibration(cam, proj, dict(meta, source="opencv_yaml"))
    print(f"imported calibration from {args.yaml} -> "
          f"{args.session}/calibration.json")


def cmd_view(args):
    """Render a point-cloud preview PNG/PGM — the build's replacement for
    the reference's OpenGL viewer widget (device-side splatting)."""
    from slr.io import read_ply
    from slr.pipeline import Session
    from slr.pipeline.viewer import render_turntable

    sess = Session(args.session)
    if args.cloud == "fused":
        pts, cols, _ = read_ply(f"{args.session}/fused.ply")
    else:
        c = sess.load_cloud(int(args.cloud))
        m = np.asarray(c.mask).astype(bool)
        pts = np.asarray(c.points)[m]
        cols = np.repeat(np.asarray(c.colors)[m][:, None], 3, -1)
    out = args.out or f"{args.session}/preview"
    outs = render_turntable(pts, cols, out, frames=args.frames,
                            size=args.size)
    print(f"wrote {len(outs)} view(s): {outs[0]}{' ...' if len(outs)>1 else ''}")


def cmd_bench(args):
    # the parent never touches a device: the benchmark process owns the card
    import subprocess
    bench = Path(__file__).resolve().parent.parent / "bench.py"
    raise SystemExit(subprocess.call([sys.executable, str(bench)]))


def main(argv=None):
    """Run one subcommand; returns what it returns (stereo-demo: the
    cloud's RMS vs ground truth in mm)."""
    ap = argparse.ArgumentParser(prog="slr", description=__doc__)
    # multi-host bring-up (SURVEY.md §7 comm backend): in a multi-host job
    # every host runs the same command with its own --proc-id; jax.distributed
    # joins them into one job before any backend use. Single-process (the
    # default) skips initialization entirely. Proven cross-process in
    # tests/test_multiprocess.py (2 and 4 local processes over Gloo).
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="jax.distributed coordinator address "
                         "(multi-host jobs only)")
    ap.add_argument("--num-procs", type=int, default=None, dest="num_procs",
                    help="total process count of the distributed job")
    ap.add_argument("--proc-id", type=int, default=None, dest="proc_id",
                    help="this process's rank in [0, num-procs)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scan", help="synthetic capture into a session")
    p.add_argument("--session", required=True)
    p.add_argument("--scene", default="bumps", choices=["bumps", "sphere"])
    p.add_argument("--pose", type=int, default=0)
    p.add_argument("--noise", type=float, default=0.005)
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("calibrate", help="device-resident Zhang calibration")
    p.add_argument("--session", required=True)
    p.add_argument("--noise-px", type=float, default=0.0, dest="noise_px")
    p.add_argument("--synthetic-corners", action="store_true",
                   dest="synthetic_corners",
                   help="skip detection/decode; feed analytically projected "
                        "corner coordinates straight to the solvers")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("reconstruct", help="decode+triangulate one scan")
    p.add_argument("--session", required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--no-fused", action="store_true")
    p.add_argument("--spatial-iters", type=int, default=0)
    p.add_argument("--ply", action="store_true")
    p.add_argument("--accumulate", action="store_true",
                   help="also bin the cloud onto the projector column "
                        "grid (component-13 accumulation stage)")
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("register", help="align all reconstructed scans")
    p.add_argument("--session", required=True)
    p.add_argument("--no-features", action="store_true")
    p.add_argument("--no-loop-closures", action="store_true",
                   help="chain odometry only (skip last<->first/skip edges)")
    p.set_defaults(fn=cmd_register)

    p = sub.add_parser("fuse", help="merge registered scans into one model")
    p.add_argument("--mesh", action="store_true",
                   help="also TSDF-fuse and export a triangle mesh (OBJ)")
    p.add_argument("--voxel", type=float, default=2.0,
                   help="TSDF voxel size (mm)")
    p.add_argument("--session", required=True)
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("demo", help="full synthetic end-to-end run")
    p.add_argument("--out", default="/tmp/slr_demo")
    p.add_argument("--scans", type=int, default=3)
    p.add_argument("--no-features", action="store_true")
    p.add_argument("--coding", default="gray_phase",
                   choices=["gray_phase", "gray", "multifreq"],
                   help="temporal coding family (gray = Gray code only)")
    p.add_argument("--pixel-tiles", type=int, default=1, dest="pixel_tiles",
                   help="shard image rows over this many devices (config 5)")
    p.add_argument("--map-blocks", type=int, default=1, dest="map_blocks",
                   help="shard scans/landmarks over this many devices "
                        "(config-5 distributed Schur BA)")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("stereo-demo",
                       help="two-camera rig end-to-end (no projector "
                            "calibration in the triangulation)")
    p.add_argument("--out", default="/tmp/slr_stereo")
    p.add_argument("--cam-w", type=int, default=512, dest="cam_w")
    p.add_argument("--cam-h", type=int, default=384, dest="cam_h")
    p.set_defaults(fn=cmd_stereo_demo)

    p = sub.add_parser("import-scan", help="ingest a scan image folder")
    p.add_argument("--session", required=True)
    p.add_argument("--folder", required=True)
    p.set_defaults(fn=cmd_import_scan)

    p = sub.add_parser("export-scan", help="write a scan as an image folder")
    p.add_argument("--session", required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--folder", required=True)
    p.add_argument("--format", default="pgm", choices=["pgm", "png"])
    p.set_defaults(fn=cmd_export_scan)

    p = sub.add_parser("export-calib", help="export cv::FileStorage YAML")
    p.add_argument("--session", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_export_calib)

    p = sub.add_parser("import-calib", help="import cv::FileStorage YAML")
    p.add_argument("--session", required=True)
    p.add_argument("--yaml", required=True)
    p.set_defaults(fn=cmd_import_calib)

    p = sub.add_parser("view", help="render point-cloud preview images")
    p.add_argument("--session", required=True)
    p.add_argument("--cloud", default="fused",
                   help="'fused' or a scan index")
    p.add_argument("--out", default=None, help="output path prefix")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--size", type=int, default=640)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("bench", help="run the benchmark harness")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.num_procs and args.num_procs > 1:
        from slr.dist import init_distributed

        init_distributed(coordinator=args.coordinator,
                         num_processes=args.num_procs,
                         process_id=args.proc_id)
    if args.fn is not cmd_bench:    # the bench parent stays off the device
        from slr.runtime import enable_compile_cache

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
