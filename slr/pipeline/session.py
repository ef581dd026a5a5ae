"""Scan-session state (SURVEY.md E1): the build's replacement for the
reference's GUI-held project state — config + calibration + scans +
derived products, with the same everything-is-a-file resume contract
(stage .npz / calibration JSON / PLY under one session directory)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from slr.config import ScanConfig, load_config, save_config
from slr.geom.camera import Camera
from slr.io import (
    load_calibration, read_ply, save_calibration, save_stage, load_stage,
    write_ply,
)
from slr.pipeline.reconstruct import ScanCloud, reconstruct_dense, reconstruct_scan
from slr.pipeline.registerfuse import RegisteredScans, fuse_scans, register_scans


class Session:
    """Directory-backed scan session.

    Layout:
        session/config.json         ScanConfig
        session/calibration.json    camera + projector
        session/scans/scan_%03d.npz captured frame stacks
        session/clouds/scan_%03d.npz decoded organized clouds
        session/registration.npz    poses
        session/fused.ply           final model
    """

    def __init__(self, root, config: Optional[ScanConfig] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "scans").mkdir(exist_ok=True)
        (self.root / "clouds").mkdir(exist_ok=True)
        cfg_path = self.root / "config.json"
        if config is not None:
            self.config = config
            save_config(config, cfg_path)
        elif cfg_path.exists():
            self.config = load_config(cfg_path)
        else:
            self.config = ScanConfig()
            save_config(self.config, cfg_path)
        self.cam: Optional[Camera] = None
        self.cam2: Optional[Camera] = None  # two-camera rig (optional)
        self.proj: Optional[Camera] = None
        self.calib_meta: dict = {}
        calib = self.root / "calibration.json"
        if calib.exists():
            self.cam, self.proj, self.calib_meta, self.cam2 = (
                load_calibration(calib, with_cam2=True))
        self._mesh = None

    @property
    def mesh(self):
        """Device mesh from config.dist (config-5 [B:12] product path).

        Built lazily on first use: ``pixel_tiles`` shards image rows
        inside each scan, ``map_blocks`` shards scans/landmark fragments.
        None when the config is single-device. Raises when the machine
        has fewer devices than the requested layout: a run configured for
        N devices never silently runs on one."""
        if self._mesh is not None:
            return self._mesh
        d = self.config.dist
        n = d.pixel_tiles * d.map_blocks
        if n <= 1:
            return None
        import jax

        if len(jax.devices()) < n:
            raise RuntimeError(
                f"config.dist asks for {n} devices (pixel_tiles="
                f"{d.pixel_tiles} x map_blocks={d.map_blocks}), but only "
                f"{len(jax.devices())} {jax.default_backend()} device(s) "
                "exist")
        from slr.dist import make_mesh

        self._mesh = make_mesh(pixel_tiles=d.pixel_tiles,
                               map_blocks=d.map_blocks,
                               devices=jax.devices()[:n])
        return self._mesh

    # --- calibration ---
    def set_calibration(self, cam: Camera, proj: Camera, meta=None,
                        cam2: Optional[Camera] = None):
        self.cam, self.proj, self.cam2 = cam, proj, cam2
        self.calib_meta = meta or {}
        save_calibration(self.root / "calibration.json", cam, proj, meta,
                         cam2=cam2)

    # --- scans ---
    def add_scan(self, frames, frames2=None) -> int:
        """``frames2`` stores the second camera's stack of the same shot
        (two-camera rig); reconstruct() then routes through the
        projector-space rendezvous path automatically."""
        idx = len(self.scan_paths())
        stage = dict(frames=np.asarray(frames))
        if frames2 is not None:
            stage["frames2"] = np.asarray(frames2)
        save_stage(self.root / "scans" / f"scan_{idx:03d}.npz", **stage)
        return idx

    def scan_paths(self):
        return sorted((self.root / "scans").glob("scan_*.npz"))

    def load_scan(self, idx: int, second: bool = False):
        d = load_stage(self.scan_paths()[idx])
        if second:
            return (jnp.asarray(d["frames2"]) if "frames2" in d else None)
        return jnp.asarray(d["frames"])

    def _load_scan_pair(self, idx: int):
        """Both cameras' stacks from ONE stage read (the .npz was being
        decompressed twice per reconstruction — ADVICE r3 #3)."""
        d = load_stage(self.scan_paths()[idx])
        frames2 = jnp.asarray(d["frames2"]) if "frames2" in d else None
        return jnp.asarray(d["frames"]), frames2

    # --- reconstruction ---
    def reconstruct(self, idx: int, fused: bool = True,
                    spatial_iters: int = 0,
                    accumulate: bool = False) -> ScanCloud:
        """Decode + triangulate scan ``idx`` into an organized cloud.

        ``accumulate`` additionally bins the cloud onto the projector
        column grid (component 13, the reference's PointCloudImage-style
        accumulation) and persists the accumulated grid alongside the
        cloud stage file.

        Route precedence (first match wins; see tests/test_pipeline.py
        route-matrix tests):
          1. HDR bracket (frames.ndim == 4) -> reconstruct_scan_hdr.
             Combining a bracket with a second camera is NOT supported
             and raises (silently dropping camera 2 would fall back to
             projector-calibration triangulation — ADVICE r3 #4).
          2. two-camera (frames2 + cam2) -> projector-space rendezvous.
             A configured pixel-tile mesh does NOT shard this route (the
             rendezvous passes are projector-grid-global); the scan still
             reconstructs, single-device.
          3. pixel-tile mesh -> sharded fused kernel (single-camera only).
          4. fused Pallas kernel / 5. pure-JAX fallback."""
        assert self.cam is not None, "calibrate or set_calibration first"
        frames, frames2 = self._load_scan_pair(idx)
        p = self.config.pattern
        mesh = self.mesh
        H = frames.shape[1]
        if frames.ndim == 4 and frames2 is not None:
            raise ValueError(
                "scan %d has both an exposure bracket and a second-camera "
                "stack: HDR + two-camera is unsupported (capture the "
                "bracket per camera as separate scans instead)" % idx)
        if frames.ndim == 4:
            # exposure bracket (E, F, H, W): HDR decode fusion
            from slr.pipeline.reconstruct import reconstruct_scan_hdr

            cloud = reconstruct_scan_hdr(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct)
        elif frames2 is not None and self.cam2 is not None:
            # two-camera rig: projector-space rendezvous triangulation
            # (projector calibration does not enter the geometry)
            from slr.pipeline.twocam import reconstruct_two_camera

            cloud = reconstruct_two_camera(
                frames, frames2, self.cam, self.cam2, p,
                self.config.decode, self.config.reconstruct)
        elif (mesh is not None and mesh.shape["pixel_tile"] > 1
                and H % mesh.shape["pixel_tile"] == 0):
            # config-5 pixel-tile route: rows sharded over the mesh, the
            # production fused kernel per shard (slr.dist.sharded)
            from slr.dist import sharded_reconstruct
            from slr.pipeline.reconstruct import _white_color

            pts, mask, x_p, quality = sharded_reconstruct(
                frames, self.cam, self.proj, p, self.config.decode, mesh,
                spatial_iters=spatial_iters,
            )
            cloud = ScanCloud(points=pts, mask=mask,
                              colors=_white_color(frames),
                              quality=quality, x_p=x_p)
        elif fused and p.phase_steps > 0 and (p.use_inverse
                                              or p.coding == "multifreq"):
            cloud = reconstruct_dense(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct, spatial_iters=spatial_iters,
                spatial_mode=self.config.decode.spatial_unwrap_mode,
            )
        else:
            cloud = reconstruct_scan(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct,
            )
        rc = self.config.reconstruct
        if rc.checked:
            # sanitizer gate on the PRODUCTION cloud (fused or sharded
            # path alike): fail loudly on NaN points / near-empty masks
            from slr.pipeline.checks import validate_cloud

            validate_cloud(cloud, rc.min_valid_fraction).throw()
        if rc.sor_k > 0:
            from slr.registration import statistical_outlier_removal

            H, W = cloud.mask.shape
            keep = statistical_outlier_removal(
                cloud.points.reshape(-1, 3), cloud.mask.reshape(-1),
                rc.sor_voxel, k=rc.sor_k, std_ratio=rc.sor_std_ratio,
            ).reshape(H, W)
            cloud = cloud._replace(mask=cloud.mask & keep)
        stage = dict(
            points=np.asarray(cloud.points), mask=np.asarray(cloud.mask),
            colors=np.asarray(cloud.colors), quality=np.asarray(cloud.quality),
            x_p=np.asarray(cloud.x_p),
        )
        if accumulate:
            from slr.pipeline.reconstruct import accumulate_by_projector

            acc_pts, acc_mask, acc_col = accumulate_by_projector(
                cloud, self.config.pattern.proj_width)
            stage.update(acc_points=np.asarray(acc_pts),
                         acc_mask=np.asarray(acc_mask),
                         acc_colors=np.asarray(acc_col))
        save_stage(self.root / "clouds" / f"scan_{idx:03d}.npz", **stage)
        return cloud

    def reconstruct_all(self, fused: bool = True) -> int:
        """Reconstruct every captured scan in one batched dispatch
        (config-5 DP: the batch axis sharded over map_block when the
        session mesh has one — slr.dist.batch). Falls back to the
        per-scan path when a pixel-tile mesh or spatial repair is
        configured. Returns the number of scans reconstructed."""
        n = len(self.scan_paths())
        if n == 0:
            return 0
        mesh = self.mesh
        from slr.io import peek_stage

        scan0_ndim = len(peek_stage(self.scan_paths()[0])["frames"])
        if self.cam2 is not None or scan0_ndim == 4 or (
                mesh is not None and mesh.shape["pixel_tile"] > 1):
            for i in range(n):
                self.reconstruct(i, fused=fused)
            return n
        from slr.dist.batch import batched_reconstruct

        frames = jnp.stack([self.load_scan(i) for i in range(n)])
        blocks = mesh.shape["map_block"] if mesh is not None else 1
        pad = (-n) % blocks
        if pad:
            frames = jnp.concatenate([frames, frames[-1:].repeat(pad, 0)])
        clouds = batched_reconstruct(
            frames, self.cam, self.proj, self.config.pattern,
            self.config.decode, self.config.reconstruct,
            mesh=mesh, fused=fused and self.config.pattern.phase_steps > 0
            and self.config.pattern.use_inverse,
        )
        for i in range(n):
            save_stage(
                self.root / "clouds" / f"scan_{i:03d}.npz",
                points=np.asarray(clouds.points[i]),
                mask=np.asarray(clouds.mask[i]),
                colors=np.asarray(clouds.colors[i]),
                quality=np.asarray(clouds.quality[i]),
                x_p=np.asarray(clouds.x_p[i]),
            )
        return n

    def load_cloud(self, idx: int) -> ScanCloud:
        d = load_stage(self.root / "clouds" / f"scan_{idx:03d}.npz")
        return ScanCloud(
            points=jnp.asarray(d["points"]), mask=jnp.asarray(d["mask"]),
            colors=jnp.asarray(d["colors"]), quality=jnp.asarray(d["quality"]),
            x_p=jnp.asarray(d["x_p"]),
        )

    def cloud_count(self) -> int:
        return len(list((self.root / "clouds").glob("scan_*.npz")))

    # --- registration + fusion ---
    def register(self, use_features: bool = True,
                 refine_ba: bool = True,
                 loop_closures: bool = True) -> RegisteredScans:
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        mesh = self.mesh
        if mesh is not None and mesh.shape["map_block"] <= 1:
            mesh = None
        if len(clouds) >= 4 or mesh is not None:
            # batched pairwise alignment: one vmapped dispatch per round
            # (sharded over map_block when configured) instead of one
            # ICP dispatch + host sync per edge
            from slr.pipeline.registerfuse import register_scans_batched

            reg = register_scans_batched(
                clouds, self.config.registration,
                use_features=use_features, cam=self.cam,
                loop_closures=loop_closures, mesh=mesh)
        else:
            reg = register_scans(clouds, self.config.registration,
                                 use_features=use_features, cam=self.cam,
                                 loop_closures=loop_closures)
        if refine_ba and len(clouds) > 2:
            from slr.pipeline.registerfuse import ba_refine

            # config-5: the distributed Schur solver (landmarks over
            # map_block) is what the product path runs when the session
            # mesh has a map_block axis
            mesh = self.mesh
            if mesh is not None and mesh.shape["map_block"] <= 1:
                mesh = None
            reg = ba_refine(clouds, reg,
                            iters=self.config.registration.pg_iters,
                            mesh=mesh)
        save_stage(self.root / "registration.npz",
                   R=np.asarray(reg.R), t=np.asarray(reg.t),
                   icp_rms=np.asarray(reg.icp_rms),
                   pg_rms=np.asarray(reg.pg_rms))
        return reg

    def load_registration(self) -> RegisteredScans:
        d = load_stage(self.root / "registration.npz")
        return RegisteredScans(
            R=jnp.asarray(d["R"]), t=jnp.asarray(d["t"]),
            icp_rms=jnp.asarray(d["icp_rms"]), pg_rms=jnp.asarray(d["pg_rms"]),
        )

    def fuse_mesh(self, voxel: float = 2.0, size_vox=(128, 128, 128)) -> str:
        """TSDF-fuse all registered scans and export the extracted surface
        (marching tetrahedra) as OBJ — the volumetric upgrade over the
        point-level ``fuse`` (SURVEY.md component 17)."""
        from slr.pipeline.tsdf import fuse_tsdf, write_tsdf_mesh_obj

        assert self.cam is not None, "calibrate or set_calibration first"
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        reg = self.load_registration()
        vol = fuse_tsdf(clouds, self.cam, reg.R, reg.t,
                        size_vox=size_vox, voxel=voxel)
        out = self.root / "fused_mesh.obj"
        nv, nf = write_tsdf_mesh_obj(out, vol)
        from slr.observability import log_event
        log_event("fuse_mesh", n_verts=nv, n_faces=nf, voxel=voxel)
        return str(out)

    def fuse(self, capacity: int = 1 << 20) -> str:
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        reg = self.load_registration()
        pts, val, col, n_vox = fuse_scans(
            clouds, reg, self.config.registration, capacity=capacity
        )
        out = self.root / "fused.ply"
        gray = jnp.broadcast_to(col, (col.shape[0], 3))
        write_ply(out, pts, mask=val, colors=gray)
        return str(out)
