"""slr benchmark harness — prints ONE JSON line.

Flagship metric (BASELINE.json:2/5): full pattern-sequence -> point cloud
latency of ``reconstruct_dense`` on one GPU at config-3 shapes (20-frame
f32 stack, 1280x1024 camera, 1024x768 projector, 7-bit Gray + 4-step
phase). Accuracy is asserted against synthetic ground truth before
timing, so a fast-but-wrong kernel cannot win. The time is the median of
20 calls on device-resident frames, each ended by block_until_ready.

Run: python bench.py   (exits with a message when no GPU is found)
"""

import json
import sys

import jax
import jax.numpy as jnp

from slr.runtime import enable_compile_cache, gpu_identity, require_gpu

CAM_W, CAM_H = 1280, 1024


def main():
    require_gpu()
    enable_compile_cache()
    from slr.config import DecodeConfig, PatternConfig, ReconstructConfig
    from slr.observability import time_fn
    from slr.pipeline.reconstruct import reconstruct_dense
    from slr.synth import bumps_depth
    from slr.synth.render import default_rig, render_scan

    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H)
    cfg = PatternConfig(proj_width=1024, proj_height=768, gray_bits=7,
                        phase_steps=4)
    dec = DecodeConfig()
    rec = ReconstructConfig()
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=30.0)
    scan = render_scan(cam, proj, depth, cfg, noise_std=0.005,
                       key=jax.random.PRNGKey(0))
    frames = jax.block_until_ready(scan.frames)

    cloud = reconstruct_dense(frames, cam, proj, cfg, dec, rec)
    valid = cloud.mask & scan.mask_true
    n = jnp.sum(valid)
    err = jnp.where(
        valid, jnp.linalg.norm(cloud.points - scan.points_true, axis=-1), 0.0
    )
    rms = float(jnp.sqrt(jnp.sum(err * err) / n))
    card = gpu_identity()
    device = {"platform": jax.devices()[0].platform,
              "kind": jax.devices()[0].device_kind,
              "count": len(jax.devices()), "nvidia_smi": card}
    if rms > 1.0:
        print(json.dumps({"metric": "scan_decode_triangulate_ms",
                          "error": f"accuracy gate failed: {rms} mm",
                          "device": device}))
        sys.exit(1)

    ms = time_fn(reconstruct_dense, frames, cam, proj, cfg, dec, rec,
                 iters=20, warmup=3)
    print(json.dumps({
        "metric": "scan_decode_triangulate_ms",
        "value": ms,
        "unit": "ms",
        "points_per_scan": int(n),
        "rms_mm": rms,
        "device": device,
    }))


if __name__ == "__main__":
    main()
