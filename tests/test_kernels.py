"""Pallas kernel tests (interpret mode on CPU, SURVEY.md section 6).

The fused decode+triangulate kernels must match the pure-JAX reference
paths to f32 tolerance on rendered scans, and lower through the Triton
route at the flagship width (the GPU compile itself runs in
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slr.config import DecodeConfig, PatternConfig
from slr.codec import decode_stack, spatial_quality_unwrap
from slr.geom.triangulate import triangulate_plane
from slr.kernels import fused_decode_triangulate
from slr.synth import bumps_depth
from slr.synth.render import default_rig, render_scan

CAM_W, CAM_H = 320, 256


def _setup(noise=0.0):
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, cfg, noise_std=noise,
                       key=jax.random.PRNGKey(1))
    return cam, proj, cfg, scan


def test_fused_kernel_matches_reference_path():
    cam, proj, cfg, scan = _setup(noise=0.005)
    dec = DecodeConfig()
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)

    ref = decode_stack(scan.frames, cfg, dec)
    v, u = jnp.meshgrid(jnp.arange(CAM_H, dtype=jnp.float32),
                        jnp.arange(CAM_W, dtype=jnp.float32), indexing="ij")
    pts_ref, z_ref = triangulate_plane(cam, proj, u, v, ref.x_p)

    # masks agree except depth-bound gating (kernel adds z bounds)
    both = (out.mask > 0.5) & ref.mask
    frac_either = jnp.mean(((out.mask > 0.5) ^ ref.mask).astype(jnp.float32))
    assert float(frac_either) < 0.01

    xerr = jnp.where(both, jnp.abs(out.x_p - ref.x_p), 0.0)
    assert float(jnp.max(xerr)) < 1e-3, float(jnp.max(xerr))

    qerr = jnp.where(both, jnp.abs(out.quality - ref.quality), 0.0)
    assert float(jnp.max(qerr)) < 1e-4

    pts_k = jnp.moveaxis(out.points, 0, -1)
    perr = jnp.where(both[..., None], jnp.abs(pts_k - pts_ref), 0.0)
    assert float(jnp.max(perr)) < 5e-2, float(jnp.max(perr))


def test_fused_kernel_accuracy_vs_ground_truth():
    cam, proj, cfg, scan = _setup(noise=0.0)
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, DecodeConfig())
    valid = (out.mask > 0.5) & scan.mask_true
    pts = jnp.moveaxis(out.points, 0, -1)
    err = jnp.where(valid, jnp.linalg.norm(pts - scan.points_true, axis=-1), 0.0)
    n = jnp.sum(valid)
    rms = float(jnp.sqrt(jnp.sum(err * err) / n))
    assert rms < 0.5, rms


def test_fused_kernel_nonaligned_sizes():
    """H, W not multiples of the tile: the masked edge tiles must stay
    correct."""
    cam, proj = default_rig(cam_w=300, cam_h=215, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        phase_steps=4)
    depth = bumps_depth(215, 300, base=480.0, amp=20.0)
    scan = render_scan(cam, proj, depth, cfg)
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, DecodeConfig())
    assert out.points.shape == (3, 215, 300)
    valid = (out.mask > 0.5) & scan.mask_true
    assert float(jnp.mean(valid.astype(jnp.float32))) > 0.3
    pts = jnp.moveaxis(out.points, 0, -1)
    err = jnp.where(valid, jnp.linalg.norm(pts - scan.points_true, axis=-1), 0.0)
    n = jnp.sum(valid)
    assert float(jnp.sqrt(jnp.sum(err * err) / n)) < 0.5


def test_hdr_fused_kernel_nonaligned_select_parity():
    """The HDR kernel at a size that is not whole tiles (the edge
    programs mask their loads and stores): fuse="select" against the
    plain bracket decode, and the same points as the kernel on the
    padded-out bracket, cropped."""
    from slr.codec import decode_multi_exposure
    from slr.kernels.fused_scan import fused_decode_triangulate_hdr
    from slr.synth.render import quantize_frames

    H, W = 100, 150
    cam, proj = default_rig(cam_w=W, cam_h=H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=5,
                        phase_steps=4)
    scan = render_scan(cam, proj, bumps_depth(H, W, base=480.0, amp=20.0),
                       cfg, noise_std=0.003, key=jax.random.PRNGKey(4))
    bracket = quantize_frames(jnp.stack(
        [jnp.clip(scan.frames * g, 0.0, 1.0) for g in (0.5, 1.5)]))
    dec = DecodeConfig()
    out = fused_decode_triangulate_hdr(bracket, cam, proj, cfg, dec,
                                       fuse="select")
    assert out.points.shape == (3, H, W) and out.mask.shape == (H, W)
    ref = decode_multi_exposure(bracket, cfg, dec)
    m_k, m_r = np.asarray(out.mask) > 0.5, np.asarray(ref.mask)
    assert (m_k ^ m_r).mean() < 0.02
    xerr = np.abs(np.asarray(out.x_p) - np.asarray(ref.x_p))[m_k & m_r]
    assert np.percentile(xerr, 99) < 0.1
    # padding the image out to whole tiles changes nothing inside it
    padded = jnp.pad(bracket, [(0, 0), (0, 0), (0, 4), (0, 106)])
    full = fused_decode_triangulate_hdr(padded, cam, proj, cfg, dec,
                                        fuse="select")
    np.testing.assert_array_equal(np.asarray(full.mask)[:H, :W],
                                  np.asarray(out.mask))
    np.testing.assert_allclose(np.asarray(full.points)[:, :H, :W],
                               np.asarray(out.points), atol=1e-4)


def test_decode_bit_depth_uint16_container():
    """12-bit sensor data in a uint16 container: normalizing by the
    container max would scale values 16x too small and break thresholds;
    bit_depth=12 must recover the f32-path decode."""
    cam, proj, cfg, scan = _setup(noise=0.0)
    dec = DecodeConfig()
    m = (1 << 12) - 1
    f12 = jnp.clip(jnp.round(scan.frames * m), 0, m).astype(jnp.uint16)
    ref = decode_stack(scan.frames, cfg, dec)
    # without bit_depth the decode collapses (almost everything masked)
    bad = decode_stack(f12, cfg, dec)
    assert float(jnp.mean(bad.mask)) < 0.01
    good = decode_stack(f12, cfg, dec, bit_depth=12)
    agree = (good.mask == ref.mask)
    assert float(jnp.mean(agree.astype(jnp.float32))) > 0.999
    both = good.mask & ref.mask
    xd = jnp.where(both, jnp.abs(good.x_p - ref.x_p), 0.0)
    frac_big = jnp.sum((xd > 1e-2).astype(jnp.float32)) / jnp.sum(both)
    assert float(frac_big) < 1e-3
    # fused kernel takes the same parameter
    outk = fused_decode_triangulate(f12, cam, proj, cfg, dec, bit_depth=12)
    md = jnp.mean(((outk.mask > 0.5) ^ ref.mask).astype(jnp.float32))
    assert float(md) < 0.01


def test_fused_kernel_uint8_frames():
    """Raw 8-bit camera frames: the kernel's in-register normalization
    must match the f32 path on the quantized stack exactly, and stay
    sub-mm vs ground truth (8-bit ADC quantization is ~0.001 intensity
    noise, well under the 0.005 sensor noise already modeled)."""
    from slr.synth.render import quantize_frames

    cam, proj, cfg, scan = _setup(noise=0.005)
    dec = DecodeConfig()
    f8 = quantize_frames(scan.frames)
    assert f8.dtype == jnp.uint8
    out8 = fused_decode_triangulate(f8, cam, proj, cfg, dec)
    # f32 path fed the same dequantized values -> bit-identical decode
    outf = fused_decode_triangulate(
        f8.astype(jnp.float32) / 255.0, cam, proj, cfg, dec
    )
    # *(1/255) in-kernel vs /255.0 outside differ by <= 1 ulp; that can
    # flip a Gray bit / fringe order on pixels sitting exactly on a code
    # edge, so compare on mutually valid pixels and allow rare flips
    md = jnp.mean(((out8.mask > 0.5) ^ (outf.mask > 0.5)).astype(jnp.float32))
    assert float(md) < 1e-3
    both8 = (out8.mask > 0.5) & (outf.mask > 0.5)
    xd = jnp.where(both8, jnp.abs(out8.x_p - outf.x_p), 0.0)
    frac_big = jnp.sum((xd > 1e-3).astype(jnp.float32)) / jnp.sum(both8)
    assert float(frac_big) < 1e-3, float(frac_big)
    # accuracy vs ground truth unchanged by quantization
    valid = (out8.mask > 0.5) & scan.mask_true
    pts = jnp.moveaxis(out8.points, 0, -1)
    err = jnp.where(valid, jnp.linalg.norm(pts - scan.points_true, axis=-1), 0.0)
    rms = float(jnp.sqrt(jnp.sum(err * err) / jnp.sum(valid)))
    assert rms < 0.5, rms
    # pure-JAX decode path accepts integer stacks too
    ref = decode_stack(f8, cfg, dec)
    both = (out8.mask > 0.5) & ref.mask
    xerr = jnp.where(both, jnp.abs(out8.x_p - ref.x_p), 0.0)
    assert float(jnp.max(xerr)) < 1e-3


def _numpy_strict_vote_unwrap(Phi, mask, iters):
    """Independent per-pixel loop of the strict-consensus repair: a pixel
    moves by k periods when >= 3 valid 4-neighbours vote the same
    non-zero k = round((Phi_nb - Phi) / 2pi); the first neighbour (in
    down, up, right, left order) reaching the highest count wins."""
    Phi = np.asarray(Phi, np.float64).copy()
    H, W = Phi.shape
    for _ in range(iters):
        new = Phi.copy()
        for y in range(H):
            for x in range(W):
                if not mask[y, x]:
                    continue
                votes = []
                for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < H and 0 <= xx < W and mask[yy, xx]:
                        votes.append(np.round((Phi[yy, xx] - Phi[y, x])
                                              / (2 * np.pi)))
                best_k, best_n = 0.0, 0
                for k in votes:
                    n = sum(v == k for v in votes)
                    if k != 0 and n > best_n:
                        best_k, best_n = k, n
                if best_n >= 3:
                    new[y, x] = Phi[y, x] + 2 * np.pi * best_k
        Phi = new
    return Phi


def test_spatial_quality_unwrap_matches_numpy_loop():
    """The plain spatial repair (the route reconstruct_dense takes when
    spatial_iters > 0) against an independent per-pixel loop."""
    rng = np.random.default_rng(0)
    H, W = 24, 40
    Phi = np.linspace(0, 30, W)[None, :] + 0.1 * rng.normal(size=(H, W))
    bad = np.zeros((H, W), bool)
    bad[rng.integers(0, H, 25), rng.integers(0, W, 25)] = True
    Phi_n = np.where(bad, Phi + 2 * np.pi * 3, Phi).astype(np.float32)
    mask = rng.random((H, W)) > 0.05
    q = np.where(bad, 0.05, 1.0).astype(np.float32)
    out = spatial_quality_unwrap(jnp.asarray(Phi_n), jnp.asarray(q),
                                 jnp.asarray(mask), iters=3)
    ref = _numpy_strict_vote_unwrap(Phi_n, mask, iters=3)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4)
    # the repair actually fixed most planted order errors
    fixed = np.abs(np.asarray(out) - Phi) < 0.5
    assert fixed[bad & mask].mean() > 0.7


def test_fused_kernel_midpoint_rowcol():
    """Row+column coding -> fused midpoint kernel vs jnp reference and
    ground truth (the 'fused midpoint/DLT kernel' of [B:5])."""
    from slr.geom.triangulate import triangulate_rays

    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0,
                            proj_dist=[-0.08, 0.02, 0.001, -0.001, 0.0])
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        row_gray_bits=6, phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, cfg)
    dec = DecodeConfig()
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)

    ref = decode_stack(scan.frames, cfg, dec)
    v, u = jnp.meshgrid(jnp.arange(CAM_H, dtype=jnp.float32),
                        jnp.arange(CAM_W, dtype=jnp.float32), indexing="ij")
    pts_ref, gap = triangulate_rays(cam, proj, u, v, ref.x_p, ref.y_p)

    both = (out.mask > 0.5) & ref.mask
    assert float(jnp.mean(both.astype(jnp.float32))) > 0.3
    pts_k = jnp.moveaxis(out.points, 0, -1)
    perr = jnp.where(both[..., None], jnp.abs(pts_k - pts_ref), 0.0)
    assert float(jnp.max(perr)) < 5e-2, float(jnp.max(perr))

    # accuracy vs ground truth: row code quantizes y_p to half a row
    # stripe, so the midpoint solve has a few-mm vertical uncertainty --
    # but x is phase-coded, keeping lateral/depth error small
    valid = both & scan.mask_true
    err = jnp.where(valid, jnp.linalg.norm(pts_k - scan.points_true, axis=-1), 0.0)
    n = jnp.sum(valid)
    rms = float(jnp.sqrt(jnp.sum(err * err) / n))
    assert rms < 5.0, rms


def test_fused_kernel_gray_only():
    """Config-1: Gray-only fused path, half-stripe accuracy."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=8,
                        phase_steps=0)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, cfg)
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, DecodeConfig())
    ref = decode_stack(scan.frames, cfg, DecodeConfig())
    both = (out.mask > 0.5) & ref.mask
    xerr = jnp.where(both, jnp.abs(out.x_p - ref.x_p), 0.0)
    assert float(jnp.max(xerr)) < 1e-3
    valid = both & scan.mask_true
    xerr_gt = jnp.where(valid, jnp.abs(out.x_p - scan.xp_true), 0.0)
    pitch = cfg.proj_width / (1 << cfg.gray_bits)
    assert float(jnp.max(xerr_gt)) < pitch


def test_fused_kernel_midpoint_row_phase():
    """Row N-step fringes (row_phase_steps > 0) give sub-pixel projector
    rows, so the fused midpoint mode reaches the same sub-mm accuracy as
    the column-plane mode — vs ~5 mm with half-stripe quantized rows."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0,
                            proj_dist=[-0.08, 0.02, 0.001, -0.001, 0.0])
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        row_gray_bits=6, phase_steps=4, row_phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, cfg)
    dec = DecodeConfig()
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)

    # parity vs the pure-JAX decode path
    ref = decode_stack(scan.frames, cfg, dec)
    both = (np.asarray(out.mask) > 0.5) & np.asarray(ref.mask)
    assert ((np.asarray(out.mask) > 0.5) ^ np.asarray(ref.mask)).mean() < 0.01
    xerr = np.abs(np.asarray(out.x_p - ref.x_p))[both]
    assert xerr.max() < 1e-3

    # sub-mm vs ground truth (row phase removes the row quantization)
    valid = both & np.asarray(scan.mask_true)
    pts = np.moveaxis(np.asarray(out.points), 0, -1)
    err = np.linalg.norm(pts - np.asarray(scan.points_true), axis=-1)[valid]
    rms = float(np.sqrt((err ** 2).mean()))
    assert rms < 0.1, rms


def test_row_phase_decode_subpixel():
    """decode_stack with row_phase_steps recovers yp_true sub-pixel under
    sensor noise (the projector-calibration decode path needs this)."""
    cam, proj, _, _ = _setup()
    # 5 row bits -> 6 px row pitch: the N-step phase supplies sub-pixel
    # precision, so a coarser row code just buys noise margin at the
    # antialiased code edges (3 px stripes leave |pat - inv| within
    # tau_white of the noise floor on too many pixels)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        row_gray_bits=5, phase_steps=4, row_phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, cfg, noise_std=0.01,
                       key=jax.random.PRNGKey(3))
    res = decode_stack(scan.frames, cfg, DecodeConfig())
    valid = np.asarray(res.mask) & np.asarray(scan.mask_true)
    assert valid.mean() > 0.4
    ey = np.abs(np.asarray(res.y_p - scan.yp_true))[valid]
    # noise at the phi ~ pi decision boundary flips a rare fringe order
    # (the repair pass exists for those); everything else is sub-pixel
    order_errs = (ey > 1.0).mean()
    assert order_errs < 2e-3, order_errs
    inliers = ey[ey <= 1.0]
    assert float(np.sqrt((inliers ** 2).mean())) < 0.05


def test_fused_kernel_multifreq():
    """Multifreq (phase-only hierarchical) fused kernel: parity vs
    decode_stack and sub-mm RMS vs ground truth."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = PatternConfig(proj_width=256, proj_height=192, coding="multifreq",
                        phase_steps=4, mf_levels=3, mf_ratio=6.0)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, cfg, noise_std=0.005,
                       key=jax.random.PRNGKey(2))
    dec = DecodeConfig()
    out = fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)

    ref = decode_stack(scan.frames, cfg, dec)
    both = (np.asarray(out.mask) > 0.5) & np.asarray(ref.mask)
    assert ((np.asarray(out.mask) > 0.5) ^ np.asarray(ref.mask)).mean() < 0.01
    xerr = np.abs(np.asarray(out.x_p - ref.x_p))[both]
    assert xerr.max() < 1e-3, xerr.max()
    qerr = np.abs(np.asarray(out.quality - ref.quality))[both]
    assert qerr.max() < 1e-4

    valid = both & np.asarray(scan.mask_true)
    assert valid.mean() > 0.3
    pts = np.moveaxis(np.asarray(out.points), 0, -1)
    err = np.linalg.norm(pts - np.asarray(scan.points_true), axis=-1)[valid]
    rms = float(np.sqrt((err ** 2).mean()))
    assert rms < 0.5, rms


def test_crossing_interp_matches_brute_force():
    """The monotone-crossing primitive (two-camera merge core) must
    reproduce a brute-force per-row crossing search exactly, including
    masked gaps and occlusion jumps."""
    from slr.pipeline.crossing import crossing_interp

    rng = np.random.default_rng(0)
    R, U, K = 16, 256, 128
    base = np.cumsum(rng.uniform(0.4, 1.2, (R, U)), axis=1) * 0.55
    base += rng.normal(0, 0.01, (R, U))
    code = base.astype(np.float32)
    valid = np.ones((R, U), bool)
    valid[:, 60:80] = False                 # shadow gap
    code[:, 160:] += 30.0                   # 30-bin occlusion jump
    chan_u = np.broadcast_to(
        np.arange(U, dtype=np.float32), (R, U)).copy()
    chan_q = rng.uniform(0.5, 1.0, (R, U)).astype(np.float32)
    channels = jnp.stack([jnp.asarray(chan_u), jnp.asarray(chan_q)])

    cnt, vals = crossing_interp(jnp.asarray(code), jnp.asarray(valid),
                                channels, K, interp=(True, False))
    cnt, vals = np.asarray(cnt), np.asarray(vals)
    n_checked = 0
    for r in range(0, R, 3):
        for k in range(K):
            xs = []
            for u in range(U - 1):
                if not (valid[r, u] and valid[r, u + 1]):
                    continue
                d = code[r, u + 1] - code[r, u]
                if not (0.125 < d < 4.0):
                    continue
                if code[r, u] <= k < code[r, u + 1]:
                    xs.append(u + (k - code[r, u]) / d)
            assert len(xs) == round(cnt[r, k]), (r, k, len(xs), cnt[r, k])
            if xs:
                assert abs(np.mean(xs) - vals[0, r, k]) < 1e-3
                n_checked += 1
    assert n_checked > 200


@pytest.mark.slow
def test_hdr_fused_kernel_parity():
    """fused_decode_triangulate_hdr vs the pure-JAX bracket fusion
    (decode_multi_exposure): same selection idea — best valid unsaturated
    modulation — computed in ONE kernel pass. Selection scores differ
    only in which validity gates they apply (the kernel gates on
    contrast+saturation, the pure path on the full decode mask), so we
    assert near-total mask agreement and code equality where both
    decode (VERDICT r3 next #5)."""
    from slr.codec import decode_multi_exposure
    from slr.kernels.fused_scan import fused_decode_triangulate_hdr
    from slr.synth.render import quantize_frames

    from slr.synth import checker_albedo

    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256,
                            proj_h=192)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=5,
                        phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    # the textbook HDR scene: albedo spans 25x, so dark cells need the
    # long exposure (which clips the bright cells) and vice versa
    albedo = checker_albedo(CAM_H, CAM_W, cells=6, lo=0.035, hi=0.75)
    scan = render_scan(cam, proj, depth, cfg, noise_std=0.003,
                       key=jax.random.PRNGKey(5), albedo=albedo)
    bracket = jnp.stack([
        jnp.clip(scan.frames * g, 0.0, 1.0) for g in (1.0, 10.0)
    ])
    bracket_u8 = quantize_frames(bracket)

    dec = DecodeConfig()
    ref = decode_multi_exposure(bracket_u8, cfg, dec)
    out = fused_decode_triangulate_hdr(bracket_u8, cam, proj, cfg, dec,
                                       fuse="select")

    m_k = np.asarray(out.mask) > 0.5
    m_r = np.asarray(ref.mask)
    assert (m_k ^ m_r).mean() < 0.02, (m_k.sum(), m_r.sum())
    both = m_k & m_r
    xerr = np.abs(np.asarray(out.x_p) - np.asarray(ref.x_p))[both]
    # where the two paths picked different exposures the codes still
    # agree to a fraction of a projector px; identical picks are exact
    assert np.percentile(xerr, 99) < 0.1, np.percentile(xerr, 99)

    # the bracket must widen coverage over the BEST single exposure
    best_single = 0
    for g in (1.0, 10.0):
        single = fused_decode_triangulate(
            quantize_frames(jnp.clip(scan.frames * g, 0, 1)), cam, proj,
            cfg, dec)
        best_single = max(best_single,
                          (np.asarray(single.mask) > 0.5).sum())
    assert m_k.sum() > 1.3 * best_single, (m_k.sum(), best_single)


@pytest.mark.slow
def test_hdr_phase_fusion_beats_selection():
    """fuse="sum" (variance-weighted phase fusion over all usable
    exposures, VERDICT r4 next #5) must beat best-single-exposure
    selection where exposures OVERLAP, and never hurt elsewhere.

    Two capture-physics details matter and are modeled explicitly:
    each exposure is an INDEPENDENT capture (independent sensor noise —
    scaling one noisy stack by gains makes the noise perfectly
    correlated and fusion provably a no-op), and the gain ladder must be
    dense enough that pixels pass the contrast gate (black_threshold)
    in more than one exposure — with a sparse ladder every pixel has
    exactly one usable capture and sum degenerates to select (verified:
    that configuration produces bitwise-equal outputs)."""
    from slr.kernels.fused_scan import fused_decode_triangulate_hdr
    from slr.synth.render import quantize_frames
    from slr.synth import checker_albedo

    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256,
                            proj_h=192)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=5,
                        phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    # dark cells: usable in all 3 exposures (contrast 0.08*g*255 > 25.5
    # for g >= 2); bright cells: only g=2 (g >= 3 saturates)
    albedo = checker_albedo(CAM_H, CAM_W, cells=6, lo=0.08, hi=0.45)
    scan = render_scan(cam, proj, depth, cfg, noise_std=0.0,
                       albedo=albedo)
    noise = 0.004
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    bracket_u8 = quantize_frames(jnp.stack([
        jnp.clip(scan.frames * g
                 + noise * jax.random.normal(k, scan.frames.shape),
                 0.0, 1.0)
        for g, k in zip((2.0, 3.0, 4.5), keys)
    ]))
    dec = DecodeConfig()
    dark = np.asarray(albedo) < 0.2

    def rms_of(fuse):
        out = fused_decode_triangulate_hdr(bracket_u8, cam, proj, cfg,
                                           dec, fuse=fuse)
        m = (np.asarray(out.mask) > 0.5) & np.asarray(scan.mask_true)
        pts = np.moveaxis(np.asarray(out.points), 0, -1)
        err = np.linalg.norm(pts - np.asarray(scan.points_true), axis=-1)
        md = m & dark
        return (float(np.sqrt(np.mean(err[md] ** 2))),
                float(np.sqrt(np.mean(err[m] ** 2))), int(m.sum()))

    dark_sum, rms_sum, n_sum = rms_of("sum")
    dark_sel, rms_sel, n_sel = rms_of("select")
    # dark cells pool 3 captures' photons: expected noise ratio
    # sqrt(2^2+3^2+4.5^2)/4.5 = 0.78; assert a solid chunk of it
    assert dark_sum < 0.92 * dark_sel, (dark_sum, dark_sel)
    # overall never worse, coverage unchanged
    assert rms_sum <= rms_sel * 1.02, (rms_sum, rms_sel)
    assert n_sum >= 0.98 * n_sel, (n_sum, n_sel)


@pytest.mark.parametrize("backend,expected", [
    ("cpu", True), ("gpu", False), ("rocm", None)])
def test_use_interpret_by_backend(monkeypatch, backend, expected):
    """Interpret on the CPU, compiled on the GPU, and no silent
    interpretation anywhere else."""
    from slr.kernels import common

    monkeypatch.setattr(common.jax, "default_backend", lambda: backend)
    if expected is None:
        with pytest.raises(RuntimeError, match="no Pallas route"):
            common.use_interpret()
    else:
        assert common.use_interpret() is expected


_LOWER_CASES = {
    "flagship": dict(gray_bits=7, phase_steps=4),
    "midpoint": dict(gray_bits=7, row_gray_bits=6, phase_steps=4,
                     row_phase_steps=4),
    "gray_only": dict(gray_bits=8, phase_steps=0),
    "multifreq": dict(coding="multifreq", phase_steps=4, mf_levels=3,
                      mf_ratio=6.0),
}


def _lower_for_cuda(monkeypatch, case, dtype, H, W):
    """StableHLO text of one kernel configuration lowered for the GPU
    (Triton route) at camera size (H, W)."""
    from slr.kernels import fused_scan

    monkeypatch.setattr(fused_scan, "use_interpret", lambda: False)
    cam, proj = default_rig(cam_w=W, cam_h=H)
    kw = _LOWER_CASES.get(case, _LOWER_CASES["flagship"])
    cfg = PatternConfig(proj_width=1024, proj_height=768, **kw)
    dec = DecodeConfig()
    if case == "hdr":
        x = jax.ShapeDtypeStruct((3, cfg.num_frames, H, W), dtype)
        fn = fused_scan.fused_decode_triangulate_hdr
    else:
        x = jax.ShapeDtypeStruct((cfg.num_frames, H, W), dtype)
        fn = fused_scan.fused_decode_triangulate
    fn.clear_cache()
    try:
        return jax.jit(lambda f: fn(f, cam, proj, cfg, dec)).trace(
            x).lower(lowering_platforms=("cuda",)).as_text()
    finally:
        fn.clear_cache()


@pytest.mark.parametrize("case,dtype", [
    ("flagship", "float32"), ("flagship", "uint8"), ("midpoint", "uint8"),
    ("gray_only", "float32"), ("multifreq", "float32"), ("hdr", "uint8")])
def test_fused_kernel_lowers_for_triton(monkeypatch, case, dtype):
    """At the flagship width (1280x1024) every kernel configuration
    lowers through the Triton route (power-of-two tiles, supported
    primitives). Lowering only: PTX compilation needs the GPU."""
    text = _lower_for_cuda(monkeypatch, case, dtype, 1024, 1280)
    assert "xla.gpu.triton" in text          # the Triton custom call


@pytest.mark.parametrize("case,hw", [
    ("flagship", (2048, 2448)), ("hdr", (1080, 1440)),
    ("midpoint", (1021, 1283))])
def test_fused_kernel_edge_tiles_lower_without_padding(monkeypatch, case,
                                                       hw):
    """Camera sizes that are not whole tiles (2448x2048, 1440x1080, odd
    sizes) lower to the masked-edge Triton kernel: the frame stack goes
    to the kernel as it is, with no pad (a copy of every frame) or crop
    around it."""
    import re

    text = _lower_for_cuda(monkeypatch, case, "uint8", *hw)
    assert "xla.gpu.triton" in text
    # the only pad is the 1-D parameter row's; no image-sized pad or slice
    assert not re.search(r"stablehlo\.(pad|slice)[^\n]*\(tensor<\d+x\d+x",
                         text)
