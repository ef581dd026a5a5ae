"""Fused decode -> unwrap -> triangulate Pallas kernel (Triton route).

This is the production hot path (SURVEY.md E4, hot loops #1-#3 of the
reference collapsed into ONE kernel): each program reads its pixel tile
of the (F, H, W) captured frame stack once, one frame at a time, and
writes the 3D point map, validity mask and quality map directly — Gray
decode + per-bit certainty, N-step phase, cyclic half-shifted temporal
unwrap, camera-ray undistortion and triangulation all stay in registers.
The work is memory-bound (20-80 B/px in, 28 B/px out, ~200 flops/px),
so what the kernel saves over the plain route (slr.pipeline.reconstruct.
reconstruct_scan) is the intermediate maps that route writes and reads
back between stages.

Two triangulation modes (the "fused midpoint/DLT kernel" of [B:5]):
- column-only coding -> camera-ray x projector-column-plane intersection
  (projector distortion neglected, standard for column codes);
- row+column coding  -> midpoint of the common perpendicular between the
  undistorted camera and projector rays (full projector distortion).

Layout for the Triton lowering: a 2-D parallel grid of (BH, BW) pixel
tiles with nothing carried between programs; every load and store is one
power-of-two (BH, BW) tile (the frame axis is indexed one frame at a
time), and the parameter row is read as scalars. When H or W is not a
whole number of tiles, the edge programs mask their loads and stores
instead of the stack being padded. Off the GPU the same kernel runs in
Pallas interpret mode (slr.kernels.common.use_interpret).

Assumes the standard scan frame: camera at the world origin with R = I.
Parity with the pure-JAX path (slr.codec.decode_stack +
slr.geom.triangulate) is asserted in tests/test_kernels.py.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from slr.config import DecodeConfig, PatternConfig
from slr.geom.camera import Camera
from slr.kernels.common import use_interpret

TWO_PI = 2.0 * math.pi

# pixel tile per program (rows, cols), both powers of two, and warps per
# program: the fastest of a sweep at 1280x1024 on an H100 (PERF.md, PR 1)
BLOCK = (8, 128)
_NUM_WARPS = 8
_N_PARAMS = 64      # parameter row padded to a power of two


class FusedScanOut(NamedTuple):
    points: jnp.ndarray    # (3, H, W) world-frame points (0 where invalid)
    mask: jnp.ndarray      # (H, W) f32 0/1 validity
    quality: jnp.ndarray   # (H, W) phase modulation B
    x_p: jnp.ndarray       # (H, W) decoded sub-pixel projector column
    y_p: jnp.ndarray       # (H, W) decoded projector row (0 if not coded)


def _round(x):
    # round-half-up: the Triton lowering has no round primitive, and the
    # arguments here are near-integers (fringe orders), never near .5
    return jnp.floor(x + 0.5)


def _inside(shape, hw):
    """(BH, BW) mask of this program's pixels that lie inside the (H, W)
    image, or None when the grid tiles the image exactly."""
    if hw is None:
        return None
    bh, bw = shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    return ((rows + pl.program_id(0) * bh < hw[0])
            & (cols + pl.program_id(1) * bw < hw[1]))


def _load(ref, idx, inside):
    """One (BH, BW) tile of ``ref[idx]``; edge programs load only the
    pixels inside the image (the rest are never stored)."""
    if inside is None:
        return ref[idx]
    return pltriton.load(ref.at[idx], mask=inside)


def _store(ref, idx, val, inside):
    if inside is None:
        ref[idx] = val
    else:
        pltriton.store(ref.at[idx], val, mask=inside)


def _undistort(xd, yd, k1, k2, p1, p2, k3, iters):
    xn, yn = xd, yd
    for _ in range(iters):
        r2 = xn * xn + yn * yn
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy = xn * yn
        xdd = xn * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * xn * xn)
        ydd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xy
        xn = xn + (xd - xdd)
        yn = yn + (yd - ydd)
    return xn, yn


def _gray_decode_block(ld, first: int, bits: int, tau_white, certain):
    """MSB-first Gray bits at frames [first, first+bits) with inverses at
    [first+bits, first+2*bits); returns (binary code, updated certainty)."""
    g = None
    for i in range(bits):
        diff = ld(first + i) - ld(first + bits + i)
        bit = (diff > 0).astype(jnp.int32)
        g = bit if g is None else (g << 1) | bit
        certain = certain & (jnp.abs(diff) > tau_white)
    b = g
    shift = 1
    while shift < bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b, certain


def _phase_sums(ld, base: int, steps: int):
    """N-step sin/cos sums of frames [base, base+steps) in raw units."""
    S = C = None
    for k in range(steps):
        d = TWO_PI * k / steps
        fk = ld(base + k)
        S = fk * math.sin(d) if S is None else S + fk * math.sin(d)
        C = fk * math.cos(d) if C is None else C + fk * math.cos(d)
    return S, C


def _kernel(params_ref, f_ref, pts_ref, mask_ref, qual_ref, xp_ref,
            yp_ref, *, bits: int, row_bits: int, steps: int,
            row_steps: int, undistort_iters: int, scale: float,
            tau_black, tau_white, tau_mod, mf_pitches: tuple = (),
            hw=None):
    # Frame loaders. Integer (8-bit camera) stacks read 1 byte/px and
    # every comparison (Gray bits, contrast/certainty thresholds) stays
    # in the integer domain; only the N phase frames are converted to
    # f32, in RAW units (atan2 ratios are scale-invariant and the
    # modulation output is rescaled once at the end). The tau_*
    # thresholds arrive as compile-time constants already in raw units.
    inside = _inside(f_ref.shape[-2:], hw)
    if scale != 1.0:
        def raw(i):
            return _load(f_ref, i, inside).astype(jnp.int32)

        def rawf(i):
            return raw(i).astype(jnp.float32)
    else:
        def raw(i):
            return _load(f_ref, i, inside)

        rawf = raw
    p = params_ref

    white = raw(0)
    contrast = white - raw(1)           # raw units (int for int stacks)
    certain = contrast > tau_black

    if mf_pitches:
        # --- multifreq hierarchical phase unwrap (no Gray frames) ---
        mask = certain
        Phi = None
        modulation = None
        for li, p_l in enumerate(mf_pitches):
            S, C = _phase_sums(rawf, 2 + li * steps, steps)
            phi = jnp.arctan2(S, C)
            phi = jnp.where(phi < 0.0, phi + TWO_PI, phi)  # [0, 2pi)
            B = (2.0 / steps) * jnp.sqrt(S * S + C * C)    # raw units
            mask = mask & (B > tau_mod)
            if Phi is None:
                Phi = phi            # coarsest pitch spans W: absolute
                modulation = B
            else:
                prev_in_cur = Phi * (mf_pitches[li - 1] / p_l)
                k_ord = _round((prev_in_cur - phi) / TWO_PI)
                Phi = phi + TWO_PI * k_ord
                modulation = jnp.minimum(modulation, B)
        modulation = modulation * scale if scale != 1.0 else modulation
        x_p = Phi * (mf_pitches[-1] / TWO_PI)
        # atan2 rounding at x=0 can wrap to the top of the unambiguous
        # range (one coarse period); fold it back
        x_p = jnp.where(x_p > mf_pitches[0] - 0.5, x_p - mf_pitches[0], x_p)
        y_p = None
    else:
        # --- column Gray decode + N-step phase (the reference scheme) ---
        x_p, y_p, mask, modulation = _gray_phase_decode(
            raw, rawf, certain, contrast,
            bits=bits, row_bits=row_bits, steps=steps, row_steps=row_steps,
            tau_white=tau_white, tau_mod=tau_mod, scale=scale,
            pitch=p[33], row_pitch=p[34])

    _triangulate_write(p, x_p, y_p, mask, modulation,
                       pts_ref, mask_ref, qual_ref, xp_ref, yp_ref, inside,
                       row_bits=row_bits, undistort_iters=undistort_iters)


def _triangulate_write(p, x_p, y_p, mask, modulation,
                       pts_ref, mask_ref, qual_ref, xp_ref, yp_ref, inside,
                       *, row_bits: int, undistort_iters: int):
    """Camera-ray construction + plane/midpoint triangulation + output
    writes — the tail shared by the single-exposure and HDR kernels."""
    fx, fy, cx, cy = p[3], p[4], p[5], p[6]
    k1, k2, p1, p2, k3 = p[7], p[8], p[9], p[10], p[11]
    pfx, pfy, pcx, pcy = p[12], p[13], p[14], p[15]
    q1, q2, s1, s2, q3 = p[16], p[17], p[18], p[19], p[20]
    R00, R01, R02 = p[21], p[22], p[23]
    R10, R11, R12 = p[24], p[25], p[26]
    R20, R21, R22 = p[27], p[28], p[29]
    Cx, Cy, Cz = p[30], p[31], p[32]
    zmin, zmax = p[35], p[36]
    row_off = p[37]

    # --- camera ray (undistort); unnormalized d1 = (xn, yn, 1) so the
    # ray parameter equals camera depth z ---
    bh, bw = x_p.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    v_pix = (rows + pl.program_id(0) * bh).astype(jnp.float32) + row_off
    u_pix = (cols + pl.program_id(1) * bw).astype(jnp.float32)
    xn, yn = _undistort((u_pix - cx) / fx, (v_pix - cy) / fy,
                        k1, k2, p1, p2, k3, undistort_iters)

    if row_bits == 0:
        # column-plane: n_p = (1, 0, -xnp), n_w = R^T n_p
        xnp = (x_p - pcx) / pfx
        nwx = R00 - R20 * xnp
        nwy = R01 - R21 * xnp
        nwz = R02 - R22 * xnp
        den = nwx * xn + nwy * yn + nwz
        den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
        num = nwx * Cx + nwy * Cy + nwz * Cz
        lam = num / den
        Xx, Xy, Xz = xn * lam, yn * lam, lam
    else:
        # midpoint of common perpendicular between camera and projector
        # rays; projector ray fully undistorted
        xnp, ynp = _undistort((x_p - pcx) / pfx, (y_p - pcy) / pfy,
                              q1, q2, s1, s2, q3, undistort_iters)
        # d2 = R^T (xnp, ynp, 1) in world frame
        d2x = R00 * xnp + R10 * ynp + R20
        d2y = R01 * xnp + R11 * ynp + R21
        d2z = R02 * xnp + R12 * ynp + R22
        # o1 = 0, o2 = C_p, r = o1 - o2 = -C_p
        a = xn * xn + yn * yn + 1.0
        bb = xn * d2x + yn * d2y + d2z
        c = d2x * d2x + d2y * d2y + d2z * d2z
        dd = -(xn * Cx + yn * Cy + Cz)
        e = -(d2x * Cx + d2y * Cy + d2z * Cz)
        den = a * c - bb * bb
        den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
        s = (bb * e - c * dd) / den
        t = (a * e - bb * dd) / den
        Xx = 0.5 * (s * xn + Cx + t * d2x)
        Xy = 0.5 * (s * yn + Cy + t * d2y)
        Xz = 0.5 * (s + Cz + t * d2z)
        lam = Xz

    mask = mask & (lam > zmin) & (lam < zmax)
    fmask = mask.astype(jnp.float32)

    _store(pts_ref, 0, Xx * fmask, inside)
    _store(pts_ref, 1, Xy * fmask, inside)
    _store(pts_ref, 2, Xz * fmask, inside)
    _store(mask_ref, ..., fmask, inside)
    _store(qual_ref, ..., modulation.astype(jnp.float32), inside)
    _store(xp_ref, ..., x_p, inside)
    # decoded projector row, 0 if not coded
    _store(yp_ref, ..., jnp.zeros_like(x_p) if y_p is None else y_p, inside)


def _gray_phase_decode(raw, rawf, certain, contrast, *, bits, row_bits,
                       steps, row_steps, tau_white, tau_mod, scale,
                       pitch, row_pitch, SC=None, SC_row=None):
    """Gray(+inverse) decode + N-step phase + cyclic half-shifted unwrap —
    the reference coding scheme. ``raw``/``rawf`` load frames in raw
    (unnormalized) units — integer for integer stacks; only the phase
    frames go through ``rawf``. Returns (x_p, y_p, mask, modulation),
    modulation rescaled to normalized units.

    ``SC`` / ``SC_row`` optionally inject precomputed phase sin/cos sums
    (raw units) — the HDR kernel computes them per exposure for its
    selection score and reuses the chosen (or fused) sums here instead
    of a second pass over the frames."""
    b, certain = _gray_decode_block(raw, 2, bits, tau_white, certain)

    # --- optional row Gray decode (y_p computed after the mask exists) ---
    rb = None
    if row_bits:
        rb, certain = _gray_decode_block(
            raw, 2 + 2 * bits, row_bits, tau_white, certain
        )

    # --- N-step phase (or Gray-only half-stripe centres when steps==0) ---
    if steps:
        if SC is not None:
            S, C = SC
        else:
            S, C = _phase_sums(rawf, 2 + 2 * bits + 2 * row_bits, steps)
        phi = jnp.arctan2(S, C)
        phi = jnp.where(phi < 0.0, phi + TWO_PI, phi)
        modulation = (2.0 / steps) * jnp.sqrt(S * S + C * C)  # raw units
        mask = certain & (modulation > tau_mod)
        if scale != 1.0:
            modulation = modulation * scale

        # --- cyclic half-shifted temporal unwrap ---
        n = 1 << bits
        k_ord = b - (phi >= math.pi).astype(jnp.int32)
        k_ord = jnp.where(k_ord < 0, k_ord + n, k_ord)
        Phi = phi + TWO_PI * k_ord.astype(jnp.float32)
        x_p = Phi * (pitch / TWO_PI)
        w_coded = pitch * n
        x_p = jnp.where(x_p > w_coded - 0.5, x_p - w_coded, x_p)
    else:
        # config-1 Gray-only decode: stripe centre, aligned layout
        x_p = (b.astype(jnp.float32) + 0.5) * pitch
        modulation = contrast.astype(jnp.float32) * scale
        mask = certain

    # --- projector row: half-stripe centres, or sub-pixel via the row
    # N-step fringes (half-shifted cyclic unwrap, mirroring the columns)
    y_p = None
    if row_bits:
        if row_steps:
            if SC_row is not None:
                Sr, Cr = SC_row
            else:
                Sr, Cr = _phase_sums(
                    rawf, 2 + 2 * bits + 2 * row_bits + steps, row_steps)
            rphi = jnp.arctan2(Sr, Cr)
            rphi = jnp.where(rphi < 0.0, rphi + TWO_PI, rphi)
            rmod = (2.0 / row_steps) * jnp.sqrt(Sr * Sr + Cr * Cr)
            mask = mask & (rmod > tau_mod)
            n_r = 1 << row_bits
            k_r = rb - (rphi >= math.pi).astype(jnp.int32)
            k_r = jnp.where(k_r < 0, k_r + n_r, k_r)
            y_p = (rphi + TWO_PI * k_r.astype(jnp.float32)) * (
                row_pitch / TWO_PI)
            h_coded = row_pitch * n_r
            y_p = jnp.where(y_p > h_coded - 0.5, y_p - h_coded, y_p)
        else:
            y_p = (rb.astype(jnp.float32) + 0.5) * row_pitch

    return x_p, y_p, mask, modulation


def _pack_params(cam, proj, cfg, dec, z_bounds, row_offset):
    """Scalar parameter row shared by the single-exposure and HDR
    kernels, zero-padded to _N_PARAMS entries."""
    row_pitch = (
        cfg.proj_height / (1 << cfg.row_gray_bits) if cfg.row_gray_bits
        else 0.0
    )
    p = jnp.concatenate(
        [
            jnp.asarray(
                [dec.black_threshold, dec.white_threshold,
                 dec.modulation_threshold], jnp.float32
            ),
            jnp.stack([cam.fx, cam.fy, cam.cx, cam.cy]),
            cam.dist,
            jnp.stack([proj.fx, proj.fy, proj.cx, proj.cy]),
            proj.dist,
            proj.R.reshape(-1),
            proj.center,
            jnp.asarray([cfg.fringe_pitch, row_pitch], jnp.float32),
            jnp.asarray(z_bounds, jnp.float32),
            jnp.asarray(row_offset, jnp.float32).reshape(1),
        ]
    ).astype(jnp.float32)
    return jnp.pad(p, (0, _N_PARAMS - p.shape[0]))


def _raw_thresholds(dtype, bit_depth, dec):
    """(scale, in_bytes, tau_black, tau_white, tau_mod) in RAW units:
    Python ints for integer stacks, so every in-kernel comparison of
    frame values stays integer."""
    if jnp.issubdtype(dtype, jnp.integer):
        m = ((1 << bit_depth) - 1 if bit_depth is not None
             else jnp.iinfo(dtype).max)
        return (1.0 / float(m), jnp.dtype(dtype).itemsize,
                int(round(dec.black_threshold * m)),
                int(round(dec.white_threshold * m)),
                dec.modulation_threshold * m)
    return (1.0, 4, dec.black_threshold, dec.white_threshold,
            dec.modulation_threshold)


def _call(kern, params, frames, H, W, flops_per_px, in_bytes_per_px):
    """pallas_call over a BLOCK tile grid of the (..., H, W) input, Triton
    route. A grid that overhangs the image masks its edge tiles."""
    bh, bw = BLOCK
    exact = H % bh == 0 and W % bw == 0
    kern = partial(kern, hw=None if exact else (H, W))
    lead = frames.shape[:-2]
    nl = len(lead)
    tile = pl.BlockSpec((bh, bw), lambda i, j: (i, j))
    pts, mask, qual, xp, yp = pl.pallas_call(
        kern,
        grid=(pl.cdiv(H, bh), pl.cdiv(W, bw)),
        in_specs=[
            pl.BlockSpec((_N_PARAMS,), lambda i, j: (0,)),
            pl.BlockSpec((*lead, bh, bw),
                         lambda i, j: (*([0] * nl), i, j)),
        ],
        out_specs=(pl.BlockSpec((3, bh, bw), lambda i, j: (0, i, j)),
                   tile, tile, tile, tile),
        out_shape=(
            jax.ShapeDtypeStruct((3, H, W), jnp.float32),
            *[jax.ShapeDtypeStruct((H, W), jnp.float32)] * 4,
        ),
        cost_estimate=pl.CostEstimate(
            flops=flops_per_px * H * W,
            bytes_accessed=(in_bytes_per_px + 7 * 4) * H * W,
            transcendentals=3 * H * W,
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=use_interpret(),
        name="fused_decode_triangulate",
    )(params, frames)
    return FusedScanOut(points=pts, mask=mask, quality=qual, x_p=xp, y_p=yp)


@partial(jax.jit, static_argnames=("cfg", "dec", "z_bounds",
                                   "undistort_iters", "bit_depth"))
def fused_decode_triangulate(
    frames,                  # (F, H, W) captured stack
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig,
    z_bounds=(1.0, 1e4),
    undistort_iters: int = 8,
    bit_depth: int | None = None,
    row_offset=0.0,          # global row of frames[…,0,:] (pixel-tile shards)
) -> FusedScanOut:
    """One-pass scan reconstruction (requires inverse Gray patterns).
    phase_steps == 0 -> Gray-only half-stripe decode (config 1);
    row_gray_bits == 0 -> column-plane mode, > 0 -> fused midpoint mode;
    cfg.coding == "multifreq" -> hierarchical phase-only decode (no Gray
    frames), column-plane triangulation.

    ``frames`` may be float32 in [0,1] or uint8 (raw 8-bit camera data);
    the uint8 path reads 1 byte/px and normalizes in-register, cutting
    the kernel's input traffic 4x. ``bit_depth`` overrides the ADC range
    for sensors delivering fewer bits than their integer container
    (10/12-bit data in uint16), as in decode_stack."""
    multifreq = cfg.coding == "multifreq"
    assert multifreq or cfg.use_inverse
    F, H, W = frames.shape
    assert F == cfg.num_frames, (F, cfg.num_frames)
    scale, in_bytes, tau_black, tau_white, tau_mod = _raw_thresholds(
        frames.dtype, bit_depth, dec)
    params = _pack_params(cam, proj, cfg, dec, z_bounds, row_offset)
    kern = partial(
        _kernel,
        bits=cfg.gray_bits,
        row_bits=cfg.row_gray_bits,
        steps=cfg.phase_steps,
        row_steps=cfg.row_phase_steps,
        undistort_iters=undistort_iters,
        scale=scale,
        tau_black=tau_black,
        tau_white=tau_white,
        tau_mod=tau_mod,
        mf_pitches=cfg.mf_pitches if multifreq else (),
    )
    if multifreq:
        flops_per_px = (
            40 + (6 * cfg.phase_steps + 20) * cfg.mf_levels
            + 14 * undistort_iters
        )
    else:
        flops_per_px = (
            40 + 4 * (cfg.gray_bits + cfg.row_gray_bits)
            + 6 * (cfg.phase_steps + cfg.row_phase_steps)
            + 14 * undistort_iters * (2 if cfg.row_gray_bits else 1)
        )
    return _call(kern, params, frames, H, W, flops_per_px, F * in_bytes)


def _hdr_kernel(params_ref, f_ref, pts_ref, mask_ref, qual_ref, xp_ref,
                yp_ref, *, E: int, bits: int, row_bits: int, steps: int,
                row_steps: int, undistort_iters: int, scale: float,
                tau_black, tau_white, tau_mod, tau_sat, fuse: str = "sum",
                hw=None):
    """Exposure-bracketed fused decode: each program reads its tile of
    the (E, F) bracket once; per-exposure phase modulation is computed
    in registers, and the standard Gray+phase decode+triangulate runs a
    single time — instead of E dense pure-JAX decodes + a gather
    (slr.codec.exposure).

    ``fuse="select"`` mirrors decode_multi_exposure: the best valid
    unsaturated exposure (score = modulation where contrast above
    tau_black AND white below saturation, else -1) supplies both the
    Gray frames and the phase sums. ``fuse="sum"`` (default) still
    selects Gray bits that way (they are binary — one clean exposure is
    all they need) but FUSES the phase: the sin/cos sums of every usable
    exposure are added, each exposure's phase vector B_e * e^(i*phi)
    weighted in proportion to its own modulation — the inverse-variance
    weighting for equal additive sensor noise per capture, so dark
    pixels seen by several exposures get strictly more signal than any
    single pick."""
    inside = _inside(f_ref.shape[-2:], hw)
    if scale != 1.0:
        def raw_e(e, i):
            return _load(f_ref, (e, i), inside).astype(jnp.int32)

        def rawf_e(e, i):
            return raw_e(e, i).astype(jnp.float32)
    else:
        def raw_e(e, i):
            return _load(f_ref, (e, i), inside)

        rawf_e = raw_e
    p = params_ref

    base = 2 + 2 * bits + 2 * row_bits
    best = None
    best_score = None
    Ss, Cs, Srs, Crs = [], [], [], []
    usables, Bs = [], []
    for e in range(E):
        S, C = _phase_sums(partial(rawf_e, e), base, steps)
        B = (2.0 / steps) * jnp.sqrt(S * S + C * C)      # raw units
        white = raw_e(e, 0)
        usable = ((white - raw_e(e, 1)) > tau_black) & (white < tau_sat)
        usables.append(usable)
        Bs.append(B)
        score = jnp.where(usable, B, -1.0)
        if best is None:
            best = jnp.zeros(S.shape, jnp.int32)
            best_score = score
        else:
            upd = score > best_score
            best = jnp.where(upd, e, best)
            best_score = jnp.where(upd, score, best_score)
        Ss.append(S)
        Cs.append(C)
        if row_steps:
            Sr, Cr = _phase_sums(partial(rawf_e, e), base + steps, row_steps)
            Srs.append(Sr)
            Crs.append(Cr)

    def sel(vals):
        out = vals[0]
        for e in range(1, E):
            out = jnp.where(best == e, vals[e], out)
        return out

    # modulation-proportional weights over usable exposures, normalized
    # by sum(B) so the fused modulation stays in single-exposure units
    # (the tau_mod gate and the quality output keep their meaning).
    # w_e ∝ B_e is the inverse-variance optimum for equal additive
    # noise per capture: phase SNR becomes sqrt(sum B_e^2)/sigma, which
    # is >= the best single exposure's B_max/sigma — always.
    if fuse == "sum":
        wts = [jnp.where(usables[e], Bs[e], 0.0) for e in range(E)]
        wnorm = wts[0]
        for wv in wts[1:]:
            wnorm = wnorm + wv
        wnorm = jnp.maximum(wnorm, 1e-20)
        wts = [wv / wnorm for wv in wts]

    def usum(vals):
        out = wts[0] * vals[0]
        for e in range(1, E):
            out = out + wts[e] * vals[e]
        return out

    def raw_sel(i):
        return sel([raw_e(e, i) for e in range(E)])

    certain = best_score >= 0.0        # at least one usable exposure
    contrast = raw_sel(0) - raw_sel(1)
    combine = usum if fuse == "sum" else sel
    x_p, y_p, mask, modulation = _gray_phase_decode(
        raw_sel, None, certain, contrast,
        bits=bits, row_bits=row_bits, steps=steps, row_steps=row_steps,
        tau_white=tau_white, tau_mod=tau_mod, scale=scale,
        pitch=p[33], row_pitch=p[34],
        SC=(combine(Ss), combine(Cs)),
        SC_row=(combine(Srs), combine(Crs)) if row_steps else None)

    _triangulate_write(p, x_p, y_p, mask, modulation,
                       pts_ref, mask_ref, qual_ref, xp_ref, yp_ref, inside,
                       row_bits=row_bits, undistort_iters=undistort_iters)


@partial(jax.jit, static_argnames=("cfg", "dec", "saturation", "z_bounds",
                                   "undistort_iters", "bit_depth", "fuse"))
def fused_decode_triangulate_hdr(
    stacks,                  # (E, F, H, W) exposure-bracketed stacks
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig,
    saturation: float = 0.98,
    z_bounds=(1.0, 1e4),
    undistort_iters: int = 8,
    bit_depth: int | None = None,
    row_offset=0.0,
    fuse: str = "sum",
) -> FusedScanOut:
    """HDR variant of the one-pass scan reconstruction: a bracket of E
    captures is read once in ONE kernel rather than E full pure-JAX
    decode passes plus a selection gather. gray_phase coding only.

    ``fuse``: "sum" (default) variance-weights the phase sin/cos sums of
    ALL usable exposures (strictly more signal per pixel); "select"
    reproduces decode_multi_exposure's best-single-exposure pick (the
    parity oracle). Gray bits always come from the best exposure — they
    are thresholded binary decisions."""
    assert cfg.coding == "gray_phase" and cfg.use_inverse
    assert cfg.phase_steps > 0, "HDR selection needs phase modulation"
    E, F, H, W = stacks.shape
    assert F == cfg.num_frames, (F, cfg.num_frames)
    scale, in_bytes, tau_black, tau_white, tau_mod = _raw_thresholds(
        stacks.dtype, bit_depth, dec)
    tau_sat = (int(round(saturation * round(1.0 / scale)))
               if scale != 1.0 else saturation)
    params = _pack_params(cam, proj, cfg, dec, z_bounds, row_offset)
    kern = partial(
        _hdr_kernel,
        E=E,
        bits=cfg.gray_bits,
        row_bits=cfg.row_gray_bits,
        steps=cfg.phase_steps,
        row_steps=cfg.row_phase_steps,
        undistort_iters=undistort_iters,
        scale=scale,
        tau_black=tau_black,
        tau_white=tau_white,
        tau_mod=tau_mod,
        tau_sat=tau_sat,
        fuse=fuse,
    )
    flops_per_px = (40 + 6 * E * (cfg.phase_steps + cfg.row_phase_steps)
                    + 4 * (cfg.gray_bits + cfg.row_gray_bits)
                    + 14 * undistort_iters)
    return _call(kern, params, stacks, H, W, flops_per_px, E * F * in_bytes)
