"""Monotone-crossing interpolation: the primitive behind the two-camera
"merge" correspondence (slr.pipeline.twocam.invert_to_projector).

Problem: along each row of a decoded map, the projector code x_p(u) is a
(noisy) monotone sequence; we need the *inverse* sampled on the integer
projector grid — for every integer code k, the sub-pixel position u*(k)
where the code crosses k, plus any other per-pixel quantity linearly
interpolated at that crossing. The reference-class solution walks each
epipolar line sequentially.

Formulation: a crossing of bin k at pair (u, u+1) is the indicator
onehot[k, u] = (code_lo[u] <= k) & (code_hi[u] > k), and every
"find + interpolate" becomes ONE contraction per row:

    out[n, k] = sum_u payload[n, u] * onehot[k, u]

with payload channels carrying the interpolation coefficients. Linear
interpolation at the crossing is EXACT through the contraction because
the crossing value of any channel q is affine in k:

    q*(k) = q[u] + (k - code_lo[u]) * g,  g = (q[u+1] - q[u]) / d
          = (q[u] - code_lo[u] * g) + k * g  =  a + k * b

so two payload channels (a, b) per interpolated channel reconstruct
q*(k) = (A[k] + k * B[k]) / cnt[k] after the contraction.

This is plain XLA: the one-hot is materialized ``chunk`` bins at a time
and contracted by an f32 einsum at HIGHEST precision (a TF32 product
would round the payload to ~3 decimal digits — whole camera pixels at
u ~ 1000).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def build_payload(pair_valid, code_lo, channels_lo, channels_hi, d,
                  interp: tuple):
    """Pack the crossing payload: channel 0 = pair validity (the count),
    then per input channel either (a, b) (linear interpolation) or one
    nearest-value term.

    Returns (payload (R, N, U) f32, unpack) where
    unpack(out (R, N, K), kgrid) -> (cnt, [vals...]).
    """
    terms = [pair_valid.astype(jnp.float32)]
    layout = []
    d_safe = jnp.where(pair_valid, d, 1.0)
    for c in range(channels_lo.shape[0]):
        i0 = len(terms)
        if interp[c]:
            g = (channels_hi[c] - channels_lo[c]) / d_safe
            a = channels_lo[c] - code_lo * g
            terms += [jnp.where(pair_valid, a, 0.0),
                      jnp.where(pair_valid, g, 0.0)]
            layout.append(("interp", i0))
        else:
            terms.append(jnp.where(pair_valid, channels_lo[c], 0.0))
            layout.append(("nearest", i0))
    payload = jnp.stack(terms, axis=1)                  # (R, N, U)

    def unpack(out, kgrid):
        cnt = out[:, 0, :]
        safe = jnp.maximum(cnt, 1e-9)
        vals = []
        for kind, i0 in layout:
            if kind == "interp":
                vals.append((out[:, i0, :] + kgrid * out[:, i0 + 1, :])
                            / safe)
            else:
                vals.append(out[:, i0, :] / safe)
        return cnt, vals

    return payload, unpack


def crossing_bin_sum(code_lo, code_hi, payload, num_bins: int,
                     chunk: int = 128):
    """out[r, n, k] = sum_u [code_lo[r,u] <= k < code_hi[r,u]] payload[r,n,u]
    for integer bins k in [0, num_bins). Invalid pairs must arrive with
    code_lo == code_hi (never fire). The one-hot is built ``chunk`` bins
    at a time (peak transient R * chunk * U * 4 bytes)."""
    R, U = code_lo.shape
    Kp = -(-num_bins // chunk) * chunk

    def one_chunk(k0):
        k = k0 + jnp.arange(chunk, dtype=jnp.float32)
        oh = ((code_lo[:, None, :] <= k[None, :, None])
              & (code_hi[:, None, :] > k[None, :, None]))
        return jnp.einsum("rku,rnu->rnk", oh.astype(jnp.float32), payload,
                          precision=jax.lax.Precision.HIGHEST)

    outs = jax.lax.map(one_chunk,
                       jnp.arange(0, Kp, chunk, dtype=jnp.float32))
    out = jnp.moveaxis(outs, 0, 2).reshape(R, payload.shape[1], Kp)
    return out[:, :, :num_bins]


@partial(jax.jit, static_argnames=("num_bins", "interp"))
def crossing_interp(code, valid, channels, num_bins: int,
                    interp: tuple, dmin: float = 0.125, dmax: float = 4.0,
                    pair_gate=None):
    """Invert a per-row monotone code sequence onto the integer bin grid.

    code (R, U) f32; valid (R, U) bool; channels (C, R, U) f32 values to
    carry to the crossings; interp: per-channel, linear interpolation at
    the crossing vs left-endpoint value. A pair (u, u+1) contributes only
    when both pixels are valid and the code step d is in (dmin, dmax):
    the lower gate keeps 1/d bounded (interpolation precision), the upper
    gate drops silhouette/occlusion jumps whose "crossings" interpolate
    across two different surfaces.

    ``pair_gate`` (R, U-1) bool optionally vetoes pairs beyond the code
    gates — e.g. continuity of a CARRIED channel. A pair can step
    smoothly in the binned code yet jump in a carried quantity (a
    shallow silhouette whose depth jump maps to < dmax code bins but
    many pixels of disparity); interpolating across it would bridge two
    surfaces with phantom points no downstream gate can see.

    Returns (cnt (R, K), vals (C, R, K)): crossings found per bin and
    the channel values linearly interpolated there (averaged if a noisy
    wiggle yields several crossings; 0 where cnt == 0).
    """
    code = code.astype(jnp.float32)
    cl = code[:, :-1]
    ch = code[:, 1:]
    d = ch - cl
    pv = (valid[:, :-1] & valid[:, 1:] & (d > dmin) & (d < dmax))
    if pair_gate is not None:
        pv = pv & pair_gate
    payload, unpack = build_payload(
        pv, cl, channels[:, :, :-1], channels[:, :, 1:], d, interp)
    out = crossing_bin_sum(jnp.where(pv, cl, -1.0), jnp.where(pv, ch, -1.0),
                           payload, num_bins)
    kgrid = jnp.arange(num_bins, dtype=jnp.float32)[None, :]
    cnt, vals = unpack(out, kgrid)
    return cnt, jnp.stack(vals)
