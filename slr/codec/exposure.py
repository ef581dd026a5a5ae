"""Multi-exposure (HDR) decode fusion (reference-class capture practice:
structured-light scanners bracket exposures so dark and glossy surfaces
both decode; SURVEY.md section 1 capture layer / component 3).

Shape: decode every exposure's full stack with ONE vmapped
``decode_stack`` (the per-exposure decodes are independent dense maps —
a pure map over a new leading axis), then a per-pixel argmax selects the
exposure with the strongest *valid* phase modulation. No data-dependent
control flow: selection is a gather, the fused mask is an any-reduce.

A pixel's best exposure must be (a) unsaturated there — the white frame
below ``saturation`` — and (b) valid per the usual shadow/certainty
gates. Saturated pixels clip the fringes, which biases the decoded phase
even though modulation looks high, so saturation zeroes the selection
score outright rather than just down-weighting it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from slr.config import DecodeConfig, PatternConfig
from slr.codec.patterns import DecodeResult, decode_stack


@partial(jax.jit, static_argnames=("cfg", "dec", "saturation"))
def decode_multi_exposure(
    stacks,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    saturation: float = 0.98,
) -> DecodeResult:
    """Fuse an exposure bracket into one decode.

    ``stacks``: (E, F, H, W) — E captures of the same F-frame pattern
    sequence at different exposures (float [0,1] or raw integers).
    Returns a ``DecodeResult`` whose every pixel carries the decode of
    its best usable exposure; ``mask`` is true where ANY exposure
    decodes validly unsaturated.
    """
    if stacks.ndim != 4:
        raise ValueError(f"stacks must be (E, F, H, W), got {stacks.shape}")

    if jnp.issubdtype(stacks.dtype, jnp.integer):
        white = stacks[:, 0].astype(jnp.float32) / float(
            jnp.iinfo(stacks.dtype).max)
    else:
        white = stacks[:, 0]

    res = jax.vmap(lambda s: decode_stack(s, cfg, dec))(stacks)

    usable = res.mask & (white < saturation)          # (E, H, W)
    score = jnp.where(usable, res.quality, -1.0)
    best = jnp.argmax(score, axis=0)                  # (H, W)

    take = lambda m: jnp.take_along_axis(m, best[None], axis=0)[0]
    return DecodeResult(
        x_p=take(res.x_p),
        y_p=None if res.y_p is None else take(res.y_p),
        mask=jnp.any(usable, axis=0),
        quality=take(res.quality),
    )
