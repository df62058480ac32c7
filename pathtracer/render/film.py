"""Film: progressive accumulation and the post-processing chain.

Clones the reference's exact pipeline (reference optixSphere.cu:400-435):

    accum   = lerp(prev, new, 1/(subframe+1))          (cu:403-408)
    rgb     = accum * exp2(exposure)                   (cu:412-415, -0.5)
    rgb     = aces_fit_tonemap(rgb)                    (cu:266-277, 419)
    rgb     = clamp(rgb, 0, 1)                         (cu:422)
    rgb     = rgb ** (1/gamma)                         (cu:425-429, 2.2)
    rgb     = 0.5 + contrast*(rgb-0.5)                 (cu:432-433, 1.25)
    u8      = make_color(rgb)  = quantize(toSRGB(clamp(rgb)))   (cu:435)

Note the double gamma: the manual 1/2.2 power *and* the sRGB transfer inside
the OptiX SDK's `make_color` — the reference's look depends on both, so both
are reproduced (the sRGB stage is `srgb_output` in RenderConfig).
"""

from __future__ import annotations

import jax.numpy as jnp

from pathtracer.config import RenderConfig


def accumulate(prev_accum: jnp.ndarray, new_frame: jnp.ndarray, subframe: jnp.ndarray) -> jnp.ndarray:
    """Progressive EWMA accumulation.

    prev_accum/new_frame: [..., 3];  subframe: scalar int (0 = first frame).
    Matches reference optixSphere.cu:403-408: accum_{k} = lerp(accum_{k-1},
    frame, 1/(k+1)) for k>0, accum_0 = frame.
    """
    subframe = jnp.asarray(subframe)
    a = 1.0 / (subframe.astype(jnp.float32) + 1.0)
    out = prev_accum + (new_frame - prev_accum) * a
    return jnp.where(subframe > 0, out, new_frame)


def accumulate_weighted(
    prev_accum: jnp.ndarray,
    new_frame: jnp.ndarray,
    prev_spp: jnp.ndarray,
    new_spp: jnp.ndarray,
) -> jnp.ndarray:
    """Sample-count-weighted progressive accumulation.

    Generalises `accumulate` to launches of UNEQUAL sample counts (the
    viewer's converge ramp renders 1/2/4-spp launches right after a
    camera settles before returning to the configured batch).  With a
    constant spp per launch it is bitwise-identical to `accumulate`:
    the exact real quotients spp/((k+1)*spp) and 1/(k+1) are equal and
    IEEE division is correctly rounded, so the f32 lerp factors match.
    """
    prev_spp = jnp.asarray(prev_spp).astype(jnp.float32)
    new_spp = jnp.asarray(new_spp).astype(jnp.float32)
    a = new_spp / (prev_spp + new_spp)
    out = prev_accum + (new_frame - prev_accum) * a
    return jnp.where(prev_spp > 0, out, new_frame)


def aces_fit_tonemap(x: jnp.ndarray) -> jnp.ndarray:
    """Rational-polynomial ACES filmic fit (Hable/Uncharted-style constants),
    exactly as at reference optixSphere.cu:266-277."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F) - E / F


def to_srgb(x: jnp.ndarray) -> jnp.ndarray:
    """sRGB transfer curve as in the OptiX SDK cuda/helpers.h `toSRGB`."""
    lo = 12.92 * x
    hi = 1.055 * jnp.power(jnp.maximum(x, 1e-10), 1.0 / 2.4) - 0.055
    return jnp.where(x <= 0.0031308, lo, hi)


def post_process(accum_rgb: jnp.ndarray, cfg: RenderConfig) -> jnp.ndarray:
    """HDR accumulation -> display-ready float RGB in [0,1]."""
    rgb = accum_rgb * jnp.exp2(cfg.exposure)
    rgb = aces_fit_tonemap(rgb)
    rgb = jnp.clip(rgb, 0.0, 1.0)
    rgb = jnp.power(jnp.maximum(rgb, 1e-10), 1.0 / cfg.gamma)
    rgb = 0.5 + cfg.contrast * (rgb - 0.5)
    rgb = jnp.clip(rgb, 0.0, 1.0)
    if cfg.srgb_output:
        rgb = to_srgb(rgb)
    return rgb


def to_uint8(rgb01: jnp.ndarray) -> jnp.ndarray:
    """Quantise like helpers.h `quantizeUnsigned8Bits`: min(uint(x*256), 255)."""
    q = jnp.minimum((jnp.clip(rgb01, 0.0, 1.0) * 256.0).astype(jnp.uint32), 255)
    return q.astype(jnp.uint8)
