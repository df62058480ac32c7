"""Microfacet BSDF math: GGX NDF, Smith/Schlick-GGX geometry, Fresnel.

Vectorized ports of the reference's device BSDF library
(reference optixSphere.cu:439-500).  All functions take [...]-batched
arrays; vectors have a trailing 3-axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from pathtracer.utils import math as vm


def d_ggx(n: jnp.ndarray, h: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """GGX normal distribution, reference `D_GGX` (cu:439-449)."""
    a2 = alpha * alpha
    ndoth = jnp.maximum(vm.dot(n, h), 1e-10)
    ndoth2 = ndoth * ndoth
    denom = ndoth2 * (a2 - 1.0) + 1.0
    denom = jnp.pi * denom * denom
    # f32 guard: at tiny alpha with ndoth ~= 1 the inner term can round
    # to exactly 0, making D = inf and downstream ratios that should
    # cancel D (brdf_specular / ggx_pdf) evaluate as inf/inf = NaN.  The
    # base estimator masks those lanes via its brdf-length check
    # (reference cu:859) but the NEE light-sample arm consumes
    # brdf_combined directly, so the NaN leaked into radiance (seen as
    # sum=nan on the high-poly scene).
    # Clamping only moves lanes whose denom < 1e-12 — exactly the ones
    # that previously produced inf/NaN.
    return a2 / jnp.maximum(denom, 1e-12)


def g_schlick_ggx(alpha: jnp.ndarray, n: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Schlick-GGX partial geometry term, reference `G_SchlickGGX`
    (cu:463-472): |n.x| / (|n.x|(1-k)+k) with k = alpha/2."""
    ndotx = jnp.abs(vm.dot(n, x))
    k = alpha / 2.0
    denom = jnp.maximum(ndotx * (1.0 - k) + k, 1e-10)
    return ndotx / denom


def g_smith(alpha, n, v, l) -> jnp.ndarray:
    """Smith geometry = product of Schlick-GGX terms (cu:474-477)."""
    return g_schlick_ggx(alpha, n, v) * g_schlick_ggx(alpha, n, l)


def fresnel_schlick(cos_theta: jnp.ndarray, f0: jnp.ndarray) -> jnp.ndarray:
    """Vector Fresnel-Schlick (cu:480-484); f0 [...,3]."""
    c = jnp.clip(cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * jnp.power(1.0 - c, 5.0)[..., None]


def fresnel_schlick_scalar(cosine: jnp.ndarray, refraction_index) -> jnp.ndarray:
    """Scalar Schlick reflectance (cu:487-492)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)


def ggx_importance_sample(r1: jnp.ndarray, r2: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Sample a GGX half-vector in tangent space (cosine axis = +y),
    reference `GGX_importance_sample` (cu:494-500)."""
    phi = 2.0 * jnp.pi * r1
    cos_theta = jnp.sqrt((1.0 - r2) / (1.0 + (alpha * alpha - 1.0) * r2))
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    h = jnp.stack(
        [sin_theta * jnp.cos(phi), cos_theta, sin_theta * jnp.sin(phi)], axis=-1
    )
    return vm.normalize(h)


def ggx_pdf(d_term: jnp.ndarray, ndoth: jnp.ndarray, vdoth: jnp.ndarray) -> jnp.ndarray:
    """Half-vector-sampling pdf in light-direction measure:
    D*NdotH / (4*VdotH), reference cu:781."""
    return d_term * ndoth / (4.0 * vdoth)
