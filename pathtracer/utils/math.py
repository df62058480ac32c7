"""Vector math for batched rays.

Everything operates on arrays whose last axis is the 3-vector axis, i.e.
shape [..., 3], so the same helpers serve scalars, ray batches and pixel
grids.  This replaces the reference's `sutil/vec_math.h` float3 helpers and
the device ONB/reflect/refract utilities (reference optixSphere.cu:38-61 and
sutil vec_math).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-10


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis; keeps no dims."""
    return jnp.sum(a * b, axis=-1)


def vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product, keepdims=True (broadcasts against [...,3])."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v: jnp.ndarray, eps: float = EPS) -> jnp.ndarray:
    """Safe normalize: returns v/|v| with |v| floored to eps."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, eps * eps))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of incident direction i about normal n.

    Matches CUDA `reflect(i, n) = i - 2 n (i.n)`.
    """
    return i - 2.0 * vdot(i, n) * n


def faceforward(n: jnp.ndarray, i: jnp.ndarray, nref: jnp.ndarray) -> jnp.ndarray:
    """Flip n so it faces the same hemisphere as i relative to nref.

    Matches sutil `faceforward(n, i, nref) = n * copysign(1, dot(i, nref))`;
    used for the flat normal at reference optixSphere.cu:638.
    """
    s = jnp.sign(dot(i, nref))
    # sign(0) = 0 would zero the normal; treat 0 as +1 like copysign does.
    s = jnp.where(s == 0, 1.0, s)
    return n * s[..., None]


def refract(i: jnp.ndarray, n: jnp.ndarray, eta_passed: jnp.ndarray):
    """Refraction matching the sutil `refract(r, i, n, ior)` call semantics
    used at reference optixSphere.cu:846.

    The reference passes an already-swapped eta and an already-flipped N
    (so dot(i, n) < 0); sutil then uses the *reciprocal* of the passed ior
    when the ray arrives against the normal.  Net effect: the effective
    index ratio is 1/eta_passed.

    Returns (refracted_dir [...,3], tir_mask [...]) — on total internal
    reflection the direction is zero (as sutil leaves r zero-initialised).
    """
    eta = 1.0 / eta_passed
    cos_i = -dot(i, n)  # > 0 when n faces against the incident ray
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    k_safe = jnp.maximum(k, 0.0)
    r = eta[..., None] * i + (eta * cos_i - jnp.sqrt(k_safe))[..., None] * n
    r = normalize(r)
    r = jnp.where(tir[..., None], 0.0, r)
    return r, tir


def onb_from_normal(normal: jnp.ndarray):
    """Orthonormal basis (tangent, binormal) for a (batch of) normal(s).

    Mirrors the reference's `Onb` (optixSphere.cu:38-61):
      up       = |n.y| < 0.9999 ? (0,1,0) : (1,0,0)
      tangent  = normalize(cross(up, n))
      binormal = normalize(cross(n, tangent))
    Returns (tangent, binormal); the caller keeps `normal` itself.
    """
    n = normalize(normal)
    ny = jnp.abs(n[..., 1]) < 0.9999
    up = jnp.where(
        ny[..., None],
        jnp.array([0.0, 1.0, 0.0], dtype=n.dtype),
        jnp.array([1.0, 0.0, 0.0], dtype=n.dtype),
    )
    tangent = normalize(jnp.cross(up, n))
    binormal = normalize(jnp.cross(n, tangent))
    return tangent, binormal


def onb_transform(local: jnp.ndarray, tangent, normal, binormal) -> jnp.ndarray:
    """Tangent-space -> world: p.x*T + p.y*N + p.z*B.

    The reference's `Onb::inverse_transform` maps the *y* axis onto the
    normal (optixSphere.cu:53-56); both its hemisphere samplers put the
    cosine axis in y accordingly.
    """
    return (
        local[..., 0:1] * tangent
        + local[..., 1:2] * normal
        + local[..., 2:3] * binormal
    )


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    return dot(rgb, jnp.array([0.2126, 0.7152, 0.0722], dtype=rgb.dtype))


def interp3(w: jnp.ndarray, attr: jnp.ndarray) -> jnp.ndarray:
    """Barycentric blend: w [N,3] x per-vertex attr [N,3,C] -> [N,C],
    as f32 elementwise products and sums (no matrix-unit contraction)."""
    return jnp.sum(w[:, :, None] * attr, axis=1)


def lerp(a, b, t):
    return a + (b - a) * t
