"""Bilinear texture sampling from the quad-packed texture pool.

Replaces the reference's `sampleTexture` / `setMaterialProperty`
(reference optixSphere.cu:569-613): repeat-wrapped bilinear fetch with a
constant fallback when a material has no map.

Layout: the pool stores, for every texel, its whole 2x2 wrap-
neighbourhood as four RGBA8-packed uint32s ([P,4], built by
scene.make_texture_quads).  A bilinear tap is then ONE row gather +
integer decode instead of four gathers.  8-bit texels match the reference
exactly (its textures are u8 PNGs converted by /255, cpp:366-380).

Each ray lane carries its own (offset, width, height) gathered from the
material table, so one vectorized fetch serves a batch of rays hitting
*different* materials — the wavefront analog of per-material SBT
texture pointers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pathtracer.scene.scene import SCRAMBLE_MULT

# np (not jnp) scalar: a module-level jnp constant would initialise the
# XLA backend at import time, breaking jax.distributed.initialize (which
# must run before any backend touch — tests/_dist_worker.py).
_INV255 = np.float32(1.0 / 255.0)


def _decode_rgb(word: jnp.ndarray):
    """uint32 RGBA8 -> (r,g,b) float32 in [0,1]."""
    r = (word & 0xFF).astype(jnp.float32) * _INV255
    g = ((word >> 8) & 0xFF).astype(jnp.float32) * _INV255
    b = ((word >> 16) & 0xFF).astype(jnp.float32) * _INV255
    return r, g, b


def sample_bilinear_pool(
    quads: jnp.ndarray,      # [P,4] u32 quad rows
    offset: jnp.ndarray,     # [N] i32 start row of each lane's map
    width: jnp.ndarray,      # [N] i32
    height: jnp.ndarray,     # [N] i32
    u: jnp.ndarray,          # [N] f32
    v: jnp.ndarray,          # [N] f32
) -> jnp.ndarray:
    """Repeat-wrap bilinear sample; returns [N,3].

    Matches sampleTexture (cu:569-596) with correct (non-negative) wrap of
    the x0/y0 texel index — the reference's `(int)floorf(x)` can be -1 at
    the wrap seam and read the previous row (SURVEY quirk list; fixed).
    """
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    x = u * width.astype(jnp.float32) - 0.5
    y = v * height.astype(jnp.float32) - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    s = x - x0f
    t = y - y0f

    x0 = jnp.mod(x0f.astype(jnp.int32), width)
    y0 = jnp.mod(y0f.astype(jnp.int32), height)

    q = quads[offset + y0 * width + x0]            # [N,4] — the ONE gather
    r00, g00, b00 = _decode_rgb(q[:, 0])
    r10, g10, b10 = _decode_rgb(q[:, 1])
    r01, g01, b01 = _decode_rgb(q[:, 2])
    r11, g11, b11 = _decode_rgb(q[:, 3])

    def lerp2(c00, c10, c01, c11):
        c0 = c00 + (c10 - c00) * s
        c1 = c01 + (c11 - c01) * s
        return c0 + (c1 - c0) * t

    return jnp.stack(
        [
            lerp2(r00, r10, r01, r11),
            lerp2(g00, g10, g01, g11),
            lerp2(b00, b10, b01, b11),
        ],
        axis=-1,
    )


def _spread_rows(n: int, table_rows: int) -> jnp.ndarray:
    """[n] hashed DISTINCT-ish row indices in [0, table_rows) for lanes
    whose gather result is unused, so inactive lanes do not all pile
    onto one row."""
    import jax

    i = jax.lax.iota(jnp.uint32, n)
    return ((i * jnp.uint32(SCRAMBLE_MULT)) % jnp.uint32(table_rows)).astype(
        jnp.int32
    )


def _part1by1(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 16 bits of v so bit i lands at bit 2i (Z-curve)."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def sample_bundle(
    bundles: jnp.ndarray,    # [Pb,8] u32 channel-packed quad rows
    offset: jnp.ndarray,     # [N] i32
    width: jnp.ndarray,      # [N] i32
    height: jnp.ndarray,     # [N] i32
    u: jnp.ndarray,
    v: jnp.ndarray,
    morton: bool = False,
    scrambled: bool = False,
    pow2_dims: bool = False,
    active=None,
):
    """Bilinear-sample all four map kinds with ONE 32-byte row gather.

    Row layout (scene.pack_bundle_rows): cols 0-3 = word A per quad corner
    (albedo.rgb + roughness.r), cols 4-7 = word B (normal.rgb +
    metallic.r) — the eight u8 channels shading actually consumes, at half
    the row bytes of a naive 4-kinds-x-4-words layout.

    Used when every material's maps share dimensions (MaterialTable
    .bundled); returns a list of four [N,3] arrays in kind order
    (albedo, roughness, normal, metallic) — roughness/metallic broadcast
    their scalar channel across rgb.

    scrambled=True addresses hash-permuted bundles (MaterialTable
    .bundled_scrambled, the default): coherent packets fetch through a
    scrambling bijection.  morton=True is the Z-curve layout (kept for
    A/B).

    `active` (bool mask): inactive lanes' gathers spread over hashed
    distinct rows (duplicate rows serialise in the gather unit; their
    samples are garbage and callers must mask).
    """
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    x = u * width.astype(jnp.float32) - 0.5
    y = v * height.astype(jnp.float32) - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    s = x - x0f
    t = y - y0f
    if pow2_dims:
        # repeat-wrap via bitwise AND (x0f >= -1, and two's-complement
        # -1 & (w-1) == w-1 — exactly mod for pow2 dims); saves two int
        # divisions per lane.
        x0 = x0f.astype(jnp.int32) & (width - 1)
        y0 = y0f.astype(jnp.int32) & (height - 1)
    else:
        x0 = jnp.mod(x0f.astype(jnp.int32), width)
        y0 = jnp.mod(y0f.astype(jnp.int32), height)

    if scrambled:
        t_row = (y0 * width + x0).astype(jnp.uint32)
        wh_mask = (width * height - 1).astype(jnp.uint32)
        texel = ((t_row * jnp.uint32(SCRAMBLE_MULT)) & wh_mask).astype(jnp.int32)
    elif morton:
        texel = _part1by1(x0) | (_part1by1(y0) << 1)
    else:
        texel = y0 * width + x0
    idx = offset + texel
    if active is not None:
        idx = jnp.where(active, idx, _spread_rows(idx.shape[0], bundles.shape[0]))
    rows = bundles[idx]                            # [N,8] — the ONE gather

    def lerp2(c00, c10, c01, c11):
        c0 = c00 + (c10 - c00) * s
        c1 = c01 + (c11 - c01) * s
        return c0 + (c1 - c0) * t

    def _alpha(word):
        return ((word >> 24) & 0xFF).astype(jnp.float32) * _INV255

    outs = []
    for base in (0, 4):                            # word A, word B
        q = rows[:, base : base + 4]
        corners = [_decode_rgb(q[:, j]) for j in range(4)]
        rgb = jnp.stack(
            [lerp2(*(corners[j][ch] for j in range(4))) for ch in range(3)],
            axis=-1,
        )
        scalar = lerp2(*(_alpha(q[:, j]) for j in range(4)))
        outs.append(rgb)                           # albedo / normal
        outs.append(jnp.stack([scalar] * 3, axis=-1))  # roughness / metallic
    # kind order: albedo, roughness, normal, metallic
    return [outs[0], outs[1], outs[2], outs[3]]


def material_property(
    quads: jnp.ndarray,
    has_map: jnp.ndarray,    # [N] bool
    offset: jnp.ndarray,     # [N] i32
    width: jnp.ndarray,
    height: jnp.ndarray,
    fallback: jnp.ndarray,   # [N,3]
    u: jnp.ndarray,
    v: jnp.ndarray,
) -> jnp.ndarray:
    """`setMaterialProperty` equivalent (cu:598-613): sample the map when
    present, else the per-material constant fallback."""
    sampled = sample_bilinear_pool(quads, offset, width, height, u, v)
    return jnp.where(has_map[..., None], sampled, fallback)
