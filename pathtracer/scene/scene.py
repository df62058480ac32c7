"""Device-resident scene: SoA arrays for geometry, materials and lighting.

This is the replacement for the reference's host->device upload
path: the `TriangleData` vectors + flattened `g_vertices/g_normals/
g_texcoords` buffers (reference optixSphere.cpp:845-858), the per-material
`HitGroupData` SBT records (cpp:1129-1281, optixSphere.h:67-102) and the
`MissData` env-map record (optixSphere.h:58-63).

Layout decisions (gather-count driven; not yet re-tuned on the GPU):

* **Packed attribute matrices.** Per-triangle shading attributes live in
  one [T,32] row matrix (`tri_attrs`) and per-material constants in one
  [M,32] matrix (`MaterialTable.attrs`), so the per-bounce lookup is a
  single row gather per table instead of dozens of field gathers.
* **Quad-packed textures.** Every texel row of `texture_quads` holds its
  full 2x2 bilinear neighbourhood as four RGBA8-packed uint32s, making a
  bilinear tap ONE gather instead of four.  Texels are 8-bit — exactly
  the reference's precision, whose textures are all u8 PNGs converted by
  /255 (reference optixSphere.cpp:366-380).
* **Quad-packed environment.** Same trick at float32 precision for the
  HDR env map (`EnvironmentMap.quads`, [H*W,12]).
* One flat texture pool addressed by (offset, width, height) per material
  map — the reference instead shares four *global* device pointers across
  all materials (cpp:395-398), aliasing multi-file scenes; fixed here.

Everything is a JAX pytree: a Scene can be donated to jit, sharded with
shard_map, and checkpointed.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.utils import pytree

# Column layout of MaterialTable.attrs ([M,MAT_COLS]).
MAT_DIFFUSE = slice(0, 3)
MAT_SPECULAR = slice(3, 6)
MAT_EMISSION = slice(6, 9)
MAT_ROUGHNESS = 9
MAT_METALLIC = 10
MAT_TRANSPARENT = 11
MAT_HAS_MAP = slice(12, 16)     # albedo, roughness, normal, metallic
MAT_MAP_OFFSET = slice(16, 20)
MAT_MAP_WIDTH = slice(20, 24)
MAT_MAP_HEIGHT = slice(24, 28)
# Bundled-texture descriptor (all of a material's maps share dimensions;
# one [P,16] row then serves all four maps in a single gather).
MAT_BUNDLE_OFFSET = 28
MAT_BUNDLE_WIDTH = 29
MAT_BUNDLE_HEIGHT = 30
# Per-material index of refraction (MTL `Ni`). 0 = unspecified: shading
# falls back to cfg.ior (the reference hard-codes 1.5, optixSphere.cu:717).
MAT_IOR = 31
# Mip (LOD) bundle descriptor: the same material's maps box-filtered to a
# coarser level and packed into `texture_bundles_mip` — a pool sized to
# stay under `mip_budget_bytes`.  Built by make_material_table only when
# the full-res pool exceeds `mip_min_pool_bytes`.
MAT_MIP_OFFSET = 32
MAT_MIP_WIDTH = 33
MAT_MIP_HEIGHT = 34
# Total packed columns (pad to a lane-friendly multiple of 8).
MAT_COLS = 40

# Column layout of Scene.tri_attrs ([T,32]).
TRI_V = slice(0, 9)       # v0 v1 v2 xyz
TRI_N = slice(9, 18)      # n0 n1 n2 xyz
TRI_UV = slice(18, 24)    # uv0 uv1 uv2
TRI_MAT = 24              # material id (as float)


@pytree.dataclass
class MaterialTable:
    """Per-material constants + texture-map descriptors.

    Software equivalent of N HitGroupData SBT records (reference
    optixSphere.h:67-102).  `attrs` is the packed [M,32] lookup matrix
    (layout above); the named arrays are kept for inspection/tests.
    """

    attrs: jnp.ndarray           # [M,MAT_COLS] f32 packed lookup matrix
    diffuse_color: jnp.ndarray   # [M,3] f32
    specular: jnp.ndarray        # [M,3] f32 (parity field; unused by the
    #                              BSDF just like the reference's)
    emission_color: jnp.ndarray  # [M,3] f32 = color * emission (cpp:1213)
    roughness: jnp.ndarray       # [M]   f32
    metallic: jnp.ndarray        # [M]   f32 (0/1 from bool)
    transparent: jnp.ndarray     # [M]   f32 (0/1 from bool)
    has_map: jnp.ndarray         # [M,4] bool
    map_offset: jnp.ndarray      # [M,4] i32 (rows into texture_quads)
    map_width: jnp.ndarray       # [M,4] i32
    map_height: jnp.ndarray      # [M,4] i32

    # [P,4] uint32: per texel, its 2x2 wrap-neighbourhood as RGBA8 words
    # (texel, x+1, y+1, x+1&y+1).
    texture_quads: jnp.ndarray
    # [Pb,8] uint32 channel-packed bundle pool (see pack_bundle_rows):
    # per texel corner, word A = albedo.rgb+roughness.r, word B =
    # normal.rgb+metallic.r — only populated when every material's maps
    # share dimensions (`bundled` static flag), in which case shading does
    # ONE 32-byte texture gather per bounce instead of four.
    texture_bundles: jnp.ndarray
    # [Pm,8] uint32 mip bundle pool (same channel-packed row format as
    # texture_bundles) holding every material's maps box-filtered down so
    # the WHOLE pool fits the mip budget.  Row 0 = no-map
    # sink.  None when no mip ladder was built (pool already small).
    texture_bundles_mip: Optional[jnp.ndarray] = None
    bundled: bool = pytree.field(static=True, default=False)
    # Bundle texels stored in Morton (Z-curve) order instead of row-major
    # (nearby texels in nearby rows); an explicit layout option, the
    # default is `bundled_scrambled`.
    bundled_morton: bool = pytree.field(static=True, default=False)
    # Bundle texels stored at hash-permuted rows (odd-multiplier bijection
    # mod the pow2 texel count): coherent ray packets fetch *scattered*
    # rows.  Set when every bundled map has a power-of-two texel count.
    # A layout kept from an earlier tuning; not re-measured on the GPU.
    bundled_scrambled: bool = pytree.field(static=True, default=False)
    # Every bundled map has power-of-two width AND height: texel wrap can
    # use a bitwise AND instead of two integer divisions per lane
    # (`jnp.mod` lowers to integer division).
    bundled_pow2_dims: bool = pytree.field(static=True, default=False)
    # Mip ladder metadata (static).  mip_level = the global box-filter
    # level the ladder was built at (per-material levels can be lower for
    # small maps); 0 = no ladder.  The scrambled/pow2 flags mirror the
    # base pool's, evaluated at mip dimensions.
    mip_level: int = pytree.field(static=True, default=0)
    mip_scrambled: bool = pytree.field(static=True, default=False)
    mip_pow2_dims: bool = pytree.field(static=True, default=False)

    @property
    def num_materials(self) -> int:
        return self.attrs.shape[0]


@pytree.dataclass
class EnvironmentMap:
    """Equirectangular HDR environment (reference MissData,
    optixSphere.h:58-63).  `data` [H,W,3] f32; `quads` [H*W,12] packs each
    texel's bilinear neighbourhood (c00,c10,c01,c11 rgb) so one gather
    serves a bilinear tap.  Build with `make_env`.

    CDF tables (render/envmap.build_env_cdf) enable importance sampling —
    beyond the reference, whose NEE path is dead code (optixSphere.cu:
    134-156, 858)."""

    data: jnp.ndarray                       # [H,W,3] f32
    quads: Optional[jnp.ndarray] = None     # [H*W,12] f32
    cdf_rows: Optional[jnp.ndarray] = None  # [H]
    cdf_cols: Optional[jnp.ndarray] = None  # [H,W]
    # [H*W,4] Vose alias table (accept_prob, alias, pdf_self, pdf_alias)
    # for O(1) importance sampling — envmap.with_importance_sampling.
    alias_table: Optional[jnp.ndarray] = None
    # Quad rows at hash-permuted positions (see MaterialTable
    # .bundled_scrambled): miss packets look up nearby sky texels from
    # scattered rows.  Set when H*W is a power of two.
    quads_scrambled: bool = pytree.field(static=True, default=False)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def make_env(data) -> EnvironmentMap:
    """Build an EnvironmentMap with the packed quad table.

    x wraps (equirect seam), y clamps (poles) — matching
    render/envmap.sample_equirect."""
    arr = np.asarray(data, np.float32)
    h, w = arr.shape[:2]
    x1 = (np.arange(w) + 1) % w
    y1 = np.minimum(np.arange(h) + 1, h - 1)
    c00 = arr
    c10 = arr[:, x1]
    c01 = arr[y1, :]
    c11 = arr[y1][:, x1]
    quads = np.concatenate([c00, c10, c01, c11], axis=-1).reshape(h * w, 12)
    scrambled = (h * w) > 1 and ((h * w) & (h * w - 1)) == 0
    if scrambled:
        scatter = scramble_order(h * w)
        squads = np.empty_like(quads)
        squads[scatter] = quads
        quads = squads
    return EnvironmentMap(
        data=jnp.asarray(arr),
        quads=jnp.asarray(quads),
        quads_scrambled=scrambled,
    )


def default_env(height: int = 8, width: int = 16, color=(0.4, 0.4, 0.6)) -> EnvironmentMap:
    """A tiny constant environment (used when env_mode != equirect)."""
    data = np.broadcast_to(np.asarray(color, np.float32), (height, width, 3))
    return make_env(data)


def _part1by1_np(v: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of v so bit i lands at bit 2i."""
    v = v.astype(np.uint32) & np.uint32(0xFFFF)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def morton_order(width: int, height: int) -> np.ndarray:
    """[H*W] permutation: morton_order[y*W+x] = Z-curve index of (x, y).

    Requires width == height == power of two."""
    y, x = np.mgrid[0:height, 0:width]
    return (_part1by1_np(x) | (_part1by1_np(y) << 1)).reshape(-1)


# Odd multiplier (Knuth's 2654435761): i -> (i * MULT) mod 2^k is a
# bijection for any pow2 modulus, cheap on both host and device.
SCRAMBLE_MULT = 2654435761


def scramble_order(n_texels: int) -> np.ndarray:
    """[n] permutation: scramble_order[i] = hash-scattered row of texel i.

    Requires power-of-two n.  Maps spatially-adjacent texels to scattered
    rows."""
    assert n_texels & (n_texels - 1) == 0
    i = np.arange(n_texels, dtype=np.uint64)
    return ((i * SCRAMBLE_MULT) & (n_texels - 1)).astype(np.int64)


def pack_rgba8(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float in [0,1] -> [H,W] uint32 RGBA8 words (A=255).

    8-bit quantisation is lossless for u8-sourced textures (the
    reference's /255 conversion, cpp:366-380)."""
    # float32 end-to-end: exact for u8-sourced textures (u8/255*255
    # round-trips exactly in f32), and 2x cheaper than the former f64
    # pass on the 16.8M-texel hero maps.  Float-sourced images arrive as
    # f64 (e.g. user-synthesised maps): keep those on the f64 quantiser —
    # a product near a .5 tie can round differently in f32, silently
    # shifting texels by 1/255.  All in-tree loaders emit f32
    # (utils/image.py), so the fast path covers every real asset.
    img = np.asarray(img)
    work = np.float64 if img.dtype == np.float64 else np.float32
    u8 = np.clip(
        np.round(img.astype(work, copy=False) * work(255.0)), 0, 255
    ).astype(np.uint32)
    return (
        u8[..., 0]
        | (u8[..., 1] << 8)
        | (u8[..., 2] << 16)
        | (np.uint32(255) << 24)
    )


def pack_bundle_rows(
    quads_albedo: Optional[np.ndarray],
    quads_rough: Optional[np.ndarray],
    quads_normal: Optional[np.ndarray],
    quads_metal: Optional[np.ndarray],
    n_texels: int,
) -> np.ndarray:
    """Four [n,4] RGBA8 quad arrays (None = absent map) -> [n,8] u32
    channel-packed bundle rows.

    Shading consumes albedo.rgb, roughness.r, normal.rgb and metallic.r —
    eight u8 channels per texel corner, not sixteen — so each corner packs
    into TWO words instead of four:
        word A = albedo.r | albedo.g<<8 | albedo.b<<16 | roughness.r<<24
        word B = normal.r | normal.g<<8 | normal.b<<16 | metallic.r<<24
    cols 0-3 = word A for corners (00,10,01,11); cols 4-7 = word B.
    Halving the row from 64B to 32B halves the bytes each bilinear
    bundle gather moves."""
    def _byte(q, b):
        if q is None:
            return np.zeros((n_texels, 4), np.uint32)
        return (q >> np.uint32(8 * b)) & np.uint32(0xFF)

    word_a = (
        _byte(quads_albedo, 0)
        | (_byte(quads_albedo, 1) << np.uint32(8))
        | (_byte(quads_albedo, 2) << np.uint32(16))
        | (_byte(quads_rough, 0) << np.uint32(24))
    )
    word_b = (
        _byte(quads_normal, 0)
        | (_byte(quads_normal, 1) << np.uint32(8))
        | (_byte(quads_normal, 2) << np.uint32(16))
        | (_byte(quads_metal, 0) << np.uint32(24))
    )
    return np.concatenate([word_a, word_b], axis=1).astype(np.uint32)


def _quads_to_channels(quads: Optional[np.ndarray], w: int, h: int) -> Optional[np.ndarray]:
    """[h*w,4] u32 quad rows (row-major texels) -> [h,w,3] u8 channels of
    the texel itself (quad column 0; alpha is the constant 255 pad)."""
    if quads is None:
        return None
    c00 = np.asarray(quads[:, 0].reshape(h, w), np.uint32)
    return np.stack(
        [
            (c00 & np.uint32(0xFF)).astype(np.uint8),
            ((c00 >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8),
            ((c00 >> np.uint32(16)) & np.uint32(0xFF)).astype(np.uint8),
        ],
        axis=-1,
    )


def _box_downsample_u8(img: np.ndarray, level: int) -> np.ndarray:
    """[h,w,c] u8 -> [h>>L, w>>L, c] u8 by exact 2^L x 2^L box-filter mean
    (round-half-up, matching pack_rgba8's quantiser).  Dims must divide."""
    if level == 0:
        return img
    h, w, c = img.shape
    f = 1 << level
    # u32 block sums are exact (max 255 * 2^(2L) well below 2^32); only
    # the final division needs float.  Exact round-half-up like before.
    blocks = img.reshape(h // f, f, w // f, f, c).astype(np.uint32)
    ssum = blocks.sum(axis=(1, 3), dtype=np.uint32)
    mean = ssum.astype(np.float64) / (f * f)
    return np.clip(np.round(mean), 0, 255).astype(np.uint8)


def _channels_to_quads(img_u8: np.ndarray) -> np.ndarray:
    """[h,w,3] u8 -> [h*w,4] u32 quad rows (repeat wrap both axes) without
    a float round-trip (texels are already quantised)."""
    h, w = img_u8.shape[:2]
    u = img_u8.astype(np.uint32)
    packed = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16) | (np.uint32(255) << 24)
    x1 = (np.arange(w) + 1) % w
    y1 = (np.arange(h) + 1) % h
    quads = np.stack(
        [packed, packed[:, x1], packed[y1, :], packed[y1][:, x1]], axis=-1
    )
    return quads.reshape(h * w, 4)


def make_texture_quads(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float -> [H*W,4] uint32 quad rows (repeat wrap both axes,
    matching render/texsample semantics)."""
    h, w = img.shape[:2]
    packed = pack_rgba8(img)                       # [H,W] u32
    x1 = (np.arange(w) + 1) % w
    y1 = (np.arange(h) + 1) % h
    quads = np.stack(
        [packed, packed[:, x1], packed[y1, :], packed[y1][:, x1]], axis=-1
    )
    return quads.reshape(h * w, 4)


@pytree.dataclass
class Scene:
    """Complete device scene (geometry + materials + lighting + accel)."""

    vertices: jnp.ndarray   # [T,3,3] f32 — v0,v1,v2 per triangle
    normals: jnp.ndarray    # [T,3,3] f32 — per-vertex shading normals
    uvs: jnp.ndarray        # [T,3,2] f32 — per-vertex texcoords
    mat_ids: jnp.ndarray    # [T]     i32 — material index per triangle
    tri_attrs: jnp.ndarray  # [T,32]  f32 — packed shading attribute rows
    materials: MaterialTable
    env: EnvironmentMap
    # Acceleration structure; filled by pathtracer.accel (None = brute).
    accel: Optional["object"] = None

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]


def pack_tri_attrs(vertices, normals, uvs, mat_ids) -> np.ndarray:
    t = vertices.shape[0]
    attrs = np.zeros((max(t, 1), 32), np.float32)
    if t:
        attrs[:, TRI_V] = vertices.reshape(t, 9)
        attrs[:, TRI_N] = normals.reshape(t, 9)
        attrs[:, TRI_UV] = uvs.reshape(t, 6)
        attrs[:, TRI_MAT] = mat_ids.astype(np.float32)
    return attrs


def make_material_table(
    materials: list[dict],
    texture_quads: Optional[np.ndarray] = None,
    mip_budget_bytes: int = 12 * 1024 * 1024,
    mip_min_pool_bytes: int = 16 * 1024 * 1024,
) -> MaterialTable:
    """Build a MaterialTable from a list of material dicts.

    Each dict supports keys: color (3,), specular (3,), emission (float),
    roughness (float), metallic (bool), transparent (bool), and per-map
    descriptors `maps` = {kind: (offset, width, height)} where kind in
    {"albedo","roughness","normal","metallic"} and offset indexes rows of
    `texture_quads`.

    Mirrors the SBT fill at reference optixSphere.cpp:1196-1262 (notably
    emission_color = color * emission, cpp:1213).

    When the bundled texture pool exceeds `mip_min_pool_bytes`, a mip
    (LOD) ladder is additionally built: every
    material's maps box-filtered to the smallest level whose combined
    pool fits `mip_budget_bytes` (see _build_mip_pool).  Shading picks
    the pool per cfg.texture_lod.
    """
    kinds = ["albedo", "roughness", "normal", "metallic"]
    m = len(materials)
    attrs = np.zeros((m, MAT_COLS), np.float32)
    attrs[:, MAT_MAP_WIDTH] = 1.0
    attrs[:, MAT_MAP_HEIGHT] = 1.0
    attrs[:, MAT_MIP_WIDTH] = 1.0
    attrs[:, MAT_MIP_HEIGHT] = 1.0

    for i, mat in enumerate(materials):
        color = np.asarray(mat.get("color", (0.5, 0.5, 0.5)), np.float32)
        attrs[i, MAT_DIFFUSE] = color
        attrs[i, MAT_SPECULAR] = np.asarray(mat.get("specular", color), np.float32)
        attrs[i, MAT_EMISSION] = color * np.float32(mat.get("emission", 0.0))
        attrs[i, MAT_ROUGHNESS] = np.float32(mat.get("roughness", 0.5))
        attrs[i, MAT_METALLIC] = 1.0 if mat.get("metallic", False) else 0.0
        attrs[i, MAT_TRANSPARENT] = 1.0 if mat.get("transparent", False) else 0.0
        attrs[i, MAT_IOR] = np.float32(mat.get("ior", 0.0))
        for k, kind in enumerate(kinds):
            desc = mat.get("maps", {}).get(kind)
            if desc is not None:
                off, w, h = desc
                attrs[i, 12 + k] = 1.0
                attrs[i, 16 + k] = float(off)
                attrs[i, 20 + k] = float(w)
                attrs[i, 24 + k] = float(h)

    if texture_quads is None or len(texture_quads) == 0:
        texture_quads = np.zeros((1, 4), np.uint32)
    if texture_quads.shape[0] > (1 << 24):
        # f32 offsets in the attr matrix stay exact below 2^24 (every
        # offset is smaller than the pool size).
        raise ValueError("texture pool exceeds 2^24 texels; offsets lose f32 precision")

    # ---- texture bundling --------------------------------------------
    # When every material's present maps share dimensions, interleave the
    # four kinds into one [Pb,16] row pool: one gather serves all maps.
    bundled = True
    for mat in materials:
        dims = {
            (desc[1], desc[2]) for desc in mat.get("maps", {}).values()
        }
        if len(dims) > 1:
            bundled = False
            break
    bundle_rows = [np.zeros((1, 8), np.uint32)]  # row 0 = no-map sink
    bundle_off = 1
    # Morton (Z-order) texel layout when every bundled map is a square
    # power of two: coherent (u,v) -> coherent HBM rows for the gather.
    def _pow2_square(w, h):
        return w == h and w > 0 and (w & (w - 1)) == 0

    def _pow2(n):
        return n > 0 and (n & (n - 1)) == 0

    # Scrambled rows are the default layout; Morton stays available for
    # A/B via layout="morton".
    bundled_scrambled = bundled and all(
        _pow2(desc[1] * desc[2])
        for mat in materials
        for desc in mat.get("maps", {}).values()
    )
    bundled_morton = (
        not bundled_scrambled
        and bundled
        and all(
            _pow2_square(desc[1], desc[2])
            for mat in materials
            for desc in mat.get("maps", {}).values()
        )
    )
    # Equivalent to bundled_scrambled's _pow2(w*h) condition (a product
    # of positive ints is a power of two iff both factors are), but kept
    # as its own named flag: one gates the hash-permuted ROW LAYOUT, the
    # other the AND-based texel WRAP, and they could diverge if a
    # non-pow2-total layout ever appears.
    bundled_pow2_dims = bundled_scrambled
    if bundled:
        attrs[:, MAT_BUNDLE_WIDTH] = 1.0
        attrs[:, MAT_BUNDLE_HEIGHT] = 1.0
        for i, mat in enumerate(materials):
            maps = mat.get("maps", {})
            if not maps:
                continue
            w, h = next(iter(maps.values()))[1], next(iter(maps.values()))[2]
            n_texels = w * h

            def _kind_quads(kind):
                desc = maps.get(kind)
                if desc is None:
                    return None
                return texture_quads[desc[0] : desc[0] + n_texels]

            bundle = pack_bundle_rows(
                _kind_quads("albedo"), _kind_quads("roughness"),
                _kind_quads("normal"), _kind_quads("metallic"), n_texels,
            )
            if bundled_scrambled and n_texels > 1:
                scatter = scramble_order(n_texels)  # row-major -> hashed
                sbundle = np.empty_like(bundle)
                sbundle[scatter] = bundle
                bundle = sbundle
            elif bundled_morton and n_texels > 1:
                scatter = morton_order(w, h)        # row-major pos -> Z pos
                zbundle = np.empty_like(bundle)
                zbundle[scatter] = bundle
                bundle = zbundle
            bundle_rows.append(bundle)
            attrs[i, MAT_BUNDLE_OFFSET] = float(bundle_off)
            attrs[i, MAT_BUNDLE_WIDTH] = float(w)
            attrs[i, MAT_BUNDLE_HEIGHT] = float(h)
            bundle_off += n_texels
    texture_bundles = np.concatenate(bundle_rows, axis=0)

    # ---- mip (LOD) ladder --------------------------------------------
    # Only built when the full-res pool exceeds mip_min_pool_bytes.
    texture_bundles_mip = None
    mip_level = 0
    mip_scrambled = False
    mip_pow2 = False
    if bundled and texture_bundles.nbytes > mip_min_pool_bytes:
        built = _build_mip_pool(materials, texture_quads, mip_budget_bytes)
        if built is not None:
            texture_bundles_mip, mip_desc, mip_level, mip_scrambled, mip_pow2 = built
            for i, (off, w, h) in mip_desc.items():
                attrs[i, MAT_MIP_OFFSET] = float(off)
                attrs[i, MAT_MIP_WIDTH] = float(w)
                attrs[i, MAT_MIP_HEIGHT] = float(h)

    return MaterialTable(
        attrs=jnp.asarray(attrs),
        diffuse_color=jnp.asarray(attrs[:, MAT_DIFFUSE]),
        specular=jnp.asarray(attrs[:, MAT_SPECULAR]),
        emission_color=jnp.asarray(attrs[:, MAT_EMISSION]),
        roughness=jnp.asarray(attrs[:, MAT_ROUGHNESS]),
        metallic=jnp.asarray(attrs[:, MAT_METALLIC]),
        transparent=jnp.asarray(attrs[:, MAT_TRANSPARENT]),
        has_map=jnp.asarray(attrs[:, MAT_HAS_MAP] > 0.5),
        map_offset=jnp.asarray(attrs[:, MAT_MAP_OFFSET].astype(np.int32)),
        map_width=jnp.asarray(attrs[:, MAT_MAP_WIDTH].astype(np.int32)),
        map_height=jnp.asarray(attrs[:, MAT_MAP_HEIGHT].astype(np.int32)),
        texture_quads=jnp.asarray(texture_quads.astype(np.uint32)),
        texture_bundles=jnp.asarray(texture_bundles),
        texture_bundles_mip=(
            None if texture_bundles_mip is None
            else jnp.asarray(texture_bundles_mip)
        ),
        bundled=bundled,
        bundled_morton=bundled_morton,
        bundled_scrambled=bundled_scrambled,
        bundled_pow2_dims=bundled_pow2_dims,
        mip_level=mip_level,
        mip_scrambled=mip_scrambled,
        mip_pow2_dims=mip_pow2,
    )


def _build_mip_pool(
    materials: list[dict],
    texture_quads: np.ndarray,
    budget_bytes: int,
):
    """Build the channel-packed mip bundle pool for a bundled material set.

    Picks the smallest global level L >= 1 whose combined pool (32 B/row)
    fits `budget_bytes`; each material's effective level is capped so its
    dimensions stay divisible by 2^level and at least 4 texels per axis
    (small maps ride along unfiltered).  Returns
    (rows [Pm,8] u32, {material_i: (offset, w, h)}, L, scrambled, pow2)
    or None when no level fits the budget.
    """
    budget_texels = max(budget_bytes // 32, 1)

    def _cap(w: int, h: int) -> int:
        cap = 0
        while (
            (w >> (cap + 1)) >= 4
            and (h >> (cap + 1)) >= 4
            and w % (1 << (cap + 1)) == 0
            and h % (1 << (cap + 1)) == 0
        ):
            cap += 1
        return cap

    entries = []  # (i, maps, w, h, cap)
    for i, mat in enumerate(materials):
        maps = mat.get("maps", {})
        if not maps:
            continue
        desc0 = next(iter(maps.values()))
        w, h = desc0[1], desc0[2]
        entries.append((i, maps, w, h, _cap(w, h)))
    if not entries:
        return None

    level = None
    for lv in range(1, 16):
        total = sum(
            (w >> min(lv, cap)) * (h >> min(lv, cap))
            for (_, _, w, h, cap) in entries
        )
        if total <= budget_texels:
            level = lv
            break
        if all(min(lv, cap) == cap for (_, _, _, _, cap) in entries):
            break  # fully capped and still over budget
    if level is None:
        return None

    def _pow2(n):
        return n > 0 and (n & (n - 1)) == 0

    mip_dims = [
        (w >> min(level, cap), h >> min(level, cap))
        for (_, _, w, h, cap) in entries
    ]
    scrambled = all(_pow2(mw * mh) for (mw, mh) in mip_dims)
    pow2_dims = scrambled

    rows = [np.zeros((1, 8), np.uint32)]  # row 0 = no-map sink
    off = 1
    desc_out = {}
    for (i, maps, w, h, cap), (mw, mh) in zip(entries, mip_dims):
        e = min(level, cap)
        n_texels = w * h

        def _mip_quads(kind):
            d = maps.get(kind)
            if d is None:
                return None
            img = _quads_to_channels(
                texture_quads[d[0] : d[0] + n_texels], w, h
            )
            return _channels_to_quads(_box_downsample_u8(img, e))

        bundle = pack_bundle_rows(
            _mip_quads("albedo"), _mip_quads("roughness"),
            _mip_quads("normal"), _mip_quads("metallic"), mw * mh,
        )
        if scrambled and mw * mh > 1:
            scatter = scramble_order(mw * mh)
            sb = np.empty_like(bundle)
            sb[scatter] = bundle
            bundle = sb
        rows.append(bundle)
        desc_out[i] = (off, mw, mh)
        off += mw * mh
    return (
        np.concatenate(rows, axis=0).astype(np.uint32),
        desc_out,
        level,
        scrambled,
        pow2_dims,
    )


def make_scene(
    vertices: np.ndarray,
    normals: np.ndarray,
    uvs: Optional[np.ndarray],
    mat_ids: np.ndarray,
    materials: MaterialTable,
    env: Optional[EnvironmentMap] = None,
) -> Scene:
    """Assemble a Scene from host numpy arrays ([T,3,3]/[T,3,2]/[T])."""
    t = vertices.shape[0]
    vertices = np.asarray(vertices, np.float32)
    normals = np.asarray(normals, np.float32)
    mat_ids = np.asarray(mat_ids, np.int32)
    if uvs is None:
        uvs = np.zeros((t, 3, 2), np.float32)
    uvs = np.asarray(uvs, np.float32)
    if env is None:
        env = default_env()
    return Scene(
        vertices=jnp.asarray(vertices),
        normals=jnp.asarray(normals),
        uvs=jnp.asarray(uvs),
        mat_ids=jnp.asarray(mat_ids),
        tri_attrs=jnp.asarray(pack_tri_attrs(vertices, normals, uvs, mat_ids)),
        materials=materials,
        env=env,
    )
