"""Texture-sampling unit tests: bilinear vs a numpy reference
(SURVEY.md §4: "texture bilinear vs scipy reference")."""

import jax.numpy as jnp
import numpy as np

from pathtracer.render.texsample import (
    material_property,
    sample_bilinear_pool,
    sample_bundle,
)
from pathtracer.scene.scene import make_texture_quads, pack_rgba8


def numpy_bilinear(img, u, v):
    """Reference repeat-wrap bilinear matching sampleTexture semantics."""
    h, w = img.shape[:2]
    u = u - np.floor(u)
    v = v - np.floor(v)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    s = (x - x0)[..., None]
    t = (y - y0)[..., None]
    x0m, x1m = x0 % w, (x0 + 1) % w
    y0m, y1m = y0 % h, (y0 + 1) % h
    c00, c10 = img[y0m, x0m], img[y0m, x1m]
    c01, c11 = img[y1m, x0m], img[y1m, x1m]
    return (c00 * (1 - s) + c10 * s) * (1 - t) + (c01 * (1 - s) + c11 * s) * t


def quantized(img):
    return np.round(np.clip(img, 0, 1) * 255) / 255.0


def test_quad_pool_matches_numpy_bilinear():
    rs = np.random.RandomState(0)
    img = rs.rand(7, 13, 3).astype(np.float32)
    quads = jnp.asarray(make_texture_quads(img))
    n = 512
    u = rs.rand(n).astype(np.float32) * 3 - 1   # exercises wrap
    v = rs.rand(n).astype(np.float32) * 3 - 1
    got = np.asarray(
        sample_bilinear_pool(
            quads,
            jnp.zeros(n, jnp.int32),
            jnp.full(n, 13, jnp.int32),
            jnp.full(n, 7, jnp.int32),
            jnp.asarray(u),
            jnp.asarray(v),
        )
    )
    want = numpy_bilinear(quantized(img), u, v)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_pack_rgba8_lossless_for_u8():
    # u8-sourced values (k/255) roundtrip exactly.
    vals = np.arange(256) / 255.0
    img = np.stack([vals, vals[::-1], np.zeros(256)], -1).reshape(16, 16, 3)
    packed = pack_rgba8(img)
    r = (packed & 0xFF) / 255.0
    np.testing.assert_array_equal(r, img[..., 0])


def test_material_property_fallback():
    quads = jnp.zeros((1, 4), jnp.uint32)
    n = 4
    fallback = jnp.asarray(np.tile([0.1, 0.2, 0.3], (n, 1)), jnp.float32)
    out = np.asarray(
        material_property(
            quads,
            jnp.zeros(n, bool),
            jnp.zeros(n, jnp.int32),
            jnp.ones(n, jnp.int32),
            jnp.ones(n, jnp.int32),
            fallback,
            jnp.zeros(n),
            jnp.zeros(n),
        )
    )
    np.testing.assert_allclose(out, np.asarray(fallback))


def test_bundle_matches_per_map():
    from pathtracer.scene.scene import pack_bundle_rows

    rs = np.random.RandomState(1)
    imgs = [rs.rand(6, 6, 3).astype(np.float32) for _ in range(4)]
    quads = np.concatenate([make_texture_quads(im) for im in imgs])
    kq = [quads[36 * k : 36 * (k + 1)] for k in range(4)]
    bundle = pack_bundle_rows(kq[0], kq[1], kq[2], kq[3], 36)
    assert bundle.shape == (36, 8)
    n = 256
    u = jnp.asarray(rs.rand(n), jnp.float32)
    v = jnp.asarray(rs.rand(n), jnp.float32)
    outs = sample_bundle(
        jnp.asarray(bundle),
        jnp.zeros(n, jnp.int32),
        jnp.full(n, 6, jnp.int32),
        jnp.full(n, 6, jnp.int32),
        u,
        v,
    )
    for k in range(4):
        per_map = sample_bilinear_pool(
            jnp.asarray(quads),
            jnp.full(n, 36 * k, jnp.int32),
            jnp.full(n, 6, jnp.int32),
            jnp.full(n, 6, jnp.int32),
            u,
            v,
        )
        if k in (0, 2):
            # albedo / normal carry full rgb
            np.testing.assert_array_equal(np.asarray(outs[k]), np.asarray(per_map))
        else:
            # roughness / metallic carry only the consumed .r channel,
            # broadcast across rgb (shading reads [:, 0])
            out = np.asarray(outs[k])
            np.testing.assert_array_equal(out[:, 0], np.asarray(per_map)[:, 0])
            np.testing.assert_array_equal(out[:, 1], out[:, 0])
            np.testing.assert_array_equal(out[:, 2], out[:, 0])


def test_bundle_scrambled_matches_rowmajor():
    # Hash-permuted bundle rows (pow2 texel count) must sample identically
    # to the row-major layout — the permutation is applied at build AND at
    # sample time, so values are bit-equal.
    from pathtracer.scene.scene import scramble_order

    rs = np.random.RandomState(3)
    w = h = 8                                      # 64 texels: pow2
    imgs = [rs.rand(h, w, 3).astype(np.float32) for _ in range(4)]
    quads = np.concatenate([make_texture_quads(im) for im in imgs])
    from pathtracer.scene.scene import pack_bundle_rows

    n_tex = w * h
    kq = [quads[n_tex * k : n_tex * (k + 1)] for k in range(4)]
    bundle = pack_bundle_rows(kq[0], kq[1], kq[2], kq[3], n_tex)
    scat = scramble_order(n_tex)
    assert sorted(scat) == list(range(n_tex))      # bijection
    sbundle = np.empty_like(bundle)
    sbundle[scat] = bundle

    n = 256
    u = jnp.asarray(rs.rand(n), jnp.float32)
    v = jnp.asarray(rs.rand(n), jnp.float32)
    args = (
        jnp.zeros(n, jnp.int32),
        jnp.full(n, w, jnp.int32),
        jnp.full(n, h, jnp.int32),
        u,
        v,
    )
    plain = sample_bundle(jnp.asarray(bundle), *args)
    scrm = sample_bundle(jnp.asarray(sbundle), *args, scrambled=True)
    for k in range(4):
        np.testing.assert_array_equal(np.asarray(plain[k]), np.asarray(scrm[k]))


def test_bundle_pow2_dims_matches_mod():
    """pow2_dims=True wraps texels with a bitwise AND; must equal the
    jnp.mod path bitwise, including the x0f == -1 wrap seam (u ~ 0)."""
    from pathtracer.scene.scene import pack_bundle_rows

    rs = np.random.RandomState(7)
    w, h = 8, 4
    imgs = [rs.rand(h, w, 3).astype(np.float32) for _ in range(4)]
    quads = np.concatenate([make_texture_quads(im) for im in imgs])
    n_tex = w * h
    kq = [quads[n_tex * k : n_tex * (k + 1)] for k in range(4)]
    bundle = jnp.asarray(pack_bundle_rows(kq[0], kq[1], kq[2], kq[3], n_tex))
    n = 128
    u = jnp.asarray(
        np.concatenate([np.zeros(8), np.full(8, 0.999), rs.rand(n - 16)]),
        jnp.float32,
    )
    v = jnp.asarray(
        np.concatenate([np.zeros(8), np.full(8, 0.999), rs.rand(n - 16)]),
        jnp.float32,
    )
    args = (
        jnp.zeros(n, jnp.int32),
        jnp.full(n, w, jnp.int32),
        jnp.full(n, h, jnp.int32),
        u,
        v,
    )
    a = sample_bundle(bundle, *args, pow2_dims=False)
    b = sample_bundle(bundle, *args, pow2_dims=True)
    for k in range(4):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
