"""Texture mip/LOD ladder.

Scenes whose bundled texture pool exceeds `mip_min_pool_bytes` get a
box-filtered mip pool that fits the mip budget.
These tests pin the build (exact box-filter means, budget respected), the
sampling semantics (constant maps bitwise-identical across every mode;
split mode exact for primary segments) and the no-op guarantee for small
pools (goldens/parity unaffected).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera
from pathtracer.render.integrator import camera_arrays, render_frame
from pathtracer.scene.scene import (
    MAT_MIP_OFFSET,
    MAT_MIP_WIDTH,
    MAT_MIP_HEIGHT,
    make_material_table,
    make_texture_quads,
)
from pathtracer.scene.procedural import single_sphere_scene


def _table(img, budget_bytes=8 * 8 * 32, **extra):
    quads = make_texture_quads(img)
    w, h = img.shape[1], img.shape[0]
    mats = [dict(color=(0.5, 0.5, 0.5), roughness=0.4,
                 maps={"albedo": (0, w, h), "roughness": (0, w, h)},
                 **extra)]
    return make_material_table(
        mats, quads, mip_budget_bytes=budget_bytes, mip_min_pool_bytes=0
    )


def _scene_with(table):
    sph = single_sphere_scene(stacks=8, slices=16)
    return sph.replace(
        materials=table,
        mat_ids=jnp.zeros_like(sph.mat_ids),
        tri_attrs=sph.tri_attrs.at[:, 24].set(0.0),
    )


def _render(scene, mode, max_depth=3):
    cfg = RenderConfig(
        width=32, height=24, samples_per_launch=2, max_depth=max_depth,
        env_mode="constant", dof=False, texture_lod=mode,
    )
    cam = camera_arrays(Camera(), cfg)
    return np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))


def test_mip_pool_is_exact_box_filter():
    """Mip rows hold the exact 2^L box-filter mean of the u8 source."""
    rng = np.random.RandomState(3)
    img = rng.rand(16, 16, 3).astype(np.float32)
    tab = _table(img, budget_bytes=4 * 4 * 32)   # forces 16x16 -> 4x4
    assert tab.mip_level == 2
    assert np.asarray(tab.attrs)[0, MAT_MIP_WIDTH] == 4.0
    assert np.asarray(tab.attrs)[0, MAT_MIP_HEIGHT] == 4.0

    # Expected: quantise to u8 (the pool's storage), then exact box mean.
    u8 = np.clip(np.round(img.astype(np.float64) * 255.0), 0, 255)
    blocks = u8.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    expect = np.clip(np.round(blocks), 0, 255).astype(np.uint8)

    # Read texel (x,y) back through the pool: sample_bundle at the texel
    # centre is an exact fetch (s == t == 0.5 lands on the 2x2 quad whose
    # corner c00 is the texel when u=(x+0.5)/w...) — simpler: decode the
    # pool rows directly, undoing the scramble.
    from pathtracer.scene.scene import scramble_order

    pool = np.asarray(tab.texture_bundles_mip)
    off = int(np.asarray(tab.attrs)[0, MAT_MIP_OFFSET])
    rows = pool[off : off + 16]
    if tab.mip_scrambled:
        rows = rows[scramble_order(16)]            # hashed pos -> row-major
    word_a = rows[:, 0].reshape(4, 4)              # c00: albedo.rgb|rough.r
    got = np.stack(
        [(word_a >> (8 * c)) & 0xFF for c in range(3)], axis=-1
    ).astype(np.uint8)
    np.testing.assert_array_equal(got, expect)


def test_mip_budget_respected():
    img = np.zeros((64, 64, 3), np.float32)
    budget = 8 * 8 * 32
    tab = _table(img, budget_bytes=budget)
    assert tab.texture_bundles_mip is not None
    # +1 sink row of 32 B
    assert tab.texture_bundles_mip.nbytes <= budget + 32


def test_small_pool_builds_no_mip():
    """Default thresholds: small pools never get a ladder, so every
    texture_lod mode is exactly 'off' for them (goldens unaffected)."""
    img = np.zeros((32, 32, 3), np.float32)
    quads = make_texture_quads(img)
    tab = make_material_table(
        [dict(color=(0.5,) * 3, maps={"albedo": (0, 32, 32)})], quads
    )
    assert tab.mip_level == 0 and tab.texture_bundles_mip is None


@pytest.mark.parametrize("mode", ["mip", "split", "auto"])
def test_constant_texture_all_modes_bitwise(mode):
    """Box-filtering a constant map is the identity: every LOD mode must
    render bitwise-identically to 'off'."""
    img = np.full((32, 32, 3), 0.3, np.float32)
    scene = _scene_with(_table(img))
    assert scene.materials.mip_level > 0
    a = _render(scene, "off")
    b = _render(scene, mode)
    assert a.max() > 0.0
    np.testing.assert_array_equal(a, b)


def test_split_mode_primary_segments_exact():
    """texture_lod='split' samples the full-res pool for primary path
    segments: with max_depth=1 (every traced segment primary) the render
    is bitwise 'off' even for a non-constant map, while 'mip' differs."""
    rng = np.random.RandomState(1)
    img = rng.rand(32, 32, 3).astype(np.float32)
    scene = _scene_with(_table(img))
    a = _render(scene, "off", max_depth=1)
    b = _render(scene, "split", max_depth=1)
    c = _render(scene, "mip", max_depth=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_mip_render_close_to_off():
    """LOD is an approximation, not an estimator change: images stay
    close (smooth map => tiny mip error)."""
    x = np.linspace(0.0, 1.0, 32, dtype=np.float32)
    img = np.stack(np.broadcast_arrays(x[None, :], x[:, None], 0.5 * x[None, :]), axis=-1)
    scene = _scene_with(_table(np.ascontiguousarray(img)))
    a = _render(scene, "off")
    b = _render(scene, "mip")
    assert np.abs(a - b).max() < 0.05


def test_auto_resolves_to_off():
    """'auto' = off (measured refutation, see config.texture_lod): even
    with a mip pool present and a non-constant map, auto renders bitwise
    identical to off."""
    rng = np.random.RandomState(2)
    img = rng.rand(32, 32, 3).astype(np.float32)
    scene = _scene_with(_table(img))
    assert scene.materials.mip_level > 0
    np.testing.assert_array_equal(_render(scene, "off"), _render(scene, "auto"))
