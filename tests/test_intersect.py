"""Möller–Trumbore intersection tests vs analytic known hits
(SURVEY.md §4 tier 1/2)."""

import jax.numpy as jnp
import numpy as np

from pathtracer.ops.intersect import intersect_brute


def unit_triangle():
    # Triangle in z=0 plane: (0,0,0), (1,0,0), (0,1,0)
    return jnp.asarray(
        [[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], jnp.float32
    )


def test_center_hit():
    tris = unit_triangle()
    o = jnp.asarray([[0.25, 0.25, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect_brute(tris, o, d, 1e-3, 1e16)
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.bary[0]), [0.25, 0.25], atol=1e-6)
    assert int(h.prim[0]) == 0


def test_miss_outside():
    tris = unit_triangle()
    o = jnp.asarray([[0.9, 0.9, 1.0]], jnp.float32)  # u+v > 1
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect_brute(tris, o, d, 1e-3, 1e16)
    assert not bool(h.hit[0])
    assert int(h.prim[0]) == -1


def test_backface_hit_two_sided():
    # Reference triangles are two-sided (no OptiX culling flags).
    tris = unit_triangle()
    o = jnp.asarray([[0.25, 0.25, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    h = intersect_brute(tris, o, d, 1e-3, 1e16)
    assert bool(h.hit[0])


def test_tmin_respected():
    tris = unit_triangle()
    o = jnp.asarray([[0.25, 0.25, 0.005]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect_brute(tris, o, d, 0.01, 1e16)
    assert not bool(h.hit[0])  # hit at t=0.005 < tmin


def test_closest_of_two():
    tris = jnp.asarray(
        [
            [[-1, -1, -2.0], [3, -1, -2.0], [-1, 3, -2.0]],
            [[-1, -1, -1.0], [3, -1, -1.0], [-1, 3, -1.0]],
        ],
        jnp.float32,
    )
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect_brute(tris, o, d, 1e-3, 1e16)
    assert int(h.prim[0]) == 1
    np.testing.assert_allclose(float(h.t[0]), 1.0, atol=1e-6)


def test_blocked_matches_unblocked():
    # Random soup: block size must not change results.
    rs = np.random.RandomState(3)
    tris = jnp.asarray(rs.randn(37, 3, 3).astype(np.float32))
    o = jnp.asarray(rs.randn(64, 3).astype(np.float32) * 3)
    d = jnp.asarray(rs.randn(64, 3).astype(np.float32))
    h1 = intersect_brute(tris, o, d, 1e-3, 1e16, block=8)
    h2 = intersect_brute(tris, o, d, 1e-3, 1e16, block=64)
    np.testing.assert_array_equal(np.asarray(h1.prim), np.asarray(h2.prim))
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), rtol=1e-6)


def test_sphere_analytic():
    # Rays at a triangulated sphere hit near the analytic distance.
    from pathtracer.scene.procedural import sphere_mesh

    verts, _ = sphere_mesh((0.0, 0.0, 0.0), 1.0, stacks=64, slices=128)
    tris = jnp.asarray(verts)
    o = jnp.asarray([[0.0, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect_brute(tris, o, d, 1e-3, 1e16)
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 4.0) < 5e-3  # mesh slightly inside the sphere


def test_occluded_matches_closest_hit():
    from pathtracer.ops.intersect import occluded_brute

    rs = np.random.RandomState(5)
    tris = jnp.asarray(rs.randn(37, 3, 3).astype(np.float32))
    o = jnp.asarray(rs.randn(128, 3).astype(np.float32) * 3)
    d = jnp.asarray(rs.randn(128, 3).astype(np.float32))
    occ = occluded_brute(tris, o, d, 1e-3, 1e16)
    h = intersect_brute(tris, o, d, 1e-3, 1e16)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(h.hit))
