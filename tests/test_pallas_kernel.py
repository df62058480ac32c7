"""Triton packet-traversal kernels vs brute force.

The kernels run through the Pallas interpreter here (`interpret=True`,
the only way the tests reach interpret mode); `test_kernels_lower_for_cuda`
lowers the same kernels for the CUDA platform, which runs the Triton
lowering on the CPU without a card.  Tests marked `gpu` compile and run
them on the card (the `gpu` fixture in tests/conftest.py decides whether
one is present)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel import cluster
from pathtracer.accel.build import build_accel
from pathtracer.ops import intersect_pallas as ip
from pathtracer.ops.intersect import intersect_brute, occluded_brute
from pathtracer.ops.intersect_pallas import (
    intersect_clusters,
    occluded_clusters,
    pack_cluster_tris,
)
from pathtracer.scene.procedural import three_spheres_scene


@pytest.fixture(scope="module")
def clustered():
    return build_accel(
        three_spheres_scene(stacks=6, slices=12), kind="cluster", cluster_size=64
    )


@pytest.fixture(scope="module")
def many_clusters():
    # cluster_size=8 over the three-spheres scene: ~150 clusters / ~19
    # supers — partial groups and far-point padding children.
    return build_accel(
        three_spheres_scene(stacks=10, slices=20), kind="cluster",
        cluster_size=8,
    )


@pytest.fixture
def kernel_route(monkeypatch):
    """Route ClusterAccel through the kernels (as on the GPU), run by the
    Pallas interpreter."""
    monkeypatch.setattr(cluster, "use_kernel", lambda: True)
    monkeypatch.setattr(ip, "intersect_clusters",
                        functools.partial(intersect_clusters, interpret=True))
    monkeypatch.setattr(ip, "occluded_clusters",
                        functools.partial(occluded_clusters, interpret=True))


def rays(n, seed):
    rs = np.random.RandomState(seed)
    o = jnp.asarray((rs.randn(n, 3) * 3).astype(np.float32))
    d = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    return o, d


def run_kernel(scene, o, d, r=128, tri_block=1, t_max=1e16):
    acc = scene.accel
    bt, bp, buv = intersect_clusters(
        acc.tris16, acc.aabb8, acc.order, o, d, t_min=0.01, t_max=t_max,
        rays_per_tile=r, tri_block=tri_block, interpret=True,
    )
    prim = np.where(np.asarray(bp) == 0x7FFFFFFF, -1, np.asarray(bp))
    return np.asarray(bt), prim, np.asarray(buv)


@pytest.mark.parametrize("tri_block", [1, 4, 16])
@pytest.mark.parametrize("r", [16, 128])
def test_kernel_matches_brute(clustered, tri_block, r):
    o, d = rays(256, 0)
    bt, prim, buv = run_kernel(clustered, o, d, r=r, tri_block=tri_block)
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))
    hit = prim >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(bt[hit], np.asarray(hb.t)[hit], rtol=1e-5)
    # Kernel-carried winner barycentrics match the finalize recompute.
    np.testing.assert_allclose(
        buv[hit], np.asarray(hb.bary)[hit], rtol=1e-4, atol=1e-6
    )


@pytest.mark.parametrize("r", [32, 64])
def test_kernel_ray_padding(clustered, r):
    # N not a multiple of rays_per_tile: padding lanes must not alias.
    o, d = rays(100, 1)
    _, prim, _ = run_kernel(clustered, o, d, r=r)
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))


def test_kernel_segment_tmax(clustered):
    # A finite t_max clips closest hits exactly like brute force.
    o, d = rays(256, 8)
    bt, prim, _ = run_kernel(clustered, o, d, t_max=3.0)
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 3.0)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))
    assert (prim >= 0).any() and (bt[prim >= 0] < 3.0).all()


@pytest.mark.parametrize("tri_block", [1, 16])
def test_kernel_infinite_tmax(clustered, tri_block):
    """t_max = inf: a triangle slice with no hit (t = inf) must not win
    the lowest-prim tie rule against an unhit ray's best t (also inf)."""
    o, d = rays(256, 9)
    bt, prim, _ = run_kernel(clustered, o, d, tri_block=tri_block,
                             t_max=float("inf"))
    hb = intersect_brute(clustered.vertices, o, d, 0.01, float("inf"))
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))
    hit = prim >= 0
    assert hit.any() and not hit.all()
    assert np.isinf(bt[~hit]).all()
    np.testing.assert_allclose(bt[hit], np.asarray(hb.t)[hit], rtol=1e-5)


def test_occlusion_infinite_tmax(clustered):
    o, d = rays(256, 10)
    acc = clustered.accel
    occ = occluded_clusters(acc.tris16, acc.aabb8, acc.order, o, d,
                            t_min=0.01, t_max=float("inf"), rays_per_tile=64,
                            interpret=True)
    want = np.asarray(occluded_brute(clustered.vertices, o, d, 0.01,
                                     float("inf")))
    np.testing.assert_array_equal(np.asarray(occ), want)
    assert want.any() and not want.all()


def test_kernel_launch_shape_validation(clustered):
    acc = clustered.accel
    o, d = rays(8, 0)
    with pytest.raises(ValueError):
        intersect_clusters(acc.tris16, acc.aabb8, acc.order, o, d,
                           rays_per_tile=96, interpret=True)
    with pytest.raises(ValueError):
        intersect_clusters(acc.tris16, acc.aabb8, acc.order, o, d,
                           tri_block=3, interpret=True)


def test_pack_cluster_tris_layout():
    verts = np.asarray(
        [[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32
    )
    packed = pack_cluster_tris(verts, cluster_size=4)
    assert packed.shape == (1, 16, 4)            # [C, 16 rows, K]
    np.testing.assert_allclose(packed[0, 0:3, 0], [0, 0, 0])   # v0
    np.testing.assert_allclose(packed[0, 3:6, 0], [1, 0, 0])   # e1
    np.testing.assert_allclose(packed[0, 6:9, 0], [0, 1, 0])   # e2
    # padding triangles are all-zero (degenerate, det == 0)
    np.testing.assert_allclose(packed[0, :, 1:], 0.0)


def test_kernel_route_render_matches_xla_route(clustered, kernel_route):
    """A render through the kernel route (sorted packets) agrees with the
    XLA cluster scan (the CPU route) up to rounding of the kernel-carried
    barycentrics."""
    from pathtracer.config import RenderConfig
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import camera_arrays, render_frame

    cfg = RenderConfig(width=24, height=16, samples_per_launch=2,
                       max_depth=3, dof=False, env_mode="constant",
                       intersector="cluster")
    cam = camera_arrays(Camera(), cfg)
    img_k = np.asarray(render_frame(clustered, cam, cfg, jnp.int32(0)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cluster, "use_kernel", lambda: False)
        # another static config so render_frame retraces on this route
        img_x = np.asarray(render_frame(
            clustered, cam, cfg.replace(pallas_rays_per_tile=64),
            jnp.int32(0),
        ))
    close = np.isclose(img_k, img_x, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.995, f"kernel vs xla pixel agreement {close.mean()}"


@pytest.mark.parametrize("tri_block", [1, 8])
def test_occlusion_kernel_matches_brute(clustered, tri_block):
    o, d = rays(300, 2)
    acc = clustered.accel
    occ_k = np.asarray(occluded_clusters(
        acc.tris16, acc.aabb8, acc.order, o, d, rays_per_tile=64,
        tri_block=tri_block, interpret=True,
    ))
    occ_b = np.asarray(occluded_brute(clustered.vertices, o, d, 0.01, 1e16))
    np.testing.assert_array_equal(occ_k, occ_b)
    assert occ_b.any() and not occ_b.all()


def test_occlusion_active_mask_parks_inactive(clustered, kernel_route):
    """ClusterAccel.occluded(active=mask) on the kernel route: active lanes
    return exactly the unmasked result, and the parking transform (origin
    outside the scene AABB, direction +x — see ClusterAccel.occluded)
    makes every parked ray miss everything in the any-hit kernel."""
    from pathtracer.config import RenderConfig

    rs = np.random.RandomState(7)
    o, d = rays(300, 7)
    mask = jnp.asarray(rs.rand(300) < 0.4)
    acc = clustered.accel
    cfg = RenderConfig(width=8, height=8, intersector="cluster")
    full = np.asarray(acc.occluded(clustered.vertices, o, d, 0.01, 1e16, cfg))
    masked = np.asarray(
        acc.occluded(clustered.vertices, o, d, 0.01, 1e16, cfg, active=mask)
    )
    m = np.asarray(mask)
    np.testing.assert_array_equal(masked[m], full[m])
    want = np.asarray(occluded_brute(clustered.vertices, o, d, 0.01, 1e16))
    np.testing.assert_array_equal(full, want)

    park = acc.scene_hi + (acc.scene_hi - acc.scene_lo) + 1.0
    o_park = jnp.broadcast_to(park[None, :], (300, 3))
    d_park = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), (300, 3))
    occ_park = np.asarray(occluded_clusters(
        acc.tris16, acc.aabb8, acc.order, o_park, d_park,
        rays_per_tile=64, interpret=True,
    ))
    assert not occ_park.any()


def test_occlusion_xla_matches_brute(clustered):
    o, d = rays(300, 3)
    occ_x = np.asarray(clustered.accel._occluded_xla(
        clustered.vertices, o, d, 0.01, 1e16
    ))
    occ_b = np.asarray(occluded_brute(clustered.vertices, o, d, 0.01, 1e16))
    np.testing.assert_array_equal(occ_x, occ_b)


def test_occlusion_segment_tmax(clustered):
    # A finite t_max must pass segments that END before the geometry.
    o = jnp.asarray([[0.0, 0.5, 8.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    acc = clustered.accel
    far = occluded_clusters(acc.tris16, acc.aabb8, acc.order, o, d,
                            t_min=0.01, t_max=1e16, rays_per_tile=64,
                            interpret=True)
    near = occluded_clusters(acc.tris16, acc.aabb8, acc.order, o, d,
                             t_min=0.01, t_max=1.0, rays_per_tile=64,
                             interpret=True)
    assert bool(far[0]) == bool(
        occluded_brute(clustered.vertices, o, d, 0.01, 1e16)[0]
    )
    assert not bool(near[0])


def test_octant_sort_roundtrip_and_kernel_equivalence(clustered):
    """octant_sort + kernel + restore == brute: the permutation must be a
    bijection and per-ray results must land back on their source lanes."""
    from pathtracer.ops.intersect_pallas import octant_sort

    o, d = rays(256, 2)
    o_s, d_s, restore = octant_sort(o, d)
    # sorted keys are non-decreasing and the permutation restores inputs
    key = lambda dd: (
        (np.asarray(dd)[:, 0] > 0).astype(int)
        + 2 * (np.asarray(dd)[:, 1] > 0).astype(int)
        + 4 * (np.asarray(dd)[:, 2] > 0).astype(int)
    )
    assert (np.diff(key(d_s)) >= 0).all()
    np.testing.assert_array_equal(np.asarray(restore(o_s)), np.asarray(o))
    np.testing.assert_array_equal(np.asarray(restore(d_s)), np.asarray(d))

    bt_s, prim_s, buv_s = run_kernel(clustered, o_s, d_s)
    bt = np.asarray(restore(jnp.asarray(bt_s)))
    prim = np.asarray(restore(jnp.asarray(prim_s)))
    buv = np.asarray(restore(jnp.asarray(buv_s)))
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))
    hit = prim >= 0
    np.testing.assert_allclose(bt[hit], np.asarray(hb.t)[hit], rtol=1e-5)
    np.testing.assert_allclose(
        buv[hit], np.asarray(hb.bary)[hit], rtol=1e-4, atol=1e-6
    )


def test_spatial_sort_roundtrip(clustered):
    """(origin Morton, octant) key: still a bijection that restores
    per-ray results."""
    from pathtracer.ops.intersect_pallas import octant_sort

    o, d = rays(200, 5)
    acc = clustered.accel
    o_s, d_s, restore = octant_sort(
        o, d, scene_lo=acc.scene_lo, scene_hi=acc.scene_hi, spatial_bits=5
    )
    np.testing.assert_array_equal(np.asarray(restore(o_s)), np.asarray(o))
    np.testing.assert_array_equal(np.asarray(restore(d_s)), np.asarray(d))
    _, prim_s, _ = run_kernel(clustered, o_s, d_s)
    prim = np.asarray(restore(jnp.asarray(prim_s)))
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))


def test_dir_bits_sort_roundtrip(clustered):
    """dir_bits-refined key: still a bijection; refined keys stay
    octant-major (the magnitude bits sit BELOW the octant bits); kernel
    results restore to brute exactly; u32 overflow clamp engages."""
    from pathtracer.ops.intersect_pallas import octant_sort, ray_sort_key

    o, d = rays(200, 7)
    acc = clustered.accel
    o_s, d_s, restore = octant_sort(
        o, d, scene_lo=acc.scene_lo, scene_hi=acc.scene_hi,
        spatial_bits=5, dir_bits=2,
    )
    np.testing.assert_array_equal(np.asarray(restore(o_s)), np.asarray(o))
    np.testing.assert_array_equal(np.asarray(restore(d_s)), np.asarray(d))
    _, prim_s, _ = run_kernel(clustered, o_s, d_s)
    prim = np.asarray(restore(jnp.asarray(prim_s)))
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))

    # Refinement only reorders WITHIN (cell, octant) groups: stripping
    # the low dir bits recovers the unrefined key order.
    k_fine = np.asarray(ray_sort_key(o, d, acc.scene_lo, acc.scene_hi, 5, 2))
    k_base = np.asarray(ray_sort_key(o, d, acc.scene_lo, acc.scene_hi, 5))
    np.testing.assert_array_equal(k_fine >> 6, k_base)
    # 3*7 spatial + 3 octant leaves 2 dir bits of u32 headroom; 4 must
    # clamp to 2, not overflow.
    k7 = np.asarray(ray_sort_key(o, d, acc.scene_lo, acc.scene_hi, 7, 4))
    np.testing.assert_array_equal(
        k7, np.asarray(ray_sort_key(o, d, acc.scene_lo, acc.scene_hi, 7, 2))
    )


def test_hier_kernel_matches_brute(many_clusters):
    """Two-level (supercluster) walk vs brute on a many-cluster scene."""
    acc = many_clusters.accel
    assert acc.num_clusters >= 100
    o, d = rays(256, 4)
    bt, bp, buv = intersect_clusters(
        acc.tris16, acc.aabb8_child, acc.order, o, d,
        supers=(acc.aabb8_super, acc.order_super), branch=acc.super_branch,
        rays_per_tile=128, tri_block=4, interpret=True,
    )
    prim = np.where(np.asarray(bp) == 0x7FFFFFFF, -1, np.asarray(bp))
    hb = intersect_brute(many_clusters.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(prim, np.asarray(hb.prim))
    hit = prim >= 0
    np.testing.assert_allclose(
        np.asarray(bt)[hit], np.asarray(hb.t)[hit], rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(buv)[hit], np.asarray(hb.bary)[hit], rtol=1e-4, atol=1e-6
    )
    assert hit.sum() > 50


def test_hier_occlusion_matches_brute(many_clusters):
    acc = many_clusters.accel
    o, d = rays(200, 6)
    occ = occluded_clusters(
        acc.tris16, acc.aabb8_child, acc.order, o, d,
        supers=(acc.aabb8_super, acc.order_super), branch=acc.super_branch,
        rays_per_tile=128, interpret=True,
    )
    want = occluded_brute(many_clusters.vertices, o, d, 0.01, 1e16)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(want))
    assert np.asarray(want).sum() > 20


@pytest.mark.parametrize("query", ["closest", "any", "closest-two-level"])
def test_kernels_lower_for_cuda(many_clusters, query):
    """The Triton lowering accepts both kernels (and the two-level walk)
    at a real launch shape: every primitive in the kernel bodies has a
    Pallas-Triton lowering rule.  Lowering for a platform needs no
    device, so this runs on the CPU."""
    acc = many_clusters.accel
    o, d = rays(1024, 0)
    kw = dict(rays_per_tile=128, tri_block=4, num_warps=4)
    if query == "any":
        def fn(o, d):
            return occluded_clusters(acc.tris16, acc.aabb8, acc.order,
                                     o, d, **kw)
    elif query == "closest":
        def fn(o, d):
            return intersect_clusters(acc.tris16, acc.aabb8, acc.order,
                                      o, d, **kw)
    else:
        def fn(o, d):
            return intersect_clusters(
                acc.tris16, acc.aabb8_child, acc.order, o, d,
                supers=(acc.aabb8_super, acc.order_super),
                branch=acc.super_branch, **kw)
    text = jax.jit(fn).trace(o, d).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert ("occluded_kernel" if query == "any" else "closest_kernel") in text


@pytest.mark.gpu
def test_kernels_on_card_match_brute(gpu, clustered):
    """On the card: the compiled Triton kernels agree with brute force."""
    o, d = rays(4096, 21)
    acc = clustered.accel
    _, bp, _ = intersect_clusters(acc.tris16, acc.aabb8, acc.order, o, d)
    hb = intersect_brute(clustered.vertices, o, d, 0.01, 1e16)
    prim = np.where(np.asarray(bp) == 0x7FFFFFFF, -1, np.asarray(bp))
    assert (prim == np.asarray(hb.prim)).mean() >= 0.9999
    occ = occluded_clusters(acc.tris16, acc.aabb8, acc.order, o, d)
    want = occluded_brute(clustered.vertices, o, d, 0.01, 1e16)
    assert (np.asarray(occ) == np.asarray(want)).mean() >= 0.9999
