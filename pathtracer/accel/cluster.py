"""Cluster accel: Morton-ordered triangle clusters with AABB culling.

Triangles (already Morton-permuted by `build_accel`) are sliced into
fixed-size clusters.  Two traversals share the structure:

* On the GPU, the Triton packet kernel (ops/intersect_pallas): each
  thread block walks the clusters front-to-back for its packet of sorted
  rays and skips a cluster when no ray of the packet overlaps it.
* Elsewhere (the CPU), a pure XLA scan over clusters whose `lax.cond`
  skips a cluster only when no ray in the whole batch overlaps it.

Both are the software analog of the reference's single-level GAS
(reference optixSphere.cpp:860-968).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.ops.intersect import Hit, _mt_block, finalize_hit
from pathtracer.utils import pytree

_BIG_PRIM = 0x7FFFFFFF

# Launch shapes of the traversal kernels (ops/intersect_pallas): rays per
# packet, triangles per test slice, warps per block.  Chosen by the sweep
# in tools/measure_gpu.py (kernels phase; PERF.md has the numbers).
KERNEL_SHAPES = {
    "closest": dict(rays_per_tile=16, tri_block=16, num_warps=4),
    "any": dict(rays_per_tile=128, tri_block=16, num_warps=4),
}


def use_kernel() -> bool:
    """Whether cluster traversal runs as the Triton kernel: on the GPU.
    Elsewhere it is the XLA scan.  No fallback: on the GPU a kernel
    compile failure raises."""
    return jax.default_backend() == "gpu"


@pytree.dataclass
class ClusterAccel:
    aabb_min: jnp.ndarray   # [C,3]
    aabb_max: jnp.ndarray   # [C,3]
    # Kernel layouts (ops/intersect_pallas): component-row triangle
    # clusters, 8-wide AABB rows, per-octant front-to-back visit orders,
    # and the scene bounds used for ray sort keys.
    tris16: jnp.ndarray     # [C,16,K] f32 (pack_cluster_tris layout)
    aabb8: jnp.ndarray      # [C,8] f32
    order: jnp.ndarray      # [8,C] i32
    scene_lo: jnp.ndarray   # [3] f32
    scene_hi: jnp.ndarray   # [3] f32
    # Two-level (supercluster) arrays: groups of `super_branch` Morton-
    # consecutive clusters with their own bounds and per-octant visit
    # order; child bounds padded to S*branch rows (far point boxes).
    aabb8_child: jnp.ndarray = None   # [S*B,8] f32
    aabb8_super: jnp.ndarray = None   # [S,8] f32
    order_super: jnp.ndarray = None   # [8,S] i32
    # static metadata
    cluster_size: int = pytree.field(static=True, default=128)
    super_branch: int = pytree.field(static=True, default=8)

    @property
    def num_clusters(self) -> int:
        return self.aabb_min.shape[0]

    def _want_sort(self, cfg) -> str:
        """Resolve cfg.sort_rays to the concrete mode for this scene:
        "" (off), "octant" or "spatial" (see config.sort_rays)."""
        if cfg.sort_rays in ("octant", "spatial"):
            return cfg.sort_rays
        if cfg.sort_rays == "off" or self.num_clusters < 2:
            return ""
        return "spatial"

    def _hier(self, cfg) -> bool:
        return (
            self.num_clusters >= cfg.hier_min_clusters
            and self.aabb8_super is not None
        )

    def _dir_bits(self, cfg) -> int:
        """Resolve cfg.sort_dir_bits for this scene: auto (0) = 3 bits for
        many-cluster scenes (>= 256), else 2; -1 = off."""
        if cfg.sort_dir_bits == 0:
            return 3 if self.num_clusters >= 256 else 2
        return max(cfg.sort_dir_bits, 0)

    def _sorted_rays(self, mode, origins, directions, cfg):
        from pathtracer.ops.intersect_pallas import octant_sort

        bits = cfg.sort_spatial_bits
        if bits == 0:   # auto: finer cells for compact scenes
            bits = 7 if self.num_clusters < 256 else 5
        return octant_sort(
            origins,
            directions,
            scene_lo=self.scene_lo,
            scene_hi=self.scene_hi,
            spatial_bits=bits if mode == "spatial" else 0,
            dir_bits=self._dir_bits(cfg),
        )

    def _kernel_args(self, cfg, t_min, t_max, query):
        """(operands, keyword arguments) of one kernel call."""
        kw = dict(KERNEL_SHAPES[query], t_min=float(t_min),
                  t_max=float(t_max))
        if cfg.pallas_rays_per_tile:
            kw["rays_per_tile"] = cfg.pallas_rays_per_tile
        if self._hier(cfg):
            kw.update(supers=(self.aabb8_super, self.order_super),
                      branch=self.super_branch)
            return (self.tris16, self.aabb8_child, self.order), kw
        return (self.tris16, self.aabb8, self.order), kw

    def intersect(self, vertices, origins, directions, t_min, t_max, cfg) -> Hit:
        """Closest hit over all clusters: the Triton packet kernel on the
        GPU (rays sorted for packet coherence first, see
        config.sort_rays), the XLA scan elsewhere.
        vertices: [T,3,3] Morton-permuted (T padded up to C*K internally).
        """
        if not use_kernel():
            return self._intersect_xla(
                vertices, origins, directions, t_min, t_max, cfg
            )
        from pathtracer.ops import intersect_pallas

        sort = self._want_sort(cfg)
        if sort:
            origins, directions, restore = self._sorted_rays(
                sort, origins, directions, cfg
            )
        operands, kw = self._kernel_args(cfg, t_min, t_max, "closest")
        best_t, best_prim, bary = intersect_pallas.intersect_clusters(
            *operands, origins, directions, **kw
        )
        if sort:
            best_t, best_prim, bary = (
                restore(best_t), restore(best_prim), restore(bary)
            )
        hit = best_prim != _BIG_PRIM
        # The kernel carries the winner's (t, prim, bary), so the Hit
        # assembles with no per-lane gathers (no finalize pass).
        return Hit(
            t=best_t,
            prim=jnp.where(hit, best_prim, -1),
            bary=jnp.where(hit[:, None], bary, 0.0),
            hit=hit,
        )

    def occluded(
        self, vertices, origins, directions, t_min, t_max, cfg, active=None
    ) -> jnp.ndarray:
        """Any-hit query over the cluster accel: True where the segment
        [t_min, t_max] is blocked.  The software `traceOcclusion`
        (reference optixSphere.cu:134-156) — cheaper than closest-hit:
        no distance ordering, no prim/barycentric tracking, and the
        kernel stops once a packet is fully occluded.

        `active=None` queries every lane.  With a mask, inactive lanes
        are PARKED: origin moved outside the scene AABB, direction +x —
        they fail every slab test, and because a parked origin clamps to
        the maximum Morton cell they share one sort key and compact into
        pure all-parked packets that skip all triangle work.  Parking is
        applied only when the batch is sorted: unsorted parked lanes
        would scatter through every packet and permanently block the
        kernel's all-occluded exit (a parked lane never occludes) while
        compacting nothing.  Their return value is unspecified (False on
        the kernel path); callers mask on `active`."""
        if not use_kernel():
            return self._occluded_xla(
                vertices, origins, directions, t_min, t_max
            )
        from pathtracer.ops import intersect_pallas

        sort = self._want_sort(cfg)
        if active is not None and sort:
            park = self.scene_hi + (self.scene_hi - self.scene_lo) + 1.0
            origins = jnp.where(active[:, None], origins, park[None, :])
            directions = jnp.where(
                active[:, None],
                directions,
                jnp.array([1.0, 0.0, 0.0], directions.dtype),
            )
        if sort:
            origins, directions, restore = self._sorted_rays(
                sort, origins, directions, cfg
            )
        operands, kw = self._kernel_args(cfg, t_min, t_max, "any")
        occ = intersect_pallas.occluded_clusters(
            *operands, origins, directions, **kw
        )
        return restore(occ) if sort else occ

    def _occluded_xla(self, vertices, origins, directions, t_min, t_max) -> jnp.ndarray:
        n = origins.shape[0]
        k = self.cluster_size
        c = self.num_clusters
        t_count = vertices.shape[0]
        pad = c * k - t_count
        if pad:
            vertices = jnp.concatenate(
                [vertices, jnp.zeros((pad, 3, 3), vertices.dtype)], axis=0
            )
        tri_blocks = vertices.reshape(c, k, 3, 3)

        ix, iy, iz = (
            jnp.where(jnp.abs(directions[:, a]) > 1e-12, 1.0 / directions[:, a], jnp.inf)
            for a in range(3)
        )
        ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
        occ0 = jnp.zeros_like(origins[:, 0], dtype=bool)

        def body(occ, inp):
            tri_block, bmin, bmax = inp
            tx0 = (bmin[0] - ox) * ix
            tx1 = (bmax[0] - ox) * ix
            ty0 = (bmin[1] - oy) * iy
            ty1 = (bmax[1] - oy) * iy
            tz0 = (bmin[2] - oz) * iz
            tz1 = (bmax[2] - oz) * iz
            tnear = jnp.maximum(
                jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                jnp.minimum(tz0, tz1),
            )
            tfar = jnp.minimum(
                jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                jnp.maximum(tz0, tz1),
            )
            overlap = (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_max) & ~occ

            def test(occ):
                _, _, _, valid = _mt_block(
                    origins, directions, tri_block, t_min, t_max
                )
                return occ | jnp.any(valid, axis=1)

            occ = jax.lax.cond(jnp.any(overlap), test, lambda o: o, occ)
            return occ, None

        occ, _ = jax.lax.scan(
            body, occ0, (tri_blocks, self.aabb_min, self.aabb_max)
        )
        return occ

    def _intersect_xla(self, vertices, origins, directions, t_min, t_max, cfg) -> Hit:
        n = origins.shape[0]
        k = self.cluster_size
        c = self.num_clusters
        t_count = vertices.shape[0]
        pad = c * k - t_count
        if pad:
            vertices = jnp.concatenate(
                [vertices, jnp.zeros((pad, 3, 3), vertices.dtype)], axis=0
            )
        tri_blocks = vertices.reshape(c, k, 3, 3)

        ix, iy, iz = (
            jnp.where(jnp.abs(directions[:, a]) > 1e-12, 1.0 / directions[:, a], jnp.inf)
            for a in range(3)
        )
        ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]

        # *_like keeps shard_map varying axes consistent across the carry.
        # Reduction-based bookkeeping (no argmin gathers); barycentrics
        # recomputed once at the end — see intersect_brute.
        init = (
            jnp.full_like(origins[:, 0], t_max),
            jnp.full_like(origins[:, 0], jnp.int32(0x7FFFFFFF), dtype=jnp.int32),
        )

        def body(carry, inp):
            best_t, best_prim = carry
            tri_block, bmin, bmax, base = inp

            # Slab test (component-unrolled): does any ray's live
            # [t_min, best_t] segment touch this cluster's AABB?
            tx0 = (bmin[0] - ox) * ix
            tx1 = (bmax[0] - ox) * ix
            ty0 = (bmin[1] - oy) * iy
            ty1 = (bmax[1] - oy) * iy
            tz0 = (bmin[2] - oz) * iz
            tz1 = (bmax[2] - oz) * iz
            tnear = jnp.maximum(
                jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                jnp.minimum(tz0, tz1),
            )
            tfar = jnp.minimum(
                jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                jnp.maximum(tz0, tz1),
            )
            overlap = (tnear <= tfar) & (tfar >= t_min) & (tnear <= best_t)
            any_hit = jnp.any(overlap)

            def test(carry):
                best_t, best_prim = carry
                t, u, v, valid = _mt_block(
                    origins, directions, tri_block, t_min, t_max
                )
                t = jnp.where(valid, t, jnp.inf)
                t_blk = jnp.min(t, axis=1)
                lane = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
                prim_blk = jnp.min(
                    jnp.where(
                        t == t_blk[:, None], base + lane, jnp.int32(0x7FFFFFFF)
                    ),
                    axis=1,
                )
                closer = t_blk < best_t
                return (
                    jnp.where(closer, t_blk, best_t),
                    jnp.where(closer, prim_blk, best_prim),
                )

            carry = jax.lax.cond(any_hit, test, lambda x: x, carry)
            return carry, None

        bases = (jnp.arange(c) * k).astype(jnp.int32)
        (best_t, best_prim), _ = jax.lax.scan(
            body, init, (tri_blocks, self.aabb_min, self.aabb_max, bases)
        )
        return finalize_hit(
            vertices, origins, directions, best_t, best_prim, t_min, t_max
        )


def build_cluster_accel(vertices: np.ndarray, cluster_size: int = 128, super_branch: int = 8) -> ClusterAccel:
    """Build cluster AABBs over Morton-permuted [T,3,3] vertices."""
    t_count = vertices.shape[0]
    c = max(1, -(-t_count // cluster_size))
    pad = c * cluster_size - t_count
    v = vertices
    if pad:
        # Padding triangles collapse to the last real vertex so they do not
        # inflate the final cluster's AABB.
        fill = np.broadcast_to(v[-1, -1], (pad, 3, 3)) if t_count else np.zeros((pad, 3, 3), np.float32)
        v = np.concatenate([v, fill], axis=0)
    blocks = v.reshape(c, cluster_size, 3, 3)
    amin = blocks.reshape(c, -1, 3).min(axis=1)
    amax = blocks.reshape(c, -1, 3).max(axis=1)

    from pathtracer.ops.intersect_pallas import octant_orders, pack_cluster_tris

    aabb8 = np.zeros((c, 8), np.float32)
    aabb8[:, 0:3] = amin
    aabb8[:, 3:6] = amax

    # Supercluster level: groups of `branch` Morton-consecutive clusters.
    branch = super_branch
    s = -(-c // branch)
    child = np.zeros((s * branch, 8), np.float32)
    # Padding children are POINT boxes at 3e37: the slab test is
    # order-agnostic (an "inverted" min>max box behaves exactly like the
    # box spanning the two corners — it does NOT fail), but a far point
    # box yields tnear ~ 3e37/|d| >> t_max and never overlaps.
    child[:, 0:3] = 3.0e37
    child[:, 3:6] = 3.0e37
    child[:c] = aabb8
    super8 = np.zeros((s, 8), np.float32)
    # Super bounds from REAL children only (the far-point pads would
    # otherwise blow up the final group's box).
    for g in range(s):
        real = aabb8[g * branch : min((g + 1) * branch, c)]
        super8[g, 0:3] = real[:, 0:3].min(axis=0)
        super8[g, 3:6] = real[:, 3:6].max(axis=0)

    flat = vertices.reshape(-1, 3) if t_count else np.zeros((1, 3), np.float32)
    return ClusterAccel(
        aabb_min=jnp.asarray(amin, jnp.float32),
        aabb_max=jnp.asarray(amax, jnp.float32),
        tris16=jnp.asarray(pack_cluster_tris(vertices, cluster_size)),
        aabb8=jnp.asarray(aabb8),
        order=jnp.asarray(octant_orders(aabb8)),
        scene_lo=jnp.asarray(flat.min(axis=0), jnp.float32),
        scene_hi=jnp.asarray(flat.max(axis=0), jnp.float32),
        aabb8_child=jnp.asarray(child),
        aabb8_super=jnp.asarray(super8),
        order_super=jnp.asarray(octant_orders(super8)),
        cluster_size=cluster_size,
        super_branch=branch,
    )
