"""Pallas/Triton kernels: packet-style cluster traversal on the GPU.

This is the software replacement for the reference's hardware ray-tracing
core (`optixTraverse` over a driver-built BVH + SER re-sorting, reference
optixSphere.cu:99-118).  The card has no RT cores exposed to JAX, so the
traversal is a packet traversal over Morton-ordered triangle clusters:

* One program (thread block) owns a packet of R sorted rays; the grid
  covers the ray batch and its blocks run in parallel, in no order.
* The block walks the clusters front-to-back in its packet's direction
  octant, loading each cluster's bounds from global memory.  A slab test
  of all R rays against the cluster AABB (against each ray's *current*
  best t) reduces to one scalar, and the cluster's triangle tests run
  only when some ray of the packet can hit it.  The branch is uniform
  across the block, so it is a real branch on the GPU — what XLA's
  batch-level `lax.cond` (the XLA path in accel/cluster.py) cannot
  express, since its predicate spans the whole launch.
* A visited cluster's triangle rows ([16,K] f32, component-row layout)
  are read from HBM/L2 in `tri_block`-triangle slices and tested against
  the packet as dense (R, tri_block) f32 tiles; the running best
  (t, prim, barycentrics) stays in registers for the whole loop.
* `branch > 0` adds an outer loop over super-clusters (groups of
  `branch` Morton-consecutive clusters with their own bounds), so one
  slab test can skip `branch` clusters.

All arithmetic is f32 and elementwise; no tensor cores are involved.
Coherence (the reference's `optixReorder`) comes from outside: rays can
be octant/Morton-sorted (`octant_sort`) before the trace.

`interpret=True` runs the same kernel bodies through the Pallas
interpreter on any backend; the tests use it on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_BIG_PRIM = np.int32(0x7FFFFFFF)
# Padding rays start here and point +x: they miss every cluster.
_FAR = 3.0e37


# ---------------------------------------------------------------------------
# Kernel-body helpers.  Every traversal kernel (closest-hit / any-hit, flat
# / two-level) is the same three primitives composed differently; keeping
# them in one place stops the tnear/tfar/t_min gating and the test epsilon
# conventions from drifting between copies.
# ---------------------------------------------------------------------------


def _packet_rays(rays_ref):
    """Packet-ray tuple from an (8,R) ray block: origin/direction (R,1)
    columns plus guarded inverse directions (|d| <= 1e-12 -> huge, so
    degenerate slabs cull cleanly)."""
    ox, oy, oz, dx, dy, dz = (rays_ref[j, :][:, None] for j in range(6))
    big = jnp.float32(3.4e38)
    ix = jnp.where(jnp.abs(dx) > 1e-12, 1.0 / dx, big)
    iy = jnp.where(jnp.abs(dy) > 1e-12, 1.0 / dy, big)
    iz = jnp.where(jnp.abs(dz) > 1e-12, 1.0 / dz, big)
    return ox, oy, oz, dx, dy, dz, ix, iy, iz


def _packet_octant(rays_ref):
    """Packet octant from the first ray's direction.  Sorted packets are
    near-uniform; a mixed packet only loses ordering quality, never
    correctness."""
    return (
        (rays_ref[3, 0] > 0.0).astype(jnp.int32)
        + 2 * (rays_ref[4, 0] > 0.0).astype(jnp.int32)
        + 4 * (rays_ref[5, 0] > 0.0).astype(jnp.int32)
    )


def _bounds(ref, idx):
    """Six AABB bound scalars from row `idx` of a [*,8] table."""
    return tuple(ref[idx, j] for j in range(6))


def _any(mask):
    """Block-wide OR of a bool tile as a scalar bool."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _slab_hits(bounds, pr, t_min, t_limit):
    """Packet slab test vs one AABB: (R,1) bool.

    `t_limit` gates the near plane — the per-lane running best t for
    closest-hit kernels (closed lanes shrink the packet) or the scalar
    t_max for any-hit."""
    bminx, bminy, bminz, bmaxx, bmaxy, bmaxz = bounds
    ox, oy, oz, _, _, _, ix, iy, iz = pr
    tx0 = (bminx - ox) * ix
    tx1 = (bmaxx - ox) * ix
    ty0 = (bminy - oy) * iy
    ty1 = (bmaxy - oy) * iy
    tz0 = (bminz - oz) * iz
    tz1 = (bmaxz - oz) * iz
    tnear = jnp.maximum(
        jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
        jnp.minimum(tz0, tz1),
    )
    tfar = jnp.minimum(
        jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
        jnp.maximum(tz0, tz1),
    )
    return (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_limit)


def _mt_tests(tri, pr, t_min, t_max):
    """Component-unrolled Möller–Trumbore of a (1,B) triangle slice
    against the (R,1) packet.  Returns (tc, u, v): (R,B) tiles, tc = hit
    distance with +inf where the test failed (tc < inf <=> valid hit)."""
    ox, oy, oz, dx, dy, dz, _, _, _ = pr
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[:9]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return jnp.where(ok, t, jnp.float32(jnp.inf)), u, v


def _tri_slice(tris_ref, c, k0, tri_block):
    """(1,B) component rows (v0, e1, e2) of triangles [k0, k0+B) of
    cluster c."""
    return [tris_ref[c, j, pl.ds(k0, tri_block)][None, :] for j in range(9)]


def _closest_in_cluster(tris_ref, c, pr, carry, *, cluster_k, tri_block,
                        t_min, t_max):
    """Fold cluster c's triangles into the per-ray best (t, prim, u, v).

    Ties resolve to the lowest prim id (as in brute force) and the
    winner's barycentrics come off the same lane, so callers need no
    finalize gather."""
    lane = jnp.arange(tri_block, dtype=jnp.int32)[None, :]

    def slice_(j, carry):
        best_t, best_p, best_u, best_v = carry
        k0 = j * tri_block
        tc, u, v = _mt_tests(_tri_slice(tris_ref, c, k0, tri_block), pr,
                             t_min, t_max)
        t_blk = jnp.min(tc, axis=1, keepdims=True)                  # (R,1)
        gid = c * cluster_k + k0 + lane
        p_blk = jnp.min(jnp.where(tc == t_blk, gid, _BIG_PRIM), axis=1,
                        keepdims=True)
        win = gid == p_blk
        u_blk = jnp.sum(jnp.where(win, u, 0.0), axis=1, keepdims=True)
        v_blk = jnp.sum(jnp.where(win, v, 0.0), axis=1, keepdims=True)
        # Ties go to the lower prim id whatever the visit order, so a
        # ray's result does not depend on which packet carried it.  A
        # slice with no hit has t_blk = inf, which ties an unhit ray's
        # best_t when t_max is inf: only a real hit may win.
        better = ((t_blk < best_t)
                  | ((t_blk == best_t) & (p_blk < best_p))) & (t_blk < jnp.inf)
        return (
            jnp.where(better, t_blk, best_t),
            jnp.where(better, p_blk, best_p),
            jnp.where(better, u_blk, best_u),
            jnp.where(better, v_blk, best_v),
        )

    return lax.fori_loop(0, cluster_k // tri_block, slice_, carry)


def _any_in_cluster(tris_ref, c, pr, occ, *, cluster_k, tri_block, t_min,
                    t_max):
    """OR cluster c's hits into the per-ray occlusion flags (R,1) i32."""

    def slice_(j, occ):
        tc, _, _ = _mt_tests(
            _tri_slice(tris_ref, c, j * tri_block, tri_block), pr,
            t_min, t_max,
        )
        hit = jnp.max((tc < jnp.inf).astype(jnp.int32), axis=1,
                      keepdims=True)
        return jnp.maximum(occ, hit)

    return lax.fori_loop(0, cluster_k // tri_block, slice_, occ)


def _closest_kernel(aabb_ref, order_ref, sup_ref, sup_order_ref, rays_ref,
                    tris_ref, t_ref, prim_ref, u_ref, v_ref, *,
                    num_clusters, num_supers, branch, cluster_k, tri_block,
                    t_min, t_max):
    pr = _packet_rays(rays_ref)
    octant = _packet_octant(rays_ref)
    zero = pr[0] * 0.0
    carry = (zero + t_max, zero.astype(jnp.int32) + _BIG_PRIM, zero, zero)
    test = functools.partial(
        _closest_in_cluster, tris_ref, pr=pr, cluster_k=cluster_k,
        tri_block=tri_block, t_min=t_min, t_max=t_max,
    )

    def visit(c, carry):
        # Visiting clusters front-to-back makes the (tnear <= best_t) slab
        # condition cull everything behind the packet's first hits.
        hit = _slab_hits(_bounds(aabb_ref, c), pr, t_min, carry[0])
        # Padding children (c >= C, two-level walk) are far point boxes
        # and never pass; the clamp keeps the row read in bounds anyway.
        c = jnp.minimum(c, num_clusters - 1)
        return lax.cond(_any(hit), lambda x: test(c, carry=x),
                        lambda x: x, carry)

    if branch:
        def visit_super(pos, carry):
            s = sup_order_ref[octant, pos]
            hit = _slab_hits(_bounds(sup_ref, s), pr, t_min, carry[0])

            def children(x):
                return lax.fori_loop(
                    0, branch, lambda j, y: visit(s * branch + j, y), x
                )

            return lax.cond(_any(hit), children, lambda x: x, carry)

        carry = lax.fori_loop(0, num_supers, visit_super, carry)
    else:
        carry = lax.fori_loop(
            0, num_clusters,
            lambda pos, x: visit(order_ref[octant, pos], x), carry,
        )
    best_t, best_p, best_u, best_v = carry
    t_ref[:] = best_t.reshape(t_ref.shape)
    prim_ref[:] = best_p.reshape(prim_ref.shape)
    u_ref[:] = best_u.reshape(u_ref.shape)
    v_ref[:] = best_v.reshape(v_ref.shape)


def _occluded_kernel(aabb_ref, order_ref, sup_ref, sup_order_ref, rays_ref,
                     tris_ref, occ_ref, *, num_clusters, num_supers, branch,
                     cluster_k, tri_block, t_min, t_max):
    """Any-hit query (the reference's `traceOcclusion`, optixSphere.cu:
    134-156 — dead code there, live here for NEE shadow rays).

    Cheaper than closest-hit: no best-t ordering, no prim/barycentric
    tracking, and the loop EXITS once every ray in the packet is
    occluded."""
    pr = _packet_rays(rays_ref)
    octant = _packet_octant(rays_ref)
    occ0 = (pr[0] * 0.0).astype(jnp.int32)
    test = functools.partial(
        _any_in_cluster, tris_ref, pr=pr, cluster_k=cluster_k,
        tri_block=tri_block, t_min=t_min, t_max=t_max,
    )

    def visit(c, occ):
        hit = _slab_hits(_bounds(aabb_ref, c), pr, t_min, t_max) & (occ == 0)
        c = jnp.minimum(c, num_clusters - 1)
        return lax.cond(_any(hit), lambda x: test(c, occ=x), lambda x: x, occ)

    if branch:
        count, table = num_supers, sup_order_ref

        def step(s, occ):
            hit = _slab_hits(_bounds(sup_ref, s), pr, t_min, t_max) & (occ == 0)

            def children(x):
                return lax.fori_loop(
                    0, branch, lambda j, y: visit(s * branch + j, y), x
                )

            return lax.cond(_any(hit), children, lambda x: x, occ)
    else:
        count, table, step = num_clusters, order_ref, visit

    def cond(state):
        pos, done, _ = state
        return (pos < count) & (done == 0)

    def body(state):
        pos, _, occ = state
        occ = step(table[octant, pos], occ)
        return pos + 1, jnp.min(occ), occ

    _, _, occ = lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(0), occ0))
    occ_ref[:] = occ.reshape(occ_ref.shape)


def _pack_rays(origins, directions, rays_per_tile):
    """[N,3]+[N,3] -> (8, n_pad) f32 ray rows (pads are far +x rays)."""
    n = origins.shape[0]
    n_pad = -(-n // rays_per_tile) * rays_per_tile
    rays = jnp.zeros((8, n_pad), jnp.float32)
    rays = rays.at[0:3, :n].set(origins.T.astype(jnp.float32))
    rays = rays.at[3:6, :n].set(directions.T.astype(jnp.float32))
    if n_pad > n:
        rays = rays.at[0, n:].set(_FAR).at[3, n:].set(1.0)
    return rays, n_pad


def _traverse_call(kernel, outs, tris, aabbs, order, supers, origins,
                   directions, *, branch, t_min, t_max, rays_per_tile, tri_block,
                   num_warps, num_stages, interpret):
    """Shared pallas_call plumbing of the two traversal kernels."""
    c, _, k = tris.shape
    r = rays_per_tile
    if r & (r - 1) or tri_block & (tri_block - 1) or k % tri_block:
        raise ValueError(
            f"rays_per_tile ({r}) and tri_block ({tri_block}) must be powers "
            f"of two, and tri_block must divide the cluster size ({k})"
        )
    if branch:
        sup, sup_order = supers
    else:
        # Unused placeholders keep one kernel signature.
        sup, sup_order = aabbs[:1], order[:, :1]
    rays, n_pad = _pack_rays(origins, directions, r)
    body = functools.partial(
        kernel, num_clusters=c, num_supers=sup.shape[0], branch=branch,
        cluster_k=k, tri_block=tri_block, t_min=float(t_min),
        t_max=float(t_max),
    )

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)

    res = pl.pallas_call(
        body,
        grid=(n_pad // r,),
        in_specs=[
            whole(aabbs), whole(order), whole(sup), whole(sup_order),
            pl.BlockSpec((8, r), lambda i: (0, i)),
            whole(tris),
        ],
        out_specs=[pl.BlockSpec((r,), lambda i: (i,)) for _ in outs],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in outs],
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(aabbs, order, sup, sup_order, rays, tris)
    return [x[: origins.shape[0]] for x in res]


_STATICS = ("branch", "t_min", "t_max", "rays_per_tile", "tri_block", "num_warps",
            "num_stages", "interpret")


@functools.partial(jax.jit, static_argnames=_STATICS)
def intersect_clusters(
    tris: jnp.ndarray,        # [C,16,K] f32 packed triangle rows
    aabbs: jnp.ndarray,       # [C,8] f32 cluster bounds
    order: jnp.ndarray,       # [8,C] i32 per-octant front-to-back order
    origins: jnp.ndarray,     # [N,3]
    directions: jnp.ndarray,  # [N,3]
    supers=None,              # (aabb8_super [S,8], order_super [8,S]) with branch
    branch: int = 0,          # >0: two-level walk over groups of `branch`
    t_min: float = 0.01,
    t_max: float = 1e16,
    rays_per_tile: int = 128,
    tri_block: int = 1,
    num_warps: int = 4,
    num_stages: int = 1,
    interpret: bool = False,
):
    """Closest hit over the cluster accel.  Returns (best_t [N],
    best_prim [N] — 0x7FFFFFFF where miss, bary [N,2] — the winner's
    (beta, gamma)).

    With `branch`, `aabbs` must be the child table padded to S*branch
    rows (far point boxes), as `build_cluster_accel` stores it."""
    t, prim, u, v = _traverse_call(
        _closest_kernel,
        (jnp.float32, jnp.int32, jnp.float32, jnp.float32),
        tris, aabbs, order, supers, origins, directions, branch=branch,
        t_min=t_min, t_max=t_max, rays_per_tile=rays_per_tile,
        tri_block=tri_block, num_warps=num_warps, num_stages=num_stages,
        interpret=interpret,
    )
    return t, prim, jnp.stack([u, v], axis=-1)


@functools.partial(jax.jit, static_argnames=_STATICS)
def occluded_clusters(
    tris: jnp.ndarray,
    aabbs: jnp.ndarray,
    order: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    supers=None,
    branch: int = 0,
    t_min: float = 0.01,
    t_max: float = 1e16,
    rays_per_tile: int = 128,
    tri_block: int = 1,
    num_warps: int = 4,
    num_stages: int = 1,
    interpret: bool = False,
) -> jnp.ndarray:
    """Any-hit over the cluster accel; returns occluded [N] bool."""
    (occ,) = _traverse_call(
        _occluded_kernel, (jnp.int32,),
        tris, aabbs, order, supers, origins, directions, branch=branch,
        t_min=t_min, t_max=t_max, rays_per_tile=rays_per_tile,
        tri_block=tri_block, num_warps=num_warps, num_stages=num_stages,
        interpret=interpret,
    )
    return occ > 0


# ---------------------------------------------------------------------------
# Ray coherence sorting (host of the kernels' packets)
# ---------------------------------------------------------------------------


def _part1by2(v: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits of v so bit i lands at bit 3i (3-D Morton)."""
    v = v & jnp.uint32(0x3FF)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def ray_sort_key(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    scene_lo=None,
    scene_hi=None,
    spatial_bits: int = 0,
    dir_bits: int = 0,
) -> jnp.ndarray:
    """[N] u32 packet-coherence sort key: (origin Morton cell << 3) | octant,
    optionally refined by `dir_bits` direction-magnitude bits per axis
    BELOW the octant bits.

    spatial_bits=0 gives the pure direction-octant key.  dir_bits
    quantises |d| per axis under the octant: primary lanes all share one
    origin cell, so without it a packet is R consecutive queue lanes of
    one octant — a scanline row's spread of directions; the refinement
    groups them into tight frustum wedges while bounce packets are barely
    affected.  The key is clamped so 3*spatial_bits + 3 + 3*dir_bits fits
    u32."""
    dir_bits = min(dir_bits, max(0, (32 - 3 - 3 * spatial_bits) // 3))
    key = (
        (directions[:, 0] > 0).astype(jnp.uint32)
        + 2 * (directions[:, 1] > 0).astype(jnp.uint32)
        + 4 * (directions[:, 2] > 0).astype(jnp.uint32)
    )
    if spatial_bits:
        lo = jnp.asarray(scene_lo, jnp.float32)
        span = jnp.maximum(jnp.asarray(scene_hi, jnp.float32) - lo, 1e-6)
        cells = jnp.float32((1 << spatial_bits) - 1)
        q = jnp.clip((origins - lo) / span, 0.0, 1.0) * cells
        qi = q.astype(jnp.uint32)
        morton = (
            _part1by2(qi[:, 0])
            | (_part1by2(qi[:, 1]) << 1)
            | (_part1by2(qi[:, 2]) << 2)
        )
        key = key | (morton << 3)
    if dir_bits:
        cells = jnp.float32((1 << dir_bits) - 1)
        mag = (jnp.clip(jnp.abs(directions), 0.0, 1.0) * cells).astype(jnp.uint32)
        fine = (mag[:, 0] << (2 * dir_bits)) | (mag[:, 1] << dir_bits) | mag[:, 2]
        key = (key << (3 * dir_bits)) | fine
    return key


def octant_sort(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    scene_lo=None,
    scene_hi=None,
    spatial_bits: int = 0,
    dir_bits: int = 0,
):
    """Sort rays by direction octant (optionally spatial-major); returns
    (origins_s, directions_s, restore).

    spatial_bits > 0 prepends a `spatial_bits`-per-axis Morton code of
    the ray origin (normalized to [scene_lo, scene_hi]) ABOVE the octant
    bits: packets become spatially tight first, octant-pure second —
    what large spread-out scenes want (their divergence is positional).
    Compact scenes want the pure octant key (spatial_bits=0): all
    clusters overlap anyway, direction purity is what makes the
    front-to-back order cull.  The sort is stable, so ties preserve the
    queue's pixel order either way.  `restore(x)` un-permutes per-ray
    results (first axis) with one gather by the inverse permutation."""
    key = ray_sort_key(
        origins, directions, scene_lo, scene_hi, spatial_bits, dir_bits
    )
    iota = jnp.arange(origins.shape[0], dtype=jnp.int32)
    _, perm = lax.sort_key_val(key, iota)
    _, inv = lax.sort_key_val(perm, iota)
    packed = jnp.concatenate([origins, directions], axis=-1)[perm]

    def restore(x):
        return x[inv]

    return packed[:, 0:3], packed[:, 3:6], restore


# ---------------------------------------------------------------------------
# Host-side packing (accel build)
# ---------------------------------------------------------------------------


def octant_orders(aabbs: np.ndarray) -> np.ndarray:
    """[8,C] front-to-back cluster visit order per direction octant.

    Clusters sorted by the min-corner projection onto the octant's
    diagonal direction (entry-distance proxy)."""
    amin = np.asarray(aabbs)[:, 0:3]
    amax = np.asarray(aabbs)[:, 3:6]
    orders = []
    for oct_ in range(8):
        sign = np.array(
            [1.0 if oct_ & 1 else -1.0,
             1.0 if oct_ & 2 else -1.0,
             1.0 if oct_ & 4 else -1.0]
        )
        near_corner = np.where(sign > 0, amin, amax)
        proj = near_corner @ sign
        orders.append(np.argsort(proj, kind="stable"))
    return np.stack(orders).astype(np.int32)


def _rows(cols: np.ndarray, t: int, k: int) -> np.ndarray:
    """[T,16] per-triangle columns -> [C,16,K] component rows (padding
    triangles all-zero, which the tests cull as degenerate)."""
    c = max(1, -(-t // k))
    out = np.zeros((c * k, 16), np.float32)
    out[:t] = cols
    return np.ascontiguousarray(out.reshape(c, k, 16).transpose(0, 2, 1))


def pack_cluster_tris(vertices: np.ndarray, cluster_size: int) -> np.ndarray:
    """[T,3,3] Morton-permuted vertices -> [C,16,K] Möller–Trumbore rows
    (v0 rows 0-2, e1 rows 3-5, e2 rows 6-8; rest zero => det==0
    padding).  Row j of cluster c is contiguous over its K triangles, so
    a kernel slice load is coalesced."""
    t = vertices.shape[0]
    cols = np.zeros((t, 16), np.float32)
    v0 = vertices[:, 0, :]
    cols[:, 0:3] = v0
    cols[:, 3:6] = vertices[:, 1, :] - v0
    cols[:, 6:9] = vertices[:, 2, :] - v0
    return _rows(cols, t, cluster_size)
