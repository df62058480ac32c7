"""Ray-triangle intersection: blocked, divergence-free Möller–Trumbore.

This is the software replacement for the reference's hardware path —
`optixTraverse` over a driver-built GAS (reference optixSphere.cu:99-112,
optixSphere.cpp:860-968).  Here intersection is a batched vector
computation:

* `intersect_brute` — every ray tests every triangle, processed in
  [N_rays x block] tiles via `lax.scan` so the working set stays bounded.
  Exact; fast enough for the reference's scene sizes (<= ~10k triangles)
  and the correctness oracle for every accelerated path.
* The accelerated variant (Morton cluster-packet traversal) lives in
  `pathtracer.accel` and reduces the tested-triangle count; it reuses
  `_mt_block` for its XLA-path leaf tests.

Triangles are two-sided (the reference never sets OptiX backface culling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtracer.utils import pytree

_DET_EPS = 1e-12


@pytree.dataclass
class Hit:
    """Closest-hit record for a ray batch ([N] lanes)."""

    t: jnp.ndarray      # [N] f32 hit distance (= t_max sentinel on miss)
    prim: jnp.ndarray   # [N] i32 triangle index (-1 on miss)
    bary: jnp.ndarray   # [N,2] f32 (beta, gamma) barycentrics, OptiX layout
    hit: jnp.ndarray    # [N] bool


def _mt_block(origins, directions, tri_block, t_min, t_max):
    """Möller–Trumbore: [N] rays x [B] triangles -> per-pair (t, u, v, valid).

    origins/directions: [N,3]; tri_block: [B,3,3].
    Returns t [N,B], u [N,B], v [N,B], valid [N,B].

    Component-unrolled: every intermediate is a 2-D [N,B] array, so
    XLA fuses the whole test into elementwise loops with no 3-vector
    axis (no cross/dot over a length-3 minor dimension).
    """
    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]      # [N,1]
    dx, dy, dz = directions[:, 0:1], directions[:, 1:2], directions[:, 2:3]

    v0x, v0y, v0z = (tri_block[None, :, 0, k] for k in range(3))        # [1,B]
    e1 = tri_block[:, 1, :] - tri_block[:, 0, :]
    e2 = tri_block[:, 2, :] - tri_block[:, 0, :]
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))

    # pvec = dir x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)

    # tvec = origin - v0
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det

    valid = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def _mt_single(origins, directions, tris, t_min, t_max):
    """Möller–Trumbore with one triangle *per lane*: tris [N,3,3].

    Returns (t, u, v, valid), each [N].  Used by per-ray BVH traversal
    where every lane is testing a different leaf triangle.
    """
    v0 = tris[:, 0, :]
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    pvec = jnp.cross(directions, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = origins - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(directions * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def intersect_brute(
    vertices: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_min: float,
    t_max: float,
    block: int = 256,
) -> Hit:
    """Closest hit by exhaustive blocked search.

    vertices: [T,3,3]; origins/directions: [N,3].
    """
    t_count = vertices.shape[0]
    block = max(8, min(block, max(t_count, 8)))
    pad = (-t_count) % block
    if pad:
        # Degenerate (all-zero) triangles never pass the det test.
        vertices = jnp.concatenate(
            [vertices, jnp.zeros((pad, 3, 3), vertices.dtype)], axis=0
        )
    num_blocks = vertices.shape[0] // block
    tri_blocks = vertices.reshape(num_blocks, block, 3, 3)

    # Derive carries from the ray arrays (not fresh constants) so varying
    # manual axes propagate correctly under shard_map.
    # Per-block bookkeeping uses pure reductions (min over the block axis)
    # — no [rows, argmin] gathers.  Barycentrics are recomputed once at the
    # end for the winning triangle.
    init = (
        jnp.full_like(origins[:, 0], t_max),
        jnp.full_like(origins[:, 0], jnp.int32(0x7FFFFFFF), dtype=jnp.int32),
    )

    def body(carry, inp):
        best_t, best_prim = carry
        tri_block, base = inp
        t, u, v, valid = _mt_block(origins, directions, tri_block, t_min, t_max)
        t = jnp.where(valid, t, jnp.inf)
        t_blk = jnp.min(t, axis=1)                              # [N]
        lane = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        prim_blk = jnp.min(
            jnp.where(t == t_blk[:, None], base + lane, jnp.int32(0x7FFFFFFF)),
            axis=1,
        )
        closer = t_blk < best_t
        best_t = jnp.where(closer, t_blk, best_t)
        best_prim = jnp.where(closer, prim_blk, best_prim)
        return (best_t, best_prim), None

    bases = (jnp.arange(num_blocks) * block).astype(jnp.int32)
    (best_t, best_prim), _ = jax.lax.scan(body, init, (tri_blocks, bases))
    return finalize_hit(vertices, origins, directions, best_t, best_prim, t_min, t_max)


def finalize_hit(vertices, origins, directions, best_t, best_prim, t_min, t_max) -> Hit:
    """Recompute barycentrics for the winning primitive (one per-lane
    gather + Möller–Trumbore) and assemble the Hit record."""
    hit = best_prim < jnp.int32(0x7FFFFFFF)
    prim = jnp.where(hit, best_prim, 0)
    tris = vertices[prim]                                       # [N,3,3]
    _, u, v, _ = _mt_single(origins, directions, tris, t_min, t_max)
    bary = jnp.where(
        hit[:, None], jnp.stack([u, v], axis=-1), jnp.zeros_like(origins[:, :2])
    )
    return Hit(
        t=best_t,
        prim=jnp.where(hit, best_prim, -1),
        bary=bary,
        hit=hit,
    )


# Below this triangle count the brute scan beats the *XLA* cluster scan
# (its batch-level lax.cond culls nothing with incoherent lanes).  The
# GPU packet kernel culls per packet, so there `auto` prefers the kernel
# whenever the scene has an accel.
AUTO_BRUTE_MAX_TRIS = 4096


def _auto_prefers_accel(scene, cfg) -> bool:
    """auto-mode dispatch: use the accel when it can actually win."""
    if scene.accel is None:
        return False
    if scene.num_triangles > AUTO_BRUTE_MAX_TRIS:
        return True
    from pathtracer.accel.cluster import use_kernel

    return use_kernel()


def occluded_brute(
    vertices: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_min: float,
    t_max: float,
    block: int = 256,
) -> jnp.ndarray:
    """Any-hit query: True where the segment [t_min, t_max] is blocked.

    The software `traceOcclusion` (reference optixSphere.cu:134-156 —
    dead code there, live here for next-event estimation).  Cheaper than
    closest-hit: no distance/prim tracking, no barycentric finalize."""
    t_count = vertices.shape[0]
    block = max(8, min(block, max(t_count, 8)))
    pad = (-t_count) % block
    if pad:
        vertices = jnp.concatenate(
            [vertices, jnp.zeros((pad, 3, 3), vertices.dtype)], axis=0
        )
    tri_blocks = vertices.reshape(-1, block, 3, 3)

    def body(occ, tri_block):
        _, _, _, valid = _mt_block(origins, directions, tri_block, t_min, t_max)
        return occ | jnp.any(valid, axis=1), None

    occ0 = jnp.zeros_like(origins[:, 0], dtype=bool)
    occ, _ = jax.lax.scan(body, occ0, tri_blocks)
    return occ


def occluded_scene(
    scene, origins, directions, t_min, t_max, cfg, active=None
) -> jnp.ndarray:
    """Any-hit dispatch (shadow rays): first accepted hit ends the query —
    no distance ordering or barycentric finalize (reference
    `traceOcclusion`, optixSphere.cu:134-156).

    `active`: optional [N] bool mask — lanes outside it return an
    unspecified value (callers must mask on it, as the NEE estimator
    already does via `cand & ~occluded`).  The cluster accel parks
    inactive rays outside the scene bounds so they stop forcing clusters
    alive in the packet kernels (~2/3 of NEE shadow lanes are inactive
    on the hero scene: misses, glass, emissive, backfacing)."""
    if cfg.intersector == "brute" or (
        cfg.intersector == "auto" and not _auto_prefers_accel(scene, cfg)
    ):
        return occluded_brute(
            scene.vertices, origins, directions, t_min, t_max, cfg.intersect_block
        )
    accel = scene.accel
    if accel is not None and hasattr(accel, "occluded"):
        return accel.occluded(
            scene.vertices, origins, directions, t_min, t_max, cfg,
            active=active,
        )
    return intersect_scene(scene, origins, directions, t_min, t_max, cfg).hit


def intersect_scene(scene, origins, directions, t_min, t_max, cfg) -> Hit:
    """Dispatch to the configured intersector for this scene."""
    mode = cfg.intersector
    accel = scene.accel
    if mode == "auto":
        if not _auto_prefers_accel(scene, cfg):
            mode = "brute"
    if mode == "brute":
        return intersect_brute(
            scene.vertices, origins, directions, t_min, t_max, cfg.intersect_block
        )
    if accel is None:
        raise ValueError(f"intersector {mode!r} requested but scene has no accel")
    # Accel structures implement .intersect(vertices, o, d, t_min, t_max, cfg)
    return accel.intersect(scene.vertices, origins, directions, t_min, t_max, cfg)
