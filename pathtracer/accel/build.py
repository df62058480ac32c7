"""Acceleration-structure construction (host-side, per scene).

The reference delegates BVH construction to the OptiX driver
(`optixAccelBuild` + compaction, reference optixSphere.cpp:860-968).  Here
the build is explicit: Morton-sort the triangles, then either

* slice the sorted order into fixed-size *clusters* with AABBs
  (`ClusterAccel` — a shallow, fully vectorizable structure: cluster
  tests are dense [rays x cluster] ops, skipped per ray packet by the
  GPU kernel or per batch by the XLA scan).

The build permutes the *whole scene* (vertices/normals/uvs/mat_ids) into
Morton order so leaf ranges are contiguous slices — the analog of OptiX
compaction locality.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _expand_bits_10(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits over 30 (standard Morton bit-interleave)."""
    x = x.astype(np.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for [T,3] centroids (normalised to the AABB)."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    return (
        (_expand_bits_10(q[:, 0]) << 2)
        | (_expand_bits_10(q[:, 1]) << 1)
        | _expand_bits_10(q[:, 2])
    )


def morton_order(vertices: np.ndarray) -> np.ndarray:
    """Permutation sorting triangles by centroid Morton code."""
    centroids = vertices.mean(axis=1)
    codes = morton_codes(centroids)
    return np.argsort(codes, kind="stable")


def build_accel_arrays(vertices: np.ndarray, kind: str = "cluster", **kw):
    """Host-side accel build over [T,3,3] numpy vertices.

    Returns (perm, accel): the Morton permutation to apply to every
    per-triangle array, and the accel structure for the permuted order.
    """
    from pathtracer.accel.cluster import build_cluster_accel

    perm = morton_order(vertices)
    permuted = np.ascontiguousarray(vertices[perm])
    if kind == "cluster":
        accel = build_cluster_accel(permuted, **kw)
    else:
        raise ValueError(f"unknown accel kind: {kind!r}")
    return perm, accel


def build_accel(scene, kind: str = "cluster", **kw):
    """Permute `scene` into Morton order and attach an accel structure.

    Returns a new Scene with `.accel` set.  kind: "cluster".

    NOTE: this round-trips the geometry device->host.  When building a
    scene from files prefer `scene.builder.load_scene(..., accel=kind)`,
    which builds on host arrays before the device upload.
    """
    import jax.numpy as jnp

    verts = np.asarray(scene.vertices)
    if verts.shape[0] == 0:
        return scene
    perm, accel = build_accel_arrays(verts, kind=kind, **kw)

    permuted = scene.replace(
        vertices=jnp.asarray(verts[perm]),
        normals=jnp.asarray(np.asarray(scene.normals)[perm]),
        uvs=jnp.asarray(np.asarray(scene.uvs)[perm]),
        mat_ids=jnp.asarray(np.asarray(scene.mat_ids)[perm]),
        tri_attrs=jnp.asarray(np.asarray(scene.tri_attrs)[perm]),
    )
    return permuted.replace(accel=accel)


def tri_aabbs(vertices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return vertices.min(axis=1), vertices.max(axis=1)
