"""Procedural geometry: UV-sphere meshes, ground planes and the reference's
fallback scene (ground + three unit spheres).

Host-side numpy; replaces `generateSphereMesh` (reference
optixSphere.cpp:295-353) and the `loadFromFile == false` branch of
`createSceneGeometry` (cpp:650-751).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pathtracer.scene.scene import MaterialTable, Scene, make_material_table, make_scene


def sphere_mesh(center, radius: float, stacks: int = 16, slices: int = 32):
    """Lat-long UV sphere as a triangle soup.

    Same vertex layout and winding as reference optixSphere.cpp:295-353:
    phi from the +y pole, per-vertex normals = radial directions.
    Returns (vertices [T,3,3], normals [T,3,3]) float32.
    """
    center = np.asarray(center, dtype=np.float64)
    i = np.arange(stacks + 1, dtype=np.float64)
    j = np.arange(slices + 1, dtype=np.float64)
    phi = np.pi * i / stacks
    theta = 2.0 * np.pi * j / slices

    y = radius * np.cos(phi)[:, None]                     # [stacks+1, 1]
    r = radius * np.sin(phi)[:, None]
    x = r * np.cos(theta)[None, :].repeat(stacks + 1, 0) * 0 + r * np.cos(theta)
    z = r * np.sin(theta)
    pos = np.stack(
        [x, np.broadcast_to(y, x.shape), np.broadcast_to(z, x.shape)], axis=-1
    )  # [stacks+1, slices+1, 3] local
    nrm = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-12)
    pos = pos + center

    # Quad (i,j) -> two triangles with the reference's index pattern:
    #   first  = (i,j) (i+1,j) (i,j+1)
    #   second = (i,j+1) (i+1,j) (i+1,j+1)
    v00 = pos[:-1, :-1]
    v10 = pos[1:, :-1]
    v01 = pos[:-1, 1:]
    v11 = pos[1:, 1:]
    n00 = nrm[:-1, :-1]
    n10 = nrm[1:, :-1]
    n01 = nrm[:-1, 1:]
    n11 = nrm[1:, 1:]

    tri1_v = np.stack([v00, v10, v01], axis=2)
    tri1_n = np.stack([n00, n10, n01], axis=2)
    tri2_v = np.stack([v01, v10, v11], axis=2)
    tri2_n = np.stack([n01, n10, n11], axis=2)

    verts = np.concatenate(
        [tri1_v.reshape(-1, 3, 3), tri2_v.reshape(-1, 3, 3)], axis=0
    )
    norms = np.concatenate(
        [tri1_n.reshape(-1, 3, 3), tri2_n.reshape(-1, 3, 3)], axis=0
    )
    return verts.astype(np.float32), norms.astype(np.float32)


def ground_plane(y: float, size: float):
    """Two-triangle ground quad at height y (reference optixSphere.cpp:694-716
    and 610-648).  Returns (vertices [2,3,3], normals [2,3,3])."""
    v0 = [-size, y, -size]
    v1 = [-size, y, size]
    v2 = [size, y, -size]
    v3 = [size, y, size]
    n = [0.0, 1.0, 0.0]
    verts = np.asarray([[v0, v1, v2], [v2, v1, v3]], dtype=np.float32)
    norms = np.broadcast_to(np.asarray(n, np.float32), (2, 3, 3)).copy()
    return verts, norms


def three_spheres_scene(stacks: int = 16, slices: int = 32) -> Scene:
    """The reference's procedural fallback scene (optixSphere.cpp:650-751):
    ground quad (size 10, y=0) + red/green/blue unit spheres at x=-3,0,3,
    y=1.  Material order: 0 ground, 1 red, 2 green, 3 blue."""
    mats = [
        dict(color=(0.5, 0.5, 0.5), specular=(1.0, 1.0, 1.0), roughness=0.8),
        dict(color=(1.0, 0.0, 0.0), roughness=0.0),
        dict(color=(0.0, 1.0, 0.0), roughness=0.0),
        dict(color=(0.0, 0.0, 1.0), roughness=0.0),
    ]
    gv, gn = ground_plane(0.0, 10.0)
    verts = [gv]
    norms = [gn]
    mat_ids = [np.zeros(2, np.int32)]
    centers = [(-3.0, 1.0, 0.0), (0.0, 1.0, 0.0), (3.0, 1.0, 0.0)]
    for i, c in enumerate(centers):
        sv, sn = sphere_mesh(c, 1.0, stacks, slices)
        verts.append(sv)
        norms.append(sn)
        mat_ids.append(np.full(len(sv), i + 1, np.int32))
    vertices = np.concatenate(verts, axis=0)
    normals = np.concatenate(norms, axis=0)
    ids = np.concatenate(mat_ids, axis=0)
    table = make_material_table(mats)
    return make_scene(vertices, normals, None, ids, table)


def high_poly_scene(
    total_tris: int = 100_000,
    n_objects: int = 5,
    seed: int = 0,
) -> Scene:
    """Dense test scene substituting the stripped statue1-4/lion.obj
    assets (BASELINE.md config 4: "high-poly scenes: deep BVH traversal").

    n_objects finely-tessellated spheres with varied materials on a
    ground plane, totalling ~total_tris triangles.
    """
    rs = np.random.RandomState(seed)
    per_obj = max(total_tris // max(n_objects, 1), 8)
    stacks = max(4, int(np.sqrt(per_obj / 4)))
    slices = 2 * stacks

    verts, norms, ids = [], [], []
    mats = []
    for i in range(n_objects):
        c = rs.randn(3) * 2.0
        c[1] = abs(c[1]) + 1.0
        sv, sn = sphere_mesh(c, 0.8 + 0.4 * rs.rand(), stacks, slices)
        verts.append(sv)
        norms.append(sn)
        ids.append(np.full(len(sv), i, np.int32))
        mats.append(
            dict(
                color=tuple(rs.rand(3).tolist()),
                roughness=float(rs.rand()),
                metallic=bool(rs.rand() < 0.3),
            )
        )
    mats.append(dict(color=(0.4, 0.4, 0.4), roughness=0.6))
    gv, gn = ground_plane(0.0, 50.0)
    verts.append(gv)
    norms.append(gn)
    ids.append(np.full(2, n_objects, np.int32))
    return make_scene(
        np.concatenate(verts),
        np.concatenate(norms),
        None,
        np.concatenate(ids),
        make_material_table(mats),
    )


def single_sphere_scene(
    radius: float = 1.0,
    stacks: int = 16,
    slices: int = 32,
    albedo=(0.8, 0.8, 0.8),
    with_ground: bool = True,
) -> Scene:
    """BASELINE.md config 1: one diffuse sphere (+ optional ground plane)."""
    mats = [dict(color=albedo, roughness=1.0)]
    sv, sn = sphere_mesh((0.0, radius, 0.0), radius, stacks, slices)
    verts = [sv]
    norms = [sn]
    ids = [np.zeros(len(sv), np.int32)]
    if with_ground:
        mats.append(dict(color=(0.5, 0.5, 0.5), roughness=1.0))
        gv, gn = ground_plane(0.0, 20.0)
        verts.append(gv)
        norms.append(gn)
        ids.append(np.ones(2, np.int32))
    table = make_material_table(mats)
    return make_scene(
        np.concatenate(verts, 0), np.concatenate(norms, 0), None, np.concatenate(ids, 0), table
    )


def _value_noise(rs, size: int, cells: int) -> np.ndarray:
    """[size,size] smooth noise in [0,1]: a random cells x cells lattice,
    bilinearly upsampled with wrap (tiles seamlessly)."""
    lat = rs.rand(cells, cells)
    t = np.arange(size) * cells / size
    i0 = np.floor(t).astype(np.int64)
    f = t - i0
    f = f * f * (3.0 - 2.0 * f)
    i1 = (i0 + 1) % cells
    rows = lat[i0] * (1 - f)[:, None] + lat[i1] * f[:, None]      # [size,cells]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i1] * f[None, :]


def write_hero_scene(out_dir: str, tex_size: int = 2048, seed: int = 0,
                     stacks: int = 32, slices: int = 36) -> str:
    """Write a suitcase-shaped textured test scene; returns the OBJ path.

    A stand-in with the shape of the reference's hero scene (suitcase.obj,
    ~2.2k textured triangles — not distributed with this repository):
    one rounded box of 2*stacks*slices triangles (2,304 by default) with
    UVs and normals, an MTL material, and the four builder-convention
    maps `hero_{albedo,roughness,metallic,normal}.png` at tex_size^2,
    written with the repository's own PNG codec.  Load it with
    `scene.builder.load_scene([path])`, which adds the floor plane.
    """
    import os

    from pathtracer.utils.image import save_png

    os.makedirs(out_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    # Superellipsoid (exponent 0.35 -> boxy with rounded edges), sitting
    # on y = 0: half extents 0.8 x 0.55 x 0.25.
    half = np.array([0.8, 0.55, 0.25])
    v = np.linspace(-np.pi / 2, np.pi / 2, stacks + 1)[:, None]
    u = np.linspace(-np.pi, np.pi, slices + 1)[None, :]

    def sp(x, e):
        return np.sign(x) * np.abs(x) ** e

    e = 0.35
    pos = np.stack(
        np.broadcast_arrays(
            half[0] * sp(np.cos(v), e) * sp(np.cos(u), e),
            half[1] * sp(np.sin(v), e) + half[1],
            half[2] * sp(np.cos(v), e) * sp(np.sin(u), e),
        ),
        axis=-1,
    )                                                   # [S+1, L+1, 3]
    # Normals of the implicit surface |x/a|^(2/e) + ... = 1.
    q = (pos - np.array([0.0, half[1], 0.0])) / half
    grad = np.sign(q) * np.abs(q) ** (2.0 / e - 1.0) / half
    nrm = grad / np.maximum(np.linalg.norm(grad, axis=-1, keepdims=True), 1e-12)
    uv = np.stack(
        np.broadcast_arrays(
            np.linspace(0, 1, slices + 1)[None, :],
            np.linspace(0, 1, stacks + 1)[:, None],
        ),
        axis=-1,
    )
    idx = np.arange((stacks + 1) * (slices + 1)).reshape(stacks + 1, slices + 1) + 1
    a, b = idx[:-1, :-1], idx[1:, :-1]
    c, d = idx[:-1, 1:], idx[1:, 1:]
    faces = np.concatenate(
        [np.stack([a, c, b], -1).reshape(-1, 3),
         np.stack([c, d, b], -1).reshape(-1, 3)]
    )
    obj = os.path.join(out_dir, "hero.obj")
    with open(os.path.join(out_dir, "hero.mtl"), "w") as f:
        f.write("newmtl leather\nKd 0.6 0.4 0.25\nNs 50\nmap_Kd hero_albedo.png\n")
    with open(obj, "w") as f:
        f.write("mtllib hero.mtl\no hero\n")
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pos.reshape(-1, 3))
        f.writelines(f"vt {s:.6f} {t:.6f}\n" for s, t in uv.reshape(-1, 2))
        f.writelines(f"vn {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in nrm.reshape(-1, 3))
        f.write("usemtl leather\n")
        f.writelines(
            f"f {i}/{i}/{i} {j}/{j}/{j} {k}/{k}/{k}\n" for i, j, k in faces
        )

    n = tex_size
    grain = _value_noise(rs, n, 256)
    blotch = _value_noise(rs, n, 16)
    yy = np.arange(n)[:, None] / n
    band = (np.abs(yy - 0.5) < 0.04).astype(np.float64) * np.ones((1, n))
    albedo = np.stack(
        [0.45 + 0.2 * blotch, 0.28 + 0.12 * blotch, 0.15 + 0.08 * blotch], -1
    ) * (0.85 + 0.3 * grain[..., None])
    albedo = albedo * (1 - band[..., None]) + band[..., None] * 0.8
    rough = 0.35 + 0.4 * grain * (1 - band)
    height = grain + 0.5 * blotch
    gy, gx = np.gradient(height)
    tn = np.stack([-gx * 40.0, -gy * 40.0, np.ones_like(gx)], -1)
    tn /= np.linalg.norm(tn, axis=-1, keepdims=True)

    def u8(x):
        x = np.clip(x, 0.0, 1.0)
        if x.ndim == 2:
            x = np.repeat(x[..., None], 3, axis=-1)
        return (x * 255.0 + 0.5).astype(np.uint8)

    for kind, img in (
        ("albedo", albedo), ("roughness", rough), ("metallic", band),
        ("normal", tn * 0.5 + 0.5),
    ):
        save_png(os.path.join(out_dir, f"hero_{kind}.png"), u8(img))
    return obj
