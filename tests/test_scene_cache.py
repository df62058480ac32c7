"""Packed-scene cache: bitwise round-trip + dependency invalidation.

Warm loads must skip decode/packing entirely.  The cache
is only correct if a warm scene is indistinguishable (every array, every
static flag) from a cold build, and if ANY probed file changing —
including a convention-map texture APPEARING where none existed —
invalidates the entry.
"""

import os
import textwrap

import numpy as np
import pytest

from pathtracer.scene.cache import (
    SCHEMA,
    cache_key,
    load_packed_scene,
    load_scene_cached,
    save_packed_scene,
    scene_deps,
)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(textwrap.dedent(content))
    return str(p)


@pytest.fixture
def scene_files(tmp_path):
    from PIL import Image

    obj = write(
        tmp_path,
        "box.obj",
        """\
        mtllib box.mtl
        v 0 0 0
        v 1 0 0
        v 0 1 0
        v 1 1 0
        usemtl red
        f 1 2 3
        f 2 4 3
        """,
    )
    write(tmp_path, "box.mtl", "newmtl red\nKd 0.8 0.1 0.1\nPr 0.3\n")
    rng = np.random.RandomState(3)
    Image.fromarray(rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        tmp_path / "box_albedo.png"
    )
    return obj


def _scene_arrays(s):
    out = {
        n: np.asarray(getattr(s, n))
        for n in ("vertices", "normals", "uvs", "mat_ids", "tri_attrs")
    }
    for n in ("attrs", "texture_quads", "texture_bundles", "diffuse_color",
              "has_map", "map_offset"):
        out[f"m.{n}"] = np.asarray(getattr(s.materials, n))
    if s.accel is not None:
        for n in ("tris16", "aabb8", "order", "aabb8_super", "order_super"):
            out[f"a.{n}"] = np.asarray(getattr(s.accel, n))
    return out


def test_roundtrip_bitwise(scene_files, tmp_path):
    from pathtracer.scene.builder import load_scene

    kw = dict(rng_seed=5, accel="cluster", accel_kw={"cluster_size": 64})
    cold = load_scene([scene_files], **kw)
    cdir = str(tmp_path / "cache")
    warm0 = load_scene_cached([scene_files], cache_dir=cdir, **kw)  # writes
    assert len(os.listdir(cdir)) == 1
    warm = load_scene_cached([scene_files], cache_dir=cdir, **kw)   # reads

    for label, ref in [("write-path", warm0), ("read-path", warm)]:
        a, b = _scene_arrays(cold), _scene_arrays(ref)
        assert a.keys() == b.keys(), label
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}:{k}")
    assert warm.accel.cluster_size == 64
    assert warm.materials.bundled == cold.materials.bundled
    assert warm.materials.bundled_scrambled == cold.materials.bundled_scrambled


def test_env_attached_fresh_not_cached(scene_files, tmp_path):
    from pathtracer.scene.scene import make_env

    cdir = str(tmp_path / "cache")
    env = make_env(np.full((4, 8, 3), 2.5, np.float32))
    load_scene_cached([scene_files], cache_dir=cdir)            # populate
    s = load_scene_cached([scene_files], env=env, cache_dir=cdir)
    np.testing.assert_array_equal(np.asarray(s.env.data), 2.5)
    s2 = load_scene_cached([scene_files], cache_dir=cdir)       # no env
    assert s2.env.data.shape != env.data.shape                  # default env


def test_invalidation_texture_mtime(scene_files, tmp_path):
    cdir = str(tmp_path / "cache")
    s1 = load_scene_cached([scene_files], cache_dir=cdir)
    tex = tmp_path / "box_albedo.png"
    os.utime(tex, ns=(12345, 987654321000000000))
    entry = os.path.join(cdir, os.listdir(cdir)[0])
    assert load_packed_scene(entry) is None                     # stale
    s2 = load_scene_cached([scene_files], cache_dir=cdir)       # rebuild
    np.testing.assert_array_equal(
        np.asarray(s1.materials.texture_quads),
        np.asarray(s2.materials.texture_quads),
    )


def test_invalidation_texture_appears(scene_files, tmp_path):
    """A convention map that did NOT exist at build time appearing later
    must invalidate (the miss is a recorded dep with size=-1)."""
    from PIL import Image

    cdir = str(tmp_path / "cache")
    load_scene_cached([scene_files], cache_dir=cdir)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        tmp_path / "box_roughness.png"
    )
    entry = os.path.join(cdir, os.listdir(cdir)[0])
    assert load_packed_scene(entry) is None
    s = load_scene_cached([scene_files], cache_dir=cdir)
    assert np.asarray(s.materials.has_map)[0, 1]                # roughness now mapped


def test_key_varies_with_params(scene_files):
    base = {"scale": 1.0, "rng_seed": 0}
    k0 = cache_key([scene_files], base)
    assert cache_key([scene_files], dict(base, scale=2.0)) != k0
    assert cache_key(["other.obj"], base) != k0
    assert cache_key([scene_files], base) == k0                 # stable


def test_deps_cover_mtl_and_convention_probes(scene_files, tmp_path):
    deps = scene_deps([scene_files], "convention", None)
    paths = {os.path.basename(p) for p, _, _ in deps}
    assert {"box.obj", "box.mtl", "box_albedo.png",
            "box_roughness.png", "box_normal.png",
            "box_metallic.png"} <= paths
    # the missing probes are recorded as misses
    miss = {os.path.basename(p) for p, sz, _ in deps if sz == -1}
    assert "box_normal.png" in miss and "box_albedo.png" not in miss


def test_torn_entry_is_a_miss_not_an_error(scene_files, tmp_path):
    cdir = str(tmp_path / "cache")
    load_scene_cached([scene_files], cache_dir=cdir)
    entry = os.path.join(cdir, os.listdir(cdir)[0])
    with open(entry, "wb") as f:
        f.write(b"PK\x03\x04 torn")
    assert load_packed_scene(entry) is None
    s = load_scene_cached([scene_files], cache_dir=cdir)        # rebuilds
    assert s.num_triangles == 4                                 # 2 + floor


def test_mtl_source_texture_dep(tmp_path):
    """material_source='mtl': MTL-referenced textures are deps."""
    from PIL import Image

    obj = write(
        tmp_path, "t.obj",
        "mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl m\nf 1 2 3\n",
    )
    write(tmp_path, "t.mtl", "newmtl m\nKd 0.5 0.5 0.5\nmap_Kd diff.png\n")
    Image.fromarray(np.full((4, 4, 3), 128, np.uint8)).save(tmp_path / "diff.png")
    deps = scene_deps([obj], "mtl", None)
    assert "diff.png" in {os.path.basename(p) for p, _, _ in deps}

    cdir = str(tmp_path / "cache")
    load_scene_cached([obj], material_source="mtl", cache_dir=cdir)
    os.utime(tmp_path / "diff.png", ns=(1, 1))
    entry = os.path.join(cdir, os.listdir(cdir)[0])
    assert load_packed_scene(entry) is None
