"""On-disk packed-scene cache: warm loads skip decode + packing.

A cold `builder.load_scene` on a textured scene pays PNG decode, texture
quad/bundle assembly and accel packing, even with the native OBJ parser
(seconds for four 2048^2 maps).  The reference pays its scene load once per
interactive session too (optixSphere.cpp:829-841), but a CLI render or a
bench run here pays it every process.  This module persists the final
packed arrays — geometry SoA, material/attr tables, texture pools, accel
tables — as one uncompressed .npz keyed by the build parameters, so a
warm load is a single sequential file read + device upload.

Invalidation is by dependency fingerprint: the cache entry records
(path, size, mtime_ns) for every file the build *probed* — OBJ files,
mtllib targets, convention-map candidates (including ones that did NOT
exist: a texture appearing later must invalidate), and MTL-referenced
textures.  Any mismatch rebuilds.  `SCHEMA` must be bumped whenever the
packed layouts (scene.py / cluster.py) change shape or meaning.

The environment map is deliberately NOT cached: it is built separately
(procedural / EXR / constant), is cheap, and is attached by the caller —
exactly as with `builder.load_scene(env=...)`.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Bump when any packed array layout changes (tri_attrs columns, material
# attr columns, bundle row format, ClusterAccel fields, ...).
SCHEMA = 4  # 4: ClusterAccel without the second triangle-row packing

_MT_STATICS = (
    "bundled",
    "bundled_morton",
    "bundled_scrambled",
    "bundled_pow2_dims",
    "mip_level",
    "mip_scrambled",
    "mip_pow2_dims",
)
_MT_ARRAYS = (
    "attrs",
    "diffuse_color",
    "specular",
    "emission_color",
    "roughness",
    "metallic",
    "transparent",
    "has_map",
    "map_offset",
    "map_width",
    "map_height",
    "texture_quads",
    "texture_bundles",
    "texture_bundles_mip",   # optional (None when no mip ladder)
)
_ACCEL_ARRAYS = (
    "aabb_min",
    "aabb_max",
    "tris16",
    "aabb8",
    "order",
    "scene_lo",
    "scene_hi",
    "aabb8_child",
    "aabb8_super",
    "order_super",
)
_ACCEL_STATICS = ("cluster_size", "super_branch")


def default_cache_dir() -> str:
    return os.path.join(
        os.path.expanduser("~"), ".cache", "pathtracer", "scenes"
    )


# ---------------------------------------------------------------------------
# dependency fingerprinting


def _sig(path: str) -> Tuple[str, int, int]:
    """(abspath, size, mtime_ns); (-1,-1) for a probed-but-missing file."""
    ap = os.path.abspath(path)
    try:
        st = os.stat(ap)
        return (ap, st.st_size, st.st_mtime_ns)
    except OSError:
        return (ap, -1, -1)


_MTLLIB_RE = re.compile(rb"^\s*mtllib\s+(.+?)\s*$", re.MULTILINE)
_KINDS = ("albedo", "roughness", "normal", "metallic")


def _mtllibs(obj_path: str) -> List[str]:
    """mtllib targets named by an OBJ file (cheap byte scan, no parse)."""
    try:
        with open(obj_path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    return [m.group(1).decode("utf-8", "replace") for m in _MTLLIB_RE.finditer(data)]


def scene_deps(
    filenames: Sequence[str],
    material_source: str,
    mtl_basepath: Optional[str],
) -> List[Tuple[str, int, int]]:
    """Every file the build will probe, with its current signature.

    Mirrors builder.load_scene's probe order: per OBJ, the OBJ itself,
    its mtllib targets, then either the four convention-map candidates
    (material_source="convention", builder.discover_convention_maps) or
    the MTL-referenced texture files ("mtl").  Missing files are recorded
    with size=-1 so their later appearance invalidates the entry.
    """
    deps: List[Tuple[str, int, int]] = []
    for path in filenames:
        deps.append(_sig(path))
        mdir = mtl_basepath or os.path.dirname(os.path.abspath(path))
        libs = [os.path.join(mdir, lib) for lib in _mtllibs(path)]
        deps.extend(_sig(lib) for lib in libs)
        if material_source == "convention":
            stem = os.path.splitext(path)[0]
            deps.extend(_sig(f"{stem}_{kind}.png") for kind in _KINDS)
        else:  # mtl: texture names come from the parsed MTLs
            from pathtracer.assets.obj import parse_mtl

            for lib in libs:
                for m in parse_mtl(lib).values():
                    for texname in (
                        m.diffuse_texname,
                        m.roughness_texname,
                        m.normal_texname or m.bump_texname,
                        m.metallic_texname,
                    ):
                        if texname:
                            deps.append(_sig(os.path.join(mdir, texname)))
    return deps


def cache_key(filenames: Sequence[str], params: dict) -> str:
    """Stable entry name from build parameters (NOT file contents —
    content changes are handled by the dep check, so an edited scene
    reuses its slot instead of growing the cache)."""
    blob = json.dumps(
        {
            "schema": SCHEMA,
            "files": [os.path.abspath(p) for p in filenames],
            "params": params,
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


# ---------------------------------------------------------------------------
# packed save / load


def save_packed_scene(path: str, scene, meta: dict) -> None:
    """Serialize a packed Scene (minus env) + meta to an uncompressed npz.

    Written atomically (temp file + rename): a killed process must not
    leave a torn entry that poisons every later warm load.
    """
    arrays: dict = {}
    for name in ("vertices", "normals", "uvs", "mat_ids", "tri_attrs"):
        arrays[f"s.{name}"] = np.asarray(getattr(scene, name))
    mt = scene.materials
    for name in _MT_ARRAYS:
        val = getattr(mt, name)
        if val is not None:
            arrays[f"m.{name}"] = np.asarray(val)

    def _py(v):  # json-safe: numpy bools/ints -> python
        return bool(v) if isinstance(v, (bool, np.bool_)) else int(v)

    statics = {f"m.{name}": _py(getattr(mt, name)) for name in _MT_STATICS}
    if scene.accel is not None:
        for name in _ACCEL_ARRAYS:
            val = getattr(scene.accel, name)
            if val is not None:
                arrays[f"a.{name}"] = np.asarray(val)
        for name in _ACCEL_STATICS:
            statics[f"a.{name}"] = _py(getattr(scene.accel, name))
        statics["has_accel"] = True
    else:
        statics["has_accel"] = False
    meta = dict(meta, schema=SCHEMA, statics=statics)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )

    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)   # store (no deflate): big pools, fast IO
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_meta(npz) -> Optional[dict]:
    try:
        return json.loads(bytes(npz["__meta__"]).decode())
    except Exception:  # torn/foreign file: treat as a miss, not an error
        return None


def load_packed_scene(path: str, env=None):
    """Rebuild the Scene from a cache entry, or None on any mismatch
    (missing file, schema bump, stale deps, torn write)."""
    import jax.numpy as jnp

    from pathtracer.scene.scene import (
        MaterialTable,
        Scene,
        default_env,
    )

    try:
        npz = np.load(path)
    except Exception:  # noqa: BLE001 — torn zip raises BadZipFile et al.
        return None
    with npz:
        meta = _read_meta(npz)
        if meta is None or meta.get("schema") != SCHEMA:
            return None
        for dep in meta.get("deps", []):
            if tuple(dep) != _sig(dep[0]):
                return None
        statics = meta["statics"]

        def arr(name):
            return jnp.asarray(npz[name]) if name in npz.files else None

        mt_kw = {n: arr(f"m.{n}") for n in _MT_ARRAYS}
        mt_kw.update({n: statics[f"m.{n}"] for n in _MT_STATICS})
        materials = MaterialTable(**mt_kw)
        accel = None
        if statics.get("has_accel"):
            from pathtracer.accel.cluster import ClusterAccel

            a_kw = {n: arr(f"a.{n}") for n in _ACCEL_ARRAYS}
            a_kw.update({n: statics[f"a.{n}"] for n in _ACCEL_STATICS})
            accel = ClusterAccel(**a_kw)
        return Scene(
            vertices=arr("s.vertices"),
            normals=arr("s.normals"),
            uvs=arr("s.uvs"),
            mat_ids=arr("s.mat_ids"),
            tri_attrs=arr("s.tri_attrs"),
            materials=materials,
            env=env if env is not None else default_env(),
            accel=accel,
        )


# ---------------------------------------------------------------------------
# the cached loader


def load_scene_cached(
    filenames: Sequence[str],
    env=None,
    cache_dir: Optional[str] = None,
    refresh: bool = False,
    **kw,
):
    """`builder.load_scene` behind the packed cache.

    Accepts every load_scene keyword.  `env` is attached fresh either
    way (never cached).  `refresh=True` forces a rebuild.  Set
    cache_dir="" (or env PT_SCENE_CACHE=0) to bypass entirely.
    """
    from pathtracer.scene.builder import load_scene
    from pathtracer.utils import logging as plog

    if cache_dir == "" or os.environ.get("PT_SCENE_CACHE") == "0":
        return load_scene(filenames, env=env, **kw)
    cache_dir = cache_dir or default_cache_dir()

    params = dict(kw)
    params.pop("use_native", None)  # bit-parity tested: output-identical
    accel_kw = params.pop("accel_kw", None)
    params["accel_kw"] = sorted((accel_kw or {}).items())
    key = cache_key(filenames, {k: params[k] for k in sorted(params)})
    path = os.path.join(cache_dir, f"scene-{key}.npz")

    material_source = kw.get("material_source", "convention")
    mtl_basepath = kw.get("mtl_basepath")

    if not refresh and os.path.exists(path):
        scene = load_packed_scene(path, env=env)
        if scene is not None:
            plog.info("scene", f"packed-scene cache hit: {path}")
            return scene
        plog.info("scene", "packed-scene cache stale; rebuilding")

    # Deps are fingerprinted BEFORE the build: a file changing mid-build
    # yields a stale-looking entry (rebuilt next time) instead of a
    # wrong-content one.
    deps = scene_deps(filenames, material_source, mtl_basepath)
    scene = load_scene(filenames, env=env, **kw)
    try:
        save_packed_scene(path, scene, {"deps": deps})
        plog.info("scene", f"packed-scene cache write: {path}")
    except OSError as e:  # read-only FS / disk full: render anyway
        plog.info("scene", f"packed-scene cache write failed: {e}")
    return scene
