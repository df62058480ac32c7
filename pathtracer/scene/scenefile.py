"""Scene description files (TOML): the reference's hard-coded scene block
as data.

The reference hard-codes its scene — OBJ list + scale (optixSphere.cpp:
829-841), env map path (cpp:835), camera pose (cpp:104-107), and every
render constant — in C++ sources.  A scene file captures all of it:

    [scene]
    objects = ["suitcase.obj", "test.obj"]   # relative to this file
    scale = 0.05
    material_source = "convention"           # or "mtl"
    add_floor = true
    rng_seed = 0
    accel = "cluster"                        # cluster | none

    [environment]
    mode = "equirect"                        # equirect | sunsky | constant
    hdr = "env4.exr"                         # image file, or:
    procedural = { height = 256, width = 512, sun_intensity = 100.0 }
    constant = [0.4, 0.4, 0.6]
    importance_sampling = false

    [camera]
    eye = [0.0, 2.0, 6.0]
    lookat = [0.0, 0.5, 0.0]
    up = [0.0, 1.0, 0.0]
    fov_y = 50.0

    [render]                                 # any RenderConfig field
    width = 1600
    height = 1200
    samples_per_launch = 10
    max_depth = 20
    dof = false

Load with `load_scene_file(path)` -> (scene, camera, cfg); the CLI takes
`--scene-file scenes/suitcase.toml`.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Optional, Tuple

from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera


def _build_env(env_spec: dict, base_dir: str, cfg_mode: str):
    """EnvironmentMap from the [environment] table (None = default)."""
    from pathtracer.scene.scene import make_env

    if "hdr" in env_spec:
        from pathtracer.utils.image import load_exr, load_image

        p = os.path.join(base_dir, env_spec["hdr"])
        data = load_exr(p) if p.lower().endswith(".exr") else load_image(p)
        env = make_env(data)
    elif "procedural" in env_spec:
        from pathtracer.utils.image import procedural_hdr

        p = dict(env_spec["procedural"])
        env = make_env(
            procedural_hdr(
                p.pop("height", 256), p.pop("width", 512), **p
            )
        )
    else:
        env = None

    if env is not None and env_spec.get("importance_sampling", False):
        from pathtracer.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)
    return env


def load_scene_file(
    path: str, overrides: Optional[dict] = None
) -> Tuple[object, Camera, RenderConfig]:
    """Parse a scene TOML into (Scene, Camera, RenderConfig).

    `overrides` (field -> value) patches [render] after parsing — the CLI
    maps explicit flags there so the file supplies defaults.
    """
    with open(path, "rb") as f:
        spec = tomllib.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))

    scene_spec = spec.get("scene", {})
    env_spec = spec.get("environment", {})
    cam_spec = spec.get("camera", {})
    render_spec = dict(spec.get("render", {}))

    # [render] -> RenderConfig (validate field names early)
    if "mode" in env_spec:
        render_spec.setdefault("env_mode", env_spec["mode"])
    if "importance_sampling" in env_spec:
        render_spec.setdefault(
            "env_importance_sampling", env_spec["importance_sampling"]
        )
    if "constant" in env_spec:
        render_spec.setdefault("env_constant", tuple(env_spec["constant"]))
    if overrides:
        render_spec.update(overrides)
    # NEE requires the textbook RR estimator (RenderConfig validation).
    # Imply it here — where the config is assembled — unless the file or
    # an explicit CLI override picked an rr_mode; then let validation
    # raise its clear error.
    if render_spec.get("env_importance_sampling") and "rr_mode" not in render_spec:
        render_spec["rr_mode"] = "standard"
    valid = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(render_spec) - valid
    if unknown:
        raise ValueError(
            f"{path}: unknown [render] fields: {sorted(unknown)}"
        )
    cfg = RenderConfig(**render_spec)

    env = _build_env(env_spec, base_dir, cfg.env_mode)
    # A CLI override (--nee/--nee-defensive) can enable NEE even when the
    # file's [environment] did not ask for importance_sampling — the env
    # still needs its alias table.
    if (
        env is not None
        and cfg.env_importance_sampling
        and env.alias_table is None
    ):
        from pathtracer.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)

    camera = Camera(
        eye=tuple(cam_spec.get("eye", (0.0, 2.0, 6.0))),       # cpp:104
        lookat=tuple(cam_spec.get("lookat", (0.0, 0.0, 0.0))),
        up=tuple(cam_spec.get("up", (0.0, 1.0, 0.0))),
        fov_y=float(cam_spec.get("fov_y", 50.0)),              # cpp:107
    )

    objects = scene_spec.get("objects", [])
    accel = scene_spec.get("accel", "cluster")
    accel = None if accel in ("none", "brute", "") else accel
    if objects:
        # Packed-scene cache: warm loads skip PNG decode + quad/bundle
        # packing (scene/cache.py; PT_SCENE_CACHE=0 bypasses).
        from pathtracer.scene.cache import load_scene_cached as load_scene

        scene = load_scene(
            [os.path.join(base_dir, o) for o in objects],
            scale=float(scene_spec.get("scale", 1.0)),
            env=env,
            material_source=scene_spec.get("material_source", "convention"),
            add_floor=bool(scene_spec.get("add_floor", True)),
            floor_size=float(scene_spec.get("floor_size", 200.0)),
            skip_non_triangles=bool(
                scene_spec.get("skip_non_triangles", False)
            ),
            rng_seed=scene_spec.get("rng_seed", 0),
            accel=accel,
        )
    else:
        # Procedural fallback, like the reference's built-in spheres
        # (optixSphere.cpp:650-751).
        from pathtracer.scene.procedural import three_spheres_scene

        scene = three_spheres_scene()
        if env is not None:
            scene = scene.replace(env=env)
        if accel is not None:
            from pathtracer.accel.build import build_accel

            scene = build_accel(scene, kind=accel)

    return scene, camera, cfg
