"""Golden-image regression tests (SURVEY.md §4 tier 3).

Goldens are small fixed-seed CPU renders committed under tests/goldens/.
Counter-based threefry-style seeding makes renders bitwise reproducible,
so the gate is exact-by-default with an SSIM safety net for compiler
noise (BASELINE.md SSIM > 0.99 target shape).

Regenerate after an *intentional* estimator change with:
    REGEN_GOLDENS=1 python -m pytest tests/test_golden.py
(running through pytest keeps the conftest device config identical to
the comparison runs — XLA's CPU partitioning shifts a few edge pixels
between 1- and 8-device compilation).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera
from pathtracer.render.film import post_process
from pathtracer.render.integrator import camera_arrays, render_frame
from pathtracer.scene.procedural import single_sphere_scene, three_spheres_scene
from pathtracer.utils.ssim import ssim

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
REF = "/root/reference"


def config1_sphere():
    """BASELINE.md config 1: diffuse sphere, constant sky (scaled down)."""
    cfg = RenderConfig(
        width=64, height=48, samples_per_launch=4, max_depth=6,
        dof=False, env_mode="constant", intersector="brute",
    )
    scene = single_sphere_scene(stacks=10, slices=20)
    return scene, Camera(), cfg


def config_spheres_sunsky():
    cfg = RenderConfig(
        width=64, height=48, samples_per_launch=2, max_depth=4,
        dof=True, env_mode="sunsky", intersector="brute",
    )
    return three_spheres_scene(stacks=8, slices=16), Camera(eye=(0, 2, 8)), cfg


def config_monkey():
    if not os.path.exists(f"{REF}/monkey.obj"):
        return None
    from pathtracer.accel.build import build_accel
    from pathtracer.scene.builder import load_scene
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = make_env(procedural_hdr(32, 64))
    scene = build_accel(
        load_scene([f"{REF}/monkey.obj"], env=env, rng_seed=0), kind="cluster"
    )
    cfg = RenderConfig(
        width=64, height=48, samples_per_launch=2, max_depth=4,
        dof=False, env_mode="equirect", intersector="cluster",
        # Strict parity mode pinned explicitly (monkey's 1024^2 albedo
        # pool is over the mip-build threshold; "auto" also resolves to
        # off, but goldens should not depend on that policy).
        texture_lod="off",
    )
    return scene, Camera(eye=(0, 1, 4), lookat=(0, 0.6, 0)), cfg


def config_spheres_nee():
    """The beyond-reference flagship path: alias-table env importance
    sampling (NEE) with the textbook RR estimator."""
    from pathtracer.render.envmap import with_importance_sampling
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = with_importance_sampling(make_env(procedural_hdr(32, 64)))
    scene = three_spheres_scene(stacks=8, slices=16).replace(env=env)
    cfg = RenderConfig(
        width=64, height=48, samples_per_launch=2, max_depth=4,
        dof=False, env_mode="equirect", intersector="brute",
        env_importance_sampling=True, rr_mode="standard",
    )
    return scene, Camera(eye=(0, 2, 8)), cfg


CONFIGS = {
    "sphere_constant": config1_sphere,
    "spheres_sunsky_dof": config_spheres_sunsky,
    "monkey_textured": config_monkey,
    "spheres_nee": config_spheres_nee,
}


def render(make):
    setup = make()
    if setup is None:
        pytest.skip("assets unavailable")
    scene, camera, cfg = setup
    cam = camera_arrays(camera, cfg)
    acc = render_frame(scene, cam, cfg, jnp.int32(0))
    acc = (acc + render_frame(scene, cam, cfg, jnp.int32(1))) / 2.0
    return np.asarray(post_process(acc, cfg))


@pytest.mark.parametrize(
    "name",
    [
        # monkey_textured is the one >10 s golden (full OBJ load + textures).
        pytest.param(n, marks=[pytest.mark.slow] if n == "monkey_textured" else [])
        for n in CONFIGS
    ],
)
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if os.environ.get("REGEN_GOLDENS"):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        img = render(CONFIGS[name])
        np.savez_compressed(path, img=img)
        pytest.skip(f"regenerated {name}")
    if not os.path.exists(path):
        pytest.skip("golden missing; run REGEN_GOLDENS=1 pytest tests/test_golden.py")
    img = render(CONFIGS[name])
    golden = np.load(path)["img"]
    if np.array_equal(img, golden):
        return
    s = ssim(img, golden)
    assert s > 0.995, f"{name}: SSIM {s:.4f} vs golden"
    np.testing.assert_allclose(img, golden, atol=5e-3)


if __name__ == "__main__":
    print(__doc__)
