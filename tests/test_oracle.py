"""Cross-validation: vectorized JAX integrator vs the pure-numpy scalar
oracle (SURVEY.md §4 tier 3: "CPU reference renderer ... same algorithms
in pure numpy").  Identical counter-based seeds make the comparison
near-bitwise; the gate tolerates the rare lane where float32 FMA
differences flip a discrete decision."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer import oracle
from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera
from pathtracer.render.integrator import camera_arrays, render_frame
from pathtracer.scene.procedural import (
    single_sphere_scene,
    three_spheres_scene,
)

REF = "/root/reference"


def compare(scene, cfg, camera, min_match=0.98):
    cam = camera_arrays(camera, cfg)
    n = cfg.width * cfg.height
    img_jax = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0))).reshape(-1, 3)
    img_orc = oracle.render(scene, cam, cfg, range(n), 0)
    diff = np.abs(img_jax - img_orc).max(axis=1)
    rel = diff / (1.0 + np.abs(img_jax).max(axis=1))
    frac = float((rel < 1e-3).mean())
    assert frac >= min_match, f"only {frac*100:.1f}% pixels match"
    return frac


def cfg_(**kw):
    base = dict(
        width=16, height=12, samples_per_launch=2, max_depth=4,
        dof=False, env_mode="sunsky", intersector="brute", regenerate=False,
    )
    base.update(kw)
    return RenderConfig(**base)


def test_oracle_sunsky_spheres():
    frac = compare(three_spheres_scene(stacks=6, slices=12), cfg_(), Camera())
    assert frac == 1.0  # exact on this scene in practice


def test_oracle_dof_and_constant_env():
    compare(
        single_sphere_scene(stacks=6, slices=12),
        cfg_(dof=True, env_mode="constant"),
        Camera(),
    )


def test_oracle_regeneration_schedules_match():
    # The oracle validates ALL schedules at once (they are bitwise-equal).
    scene = single_sphere_scene(stacks=6, slices=12)
    compare(scene, cfg_(regenerate=True, env_mode="constant"), Camera())


def test_oracle_standard_rr():
    compare(
        single_sphere_scene(stacks=6, slices=12),
        cfg_(rr_mode="standard", env_mode="constant"),
        Camera(),
    )


def test_oracle_glass():
    from tests.test_integrator import make_single_material_sphere

    scene = make_single_material_sphere(
        dict(color=(1, 1, 1), roughness=0.1, transparent=True)
    )
    compare(scene, cfg_(env_mode="constant", max_depth=6), Camera(eye=(0, 0, 4)))


@pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
def test_oracle_textured_monkey_equirect():
    from pathtracer.scene.builder import load_scene
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = make_env(procedural_hdr(16, 32))
    scene = load_scene([f"{REF}/monkey.obj"], env=env, rng_seed=0)
    compare(
        scene,
        # texture_lod="off": the numpy oracle has no mip ladder, and the
        # monkey's 32 MB pool would engage it in "auto" mode.
        cfg_(
            env_mode="equirect", samples_per_launch=1, max_depth=3,
            texture_lod="off",
        ),
        Camera(eye=(0, 1, 4), lookat=(0, 0.6, 0)),
    )


def test_oracle_nee():
    # NEE path: alias-table draws, shadow query and the lobe-partitioned
    # weight must agree lane-for-lane with the integrator.
    from pathtracer.render.envmap import with_importance_sampling
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = with_importance_sampling(make_env(procedural_hdr(16, 32, seed=5)))
    scene = three_spheres_scene(stacks=6, slices=12).replace(env=env)
    cfg = cfg_(
        env_mode="equirect", env_importance_sampling=True, rr_mode="standard"
    )
    frac = compare(scene, cfg, Camera())
    assert frac >= 0.98


def test_oracle_nee_defensive_mix():
    # Defensive-mixture NEE: branch choice, cosine draw, mixture pdf and
    # the discarded pair-parity draw must agree lane-for-lane with the
    # integrator (same contract as test_oracle_nee).
    from pathtracer.render.envmap import with_importance_sampling
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = with_importance_sampling(make_env(procedural_hdr(16, 32, seed=5)))
    scene = three_spheres_scene(stacks=6, slices=12).replace(env=env)
    cfg = cfg_(
        env_mode="equirect", env_importance_sampling=True,
        nee_defensive_mix=True, rr_mode="standard",
    )
    frac = compare(scene, cfg, Camera())
    assert frac >= 0.98


def test_oracle_nee_mis_spec():
    # Spec-lobe MIS: the carried balance weight, the light-arm spec term
    # and the weighted miss credit must agree lane-for-lane.
    from pathtracer.render.envmap import with_importance_sampling
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = with_importance_sampling(make_env(procedural_hdr(16, 32, seed=5)))
    scene = three_spheres_scene(stacks=6, slices=12).replace(env=env)
    cfg = cfg_(
        env_mode="equirect", env_importance_sampling=True,
        nee_mis_spec=True, rr_mode="standard",
    )
    frac = compare(scene, cfg, Camera())
    assert frac >= 0.98


@pytest.mark.slow
def test_oracle_ssim_hero_crop():
    """Whole-image SSIM gate vs the oracle on a hero-scene crop — the
    reduced-size version of tools/parity_oracle_ssim.py (full artifact:
    96x54 @ 64 spp -> SSIM 1.00000 reference-RR / 0.99996 NEE+MIS,
    artifacts/parity_report.json["oracle_ssim"])."""
    from pathtracer import oracle
    from pathtracer.render.film import post_process
    from pathtracer.scene.builder import load_scene
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr
    from pathtracer.utils.ssim import ssim

    if not os.path.exists(f"{REF}/suitcase.obj"):
        pytest.skip("reference assets unavailable")
    env = make_env(procedural_hdr(32, 64))
    scene = load_scene(
        [f"{REF}/suitcase.obj", f"{REF}/test.obj"], scale=0.05, env=env,
        rng_seed=0,
    )
    cfg = RenderConfig(
        width=32, height=18, samples_per_launch=8, max_depth=6, dof=False,
        env_mode="equirect", intersector="brute", regenerate=False,
        rr_mode="reference",
    )
    camera = Camera(eye=(0, 2, 6), lookat=(0, 0.5, 0)).with_aspect(32, 18)
    cam = camera_arrays(camera, cfg)
    img_jax = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))
    img_orc = oracle.render(scene, cam, cfg, range(32 * 18), 0).reshape(
        18, 32, 3
    )
    s = float(ssim(
        np.asarray(post_process(jnp.asarray(img_jax), cfg)),
        np.asarray(post_process(jnp.asarray(img_orc), cfg)),
    ))
    assert s >= 0.99, s
