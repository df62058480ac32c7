"""Environment lighting tests: equirect mapping, bilinear fetch, CDF +
alias-table importance sampling, and the NEE integrator path."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render import envmap
from pathtracer.scene.scene import make_env
from pathtracer.utils.image import procedural_hdr


def test_direction_uv_roundtrip():
    rs = np.random.RandomState(0)
    d = rs.randn(256, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u, v = envmap.direction_to_uv(jnp.asarray(d))
    back = np.asarray(envmap.uv_to_direction(u, v))
    np.testing.assert_allclose(back, d, atol=1e-5)


def test_sample_equirect_quads_match_plain():
    env = make_env(procedural_hdr(32, 64, seed=2))
    rs = np.random.RandomState(1)
    u = jnp.asarray(rs.rand(512).astype(np.float32))
    v = jnp.asarray(rs.rand(512).astype(np.float32))
    a = np.asarray(envmap.sample_equirect(env.data, u, v))
    b = np.asarray(
        envmap.sample_equirect(
            env.data, u, v, quads=env.quads, scrambled=env.quads_scrambled
        )
    )
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert env.quads_scrambled  # 32*64 is pow2 -> scrambled layout active


def test_constant_env_exact():
    env = make_env(np.full((8, 16, 3), 0.7, np.float32))
    d = jnp.asarray(np.random.RandomState(0).randn(64, 3), jnp.float32)
    cfg = RenderConfig(env_mode="equirect")
    out = np.asarray(envmap.eval_env(env, d, cfg))
    np.testing.assert_allclose(out, 0.7, atol=1e-5)


def test_sunsky_matches_reference_constants():
    # Sun disk (200,175,125) around normalize(0,2,3); sky (0.4,0.4,0.6)
    # (reference optixSphere.cu:552-557).
    sun = jnp.asarray([[0.0, 2.0, 3.0]], jnp.float32)
    side = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(envmap.sunsky(sun))[0], [200, 175, 125]
    )
    np.testing.assert_allclose(
        np.asarray(envmap.sunsky(side))[0], [0.4, 0.4, 0.6]
    )


def test_alias_table_distribution():
    # Draws must follow the luminance*sin(theta) texel distribution.
    env = envmap.with_importance_sampling(make_env(procedural_hdr(16, 32, seed=3)))
    h, w = 16, 32
    n = 200_000
    rs = np.random.RandomState(0)
    u1, u2 = jnp.asarray(rs.rand(n), jnp.float32), jnp.asarray(rs.rand(n), jnp.float32)
    u3, u4 = jnp.asarray(rs.rand(n), jnp.float32), jnp.asarray(rs.rand(n), jnp.float32)
    dirs, pdf, _, _ = envmap.sample_env_alias(env.alias_table, h, w, u1, u2, u3, u4)
    uu, vv = envmap.direction_to_uv(dirs)
    tx = np.clip((np.asarray(uu) * w).astype(int), 0, w - 1)
    ty = np.clip((np.asarray(vv) * h).astype(int), 0, h - 1)
    counts = np.bincount(ty * w + tx, minlength=h * w) / n

    weights, _ = envmap._env_texel_weights(env.data)
    p = np.asarray(weights).reshape(-1)
    p = p / p.sum()
    # L1 distance small; dominated texels sampled.
    assert np.abs(counts - p).sum() < 0.05
    assert np.all(np.asarray(pdf) > 0)


def test_eval_env_uv_passthrough_matches_direction_path():
    """eval_env(uv=...) must fetch the same radiance the direction
    round-trip would (within the float atan2/asin round-trip error that
    motivated the shortcut): for alias draws the two paths land in the
    same texel for virtually all lanes."""
    env = envmap.with_importance_sampling(make_env(procedural_hdr(16, 32, seed=6)))
    cfg = RenderConfig(width=8, height=8, env_mode="equirect")
    n = 4096
    rs = np.random.RandomState(2)
    us = [jnp.asarray(rs.rand(n), jnp.float32) for _ in range(4)]
    dirs, _, u, v = envmap.sample_env_alias(env.alias_table, 16, 32, *us)
    via_uv = np.asarray(envmap.eval_env(env, dirs, cfg, uv=(u, v)))
    via_dir = np.asarray(envmap.eval_env(env, dirs, cfg))
    same = np.isclose(via_uv, via_dir, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert same.mean() > 0.99  # only seam/rounding lanes may differ
    # And the uv path is exactly sample_equirect at those coordinates.
    direct = np.asarray(envmap.sample_equirect(
        env.data, u, v, quads=env.quads, scrambled=env.quads_scrambled
    ))
    np.testing.assert_array_equal(via_uv, direct)


def test_alias_pdf_consistency():
    # Monte-Carlo estimate of integral of 1 over the sphere using the
    # sampler's pdf must be ~4*pi.
    env = envmap.with_importance_sampling(make_env(procedural_hdr(16, 32, seed=4)))
    n = 200_000
    rs = np.random.RandomState(1)
    us = [jnp.asarray(rs.rand(n), jnp.float32) for _ in range(4)]
    _, pdf, _, _ = envmap.sample_env_alias(env.alias_table, 16, 32, *us)
    est = float(np.mean(1.0 / np.asarray(pdf)))
    assert abs(est - 4.0 * np.pi) / (4.0 * np.pi) < 0.05


def test_nee_render_runs_and_reduces_variance():
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import single_sphere_scene

    # Sun-heavy env: NEE should slash variance on the diffuse sphere.
    env = envmap.with_importance_sampling(
        make_env(procedural_hdr(32, 64, sun_intensity=500.0))
    )
    scene = single_sphere_scene(stacks=6, slices=12).replace(env=env)
    base = dict(
        width=24, height=16, samples_per_launch=4, max_depth=3, dof=False,
        env_mode="equirect", intersector="brute", rr_mode="standard",
    )
    cfg_bsdf = RenderConfig(**base)
    cfg_nee = RenderConfig(**base, env_importance_sampling=True)
    cam = camera_arrays(Camera(), cfg_bsdf)

    def frames(cfg, k0):
        return [
            np.asarray(render_frame(scene, cam, cfg, jnp.int32(k)))
            for k in range(k0, k0 + 4)
        ]

    f_b = frames(cfg_bsdf, 0)
    f_n = frames(cfg_nee, 0)
    assert all(np.all(np.isfinite(f)) for f in f_b + f_n)
    # Frame-to-frame variance on sphere pixels (bottom half of image).
    var_b = np.var(np.stack(f_b), axis=0)[:8].mean()
    var_n = np.var(np.stack(f_n), axis=0)[:8].mean()
    assert var_n < var_b


def test_nee_requires_alias_table():
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import single_sphere_scene

    scene = single_sphere_scene(stacks=4, slices=8)  # default env, no table
    cfg = RenderConfig(
        width=8, height=8, samples_per_launch=1, max_depth=2, dof=False,
        env_mode="equirect", intersector="brute", env_importance_sampling=True,
        rr_mode="standard",
    )
    with pytest.raises(ValueError, match="alias table"):
        render_frame(scene, camera_arrays(Camera(), cfg), cfg, jnp.int32(0))


def test_nee_rejects_reference_rr():
    """NEE with the reference's quirky terminal-/p RR estimator is an
    unvalidated combination: config must refuse it,
    so no reachable CLI invocation runs it."""
    with pytest.raises(ValueError, match="rr_mode='standard'"):
        RenderConfig(
            width=8, height=8, env_importance_sampling=True,
            rr_mode="reference",
        )


def test_cli_nee_implies_standard_rr():
    """`--nee` without an explicit --rr-mode must build a standard-RR
    config instead of tripping the validation error — independent of
    the host process's sys.argv (the implication keys off argparse
    None-sentinel defaults, not argv sniffing)."""
    from pathtracer.cli import build_arg_parser, build_from_args

    args = build_arg_parser().parse_args(
        ["--dim", "16x12", "--env", "procedural", "--nee"]
    )
    _, _, cfg = build_from_args(args)
    assert cfg.env_importance_sampling and cfg.rr_mode == "standard"

    # An EXPLICIT reference-RR request (including the --flag=value
    # spelling argv sniffing used to miss) must NOT be silently
    # overridden: validation raises its clear error instead.
    args = build_arg_parser().parse_args(
        ["--dim", "16x12", "--env", "procedural", "--nee",
         "--rr-mode=reference"]
    )
    with pytest.raises(ValueError, match="rr_mode='standard'"):
        build_from_args(args)


def test_scenefile_nee_implies_standard_rr(tmp_path):
    """A scene file enabling env importance sampling without an rr_mode
    key must load with standard RR (the implication lives at config
    assembly in scenefile.py, not just the CLI)."""
    from pathtracer.scene.scenefile import load_scene_file

    f = tmp_path / "nee.toml"
    f.write_text(
        "[render]\nwidth = 16\nheight = 12\n"
        "[environment]\nmode = \"equirect\"\n"
        "procedural = { height = 16, width = 32 }\n"
        "importance_sampling = true\n"
    )
    _, _, cfg = load_scene_file(str(f), {})
    assert cfg.env_importance_sampling and cfg.rr_mode == "standard"


@pytest.mark.slow
def test_nee_matches_bsdf_sampling_mean():
    """The NEE estimator must converge to the SAME image as plain BSDF
    sampling (a biased NEE would silently corrupt --nee).

    Diffuse sphere under a sun-heavy env; both estimators accumulate many
    subframes; means must agree within Monte-Carlo noise."""
    from pathtracer.render.camera import Camera
    from pathtracer.render.film import accumulate
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import single_sphere_scene

    env = envmap.with_importance_sampling(
        make_env(procedural_hdr(16, 32, seed=7, sun_intensity=40.0))
    )
    scene = single_sphere_scene(stacks=8, slices=16).replace(env=env)
    base = dict(
        width=16, height=12, samples_per_launch=16, max_depth=4, dof=False,
        env_mode="equirect", intersector="brute", rr_mode="standard",
        regenerate=False,
    )
    cfg_bsdf = RenderConfig(**base)
    cfg_nee = RenderConfig(**base, env_importance_sampling=True)
    cam = camera_arrays(Camera(), cfg_bsdf)

    def mean_image(cfg, frames):
        acc = jnp.zeros((cfg.height, cfg.width, 3))
        for k in range(frames):
            acc = accumulate(acc, render_frame(scene, cam, cfg, jnp.int32(k)), k)
        return np.asarray(acc)

    img_b = mean_image(cfg_bsdf, 40)
    img_n = mean_image(cfg_nee, 40)
    # Mean brightness agreement (global bias gate) ...
    tot_b, tot_n = img_b.mean(), img_n.mean()
    assert abs(tot_b - tot_n) / tot_b < 0.03, (tot_b, tot_n)
    # ... and per-pixel agreement within noise.
    rel = np.abs(img_b - img_n) / (img_b + 0.05)
    assert np.median(rel) < 0.08, float(np.median(rel))


def test_env_pdf_alias_matches_sampler():
    # env_pdf_alias evaluated AT the sampler's own draws must reproduce
    # the pdf the sampler returned (same mass, same continuous-elevation
    # Jacobian) — the consistency the defensive-mixture weight rests on.
    env = envmap.with_importance_sampling(make_env(procedural_hdr(16, 32, seed=4)))
    n = 20_000
    rs = np.random.RandomState(3)
    us = [jnp.asarray(rs.rand(n), jnp.float32) for _ in range(4)]
    d, pdf, _, _ = envmap.sample_env_alias(env.alias_table, 16, 32, *us)
    pdf2 = envmap.env_pdf_alias(env.alias_table, 16, 32, d)
    # The direction->uv round-trip can land in a neighbouring texel for
    # draws at a texel edge; demand exact-texel agreement for the bulk.
    rel = np.abs(np.asarray(pdf2) - np.asarray(pdf)) / np.asarray(pdf)
    assert float(np.mean(rel < 1e-3)) > 0.97, float(np.mean(rel < 1e-3))


@pytest.mark.slow
def test_nee_defensive_mix_matches_mean():
    """The defensive 0.5 alias + 0.5 cosine mixture is the SAME integral:
    its converged image must agree with plain NEE and the weight math is
    bounded by the balance heuristic (no silent bias)."""
    from pathtracer.render.camera import Camera
    from pathtracer.render.film import accumulate
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import single_sphere_scene

    env = envmap.with_importance_sampling(
        make_env(procedural_hdr(16, 32, seed=7, sun_intensity=40.0))
    )
    scene = single_sphere_scene(stacks=8, slices=16).replace(env=env)
    base = dict(
        width=16, height=12, samples_per_launch=16, max_depth=4, dof=False,
        env_mode="equirect", intersector="brute", rr_mode="standard",
        regenerate=False, env_importance_sampling=True,
    )
    cfg_nee = RenderConfig(**base)
    cfg_mix = RenderConfig(**base, nee_defensive_mix=True)
    cam = camera_arrays(Camera(), cfg_nee)

    def mean_image(cfg, frames):
        acc = jnp.zeros((cfg.height, cfg.width, 3))
        for k in range(frames):
            acc = accumulate(acc, render_frame(scene, cam, cfg, jnp.int32(k)), k)
        return np.asarray(acc)

    img_n = mean_image(cfg_nee, 40)
    img_m = mean_image(cfg_mix, 40)
    tot_n, tot_m = img_n.mean(), img_m.mean()
    assert abs(tot_n - tot_m) / tot_n < 0.03, (tot_n, tot_m)
    rel = np.abs(img_n - img_m) / (img_n + 0.05)
    assert np.median(rel) < 0.08, float(np.median(rel))


def test_nee_defensive_mix_requires_nee():
    import pytest

    with pytest.raises(ValueError, match="nee_defensive_mix"):
        RenderConfig(nee_defensive_mix=True)


@pytest.mark.slow
def test_nee_mis_spec_matches_mean():
    """Spec-lobe MIS re-weights BOTH arms of the spec env estimate with
    balance weights that sum to 1, so the converged image must agree
    with plain NEE (no silent bias from the pdf bookkeeping)."""
    from pathtracer.render.camera import Camera
    from pathtracer.render.film import accumulate
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import single_sphere_scene

    env = envmap.with_importance_sampling(
        make_env(procedural_hdr(16, 32, seed=7, sun_intensity=40.0))
    )
    scene = single_sphere_scene(stacks=8, slices=16).replace(env=env)
    base = dict(
        width=16, height=12, samples_per_launch=16, max_depth=4, dof=False,
        env_mode="equirect", intersector="brute", rr_mode="standard",
        regenerate=False, env_importance_sampling=True,
    )
    cfg_nee = RenderConfig(**base)
    cfg_mis = RenderConfig(**base, nee_mis_spec=True)
    cam = camera_arrays(Camera(), cfg_nee)

    def mean_image(cfg, frames):
        acc = jnp.zeros((cfg.height, cfg.width, 3))
        for k in range(frames):
            acc = accumulate(acc, render_frame(scene, cam, cfg, jnp.int32(k)), k)
        return np.asarray(acc)

    img_n = mean_image(cfg_nee, 40)
    img_m = mean_image(cfg_mis, 40)
    tot_n, tot_m = img_n.mean(), img_m.mean()
    assert abs(tot_n - tot_m) / tot_n < 0.04, (tot_n, tot_m)
    rel = np.abs(img_n - img_m) / (img_n + 0.05)
    assert np.median(rel) < 0.08, float(np.median(rel))


def test_nee_mis_spec_requires_nee():
    import pytest

    with pytest.raises(ValueError, match="nee_mis_spec"):
        RenderConfig(nee_mis_spec=True)


def test_nee_multi_queue_matches_immediate_mean():
    """Multi-queue NEE (shadow ray deferred onto the next bounce's
    closest-hit batch; RR-killed paths drop it, survivors scale by
    1/p_survive) is a DIFFERENT unbiased estimator from the immediate
    any-hit resolve — gate the agreement statistically, per scheduler."""
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import three_spheres_scene

    env = envmap.with_importance_sampling(make_env(procedural_hdr(16, 32)))
    scene = three_spheres_scene(stacks=6, slices=12).replace(env=env)
    base = dict(
        width=24, height=16, max_depth=5, dof=False, env_mode="equirect",
        intersector="brute", rr_mode="standard",
        env_importance_sampling=True,
    )
    cam = camera_arrays(
        Camera(eye=(0, 2, 8), lookat=(0, 1, 0)).with_aspect(24, 16),
        RenderConfig(**base),
    )

    for sched_kw in (
        dict(regenerate=False, samples_per_launch=64),
        dict(regenerate=True, samples_per_launch=64),
        dict(regenerate=True, samples_per_launch=8, stream_lanes=96),
    ):
        img = {}
        for mqv in ("off", "on"):
            cfg = RenderConfig(**base, nee_multi_queue=mqv, **sched_kw)
            img[mqv] = np.asarray(
                render_frame(scene, cam, cfg, jnp.int32(0))
            )
            assert np.all(np.isfinite(img[mqv]))
        rel = abs(img["on"].mean() - img["off"].mean()) / img["off"].mean()
        assert rel < 0.03, (sched_kw, rel)
        # Determinism: the mq estimator itself is seed-reproducible.
        cfg = RenderConfig(**base, nee_multi_queue="on", **sched_kw)
        again = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))
        np.testing.assert_array_equal(again, img["on"])


def test_nee_multi_queue_shadow_accounting():
    """mq counts traced (deferred) shadow rays, not hit lanes: totals stay
    plausible (> 0, <= segments) and the render is finite."""
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import (
        camera_arrays, render_frame_stats,
    )
    from pathtracer.scene.procedural import single_sphere_scene

    env = envmap.with_importance_sampling(make_env(procedural_hdr(16, 32)))
    scene = single_sphere_scene(stacks=6, slices=12).replace(env=env)
    cfg = RenderConfig(
        width=16, height=12, samples_per_launch=4, max_depth=4, dof=False,
        env_mode="equirect", intersector="brute", rr_mode="standard",
        env_importance_sampling=True, nee_multi_queue="on",
    )
    cam = camera_arrays(Camera(), cfg)
    img, stats = render_frame_stats(scene, cam, cfg, jnp.int32(0))
    assert np.all(np.isfinite(np.asarray(img)))
    sh = int(stats["shadow_segments"])
    assert 0 < sh <= int(stats["segments"])


def test_nee_multi_queue_with_mis_and_defensive():
    """mq composes with spec-lobe MIS and the defensive mixture: finite,
    deterministic, and statistically equal to immediate resolve."""
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import three_spheres_scene

    env = envmap.with_importance_sampling(
        make_env(procedural_hdr(16, 32, sun_intensity=100.0))
    )
    scene = three_spheres_scene(stacks=6, slices=12).replace(env=env)
    base = dict(
        width=24, height=16, samples_per_launch=32, max_depth=5, dof=False,
        env_mode="equirect", intersector="brute", rr_mode="standard",
        env_importance_sampling=True, regenerate=False,
        nee_mis_spec=True, nee_defensive_mix=True,
    )
    cam = camera_arrays(
        Camera(eye=(0, 2, 8), lookat=(0, 1, 0)).with_aspect(24, 16),
        RenderConfig(**base),
    )
    img = {}
    for mqv in ("off", "on"):
        cfg = RenderConfig(nee_multi_queue=mqv, **base)
        img[mqv] = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))
        assert np.all(np.isfinite(img[mqv]))
    rel = abs(img["on"].mean() - img["off"].mean()) / img["off"].mean()
    assert rel < 0.05, rel
