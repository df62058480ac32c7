"""Runtime tests: progressive driver, checkpoint/resume bitwise identity,
CLI, viewer endpoints (SURVEY.md §5 aux subsystems)."""

import json
import urllib.request

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera
from pathtracer.runtime.progressive import ProgressiveRenderer
from pathtracer.scene.procedural import single_sphere_scene


def cfg_(**kw):
    base = dict(
        width=32,
        height=16,
        samples_per_launch=2,
        max_depth=3,
        dof=False,
        env_mode="constant",
        intersector="brute",
    )
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def scene():
    return single_sphere_scene(stacks=6, slices=12)


def test_progressive_steps_advance(scene):
    r = ProgressiveRenderer(scene, Camera(), cfg_())
    r.step()
    r.step()
    assert r.subframe == 2
    assert r.spp == 4
    assert r.stats()["subframe"] == 2


def test_camera_change_resets(scene):
    r = ProgressiveRenderer(scene, Camera(), cfg_())
    r.step()
    r.set_camera(r.camera.orbit(10, 0))
    assert r.subframe == 0
    assert float(np.abs(np.asarray(r.accum)).max()) == 0.0


@pytest.mark.slow
def test_denoise_display_path(scene):
    """denoise=True filters the displayed/saved image only: the raw
    accumulation (and therefore checkpoints and the progressive
    estimator) is untouched, and the G-buffer invalidates on camera
    change."""
    raw = ProgressiveRenderer(scene, Camera(), cfg_())
    den = ProgressiveRenderer(scene, Camera(), cfg_(), denoise=True)
    raw.step()
    den.step()
    np.testing.assert_array_equal(np.asarray(raw.accum), np.asarray(den.accum))
    img_raw = raw.image_u8()
    img_den = den.image_u8()
    assert img_den.shape == img_raw.shape
    assert np.isfinite(den.image_hdr()).all()
    # EXR/HDR output stays RAW even with denoise on (external denoisers
    # need the unfiltered accumulation; docs/usage.md promises this).
    np.testing.assert_array_equal(den.image_hdr(), np.asarray(den.accum)[::-1])
    # The filter actually does something on a noisy 2-spp sphere frame.
    assert not np.array_equal(img_raw, img_den)
    assert den._aov is not None
    den.set_camera(den.camera.orbit(10, 0))
    assert den._aov is None
    # Denoised in-motion preview: finite and displayed at full size.
    assert den.step_preview()
    img = den.image_u8()
    assert img.shape == img_raw.shape and np.isfinite(img).all()


def test_checkpoint_resume_bitwise(scene, tmp_path):
    ck = str(tmp_path / "ck.npz")
    cfg = cfg_()
    # straight 4 subframes
    a = ProgressiveRenderer(scene, Camera(), cfg)
    for _ in range(4):
        a.step()
    # 2 subframes, checkpoint, resume in a fresh renderer, 2 more
    b = ProgressiveRenderer(scene, Camera(), cfg)
    b.step()
    b.step()
    b.save_checkpoint(ck)
    c = ProgressiveRenderer(scene, Camera(), cfg)
    c.load_checkpoint(ck)
    c.step()
    c.step()
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(c.accum))


def test_checkpoint_config_mismatch_rejected(scene, tmp_path):
    ck = str(tmp_path / "ck.npz")
    a = ProgressiveRenderer(scene, Camera(), cfg_())
    a.step()
    a.save_checkpoint(ck)
    b = ProgressiveRenderer(scene, Camera(), cfg_(max_depth=5))
    with pytest.raises(ValueError, match="config mismatch"):
        b.load_checkpoint(ck)


def test_cli_offline_render(scene, tmp_path):
    from pathtracer.cli import main

    out = str(tmp_path / "out.png")
    rc = main(
        [
            "--file", out, "--dim=32x16", "-s", "1", "--spp", "2",
            "--max-depth", "2", "--no-dof", "--env", "constant",
        ]
    )
    assert rc == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (16, 32, 3)
    assert img.max() > 0


def test_cli_denoise_and_aov_outputs(scene, tmp_path):
    from PIL import Image

    from pathtracer.cli import main

    out = str(tmp_path / "out.png")
    prefix = str(tmp_path / "g")
    rc = main(
        [
            "--file", out, "--dim=32x16", "-s", "1", "--spp", "1",
            "--max-depth", "2", "--no-dof", "--env", "constant",
            "--denoise", "--aov-prefix", prefix,
        ]
    )
    assert rc == 0
    assert np.asarray(Image.open(out)).max() > 0
    for kind in ("normal", "depth", "albedo"):
        img = np.asarray(Image.open(f"{prefix}_{kind}.png"))
        assert img.shape == (16, 32, 3), kind


def test_cli_nee_defensive_smoke(scene, tmp_path):
    # --nee-defensive implies --nee, builds the alias table for the
    # procedural equirect env, and renders non-black output.
    from PIL import Image

    from pathtracer.cli import main

    out = str(tmp_path / "mix.png")
    rc = main(
        [
            "--file", out, "--dim=32x16", "-s", "1", "--spp", "1",
            "--max-depth", "2", "--no-dof", "--env", "procedural",
            "--nee-defensive",
        ]
    )
    assert rc == 0
    assert np.asarray(Image.open(out)).max() > 0


def test_cli_dim_validation():
    from pathtracer.cli import main

    with pytest.raises(SystemExit):
        main(["--dim", "banana"])


def test_viewer_endpoints(scene):
    from pathtracer.viewer import serve

    r = ProgressiveRenderer(scene, Camera(), cfg_())
    httpd, stop = serve(r, port=0, block=False)
    port = httpd.server_address[1]
    try:
        html = urllib.request.urlopen(f"http://127.0.0.1:{port}/").read()
        assert b"pathtracer" in html
        png = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        stats = json.loads(
            urllib.request.urlopen(f"http://127.0.0.1:{port}/stats").read()
        )
        assert "spp" in stats and "dof" in stats
        assert (
            urllib.request.urlopen(f"http://127.0.0.1:{port}/orbit?dyaw=5&dpitch=0").read()
            == b"ok"
        )
        assert (
            urllib.request.urlopen(f"http://127.0.0.1:{port}/toggle_dof").read()
            == b"ok"
        )
        assert r.cfg.dof  # toggled from False
        assert "denoise" in stats and not stats["denoise"]
        assert (
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/toggle_denoise"
            ).read()
            == b"ok"
        )
        assert r.denoise  # toggled from False
    finally:
        stop.set()
        httpd.shutdown()


def test_count_segments(scene):
    import jax.numpy as jnp

    from pathtracer.render.integrator import camera_arrays, count_segments

    cfg = cfg_()
    cam = camera_arrays(Camera(), cfg)
    segs = int(count_segments(scene, cam, cfg, jnp.int32(0)))
    n_primary = cfg.width * cfg.height * cfg.samples_per_launch
    assert segs >= n_primary          # every path traces at least once
    assert segs <= n_primary * (cfg.max_depth + 2)


def test_viewer_resize(scene):
    from pathtracer.viewer import serve

    r = ProgressiveRenderer(scene, Camera(), cfg_())
    httpd, stop = serve(r, port=0, block=False)
    port = httpd.server_address[1]
    try:
        assert (
            urllib.request.urlopen(f"http://127.0.0.1:{port}/resize?w=64&h=40").read()
            == b"ok"
        )
        assert r.cfg.width == 64 and r.cfg.height == 40
        png = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        stop.set()
        httpd.shutdown()


@pytest.mark.slow
def test_cli_exr_output_is_linear_hdr(scene, tmp_path):
    # .exr gets the raw linear accumulation (values can exceed 1), not the
    # tonemapped u8 image.
    from pathtracer.cli import main
    from pathtracer.utils.image import load_exr

    out = str(tmp_path / "out.exr")
    # Camera aimed straight at the sunsky sun (direction 0,2,3) so the
    # linear radiance 200 is guaranteed to land in the file.
    rc = main(
        ["--file", out, "--dim=16x8", "-s", "1", "--spp", "1",
         "--max-depth", "2", "--no-dof", "--env", "sunsky",
         "--eye", "0,30,0", "--lookat", "0,32,3", "--fov", "10"]
    )
    assert rc == 0
    img = load_exr(out)
    assert img.shape == (8, 16, 3)
    assert img.max() > 1.5  # sun radiance is 200 pre-tonemap


def test_checkpoint_scene_mismatch_rejected(scene, tmp_path):
    # Resume must reject a checkpoint rendered from different geometry
    # even when the config matches (else the blend is silently wrong).
    ck = str(tmp_path / "ck_scene.npz")
    a = ProgressiveRenderer(scene, Camera(), cfg_())
    a.step()
    a.save_checkpoint(ck)
    other = single_sphere_scene(stacks=8, slices=16)
    b = ProgressiveRenderer(other, Camera(), cfg_())
    with pytest.raises(ValueError, match="scene mismatch"):
        b.load_checkpoint(ck)


def test_segment_counts_schedule_invariant(scene):
    # All three schedules trace the same samples, so in-schedule counters
    # must agree: stream vs regen vs wide (no duplicated
    # counting loop that can drift from what actually renders).
    import jax.numpy as jnp

    from pathtracer.render.integrator import (
        camera_arrays,
        count_segments,
        render_frame_stats,
    )

    base = dict(width=32, height=16, samples_per_launch=4, max_depth=3,
                dof=False, env_mode="constant", intersector="brute")
    cam = camera_arrays(Camera(), cfg_(**base))
    counts = {}
    for name, kw in (
        ("wide", dict(regenerate=False)),
        ("regen", dict(stream_lanes=1 << 20)),
        ("stream", dict(stream_lanes=64)),
    ):
        cfg = cfg_(**base, **kw)
        img, stats = render_frame_stats(scene, cam, cfg, jnp.int32(0))
        counts[name] = int(stats["segments"])
        assert int(stats["shadow_segments"]) == 0
        assert int(count_segments(scene, cam, cfg, jnp.int32(0))) == counts[name]
    assert counts["wide"] == counts["regen"] == counts["stream"], counts


def test_tiled_pixel_order_bitwise_identical(scene):
    # 16x8-block pixel hand-out is a pure scheduling change: seeds key off
    # the pixel id and each pixel's samples accumulate on one lane in
    # sample order, so the image must be BITWISE identical to scanline.
    import jax.numpy as jnp

    from pathtracer.render.integrator import camera_arrays, render_frame

    base = dict(width=32, height=16, samples_per_launch=4, max_depth=3,
                dof=False, env_mode="constant", intersector="brute",
                stream_lanes=64)  # force the streaming schedule
    cam = camera_arrays(Camera(), cfg_(**base))
    imgs = {}
    for order in ("scanline", "tiled"):
        cfg = cfg_(**base, pixel_order=order)
        imgs[order] = np.asarray(
            render_frame(scene, cam, cfg, jnp.int32(0))
        )
    assert np.array_equal(imgs["scanline"], imgs["tiled"])


def test_tiled_pixel_order_validation():
    with pytest.raises(ValueError):
        RenderConfig(width=30, height=16, pixel_order="tiled")
    # auto silently falls back to scanline on unaligned dims
    RenderConfig(width=30, height=17, pixel_order="auto")


def test_auto_preview_controller(scene):
    """preview_scale="auto": the controller steps the preview finer while
    measured frames sit comfortably under the budget, backs off (and
    blacklists) a scale that misses it, and never oscillates back."""
    r = ProgressiveRenderer(
        scene, Camera(), cfg_(width=64, height=32),
        preview_scale="auto", preview_budget_s=0.1,
    )
    assert r.preview_scale == 4
    for _ in range(3):              # comfortably under budget -> finer
        r._pv_update(0.01)
    assert r.preview_scale == 2
    for _ in range(3):
        r._pv_update(0.01)
    assert r.preview_scale == 1     # full-res 1-spp previews
    assert r._preview_cfg.width == 64 and r._preview_cfg.samples_per_launch == 1
    for _ in range(3):              # budget miss -> back off + blacklist
        r._pv_update(0.5)
    assert r.preview_scale == 2 and r._pv_floor == 2
    for _ in range(6):              # under budget again, but 1 is banned
        r._pv_update(0.01)
    assert r.preview_scale == 2


def test_adaptive_preview(scene):
    # While the camera moves the viewer shows low-res 1-spp previews;
    # preview output is display-sized and cleared by the next full step.
    r = ProgressiveRenderer(
        scene, Camera(), cfg_(width=64, height=32), preview_scale=4
    )
    assert r._preview_cfg.width == 16 and r._preview_cfg.height == 8
    assert r._preview_cfg.samples_per_launch == 1
    assert r.step_preview()
    img = r.image_u8()
    assert img.shape == (32, 64, 3)   # upscaled to display size
    r.step()                          # full-res step supersedes preview
    assert r._preview_img is None
    assert r.image_u8().shape == (32, 64, 3)

    r2 = ProgressiveRenderer(scene, Camera(), cfg_(), preview_scale=0)
    assert not r2.step_preview()      # disabled


def test_converge_ramp_weighted_mean(scene):
    """step_converge renders a 1/2/4-spp ramp after reset, accounting is
    by samples, and the accumulation equals the sample-weighted mean of
    the individual launches."""
    import jax.numpy as jnp

    from pathtracer.render.integrator import camera_arrays, render_frame

    cfg = cfg_(samples_per_launch=8)
    r = ProgressiveRenderer(scene, Camera(), cfg)
    sizes = []
    for _ in range(4):
        before = r.spp
        r.step_converge()
        sizes.append(r.spp - before)
    # full=8 -> ramp while accum < 4: launches 1, 1, 2, then full 8.
    assert sizes == [1, 1, 2, 8]
    assert r.spp == 12 and r.subframe == 4

    cam = camera_arrays(Camera().with_aspect(cfg.width, cfg.height), cfg)
    num = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for k, s in enumerate(sizes):
        cfg_l = cfg.replace(samples_per_launch=s)
        num += s * np.asarray(render_frame(scene, cam, cfg_l, jnp.int32(k)))
    np.testing.assert_allclose(
        np.asarray(r.accum), num / sum(sizes), rtol=1e-5, atol=1e-6
    )


def test_constant_spp_step_bitwise_unchanged(scene):
    """The weighted accumulator is bitwise-identical to the subframe EWMA
    for constant-spp histories (film.accumulate_weighted's contract), so
    plain step() sequences — and every existing checkpoint — reproduce."""
    import jax.numpy as jnp

    from pathtracer.render.film import accumulate
    from pathtracer.render.integrator import camera_arrays, render_frame

    cfg = cfg_()
    r = ProgressiveRenderer(scene, Camera(), cfg)
    for _ in range(3):
        r.step()
    cam = camera_arrays(Camera().with_aspect(cfg.width, cfg.height), cfg)
    acc = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    for k in range(3):
        acc = accumulate(acc, render_frame(scene, cam, cfg, jnp.int32(k)), k)
    np.testing.assert_array_equal(np.asarray(r.accum), np.asarray(acc))


def test_checkpoint_roundtrip_preserves_accum_spp(scene, tmp_path):
    ck = str(tmp_path / "ck_ramp.npz")
    cfg = cfg_(samples_per_launch=8)
    a = ProgressiveRenderer(scene, Camera(), cfg)
    a.step_converge()           # 1-spp ramp launch
    a.step_converge()
    assert a.spp == 2
    a.save_checkpoint(ck)
    b = ProgressiveRenderer(scene, Camera(), cfg)
    b.load_checkpoint(ck)
    assert b.spp == 2 and b.subframe == 2
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))
