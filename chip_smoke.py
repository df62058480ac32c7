"""Bring-up check of the renderer on one NVIDIA GPU (or four with --four).

Runs the main path once through the entry points a user calls, at full
size, in this one process, and fails on the first wrong result:

  (a) device: platform, kind, count, and the card's name and power limit;
  (b) the Triton traversal kernels (closest hit, any hit) at 131,072 rays
      on a hero-sized scene and on the 100k-triangle scene, each compared
      with the brute-force scan on the card;
  (c) render_frame on high_poly_scene(100_000), cluster accel, procedural
      equirect HDR, 1920x1080, 10 spp per launch, depth 8, a few launches;
  (d) the CLI (OBJ/MTL loading, textures, NEE any-hit path) on a generated
      textured hero scene at 1920x1080;
  (e) both scenes against the numpy oracle at 32x24, 2 spp, depth 4.

--four runs only (f): render_frame_sharded over four cards in pixel and
sample mode, compared with one card's render.

With no GPU it exits non-zero before printing any result.  The last line
of standard output is one JSON object: {"ok": true, "device": {...}}.

Usage: python chip_smoke.py [--four] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

RAYS = 131_072
W, H, SPP, DEPTH = 1920, 1080, 10, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`nvidia-smi` name and power limit of the card(s)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out


def check(ok, what: str) -> None:
    """Fail the run (also under python -O, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def require_kernel(hlo: str, what: str) -> None:
    """Fail unless compiled/lowered module text holds the Triton call."""
    check("__gpu$xla.gpu.triton" in hlo,
          f"{what}: no Triton kernel in the program")


def hero_camera():
    from pathtracer.render.camera import Camera

    return Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))


def field_camera():
    from pathtracer.render.camera import Camera

    return Camera(eye=(0.0, 3.0, 10.0), lookat=(0.0, 1.0, 0.0))


def scenes(out_dir: str):
    """(hero OBJ path, hero scene, 100k scene) — generated from seed 0."""
    from pathtracer.accel.build import build_accel
    from pathtracer.scene.builder import load_scene
    from pathtracer.scene.procedural import high_poly_scene, write_hero_scene
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    env = make_env(procedural_hdr(256, 512))
    obj = write_hero_scene(os.path.join(out_dir, "hero"), tex_size=2048, seed=0)
    hero = load_scene([obj], env=env, rng_seed=0, accel="cluster")
    field = build_accel(
        high_poly_scene(total_tris=100_000, seed=0).replace(env=env),
        kind="cluster",
    )
    return obj, hero, field


def test_rays(scene, n: int, seed: int):
    """Half camera rays through a 1920x1080 frame, half bounce-like rays
    leaving random surface points in uniform directions."""
    import jax.numpy as jnp

    from pathtracer.config import RenderConfig
    from pathtracer.render.integrator import camera_arrays

    rs = np.random.RandomState(seed)
    cfg = RenderConfig(width=W, height=H)
    cam = {k: np.asarray(v) for k, v in camera_arrays(hero_camera(), cfg).items()}
    m = n // 2
    px, py = rs.rand(m) * 2 - 1, rs.rand(m) * 2 - 1
    d0 = px[:, None] * cam["U"] + py[:, None] * cam["V"] + cam["W"]
    o0 = np.broadcast_to(cam["eye"], d0.shape)
    v = np.asarray(scene.vertices)
    tri = v[rs.randint(0, v.shape[0], n - m)]
    b = rs.dirichlet(np.ones(3), n - m)
    o1 = np.einsum("nk,nkc->nc", b, tri)
    d1 = rs.randn(n - m, 3)
    o = np.concatenate([o0, o1]).astype(np.float32)
    d = np.concatenate([d0, d1])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def check_kernels(name: str, scene) -> None:
    """(b): closest/any hit through the cluster accel's GPU route vs brute."""
    import jax

    from pathtracer.accel.cluster import use_kernel
    from pathtracer.config import RenderConfig
    from pathtracer.ops.intersect import intersect_brute

    check(use_kernel(), "cluster traversal is not on the Triton route")
    acc = scene.accel
    cfg = RenderConfig(intersector="cluster")
    o, d = test_rays(scene, RAYS, seed=1)
    log(f"[b] {name}: {scene.num_triangles} triangles in {acc.num_clusters} "
        f"clusters of {acc.cluster_size}, {RAYS} rays; all kernel arithmetic "
        "is f32 and elementwise (no tensor cores, no matmul precision)")

    def closest(o, d):
        h = acc.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
        return h.t, h.prim

    for tmax in (cfg.t_max, 2.0):
        def anyhit(o, d, tmax=tmax):
            return acc.occluded(scene.vertices, o, d, cfg.t_min, tmax, cfg)

        step = jax.jit(anyhit)
        comp = step.lower(o, d).compile()
        require_kernel(comp.as_text(), f"{name} any-hit")
        got = np.asarray(step(o, d))
        # Occluded <=> brute force finds a closest hit inside the segment.
        want = np.asarray(jax.jit(
            lambda o, d: intersect_brute(scene.vertices, o, d, cfg.t_min,
                                         tmax).hit
        )(o, d))
        agree = float((got == want).mean())
        log(f"[b] {name} any-hit t_max={tmax:g}: occluded {want.mean():.4f} "
            f"of rays, agreement with brute {agree:.6f}")
        if tmax == cfg.t_max:
            log(f"[b] {name} any-hit memory_analysis: {comp.memory_analysis()}")
        check(agree >= 0.9999, f"{name} any-hit agreement {agree}")

    step = jax.jit(closest)
    comp = step.lower(o, d).compile()
    require_kernel(comp.as_text(), f"{name} closest-hit")
    log(f"[b] {name} closest-hit memory_analysis: {comp.memory_analysis()}")
    t, prim = (np.asarray(x) for x in step(o, d))
    hb = jax.jit(
        lambda o, d: intersect_brute(scene.vertices, o, d, cfg.t_min, cfg.t_max)
    )(o, d)
    tb, pb = np.asarray(hb.t), np.asarray(hb.prim)
    same_hit = (prim >= 0) == (pb >= 0)
    same_prim = prim == pb
    agree = float(same_prim.mean())
    both = same_prim & (pb >= 0)
    dt = np.abs(t[both] - tb[both]) / np.maximum(1.0, tb[both])
    log(f"[b] {name} closest-hit: hit rate {(pb >= 0).mean():.4f}, hit/miss "
        f"agreement {same_hit.mean():.6f}, prim agreement {agree:.6f}, max "
        f"|dt|/max(1,t) {dt.max() if dt.size else 0.0:.3e}")
    check(agree >= 0.9999, f"{name} closest-hit prim agreement {agree}")
    check(dt.size and dt.max() <= 1e-5, f"{name} closest-hit t mismatch")
    check(np.all(np.isfinite(t)), f"{name} non-finite t")


def render_full(scene, card: str) -> None:
    """(c): the render path at the bench shape on the 100k scene."""
    import jax.numpy as jnp

    from pathtracer.config import RenderConfig
    from pathtracer.render.integrator import (
        camera_arrays, render_frame, render_frame_stats,
    )

    cfg = RenderConfig(width=W, height=H, samples_per_launch=SPP,
                       max_depth=DEPTH, dof=False, env_mode="equirect",
                       intersector="cluster")
    cam = camera_arrays(field_camera(), cfg)
    hlo = render_frame.lower(scene, cam, cfg, jnp.int32(0)).as_text()
    require_kernel(hlo, "render_frame")
    check("closest_kernel" in hlo, "render_frame: no closest-hit kernel")
    t0 = time.perf_counter()
    img, stats = render_frame_stats(scene, cam, cfg, jnp.int32(0))
    img = np.asarray(img)
    log(f"[c] compile + first launch {time.perf_counter() - t0:.1f} s; "
        f"segments {int(stats['segments'])}, shadow segments "
        f"{int(stats['shadow_segments'])}")
    check(img.shape == (H, W, 3) and np.all(np.isfinite(img)), "bad image")
    check(img.max() > 0.0, "black image")
    render_frame(scene, cam, cfg, jnp.int32(1)).block_until_ready()
    times = []
    for k in range(3):
        t0 = time.perf_counter()
        out = render_frame(scene, cam, cfg, jnp.int32(2 + k))
        out.block_until_ready()
        times.append(time.perf_counter() - t0)
        check(np.all(np.isfinite(np.asarray(out))), "non-finite launch")
    log(f"[c] 100k scene {W}x{H}, {SPP} spp/launch, depth {DEPTH}: seconds "
        f"per launch {', '.join(f'{x:.4f}' for x in times)} on {card} "
        "(a bring-up reading, not a benchmark)")


def render_cli(obj: str, out_dir: str) -> None:
    """(d): the CLI in-process on the generated textured hero scene."""
    from pathtracer import cli
    from pathtracer.utils.image import load_png

    out = os.path.join(out_dir, "hero_cli.png")
    t0 = time.perf_counter()
    rc = cli.main([
        "--file", out, f"--dim={W}x{H}", "--scene", obj, "--nee",
        "--launch-samples", str(SPP), "--max-depth", str(DEPTH), "--no-dof",
        "--eye", "0,2,6", "--lookat", "0,0.5,0", "--no-scene-cache",
        "--verbosity", "3",
    ])
    check(rc == 0, f"cli returned {rc}")
    img = load_png(out)
    log(f"[d] cli --nee hero render {img.shape[1]}x{img.shape[0]} written to "
        f"{out} in {time.perf_counter() - t0:.1f} s, mean {img.mean():.2f}")
    check(img.shape == (H, W, 3) and img.max() > 0, "cli image black")


def oracle_gate(name: str, scene, camera) -> None:
    """(e): the tests' oracle gate at reduced size."""
    import jax.numpy as jnp

    from pathtracer import oracle
    from pathtracer.config import RenderConfig
    from pathtracer.render.integrator import camera_arrays, render_frame

    cfg = RenderConfig(width=32, height=24, samples_per_launch=2, max_depth=4,
                       dof=False, env_mode="equirect", regenerate=False)
    cam = camera_arrays(camera, cfg)
    got = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0))).reshape(-1, 3)
    want = oracle.render(scene, cam, cfg, range(32 * 24), 0)
    rel = np.abs(got - want).max(axis=1) / (1.0 + np.abs(got).max(axis=1))
    frac = float((rel < 1e-3).mean())
    log(f"[e] {name} vs numpy oracle: {frac * 100:.2f}% of pixels within "
        "relative 1e-3 (gate 98%)")
    check(frac >= 0.98, f"{name} oracle agreement {frac}")


def four_cards(scene) -> None:
    """(f): pixel and sample sharding over four cards vs one card."""
    import jax
    import jax.numpy as jnp

    from pathtracer.config import RenderConfig
    from pathtracer.parallel.shard import make_mesh, render_frame_sharded
    from pathtracer.render.integrator import camera_arrays, render_frame

    check(len(jax.devices()) == 4, "--four needs four GPUs")
    mesh = make_mesh(4)
    # 8 spp divides over 4 cards; one lane-pool size for every shape so
    # the one-card and per-card schedules run identical programs.
    cfg = RenderConfig(width=W, height=H, samples_per_launch=8,
                       max_depth=DEPTH, dof=False, env_mode="equirect",
                       intersector="cluster", stream_lanes=32768)
    cam = camera_arrays(field_camera(), cfg)
    one = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))
    t0 = time.perf_counter()
    render_frame(scene, cam, cfg, jnp.int32(1)).block_until_ready()
    log(f"[f] one card: {time.perf_counter() - t0:.4f} s per warm launch")
    for mode in ("pixels", "samples"):
        t0 = time.perf_counter()
        img = np.asarray(render_frame_sharded(scene, cam, cfg, jnp.int32(0),
                                              mesh, mode=mode))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        render_frame_sharded(scene, cam, cfg, jnp.int32(1), mesh,
                             mode=mode).block_until_ready()
        warm = time.perf_counter() - t0
        check(np.all(np.isfinite(img)) and img.max() > 0, f"{mode}: bad image")
        if mode == "pixels":
            same = float((img == one).all(axis=-1).mean())
            log(f"[f] pixels mode on 4 cards ({first:.1f} s incl. compile, "
                f"{warm:.4f} s per warm launch): {same * 100:.4f}% of pixels "
                "bitwise equal to one card")
            check(same == 1.0, "pixel sharding is not bitwise equal")
        else:
            # Each card averages its 2 samples, then pmean averages the 4
            # partial frames: the same 8 samples summed in another order,
            # so values differ by f32 rounding of the reduction only.
            rel = np.abs(img - one) / np.maximum(np.abs(one), 1e-3)
            log(f"[f] samples mode on 4 cards ({first:.1f} s incl. compile, "
                f"{warm:.4f} s per warm launch): max relative difference "
                f"{rel.max():.3e} vs one card (all-reduce order; gate 1e-5)")
            check(rel.max() <= 1e-5, "sample sharding differs beyond rounding")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharding phase")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke"),
                    help="directory for generated scenes and images")
    args = ap.parse_args(argv)

    from pathtracer.utils.logging import enable_compile_cache

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_line()
    log(f"[a] platform {dev.platform}, device_kind {dev.device_kind}, "
        f"device count {len(devs)}")
    log(f"[a] nvidia-smi: {card}")
    os.makedirs(args.out, exist_ok=True)
    t_all = time.perf_counter()
    obj, hero, field = scenes(args.out)
    log(f"[a] scenes: hero {hero.num_triangles} triangles "
        f"({hero.accel.num_clusters} clusters), field {field.num_triangles} "
        f"triangles ({field.accel.num_clusters} clusters)")

    if args.four:
        four_cards(field)
    else:
        check_kernels("hero", hero)
        check_kernels("field-100k", field)
        render_full(field, card.splitlines()[0])
        render_cli(obj, args.out)
        oracle_gate("hero", hero, hero_camera())
        oracle_gate("field-100k", field, field_camera())
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
