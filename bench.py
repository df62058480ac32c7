"""Headline benchmark: Mrays/sec on one GPU at 1080p, path depth 8.

BASELINE.md metric: "Mrays/sec/chip and spp/sec at 1080p, path depth 8
(suitcase PBR scene)".  The reference's suitcase assets are not part of
this repository: `--ref DIR` points at them; without it the headline
configs (0, 3) render the generated suitcase-shaped stand-in
(scene.procedural.write_hero_scene), and the metric says so.

Prints the device and the card's name and power limit, then ONE JSON line:
    {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N}
(vs_baseline = value / 100 against the BASELINE.json north-star target.)
Needs a GPU; exits non-zero on any other platform.

Usage: python bench.py [--small] [--frames N] [--config K] [--ref DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="tiny config (256x192, 4 frames)")
    ap.add_argument("--frames", type=int, default=8, help="timed launches")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument(
        "--spp", type=int, default=None,
        help="samples per launch (default 10 — the reference's hard-coded "
        "batch, optixSphere.cu:323; config 1 defaults to its whole 64-spp "
        "budget in one launch)",
    )
    ap.add_argument("--accel", default="auto", choices=["auto", "brute", "cluster"])
    ap.add_argument("--tiles", type=int, default=0, help="pixel tiles per frame (0=auto)")
    ap.add_argument("--lanes", type=int, default=0, help="streaming lane-pool size (0 = config default)")
    ap.add_argument("--nee", action="store_true", help="env importance sampling (config-3 'GGX + env importance sampling' fidelity)")
    ap.add_argument("--pixel-order", default="auto", choices=["auto", "scanline", "tiled"])
    ap.add_argument("--sort-rays", default="auto",
                    choices=["auto", "off", "octant", "spatial"],
                    help="ray coherence sort key (config.sort_rays)")
    ap.add_argument("--mq", default="auto", choices=["auto", "on", "off"],
                    help="multi-queue NEE (config.nee_multi_queue)")
    ap.add_argument("--rpt", type=int, default=0,
                    help="rays per kernel packet (0 = auto)")
    ap.add_argument(
        "--config", type=int, default=0, choices=range(6),
        help="BASELINE.json benchmark config preset (1-5); 0 = headline "
        "(hero scene @ given dims/depth)",
    )
    ap.add_argument("--ref", default="",
                    help="directory holding the reference OBJ assets "
                    "(suitcase.obj, test.obj, monkey.obj, tower.obj, fish.obj)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "bench"),
                    help="directory for the generated hero scene")
    return _run(ap.parse_args())


def _run(args) -> int:
    import jax
    import jax.numpy as jnp

    from pathtracer.utils.logging import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {card}", flush=True)

    from pathtracer.accel.build import build_accel
    from pathtracer.config import RenderConfig
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import (
        camera_arrays,
        render_frame,
        render_frame_stats,
    )
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    if args.small:
        args.width, args.height, args.frames = 256, 192, 4

    ref = args.ref
    env = make_env(procedural_hdr(256, 512))
    if args.nee:
        from pathtracer.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)
    accel_kind = (
        ("cluster" if args.accel == "auto" else args.accel)
        if args.accel != "brute"
        else None
    )
    env_mode = "equirect"
    scene = None
    camera = Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))

    def obj_scene(files, scale):
        from pathtracer.scene.builder import load_scene

        paths = [os.path.join(ref, f) for f in files]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise SystemExit(f"config {args.config} needs --ref with {missing}")
        return load_scene(paths, scale=scale, env=env, rng_seed=0,
                          accel=accel_kind)

    # BASELINE.json benchmark config presets.
    if args.config == 1:
        # analytic sphere, diffuse, constant sky, 512x512 @ 64 spp
        from pathtracer.scene.procedural import single_sphere_scene

        scene = single_sphere_scene(stacks=32, slices=64)
        args.width = args.height = 512
        # The whole 64-spp budget in ONE launch: at 0.26M pixels the
        # per-launch fixed costs and the queue's drain tail dominate an
        # 8-spp launch (the 131k-lane pool only gets ~25 full-work
        # iterations); 64 spp/launch amortises both 8x.
        if args.spp is None:
            args.spp = 64
        args.depth = 8
        env_mode = "constant"
        camera = Camera()
    elif args.config == 2:
        scene = obj_scene(["monkey.obj"], 1.0)
        args.depth = 4
        camera = Camera(eye=(0, 1, 4), lookat=(0, 0.6, 0))
    elif args.config == 3 or args.config == 0:
        if ref:
            # the reference hero scene (optixSphere.cpp:829-841)
            scene = obj_scene(["suitcase.obj", "test.obj"], 0.05)
        else:
            from pathtracer.scene.builder import load_scene
            from pathtracer.scene.procedural import write_hero_scene

            obj = write_hero_scene(os.path.join(args.out, "hero"), seed=0)
            scene = load_scene([obj], env=env, rng_seed=0, accel=accel_kind)
    elif args.config == 4:
        # statue/lion substitutes: high-poly, deep traversal
        from pathtracer.accel.build import build_accel as _ba
        from pathtracer.scene.procedural import high_poly_scene

        scene = high_poly_scene(total_tris=100_000).replace(env=env)
        if accel_kind:
            scene = _ba(scene, kind=accel_kind)
        camera = Camera(eye=(0, 3, 10), lookat=(0, 1, 0))
    elif args.config == 5:
        scene = obj_scene(["tower.obj", "fish.obj", "test.obj"], 1.0)
        camera = Camera(eye=(0, 1.5, 5), lookat=(0, 0.6, 0))

    if args.spp is None:
        args.spp = 10
    n_pix = args.width * args.height
    tiles = args.tiles
    if tiles == 0:
        if args.spp > 1:
            # Streaming work-queue renderer handles the whole frame with a
            # fixed 256k-lane pool; no tiling needed.
            tiles = 1
        else:
            per_tile = 262144
            tiles = max(1, n_pix // per_tile)
            while n_pix % tiles:
                tiles -= 1
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        samples_per_launch=args.spp,
        max_depth=args.depth,
        dof=False,
        env_mode=env_mode,
        env_importance_sampling=args.nee,
        # NEE requires the textbook RR estimator (config validation).
        rr_mode="standard" if args.nee else "reference",
        intersector=args.accel,
        tile_pixels=(n_pix // tiles) if tiles > 1 else 0,
        pixel_order=args.pixel_order,
        sort_rays=args.sort_rays,
        pallas_rays_per_tile=args.rpt,
        nee_multi_queue=args.mq,
        **({"stream_lanes": args.lanes} if args.lanes else {}),
    )
    if args.accel not in ("brute", "auto") and scene.accel is None:
        scene = build_accel(scene, kind=args.accel)

    cam = camera_arrays(camera.with_aspect(cfg.width, cfg.height), cfg)

    # Compile + warm up.  Gate on non-black output: a silently broken
    # kernel path renders black AND terminates paths instantly, making
    # every timing look fantastic.
    warm = render_frame(scene, cam, cfg, jnp.int32(0))
    if not (float(warm.max()) > 0.0):
        print(json.dumps({"error": "black render — refusing to benchmark"}))
        return 1

    # Traced-ray accounting from inside the actual render schedule
    # (render_frame_stats), including NEE shadow rays.
    _, stats = render_frame_stats(scene, cam, cfg, jnp.int32(0))
    path_segs = int(stats["segments"])
    shadow_segs = int(stats["shadow_segments"])
    segs = path_segs + shadow_segs

    t0 = time.perf_counter()
    for k in range(args.frames):
        img = render_frame(scene, cam, cfg, jnp.int32(k + 1))
    img.block_until_ready()
    dt = time.perf_counter() - t0

    rays_per_launch = segs  # segments == rays traced
    mrays = rays_per_launch * args.frames / dt / 1e6
    spp_per_sec = args.spp * args.frames / dt

    hero = "suitcase PBR" if ref else "generated suitcase-shaped hero"
    scene_name = {0: hero, 1: "sphere/constant-sky", 2: "monkey+env",
                  3: hero, 4: "high-poly 100k", 5: "tower+fish+test"}[args.config]
    result = {
        "metric": f"Mrays/sec/chip, {scene_name} scene, "
        f"{args.width}x{args.height}, depth {args.depth}, {args.accel} accel "
        f"({dev.platform} {dev.device_kind}; {card})",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / 100.0, 4),
        "detail": {
            "rays_per_launch": rays_per_launch,
            "path_segments": path_segs,
            "shadow_segments": shadow_segs,
            "spp_per_sec": round(spp_per_sec, 3),
            "sec_per_launch": round(dt / args.frames, 4),
            "triangles": int(scene.num_triangles),
            "nee": args.nee,
            "frames": args.frames,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
