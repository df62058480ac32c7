"""Command-line renderer.

Superset of the reference CLI (reference optixSphere.cpp:124-131,
1319-1356): `--file/-f`, `--dim=WxH`, `--launch-samples/-s` (which the
reference parses but never uses — here it works), plus everything the
reference hard-codes: scene OBJ list (cpp:829-835), scale (cpp:841), env
map (cpp:835), camera pose (cpp:104-107), spp/depth (cu:323,360), DOF
toggle (key G, cpp:217-221), and checkpoint/resume.

Examples:
    python -m pathtracer.cli --file out.png --dim=512x384 \
        --scene /root/reference/monkey.obj --spp 64
    python -m pathtracer.cli --interactive --scene ...   # web viewer
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer",
        description="GPU wavefront path tracer in JAX",
    )
    # Flags that a --scene-file's [render] table can also set use a None
    # default: "the user explicitly passed this" is then `is not None`
    # (robust against --flag=value and prefix-abbreviated spellings that
    # argv sniffing misses).  Effective defaults live in CLI_DEFAULTS.
    p.add_argument("--file", "-f", default="", help="output image (png/ppm/exr); empty = interactive")
    p.add_argument("--dim", default=None, help="image dimensions WxH (reference default 1600x1200)")
    p.add_argument("--launch-samples", "-s", type=int, default=None, help="samples per launch (reference hard-codes 10)")
    p.add_argument("--spp", type=int, default=0, help="total samples/pixel for offline render (0 = one launch)")
    p.add_argument("--max-depth", type=int, default=None, help="max path depth (reference: 20)")
    p.add_argument("--scene", nargs="*", default=[], help="OBJ files (default: procedural three-spheres scene)")
    p.add_argument("--scene-file", default="", help="TOML scene description (scenes/*.toml); explicit flags override its [render] table")
    p.add_argument("--scale", type=float, default=1.0, help="uniform scene scale (reference hero scene: 0.05)")
    p.add_argument("--env", default="procedural", help="HDR .exr path | procedural | sunsky | constant")
    p.add_argument("--eye", default="0,2,6", help="camera eye (reference default 0,2,6)")
    p.add_argument("--lookat", default="0,0,0", help="camera look-at")
    p.add_argument("--fov", type=float, default=50.0, help="vertical FOV degrees")
    p.add_argument("--dof", action=argparse.BooleanOptionalAction, default=None, help="thin-lens depth of field (reference default on)")
    p.add_argument("--accel", default="auto", choices=["auto", "brute", "cluster"], help="intersection structure (auto = brute for small scenes, cluster otherwise)")
    p.add_argument("--materials", default="convention", choices=["convention", "mtl"], help="material source for OBJ scenes")
    p.add_argument("--rr-mode", default=None, choices=["reference", "standard"], help="Russian-roulette estimator (default: reference, or standard when --nee is on)")
    p.add_argument("--texture-lod", default=None, choices=["auto", "off", "mip", "split"], help="texture mip policy for big texture pools (config.texture_lod)")
    p.add_argument("--aov-prefix", default="", help="also write <prefix>_normal/_depth/_albedo.png G-buffer passes (render/aov.py)")
    p.add_argument("--denoise", action="store_true", help="edge-avoiding A-Trous denoise of the output/display image, guided by a G-buffer AOV pass (beyond reference; accumulation and checkpoints stay raw)")
    p.add_argument("--nee", action="store_true", help="environment importance sampling (next-event estimation; beyond reference)")
    p.add_argument("--nee-defensive", action="store_true", help="with --nee: draw the light sample from a 0.5 alias + 0.5 cosine mixture (balance heuristic) — trades a bounded 2x sun-sample variance for much lower broad-sky noise")
    p.add_argument("--nee-mis", action="store_true", help="with --nee: spec-lobe MIS — balance-weight spec-sampled env credits against the light sample and add the matching light-sampled spec term (kills rough-specular sun fireflies)")
    p.add_argument("--tile-pixels", type=int, default=None, help="pixels per launch tile (0 = whole frame)")
    p.add_argument("--checkpoint", default="", help="checkpoint file; saved every --checkpoint-every subframes")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    p.add_argument("--shard", default="none", choices=["none", "pixels", "samples"], help="multi-chip sharding mode")
    p.add_argument("--profile", default="", help="capture an XLA trace to this TensorBoard logdir")
    p.add_argument("--interactive", action="store_true", help="serve the interactive web viewer")
    p.add_argument("--port", type=int, default=8000, help="viewer port")
    p.add_argument("--preview-budget-ms", type=float, default=125.0, help="interaction preview frame budget; the viewer auto-picks the finest preview resolution that fits it")
    p.add_argument("--no-converge-ramp", action="store_true", help="skip the post-settle 1/2/4-spp ramp (saves its one-time extra jit compiles)")
    p.add_argument("--seed", type=int, default=0, help="seed for random (untextured) materials")
    p.add_argument("--scene-cache", action=argparse.BooleanOptionalAction, default=True, help="packed-scene cache under ~/.cache/pathtracer/scenes (warm loads skip decode+packing)")
    p.add_argument("--refresh-scene-cache", action="store_true", help="rebuild the packed-scene cache entry even if fresh")
    p.add_argument("--debug-nans", action="store_true", help="abort on NaN/Inf in any kernel (jax_debug_nans; SURVEY §5 sanitizer analog)")
    p.add_argument("--verbosity", type=int, default=4)
    return p


# Effective defaults for the None-sentinel flags above (single source of
# truth for both the plain-CLI path and --scene-file override detection).
CLI_DEFAULTS = dict(
    dim="1600x1200",        # reference default (optixSphere.cpp:759-765)
    launch_samples=10,      # reference hard-codes 10 (cu:323)
    max_depth=20,           # reference: 20 (cu:360)
    texture_lod="auto",
    tile_pixels=0,
    dof=True,               # reference default on (cpp:1375)
)


def parse_dim(s: str):
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError:
        raise SystemExit(f"invalid --dim {s!r}; expected WxH like 1600x1200")


def parse_vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise SystemExit(f"invalid vec3 {s!r}; expected x,y,z")
    return tuple(parts)


def build_from_args(args):
    """(scene, camera, cfg) from parsed CLI args."""
    import jax.numpy as jnp

    from pathtracer.config import RenderConfig
    from pathtracer.render.camera import Camera
    from pathtracer.render.envmap import build_env_cdf

    if args.nee_defensive or args.nee_mis:
        args.nee = True  # both are modes OF the NEE light sample

    if args.scene_file:
        from pathtracer.scene.scenefile import load_scene_file
        from pathtracer.utils import logging as plog

        # Explicit CLI flags override the file's [render] table ("passed
        # explicitly" = the None-sentinel default was replaced; see
        # build_arg_parser).  The NEE-implies-standard-RR rule lives in
        # scenefile.load_scene_file, where the config is assembled.
        overrides = {}
        if args.dim is not None:
            w, h = parse_dim(args.dim)
            overrides["width"], overrides["height"] = w, h
        for field, val in (
            ("samples_per_launch", args.launch_samples),
            ("max_depth", args.max_depth),
            ("rr_mode", args.rr_mode),
            ("texture_lod", args.texture_lod),
            ("tile_pixels", args.tile_pixels),
            ("dof", args.dof),
        ):
            if val is not None:
                overrides[field] = val
        if args.nee:
            overrides["env_importance_sampling"] = True
        if args.nee_defensive:
            overrides["env_importance_sampling"] = True
            overrides["nee_defensive_mix"] = True
        if args.nee_mis:
            overrides["env_importance_sampling"] = True
            overrides["nee_mis_spec"] = True
        scene, camera, cfg = load_scene_file(args.scene_file, overrides)
        plog.set_verbosity(args.verbosity)
        plog.info(
            "scene",
            f"scene file {args.scene_file}: {scene.num_triangles} triangles, "
            f"{scene.materials.num_materials} materials",
        )
        return scene, camera.with_aspect(cfg.width, cfg.height), cfg
    from pathtracer.scene.scene import make_env
    from pathtracer.utils import logging as plog
    from pathtracer.utils.image import load_exr, procedural_hdr

    plog.set_verbosity(args.verbosity)
    width, height = parse_dim(args.dim or CLI_DEFAULTS["dim"])

    env_mode = "equirect"
    env = None
    if args.env == "procedural":
        env = make_env(procedural_hdr(256, 512))
    elif args.env in ("sunsky", "constant"):
        env_mode = args.env
        if args.nee:
            raise SystemExit("--nee requires an equirect environment (procedural or .exr)")
    else:
        env = make_env(load_exr(args.env))
        plog.info("scene", f"loaded env map {args.env} {env.data.shape}")
    if args.nee and env is not None:
        from pathtracer.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)

    # NEE requires standard RR (RenderConfig validation); imply it unless
    # the user explicitly picked an RR mode — then let validation raise
    # its clear error.
    rr_mode = args.rr_mode
    if rr_mode is None:
        rr_mode = "standard" if args.nee else "reference"

    def dflt(v, key):
        return CLI_DEFAULTS[key] if v is None else v

    cfg = RenderConfig(
        width=width,
        height=height,
        samples_per_launch=dflt(args.launch_samples, "launch_samples"),
        max_depth=dflt(args.max_depth, "max_depth"),
        dof=dflt(args.dof, "dof"),
        env_mode=env_mode,
        rr_mode=rr_mode,
        texture_lod=dflt(args.texture_lod, "texture_lod"),
        env_importance_sampling=args.nee,
        nee_defensive_mix=args.nee_defensive,
        nee_mis_spec=args.nee_mis,
        intersector=args.accel if args.scene else "brute",
        tile_pixels=dflt(args.tile_pixels, "tile_pixels"),
    )

    if args.scene:
        # Packed-scene cache: warm loads are one sequential npz read +
        # upload instead of PNG decode + quad/bundle packing
        # (scene/cache.py; --no-scene-cache or PT_SCENE_CACHE=0
        # bypasses, --refresh-scene-cache forces a rebuild).
        from pathtracer.scene.cache import load_scene_cached

        scene = load_scene_cached(
            args.scene,
            scale=args.scale,
            env=env,
            material_source=args.materials,
            rng_seed=args.seed,
            accel=("cluster" if args.accel == "auto" else args.accel)
            if args.accel != "brute" else None,
            cache_dir="" if not args.scene_cache else None,
            refresh=args.refresh_scene_cache,
        )
        plog.info(
            "scene",
            f"loaded {scene.num_triangles} triangles, "
            f"{scene.materials.num_materials} materials from {len(args.scene)} files"
            + (f", {args.accel} accel" if args.accel != "brute" else ""),
        )
    else:
        from pathtracer.scene.procedural import three_spheres_scene

        scene = three_spheres_scene()
        if env is not None:
            scene = scene.replace(env=env)
        plog.info("scene", f"procedural scene: {scene.num_triangles} triangles")

    camera = Camera(
        eye=parse_vec3(args.eye),
        lookat=parse_vec3(args.lookat),
        fov_y=args.fov,
    ).with_aspect(width, height)
    return scene, camera, cfg


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from pathtracer.utils.logging import enable_compile_cache

    enable_compile_cache()
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    from pathtracer.runtime.progressive import ProgressiveRenderer
    from pathtracer.utils import logging as plog
    from pathtracer.utils.image import save_image

    scene, camera, cfg = build_from_args(args)

    mesh = None
    if args.shard != "none":
        import jax

        from pathtracer.parallel.shard import make_mesh

        mesh = make_mesh()
        plog.info("shard", f"{args.shard}-sharding over {len(jax.devices())} devices")

    renderer = ProgressiveRenderer(
        scene, camera, cfg, mesh=mesh,
        shard_mode=args.shard if args.shard != "none" else "pixels",
        preview_budget_s=args.preview_budget_ms / 1e3,
        denoise=args.denoise,
    )

    if args.resume and args.checkpoint:
        renderer.load_checkpoint(args.checkpoint)

    if args.interactive:
        from pathtracer.viewer import serve

        serve(renderer, port=args.port,
              converge_ramp=not args.no_converge_ramp)
        return 0

    total_spp = args.spp if args.spp > 0 else cfg.samples_per_launch

    def run():
        spp_per_frame = cfg.samples_per_launch
        n_frames = max(1, -(-total_spp // spp_per_frame))
        while renderer.subframe < n_frames:
            renderer.step()
            if renderer.subframe % 10 == 0 or renderer.subframe == n_frames:
                st = renderer.stats()
                plog.info(
                    "render",
                    f"subframe {renderer.subframe}/{n_frames} "
                    f"({st.get('ms_per_frame', 0):.1f} ms/frame, "
                    f"{st.get('paths_per_sec', 0)/1e6:.2f} Mpaths/s)",
                )
            if (
                args.checkpoint
                and renderer.subframe % args.checkpoint_every == 0
            ):
                renderer.save_checkpoint(args.checkpoint)

    def run_maybe_profiled():
        if args.profile:
            from pathtracer.runtime.profiler import xla_trace

            with xla_trace(args.profile):
                run()
        else:
            run()

    run_maybe_profiled()

    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)

    if args.aov_prefix:
        import numpy as np

        from pathtracer.render.aov import render_aov

        aov = render_aov(scene, renderer._cam_arrays, cfg)
        n8 = np.asarray((aov["normal"] * 0.5 + 0.5) * 255.0).astype(np.uint8)
        d = np.asarray(aov["depth"])
        d8 = (255.0 * d / max(float(d.max()), 1e-6)).astype(np.uint8)
        d8 = np.repeat(d8[..., None], 3, axis=-1)   # save_png wants RGB
        a8 = np.asarray(
            np.clip(aov["albedo"], 0.0, 1.0) * 255.0
        ).astype(np.uint8)
        for name, img in (("normal", n8), ("depth", d8), ("albedo", a8)):
            save_image(f"{args.aov_prefix}_{name}.png", img[::-1])
        plog.info("output", f"wrote {args.aov_prefix}_{{normal,depth,albedo}}.png")

    outfile = args.file or "out.png"
    if outfile.lower().endswith(".exr"):
        # EXR gets the raw linear HDR accumulation — never tonemapped and
        # never pre-denoised (external denoisers need unfiltered input;
        # --denoise affects the display/PNG path only).
        save_image(outfile, renderer.image_hdr())
    else:
        save_image(outfile, renderer.image_u8())
    plog.info("output", f"wrote {outfile} ({renderer.spp} spp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
