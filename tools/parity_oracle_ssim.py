"""Full-image SSIM of the JAX renderer vs the independent numpy oracle
on a hero-scene crop.

The OptiX reference binary cannot run here (no GPU, env4.exr stripped),
so the strongest attainable parity artifact is a whole-image statistical
gate against the independently written scalar oracle (pathtracer/
oracle.py): identical counter-based seeds make the two renders
near-bitwise — every divergence is an algorithmic mismatch, not noise —
and a full-image SSIM over the DISPLAY chain (exposure/ACES/gamma/
contrast/sRGB) exercises film parity too.

Two arms:
  A  reference-parity estimator (rr_mode="reference", no NEE) — the
     headline-bench fidelity;
  B  beyond-reference estimator (standard RR + env importance sampling
     + spec-lobe MIS) — the --nee --nee-mis path.

Writes artifacts/parity_report.json["oracle_ssim"] and exits nonzero if
either arm's SSIM < 0.99.  A reduced-size version of arm A gates in
tests/test_oracle.py.

Usage (CPU; ~15-40 min at the defaults on a 1-core box):
  python tools/parity_oracle_ssim.py [--size 96x54] [--spp 64]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def run_arm(scene, camera, cfg, tag: str) -> dict:
    import jax.numpy as jnp

    from pathtracer import oracle
    from pathtracer.render.film import post_process
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.utils.ssim import ssim

    cam = camera_arrays(camera.with_aspect(cfg.width, cfg.height), cfg)
    n = cfg.width * cfg.height

    t0 = time.time()
    img_jax = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))
    t_jax = time.time() - t0
    t0 = time.time()
    img_orc = oracle.render(scene, cam, cfg, range(n), 0).reshape(
        cfg.height, cfg.width, 3
    )
    t_orc = time.time() - t0

    # Raw-radiance agreement (pre-film): relative error + matched-lane
    # fraction (the test_oracle gate, now whole-image).
    diff = np.abs(img_jax - img_orc).max(axis=-1)
    rel = diff / (1.0 + np.abs(img_jax).max(axis=-1))
    frac_match = float((rel < 1e-3).mean())

    # Display-chain SSIM (the BASELINE.md gate's metric).
    disp_jax = np.asarray(post_process(jnp.asarray(img_jax), cfg))
    disp_orc = np.asarray(post_process(jnp.asarray(img_orc), cfg))
    s = float(ssim(disp_jax, disp_orc, data_range=1.0))
    mean_rel = [
        float(
            np.abs(img_jax[..., c].mean() - img_orc[..., c].mean())
            / max(abs(float(img_orc[..., c].mean())), 1e-9)
        )
        for c in range(3)
    ]
    print(
        f"[{tag}] ssim={s:.5f} match_frac={frac_match:.4f} "
        f"mean_rel_err={['%.2e' % v for v in mean_rel]} "
        f"(jax {t_jax:.0f}s, oracle {t_orc:.0f}s)",
        flush=True,
    )
    return {
        "ssim_display": round(s, 5),
        "pixel_match_fraction_rel1e-3": round(frac_match, 5),
        "per_channel_mean_rel_err": [round(v, 7) for v in mean_rel],
        "spp": cfg.samples_per_launch,
        "size": f"{cfg.width}x{cfg.height}",
        "rr_mode": cfg.rr_mode,
        "nee": cfg.env_importance_sampling,
        "nee_mis_spec": cfg.nee_mis_spec,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="96x54")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--spp-nee", type=int, default=32)
    ap.add_argument("--out", default="artifacts/parity_report.json")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    from pathtracer.config import RenderConfig
    from pathtracer.render.camera import Camera
    from pathtracer.render.envmap import with_importance_sampling
    from pathtracer.scene.cache import load_scene_cached
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    ref = "/root/reference"
    env = with_importance_sampling(make_env(procedural_hdr(64, 128)))
    scene = load_scene_cached(
        [f"{ref}/suitcase.obj", f"{ref}/test.obj"], scale=0.05,
        env=env, accel="cluster",
    )
    camera = Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))

    base = dict(
        width=w, height=h, max_depth=8, dof=False, env_mode="equirect",
        intersector="brute", regenerate=False,
    )
    arm_a = run_arm(
        scene, camera,
        RenderConfig(samples_per_launch=args.spp, rr_mode="reference", **base),
        "A reference-RR",
    )
    arm_b = run_arm(
        scene, camera,
        RenderConfig(
            samples_per_launch=args.spp_nee, rr_mode="standard",
            env_importance_sampling=True, nee_mis_spec=True, **base,
        ),
        "B standard-RR+NEE+MIS",
    )

    report = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
    report["oracle_ssim"] = {
        "what": (
            "whole-image SSIM (display chain) + raw-radiance agreement of "
            "the JAX renderer vs the independent scalar numpy oracle on a "
            "suitcase hero crop, identical counter-based seeds"
        ),
        "gate": "ssim_display >= 0.99 both arms",
        "arms": {"reference_rr": arm_a, "nee_mis": arm_b},
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    ok = arm_a["ssim_display"] >= 0.99 and arm_b["ssim_display"] >= 0.99
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
