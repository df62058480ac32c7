"""Parity artifact + report for the SSIM north star.

BASELINE.md gate: SSIM > 0.99 vs the OptiX reference render of the
suitcase PBR scene at 1024 spp.  OptiX cannot run in this environment, so
this tool produces OUR side of the comparison and gates automatically the
moment a reference image is dropped into place:

    python tools/parity_report.py                  # render + report
    python tools/parity_report.py --spp 1024 --dim 1920x1080

Outputs (committed under artifacts/):
    artifacts/suitcase_<spp>spp.png   tonemapped render (display chain)
    artifacts/suitcase_<spp>spp.exr   linear HDR accumulation
    artifacts/parity_report.json      SSIM vs the reference if present,
                                      else the best-effort proxy evidence

Reference drop path: reference_images/suitcase_optix_1024spp.png
(render the reference with `optixSphere.exe --file ... --dim=WxH` after
letting the interactive accumulation reach 1024 subframes, camera eye
(0,2,6) lookat (0,0.5,0), suitcase.obj+test.obj scale 0.05).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REF_IMAGE = "reference_images/suitcase_optix_1024spp.png"

PROXY_EVIDENCE = {
    "note": (
        "No OptiX runtime exists in this environment and the reference's "
        "env4.exr asset is stripped, so the SSIM gate cannot run in-tree "
        "yet.  Until a reference image is dropped at "
        f"{REF_IMAGE!r}, parity rests on:"
    ),
    "evidence": [
        "numpy scalar oracle: same per-lane algorithm, near-bitwise "
        "agreement gated in tests/test_oracle.py (incl. glass, textures, "
        "normal maps, NEE, both RR modes)",
        "reference quirk-clone inventory (SURVEY.md C16): UV v-flip, "
        "degenerate-normal cut, backface->flat normal, normal map Y/Z "
        "swap @0.4, roughness clamps [0.015,0.999], IdotN specular-cosine "
        "quirk, lobe-blend estimator, unnormalized perturbed refraction, "
        "path_rgb/=p RR shape — each carries a reference file:line cite "
        "and a unit test",
        "film chain constants bit-matched to the reference: exposure "
        "exp2(-0.5), ACES fit, gamma 2.2, contrast 1.25, hidden make_color "
        "sRGB stage (tests/test_film.py)",
        "bitwise-reproducible renders + committed goldens "
        "(tests/test_golden.py)",
    ],
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--dim", default="1920x1080")
    ap.add_argument("--reference", default=REF_IMAGE)
    ap.add_argument("--scene-file", default="scenes/suitcase.toml")
    ap.add_argument("--out-dir", default="artifacts")
    ap.add_argument("--ssim-min", type=float, default=0.99)
    args = ap.parse_args()

    os.makedirs(args.out_dir, exist_ok=True)
    w, h = (int(x) for x in args.dim.split("x"))
    png = os.path.join(args.out_dir, f"suitcase_{args.spp}spp.png")
    exr = os.path.join(args.out_dir, f"suitcase_{args.spp}spp.exr")

    import jax.numpy as jnp
    import numpy as np

    from pathtracer.render.integrator import camera_arrays  # noqa: F401
    from pathtracer.runtime.progressive import ProgressiveRenderer
    from pathtracer.scene.scenefile import load_scene_file
    from pathtracer.utils.image import save_exr, save_png
    from pathtracer.utils.logging import enable_compile_cache

    enable_compile_cache()
    # Keep the scene file's own settings (incl. DOF — the reference
    # defaults it on) so the artifact matches what the reference would
    # render; only the image size is pinned here.
    scene, camera, cfg = load_scene_file(
        args.scene_file, overrides=dict(width=w, height=h)
    )
    r = ProgressiveRenderer(scene, camera, cfg)
    t0 = time.time()
    r.render_spp(args.spp, log_every=16)
    dt = time.time() - t0
    save_png(png, r.image_u8())
    save_exr(exr, r.image_hdr())
    print(f"rendered {r.spp} spp in {dt:.0f}s -> {png}, {exr}")

    report = {
        "render": {
            "png": png,
            "exr": exr,
            "spp": r.spp,
            "dim": args.dim,
            "scene_file": args.scene_file,
            "seconds": round(dt, 1),
        }
    }
    if os.path.exists(args.reference):
        cmp_ = subprocess.run(
            [sys.executable, "tools/compare_images.py", png, args.reference,
             "--ssim-min", str(args.ssim_min)],
            capture_output=True, text=True,
        )
        report["comparison"] = json.loads(cmp_.stdout)
    else:
        report["comparison"] = {
            "reference_missing": args.reference,
            **PROXY_EVIDENCE,
        }

    out = os.path.join(args.out_dir, "parity_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report.get("comparison", {}), indent=2)[:500])
    print(f"report -> {out}")
    ok = report["comparison"].get("pass", None)
    return 0 if ok in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())
