"""Image comparison harness: SSIM / PSNR / max-abs between two renders.

Supports the BASELINE.md parity gate (SSIM > 0.99 vs the OptiX reference
on the suitcase scene): render with pathtracer, then

    python tools/compare_images.py ours.png reference.png [--ssim-min 0.99]

Accepts PNG/PPM/EXR (any pair); images are compared in [0,1] float after
optional resize-free shape check.  Exit code 0 iff the SSIM gate passes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load(path: str) -> np.ndarray:
    from pathtracer.utils.image import load_image

    return np.asarray(load_image(path), np.float64)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("image_a")
    ap.add_argument("image_b")
    ap.add_argument("--ssim-min", type=float, default=0.99)
    ap.add_argument("--flip-b", action="store_true", help="flip B vertically first")
    args = ap.parse_args()

    from pathtracer.utils.ssim import ssim

    a = load(args.image_a)
    b = load(args.image_b)
    if args.flip_b:
        b = b[::-1]
    if a.shape != b.shape:
        print(json.dumps({"error": f"shape mismatch {a.shape} vs {b.shape}"}))
        return 2

    s = ssim(a, b)
    mse = float(np.mean((a - b) ** 2))
    psnr = float(10 * np.log10(1.0 / mse)) if mse > 0 else 999.0  # JSON-safe
    out = {
        "ssim": round(s, 6),
        "psnr_db": round(psnr, 3),
        "max_abs": round(float(np.abs(a - b).max()), 6),
        "pass": s >= args.ssim_min,
        "ssim_min": args.ssim_min,
    }
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
