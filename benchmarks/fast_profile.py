"""Fast-profile lab: throughput + image delta of the declared non-parity
fast profile (``config.fast_config`` — see its docstring for the measured
contents) against the parity profile, on the GPU.

Two measurements per scene, both at 1080p:

1. **Image delta**: one parity render and one fast render of the same
   frame; PSNR and max abs error over the clamped image.  Quantifies what
   the fast profile gives up — the table lands in docs/performance.md.
2. **Throughput**: slope-measured fwd and fwd+bwd rays/s for each profile
   via ``sdf3d_tpu.bench.run_benchmark`` (same harness as the driver
   metric, so the numbers are directly comparable to the headline row).

Usage: python -m benchmarks.fast_profile [--quick]
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

import sdf3d_tpu as s
from sdf3d_tpu.bench import run_benchmark


def image_delta(scene_name: str, width: int = 1920, height: int = 1080) -> dict:
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=width, height=height)
    fast = s.fast_config(cfg)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = {"reference": s.reference_scene, "flagship": s.flagship_scene}[scene_name]()
    a = np.clip(np.asarray(s.render(scene, cam, light, mat, cfg)), 0.0, 1.0)
    b = np.clip(np.asarray(s.render(scene, cam, light, mat, fast)), 0.0, 1.0)
    mse = float(np.mean((a - b) ** 2))
    return {
        "scene": scene_name,
        "psnr_db": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
        "max_abs_err": float(np.max(np.abs(a - b))),
        "pixels_changed_gt_1pct": float(np.mean(np.any(np.abs(a - b) > 0.01, axis=-1))),
    }


def main() -> None:
    quick = "--quick" in sys.argv
    out: dict = {"deltas": [], "throughput": []}

    for scene_name in ("reference", "flagship"):
        d = image_delta(scene_name)
        out["deltas"].append(d)
        print(json.dumps(d))

    # "fast_stop2" = fast profile + pc.stop_every=2 (the round-5 predicate-
    # thinning knob — kernel-level, so its image delta is measured against
    # the parity render separately below).
    variants = (
        ("parity", "parity", None),
        ("fast", "fast", None),
        ("fast_stop2", "fast", {"stop_every": 2}),
    )
    for label, profile, pco in variants:
        for mode in ("fwd", "fwd_bwd"):
            r = run_benchmark(
                mode=mode,
                profile=profile,
                iters=4 if quick else 10,
                frames_per_dispatch=8 if quick else 16,
                pc_overrides=pco,
            )
            row = {
                "profile": label,
                "mode": mode,
                "rays_per_s": r["value"],
                "ms_per_frame": 1e3 * r["seconds_per_frame"],
                "platform": r["platform"],
                "device_kind": r["device_kind"],
                "card": r["card"],
            }
            out["throughput"].append(row)
            print(json.dumps(row))

    # Image delta of the stop-thinned kernel (kernel-only knob): fast+stop2
    # kernel render vs the parity XLA render.
    from sdf3d_tpu.ops import default_pallas_config
    from sdf3d_tpu.ops.render_kernel import render_kernel_forward

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=1920, height=1080)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = s.reference_scene()
    a = np.clip(np.asarray(s.render(scene, cam, light, mat, cfg)), 0.0, 1.0)
    pc = default_pallas_config(scene, stop_every=2)
    b, _, _, _ = render_kernel_forward(scene, cam, light, mat, s.fast_config(cfg), pc)
    b = np.clip(np.asarray(b), 0.0, 1.0)
    mse = float(np.mean((a - b) ** 2))
    d = {
        "scene": "reference", "variant": "fast_stop2",
        "psnr_db": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
        "max_abs_err": float(np.max(np.abs(a - b))),
    }
    out["deltas"].append(d)
    print(json.dumps(d))

    print(json.dumps(out))


if __name__ == "__main__":
    main()
