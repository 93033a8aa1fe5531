"""Camera-pose estimation demo: recover a perturbed camera from one image.

The complement of inverse_fit.py — the scene is *known* and fixed; the
unknowns are the view parameters (here: eye position + orientation, fit in
the SO(3) tangent space via fit_view's delta-rotation parameterization).
The silhouette (coverage) term supplies the pose gradient that plain pixel
L2 misses — see sdf3d_tpu.fit.fit_view's docstring.
"""

import argparse
import dataclasses
import pathlib

import numpy as np

import _common  # noqa: F401  (sys.path bootstrap)

import jax.numpy as jnp  # noqa: E402

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu.camera import camera_rays  # noqa: E402
from sdf3d_tpu.diff import coverage  # noqa: E402
from sdf3d_tpu.fit import FitConfig, fit_view  # noqa: E402
from sdf3d_tpu.sdf.transforms import rotvec_to_matrix  # noqa: E402
from sdf3d_tpu.utils import MetricsLogger, write_png  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--pert", type=float, default=0.06, help="pose perturbation scale")
    ap.add_argument("--out", default="/tmp/sdf3d_pose")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=128, height=96)
    light, mat = s.reference_light(), s.reference_material()
    scene = s.sdf.union(
        s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
    )

    cam_true = s.Camera.reference()
    target = s.render(scene, cam_true, light, mat, cfg)
    write_png(out / "target.png", np.asarray(target))
    o, d = camera_rays(cam_true, cfg.width, cfg.height, cfg.ray_mode)
    cov_target = coverage(cfg.march, scene, o, d, None)

    # Perturbed initial guess: translated + rotated.
    cam0 = s.Camera(
        position=cam_true.position + args.pert * jnp.asarray([1.0, -0.7, 1.3], jnp.float32),
        c2w=rotvec_to_matrix(args.pert * jnp.asarray([0.3, 0.8, -0.3], jnp.float32)) @ cam_true.c2w,
        fov_deg=cam_true.fov_deg,
    )
    write_png(out / "init.png", np.asarray(s.render(scene, cam0, light, mat, cfg)))

    with MetricsLogger(str(out / "metrics.jsonl")) as log:
        result = fit_view(
            target, scene, cam0, light, mat, cfg,
            FitConfig(steps=args.steps, learning_rate=args.lr, silhouette_weight=1.0),
            optimize=("camera",), logger=log, target_coverage=cov_target,
        )

    write_png(out / "fitted.png", np.asarray(s.render(scene, result.camera, light, mat, cfg)))
    e0 = float(jnp.linalg.norm(cam0.position - cam_true.position))
    e1 = float(jnp.linalg.norm(result.camera.position - cam_true.position))
    print(f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.4f}")
    print(f"position error {e0:.4f} -> {e1:.4f}   -> {out}")


if __name__ == "__main__":
    main()
