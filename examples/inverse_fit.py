"""Inverse rendering demo: recover sphere parameters from a target image."""

import argparse
import dataclasses
import pathlib

import numpy as np

import _common  # noqa: F401  (sys.path bootstrap)

import jax  # noqa: E402

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu.fit import FitConfig, fit_scene  # noqa: E402
from sdf3d_tpu.utils import MetricsLogger, write_png  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--out", default="/tmp/sdf3d_fit")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=96, height=64,
                              background=(0.0, 0.0, 0.0))
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()

    true_scene = s.sdf.union(
        s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
    )
    target = s.render(true_scene, cam, light, mat, cfg)
    write_png(out / "target.png", np.asarray(target))

    scene0 = s.sdf.union(
        s.sdf.ground_plane(), s.sdf.sphere(center=(0.08, 0.45, 0.0), radius=0.27)
    )
    write_png(out / "init.png", np.asarray(s.render(scene0, cam, light, mat, cfg)))

    trainable = jax.tree_util.tree_map(lambda _: True, scene0)
    trainable = trainable.replace(a=jax.tree_util.tree_map(lambda _: False, scene0.a))

    with MetricsLogger(str(out / "metrics.jsonl")) as log:
        result = fit_scene(
            target, scene0, cam, light, mat, cfg,
            FitConfig(steps=args.steps, learning_rate=args.lr, loss="multiscale",
                      silhouette_weight=1.0,
                      checkpoint_dir=str(out / "ckpt"), checkpoint_every=50),
            logger=log, trainable=trainable,
        )

    write_png(out / "fitted.png", np.asarray(s.render(result.scene, cam, light, mat, cfg)))
    sphere = result.scene.b
    print(f"true   : center (0, 0.4, 0)  radius 0.2")
    print(f"fitted : center {np.round(np.asarray(sphere.center), 4).tolist()}  "
          f"radius {float(sphere.radius):.4f}")
    print(f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.4f}  "
          f"({result.rays_per_second:.3g} rays/s fwd+bwd)  -> {out}")


if __name__ == "__main__":
    main()
