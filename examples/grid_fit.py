"""Free-form shape recovery: fit a voxel-grid SDF to target renders.

The analytic fits (inverse_fit.py) recover a handful of named parameters;
this demo fits *every sample of a voxel grid* (sdf/grid.py) — the discrete
precursor of a neural SDF — from multi-view target images. The grid starts
as a sphere and is pulled toward a smooth-union "peanut" it has never seen.

    python examples/grid_fit.py --res 24 --steps 300
"""

import argparse
import dataclasses
import pathlib

import numpy as np

import _common  # noqa: F401  (sys.path bootstrap)

import jax.numpy as jnp  # noqa: E402

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu.fit import FitConfig, fit_scene  # noqa: E402
from sdf3d_tpu.utils import write_png  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=24, help="grid resolution per axis")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--size", type=int, default=96, help="render width")
    ap.add_argument("--out", default="/tmp/sdf3d_grid_fit")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = dataclasses.replace(
        s.REFERENCE_CONFIG,
        width=args.size,
        height=args.size * 3 // 4,
        shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
    )
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()

    # Target: a smooth-union peanut the initial sphere-grid has never seen.
    blob = s.sdf.smooth_union(
        s.sdf.sphere(center=(-0.12, 0.4, 0.0), radius=0.18),
        s.sdf.sphere(center=(0.15, 0.48, 0.0), radius=0.14),
        k=0.08,
    )
    target_scene = s.sdf.ground_plane() | blob
    target = s.render(target_scene, cam, light, mat, cfg)
    write_png(out / "target.png", np.asarray(target))

    # Start: a baked sphere grid (every sample now a free parameter).
    box_lo, box_hi = (-0.6, -0.1, -0.6), (0.6, 1.1, 0.6)
    grid0 = s.sdf.voxelize(
        s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2),
        resolution=args.res, lo=box_lo, hi=box_hi,
    )
    scene0 = s.sdf.ground_plane() | grid0
    trainable = s.sdf.Union(
        a=s.sdf.Plane(normal=False, offset=False),
        b=s.sdf.VoxelGrid(values=True, origin=False, spacing=False),
    )
    write_png(out / "initial.png", np.asarray(s.render(scene0, cam, light, mat, cfg)))

    result = fit_scene(
        target, scene0, cam, light, mat, cfg,
        FitConfig(steps=args.steps, learning_rate=args.lr, loss="multiscale",
                  log_every=max(args.steps // 10, 1)),
        trainable=trainable,
    )
    final = s.render(result.scene, cam, light, mat, cfg)
    write_png(out / "fitted.png", np.asarray(final))

    err0 = float(jnp.mean((s.render(scene0, cam, light, mat, cfg) - target) ** 2))
    err1 = float(jnp.mean((final - target) ** 2))
    print(f"losses: {['%.1f' % x for x in result.losses]}")
    print(f"mean-sq pixel error: initial {err0:.5f} -> fitted {err1:.5f}")
    print(f"wrote {out}/target.png, initial.png, fitted.png")
    assert err1 < err0, "fit should reduce image error"


if __name__ == "__main__":
    main()
