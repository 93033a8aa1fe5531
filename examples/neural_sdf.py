"""Neural SDF demo: distill an analytic shape into an MLP, then orbit it.

Distills a smooth-union blob into a 64-hidden NeuralSDF (distance
regression + eikonal regularization, one scan dispatch), verifies the field
error, and renders a turntable of the neural scene with ``render_batch``
(all frames in one dispatch).

    python examples/neural_sdf.py --frames 12
"""

import argparse
import pathlib

import numpy as np

import _common  # noqa: F401  (sys.path bootstrap)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu import sdf  # noqa: E402
from sdf3d_tpu.utils import write_png  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="/tmp/sdf3d_neural")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    blob = sdf.smooth_union(
        sdf.sphere(center=(-0.12, 0.4, 0.0), radius=0.18),
        sdf.sphere(center=(0.15, 0.48, 0.0), radius=0.14),
        k=0.08,
    )
    model, losses = sdf.distill(
        sdf.neural_sdf(key=0, hidden=args.hidden, depth=3, radius=0.3),
        blob, key=1, steps=args.steps, batch=4096,
        lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6),
    )
    print(f"distill loss {losses[0]:.4f} -> {losses[-1]:.6f}")

    cfg = dataclasses.replace(
        s.REFERENCE_CONFIG, width=args.size, height=args.size * 3 // 4,
        march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=64),
        shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, max_steps=32),
    )
    light, mat = s.reference_light(), s.reference_material()
    scene = sdf.ground_plane() | model

    cams = [s.Camera.orbit(azimuth_deg=360.0 * k / args.frames, elevation_deg=18.0)
            for k in range(args.frames)]
    cameras = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    frames = np.asarray(s.render_batch(scene, cameras, light, mat, cfg, engine="xla"))
    for k in range(args.frames):
        write_png(out / f"frame_{k:05d}.png", frames[k])
    print(f"{args.frames} neural-scene frames -> {out}")


if __name__ == "__main__":
    main()
