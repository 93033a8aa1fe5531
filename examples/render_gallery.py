"""Render every scene preset + AOV debug views to PNGs."""

import argparse
import dataclasses
import pathlib

import numpy as np

import _common  # noqa: F401  (sys.path bootstrap)

import jax.numpy as jnp  # noqa: E402

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu.config import AOConfig  # noqa: E402
from sdf3d_tpu.march import ambient_occlusion, estimate_normals, soft_shadow, sphere_trace  # noqa: E402
from sdf3d_tpu.camera import camera_rays  # noqa: E402
from sdf3d_tpu.sdf.node import vnormalize  # noqa: E402
from sdf3d_tpu.utils import write_png  # noqa: E402
from sdf3d_tpu.viz import turbo  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/sdf3d_gallery")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = dataclasses.replace(
        s.REFERENCE_CONFIG, width=args.width, height=args.height,
        ao=AOConfig(enabled=True),
    )
    light, mat = s.reference_light(), s.reference_material()

    scenes = {
        "reference": (s.reference_scene(), s.Camera.reference()),
        "flagship": (s.flagship_scene(), s.Camera.orbit(30, 20, 2.0)),
        "csg_showcase": (s.csg_showcase(), s.Camera.orbit(25, 25, 2.4)),
        "lattice": (s.lattice_scene(), s.Camera.orbit(15, 18, 3.0)),
        "capsule_chain": (s.capsule_chain(), s.Camera.orbit(0, 25, 2.2)),
        "random_blobs": (s.random_blobs(n=8), s.Camera.orbit(40, 22, 2.4)),
        "fractal": (s.fractal_scene(), s.Camera.orbit(20, 15, 1.9)),
    }
    for name, (scene, cam) in scenes.items():
        img = s.render(scene, cam, light, mat, cfg)
        write_png(out / f"{name}.png", np.asarray(img))
        print(f"{name}.png")

    # AOV debug views for the flagship scene.
    scene, cam = scenes["flagship"]
    o, d = camera_rays(cam, cfg.width, cfg.height)
    t = sphere_trace(scene.distance, o, d, cfg.march)
    p = o + t[..., None] * d
    n = estimate_normals(scene.distance, p, "central", cfg.march.epsilon)
    inc = vnormalize(light.position - p)
    sh = soft_shadow(scene.distance, p + n * 0.02, inc, cfg.shadow, cfg.march)
    ao = ambient_occlusion(scene.distance, p, n, cfg.ao)
    write_png(out / "aov_depth.png", np.asarray(turbo(jnp.clip(t / 5.0, 0, 1))))
    write_png(out / "aov_normals.png", np.asarray(n) * 0.5 + 0.5)
    write_png(out / "aov_shadow.png", np.asarray(turbo(sh)))
    write_png(out / "aov_ao.png", np.asarray(turbo(ao)))
    print("aov_{depth,normals,shadow,ao}.png")
    print(f"gallery -> {out}")


if __name__ == "__main__":
    main()
