"""Command-line driver: render / fit / bench / info.

The replacement for the reference's interactive host program
(``/root/reference/Code/src/main.cpp:34-110``): instead of a window + arcball
loop, explicit camera parameters and image files; instead of a build step,
jit compilation; instead of frame tic/toc, a rays/s benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def _build_scene(name: str):
    import sdf3d_tpu as s

    scenes = {
        "reference": s.reference_scene,
        "flagship": s.flagship_scene,
        "sphere": s.sphere_scene,
        "fractal": s.fractal_scene,
    }
    if name not in scenes:
        raise SystemExit(f"unknown scene {name!r}; choose from {sorted(scenes)}")
    return scenes[name]()


def _apply_profile(cfg, args):
    """Apply ``--profile fast`` (config.fast_config) to a base config.
    Explicit flags (``--normals`` etc.) are applied *after* the profile by
    the callers, so they win over the profile's choices."""
    import sdf3d_tpu as s

    profile = getattr(args, "profile", "parity")
    return s.fast_config(cfg) if profile == "fast" else cfg


def _build_config(args):
    import sdf3d_tpu as s

    cfg = _apply_profile(s.REFERENCE_CONFIG, args)
    updates = {}
    if args.width:
        updates["width"] = args.width
    if args.height:
        updates["height"] = args.height
    if getattr(args, "normals", None):
        updates["normals"] = args.normals
    if getattr(args, "ao", False):
        updates["ao"] = dataclasses.replace(cfg.ao, enabled=True)
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _orbit_override_given(args) -> bool:
    """True when ANY orbit flag was passed explicitly.  Flags default to
    None (not 0.0) so ``--azimuth 0`` selects the zero-azimuth orbit and
    ``--radius`` alone also triggers the override."""
    return any(
        getattr(args, k, None) is not None for k in ("azimuth", "elevation", "radius")
    )


def _build_camera(args):
    import sdf3d_tpu as s

    if _orbit_override_given(args):
        return s.Camera.orbit(
            azimuth_deg=args.azimuth or 0.0,
            elevation_deg=args.elevation or 0.0,
            radius=args.radius if args.radius is not None else 2.0,
        )
    return s.Camera.reference()


def cmd_render(args) -> int:
    import sdf3d_tpu as s
    from sdf3d_tpu.utils import write_png
    from sdf3d_tpu.viz import turbo

    if args.scene_file:
        from sdf3d_tpu.sdf.io import load_setup

        setup = load_setup(args.scene_file)
        scene = setup["scene"]
        cfg, cam = setup["config"], setup["camera"]
        light, mat = setup["light"], setup["material"]
        # Explicit flags are applied ON TOP of the loaded setup — every flag
        # the no-file path honors is honored here too (none silently dropped).
        cfg = _apply_profile(cfg, args)
        updates = {}
        if args.width:
            updates["width"] = args.width
        if args.height:
            updates["height"] = args.height
        if args.normals:
            updates["normals"] = args.normals
        if args.ao:
            updates["ao"] = dataclasses.replace(cfg.ao, enabled=True)
        if updates:
            cfg = dataclasses.replace(cfg, **updates)
        if _orbit_override_given(args):
            # Orbit override replaces the pose only; the file camera's fov
            # AND its distance are preserved unless --radius is passed (an
            # azimuth flag shouldn't teleport the camera to the default
            # orbit radius).
            # Distance about the default orbit target (camera.Camera.orbit's
            # (0, 0.2, 0)) — exact for file cameras that came from orbit().
            orbit_target = np.array([0.0, 0.2, 0.0])
            to_target = orbit_target - np.asarray(cam.position)
            file_radius = float(np.linalg.norm(to_target))
            if args.radius is None:
                # Surface the heuristic: a file camera not produced by
                # Camera.orbit (or aimed elsewhere) makes the inferred
                # distance wrong — warn instead of silently teleporting.
                forward = -np.asarray(cam.c2w)[:, 2]
                aligned = float(
                    np.dot(forward, to_target) / max(file_radius, 1e-9)
                )
                if aligned < 0.999:
                    import warnings

                    warnings.warn(
                        "--azimuth/--elevation without --radius: camera "
                        "distance inferred from the default orbit target "
                        f"(0, 0.2, 0), but the file camera does not look at "
                        f"it (alignment {aligned:.3f}); pass --radius to "
                        "place the camera exactly",
                        stacklevel=1,
                    )
            cam = s.Camera.orbit(
                azimuth_deg=args.azimuth or 0.0,
                elevation_deg=args.elevation or 0.0,
                radius=args.radius if args.radius is not None else file_radius,
                fov_deg=float(cam.fov_deg),
            )
    else:
        scene = _build_scene(args.scene)
        cfg = _build_config(args)
        cam = _build_camera(args)
        light, mat = s.reference_light(), s.reference_material()

    if args.engine == "pallas":
        from sdf3d_tpu.ops import default_pallas_config, render_pallas

        img = render_pallas(cfg, default_pallas_config(scene), scene, cam, light, mat)
    else:
        img = s.render(scene, cam, light, mat, cfg)

    if args.depth:
        d = s.render_depth(scene, cam, cfg)
        img = turbo(np.clip(np.asarray(d) / 5.0, 0.0, 1.0))

    write_png(args.out, np.asarray(img))
    print(f"wrote {cfg.width}x{cfg.height} -> {args.out}")
    return 0


def cmd_fit(args) -> int:
    import jax.numpy as jnp

    import sdf3d_tpu as s
    from sdf3d_tpu.fit import FitConfig, fit_scene
    from sdf3d_tpu.utils import MetricsLogger

    cfg = _build_config(args)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = s.render(_build_scene(args.scene), cam, light, mat, cfg)
    # Perturbed init: the demo recovers the reference sphere's radius/center.
    scene0 = s.sdf.union(
        s.sdf.ground_plane(),
        s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25),
    )
    logger = MetricsLogger(args.metrics) if args.metrics else MetricsLogger(echo=True)
    import jax

    trainable = jax.tree_util.tree_map(lambda _: True, scene0)
    trainable = trainable.replace(a=jax.tree_util.tree_map(lambda _: False, scene0.a))
    result = fit_scene(
        target, scene0, cam, light, mat, cfg,
        FitConfig(steps=args.steps, learning_rate=args.lr,
                  checkpoint_every=args.checkpoint_every,
                  checkpoint_dir=args.checkpoint_dir),
        logger=logger,
        trainable=trainable,
    )
    print(f"final loss {result.losses[-1]:.6f} after {result.steps_run} steps "
          f"({result.rays_per_second:.3g} rays/s fwd+bwd)")
    return 0


def cmd_fit_view(args) -> int:
    import jax.numpy as jnp

    import sdf3d_tpu as s
    from sdf3d_tpu.camera import camera_rays
    from sdf3d_tpu.diff import coverage
    from sdf3d_tpu.fit import FitConfig, fit_view
    from sdf3d_tpu.sdf.transforms import rotvec_to_matrix
    from sdf3d_tpu.utils import MetricsLogger

    cfg = _build_config(args)
    scene = _build_scene(args.scene)
    light, mat = s.reference_light(), s.reference_material()
    cam_true = s.Camera.reference()
    target = s.render(scene, cam_true, light, mat, cfg)
    o, d = camera_rays(cam_true, cfg.width, cfg.height, cfg.ray_mode)
    cov_target = coverage(cfg.march, scene, o, d, None)

    cam0 = s.Camera(
        position=cam_true.position + args.pert * jnp.asarray([1.0, -0.7, 1.3], jnp.float32),
        c2w=rotvec_to_matrix(args.pert * jnp.asarray([0.3, 0.8, -0.3], jnp.float32)) @ cam_true.c2w,
        fov_deg=cam_true.fov_deg,
    )
    logger = MetricsLogger(args.metrics) if args.metrics else MetricsLogger(echo=True)
    result = fit_view(
        target, scene, cam0, light, mat, cfg,
        FitConfig(steps=args.steps, learning_rate=args.lr, silhouette_weight=1.0),
        optimize=("camera",), logger=logger, target_coverage=cov_target,
    )
    e0 = float(jnp.linalg.norm(cam0.position - cam_true.position))
    e1 = float(jnp.linalg.norm(result.camera.position - cam_true.position))
    print(f"final loss {result.losses[-1]:.6f} after {result.steps_run} steps; "
          f"position error {e0:.4f} -> {e1:.4f}")
    return 0


def cmd_bench(args) -> int:
    from sdf3d_tpu.bench import run_benchmark

    result = run_benchmark(width=args.width or 1920, height=args.height or 1080,
                           engine=args.engine, profile=getattr(args, "profile", "parity"))
    print(json.dumps(result))
    return 0


def cmd_info(args) -> int:
    import jax

    import sdf3d_tpu

    print(f"sdf3d-tpu {sdf3d_tpu.__version__}")
    print(f"jax {jax.__version__}")
    print(f"default backend: {jax.default_backend()}")
    for d in jax.devices():
        print(f"  {d}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sdf3d", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="render a scene to a PNG")
    pr.add_argument("--scene", default="reference")
    pr.add_argument("--scene-file", default=None,
                    help="JSON scene/setup file (sdf.save_scene / save_setup)")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--out", default="render.png")
    # None (not 0.0/2.0) so explicit zeros trigger the orbit override and a
    # scene-file camera's distance is preserved unless --radius is passed.
    pr.add_argument("--azimuth", type=float, default=None)
    pr.add_argument("--elevation", type=float, default=None)
    pr.add_argument("--radius", type=float, default=None)
    pr.add_argument("--normals", choices=["central", "tetrahedron", "autodiff"], default=None)
    pr.add_argument("--ao", action="store_true")
    pr.add_argument("--depth", action="store_true", help="write turbo-mapped depth instead of RGB")
    pr.add_argument("--engine", choices=["xla", "pallas"], default="xla")
    pr.add_argument("--profile", choices=["parity", "fast"], default="parity",
                    help="'fast' = config.fast_config (non-parity, measured faster)")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse-rendering demo: recover scene params")
    pf.add_argument("--scene", default="reference")
    pf.add_argument("--width", type=int, default=96)
    pf.add_argument("--height", type=int, default=72)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--metrics", default=None, help="JSONL metrics file")
    pf.add_argument("--checkpoint-dir", default=None)
    pf.add_argument("--checkpoint-every", type=int, default=0)
    pf.set_defaults(fn=cmd_fit)

    pv = sub.add_parser("fit-view", help="pose-estimation demo: recover a perturbed camera")
    pv.add_argument("--scene", default="reference")
    pv.add_argument("--width", type=int, default=128)
    pv.add_argument("--height", type=int, default=96)
    pv.add_argument("--steps", type=int, default=200)
    pv.add_argument("--lr", type=float, default=2e-3)
    pv.add_argument("--pert", type=float, default=0.06)
    pv.add_argument("--metrics", default=None, help="JSONL metrics file")
    pv.set_defaults(fn=cmd_fit_view)

    pb = sub.add_parser("bench", help="throughput benchmark (prints one JSON line)")
    pb.add_argument("--width", type=int, default=0)
    pb.add_argument("--height", type=int, default=0)
    pb.add_argument("--engine", choices=["xla", "pallas"], default="pallas")
    pb.add_argument("--profile", choices=["parity", "fast"], default="parity",
                    help="'fast' = config.fast_config (non-parity, measured faster)")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="version and device info")
    pi.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    from sdf3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
