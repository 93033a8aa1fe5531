"""360-degree turntable animation via the interactive session."""

import argparse
import dataclasses

import _common  # noqa: F401  (sys.path bootstrap)

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu.interact import render_turntable  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default="/tmp/sdf3d_turntable")
    ap.add_argument("--scene", default="flagship")
    args = ap.parse_args()

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=320, height=240)
    light, mat = s.reference_light(), s.reference_material()
    scene = {"reference": s.reference_scene, "flagship": s.flagship_scene,
             "csg": s.csg_showcase}[args.scene]()

    frames = render_turntable(
        lambda cam: s.render(scene, cam, light, mat, cfg), cfg,
        n_frames=args.frames, out_dir=args.out,
    )
    print(f"{len(frames)} frames -> {args.out}")


if __name__ == "__main__":
    main()
