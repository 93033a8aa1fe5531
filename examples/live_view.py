"""Live interactive viewer: orbit the reference scene from a browser.

The browser version of the reference app's windowed loop
(``Code/src/main.cpp:87-98`` in the reference): frames render on the GPU via
the fused Pallas kernel, stream to the browser as a multipart PNG stream,
and mouse orbit/pan/zoom come back as JSON events into the same native
navigation controller (arcball + low-pass decay) the headless session uses.

    python examples/live_view.py [--port 8000] [--width 800] [--height 600]

then open http://127.0.0.1:8000/ — drag to orbit, shift-drag to pan,
wheel to zoom.
"""

import argparse
import dataclasses

import _common  # noqa: F401  (sys.path bootstrap)
import jax
import numpy as np

import sdf3d_tpu as s
from sdf3d_tpu.interact.app import InteractiveSession
from sdf3d_tpu.interact.devices import JoystickReader
from sdf3d_tpu.interact.viewer import LiveViewer
from sdf3d_tpu.ops import default_pallas_config, render_kernel_forward


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--scene", default="reference",
                    choices=["reference", "flagship", "fractal"])
    ap.add_argument("--profile", default="fast", choices=["parity", "fast"],
                    help="'fast' (default here: interactivity over parity) = config.fast_config")
    ap.add_argument("--frames", type=int, default=None, help="stop after N frames (default: run until ctrl-C)")
    args = ap.parse_args()

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=args.width, height=args.height)
    if args.profile == "fast":
        cfg = s.fast_config(cfg)
    scene = {"reference": s.reference_scene, "flagship": s.flagship_scene,
             "fractal": s.fractal_scene}[args.scene]()
    # The Triton kernel compiles for GPUs only; elsewhere it is interpreted.
    pc = default_pallas_config(scene, interpret=jax.devices()[0].platform != "gpu")
    light, mat = s.reference_light(), s.reference_material()

    @jax.jit
    def render(cam):
        return render_kernel_forward(scene, cam, light, mat, cfg, pc)[0]

    session = InteractiveSession(lambda cam: np.asarray(render(cam)), cfg)
    # A physical gamepad plugged into this host drives the loop directly
    # (the browser's Gamepad API covers pads on the viewing machine).
    readers = []
    if JoystickReader.available():
        readers.append(JoystickReader())
        print("gamepad: /dev/input/js0 connected")
    LiveViewer(session, port=args.port, device_readers=readers).run(max_frames=args.frames)


if __name__ == "__main__":
    main()
