"""Headless frame-loop driver: the reference's render loop, without a window.

The reference loop (``/root/reference/Code/src/main.cpp:87-98``) is
begin → poll events → navigate → plot → end.  Here the same loop runs
headless: input events come from a programmatic source (scripted gestures,
a replay file, or live callbacks), navigation runs in the native controller,
and frames land in an image sink instead of a swapchain — the renderer
itself stays a pure jitted function, re-executed (not re-compiled) per frame
because the camera is a runtime input.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Iterable

import numpy as np

from sdf3d_tpu.camera import Camera
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.interact.controller import NavigationController
from sdf3d_tpu.utils.image_io import write_png


@dataclasses.dataclass
class FrameStats:
    """Per-frame timing — the tic/toc analogue (``main.cpp:89,97``)."""

    frame: int
    seconds: float
    rays_per_second: float


class InteractiveSession:
    """Drive a renderer with a navigation controller, frame by frame.

    ``render_fn(camera) -> (H, W, 3) image`` — typically a closure over a
    jitted render with scene/light/material bound.
    """

    def __init__(
        self,
        render_fn: Callable[[Camera], np.ndarray],
        config: RenderConfig,
        nav: NavigationController | None = None,
        fov_deg: float = 60.0,
    ):
        self.render_fn = render_fn
        self.config = config
        self.nav = nav or NavigationController().configure()
        self.fov_deg = fov_deg
        self.frame_count = 0
        self.stats: list[FrameStats] = []

    def camera(self) -> Camera:
        # Host-side numpy pose math (a 4×4 inverse), not jnp: no per-frame
        # eager device dispatches (dispatch discipline, docs/architecture.md).
        # The numpy leaves upload as arguments of the one jitted render call.
        V = np.asarray(self.nav.view_matrix(), np.float32)
        Vinv = np.linalg.inv(V)
        from sdf3d_tpu.camera import REFERENCE_BASE_POSITION

        base = np.array([*REFERENCE_BASE_POSITION, 1.0], np.float32)
        return Camera(
            position=(Vinv @ base)[:3].astype(np.float32),
            c2w=Vinv[:3, :3].astype(np.float32),
            fov_deg=np.float32(self.fov_deg),
        )

    def frame(self, dt: float = 1 / 60) -> np.ndarray:
        """Advance navigation and render one frame."""
        self.nav.step(dt)
        t0 = time.perf_counter()
        img = np.asarray(self.render_fn(self.camera()))
        seconds = time.perf_counter() - t0
        self.stats.append(
            FrameStats(
                frame=self.frame_count,
                seconds=seconds,
                rays_per_second=self.config.width * self.config.height / max(seconds, 1e-12),
            )
        )
        self.frame_count += 1
        return img

    def run(
        self,
        events: Iterable[Callable[[NavigationController], None]],
        out_dir: str | None = None,
        dt: float = 1 / 60,
    ) -> list[np.ndarray]:
        """Replay a gesture script: each element is a callable applied to the
        controller before its frame (None-like no-ops allowed)."""
        frames = []
        out = pathlib.Path(out_dir) if out_dir else None
        if out:
            out.mkdir(parents=True, exist_ok=True)
        for event in events:
            if event is not None:
                event(self.nav)
            img = self.frame(dt)
            frames.append(img)
            if out:
                write_png(out / f"frame_{self.frame_count - 1:05d}.png", img)
        return frames


def render_turntable(
    render_fn: Callable[[Camera], np.ndarray],
    config: RenderConfig,
    n_frames: int = 24,
    elevation_deg: float = 15.0,
    radius: float = 2.0,
    out_dir: str | None = None,
) -> list[np.ndarray]:
    """Orbit 360° around the scene — the scripted stand-in for mouse orbit."""
    frames = []
    out = pathlib.Path(out_dir) if out_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    for k in range(n_frames):
        cam = Camera.orbit(
            azimuth_deg=360.0 * k / n_frames, elevation_deg=elevation_deg, radius=radius
        )
        img = np.asarray(render_fn(cam))
        frames.append(img)
        if out:
            write_png(out / f"frame_{k:05d}.png", img)
    return frames
