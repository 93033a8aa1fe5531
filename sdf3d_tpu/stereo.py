"""Projection modes: monocular, side-by-side stereo, and anaglyph.

The reference renders with ``gl->plot(sh, nu::MONOCULAR)``
(``/root/reference/Code/src/main.cpp:50,95``) — Neutrino's projection-mode
switch, of which only the monocular mode is exercised.  This module supplies
the projection-mode surface: a stereo camera-pair constructor and
a one-dispatch stereo renderer (both eyes rendered in a single ``lax.map``
batch — dispatch discipline, docs/architecture.md).

Conventions: the inter-ocular offset is along the camera's +x (right) axis;
``convergence`` (optional) toes both eyes in so their optical axes meet at
that distance along the center forward axis (parallel-axis rig when None).
Everything stays differentiable — ``baseline`` and ``convergence`` are
runtime scalars.
"""

from __future__ import annotations

import jax.numpy as jnp

from sdf3d_tpu.camera import Camera
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.lighting import Material, PointLight
from sdf3d_tpu.sdf.node import SDFNode, as_f32
from sdf3d_tpu.sdf.transforms import rotvec_to_matrix


def stereo_cameras(
    camera: Camera, baseline=0.065, convergence=None
) -> tuple[Camera, Camera]:
    """Split a camera into a (left, right) stereo pair.

    Eyes sit ``±baseline/2`` along the camera's right axis.  With
    ``convergence`` set, each eye yaws about the camera's up axis by
    ``atan(baseline / (2·convergence))`` so the optical axes intersect at
    that distance (toe-in rig); otherwise the axes stay parallel.
    """
    b = as_f32(baseline)
    right = camera.c2w[:, 0]
    offset = right * (b * 0.5)
    left_pos = camera.position - offset
    right_pos = camera.position + offset
    if convergence is None:
        return (
            camera.replace(position=left_pos),
            camera.replace(position=right_pos),
        )
    up = camera.c2w[:, 1]
    theta = jnp.arctan2(b * 0.5, as_f32(convergence))
    # Left eye yaws by −θ about up (toward the center axis), right by +θ —
    # verified against the center ray passing through the convergence point
    # (tests/test_stereo.py).
    r_l = rotvec_to_matrix(up * (-theta))
    r_r = rotvec_to_matrix(up * theta)
    return (
        camera.replace(position=left_pos, c2w=r_l @ camera.c2w),
        camera.replace(position=right_pos, c2w=r_r @ camera.c2w),
    )


def render_stereo(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    mode: str = "sbs",
    baseline=0.065,
    convergence=None,
    engine: str = "xla",
    pc=None,
) -> jnp.ndarray:
    """Stereo render in ONE dispatch.

    ``mode``:
    - ``"sbs"``       — side-by-side ``(H, 2W, 3)`` (left | right);
    - ``"cross"``     — crossed side-by-side ``(H, 2W, 3)`` (right | left);
    - ``"anaglyph"``  — red/cyan composite ``(H, W, 3)``: red from the left
      eye's luminance-weighted channels, green/blue from the right eye.

    Both eyes run as a 2-camera ``render_batch`` (a single jit dispatch);
    ``engine``/``pc`` select the XLA or fused-Pallas path exactly as in
    :func:`sdf3d_tpu.render.render_batch`.
    """
    import jax

    from sdf3d_tpu.render import render_batch

    cam_l, cam_r = stereo_cameras(camera, baseline, convergence)
    pair = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), cam_l, cam_r)
    frames = render_batch(scene, pair, light, mat, config, engine=engine, pc=pc)
    left, right = frames[0], frames[1]
    if mode == "sbs":
        return jnp.concatenate([left, right], axis=1)
    if mode == "cross":
        return jnp.concatenate([right, left], axis=1)
    if mode == "anaglyph":
        return jnp.stack([left[..., 0], right[..., 1], right[..., 2]], axis=-1)
    raise ValueError(f"unknown stereo mode {mode!r} (sbs | cross | anaglyph)")
