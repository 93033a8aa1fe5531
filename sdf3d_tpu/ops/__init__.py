"""Pallas kernels (Triton route): the fused sphere-trace/shade fast path.

This package replaces the reference's GPU programs
(``/root/reference/Code/shader/voxel_fragment.frag`` — the 210-line fragment
shader that *is* the renderer, and the empty compute-kernel slot
``Code/kernel/thekernel_1.cl`` it would have grown into):

- :mod:`sdf3d_tpu.ops.scene_program` — compiles an SDF scene pytree into a
  structure-of-arrays evaluator driven by a flat scalar parameter vector
  (the analogue of shader compilation, but staged at JAX trace time);
- :mod:`sdf3d_tpu.ops.render_kernel` — the fused ray-gen → march → normals →
  shadow → AO → shade kernel (no device-memory traffic between stages);
- :mod:`sdf3d_tpu.ops.fit_kernel` — the single-launch fused fit step
  (march + in-kernel ``value_and_grad`` of the pixel loss);
- :mod:`sdf3d_tpu.ops.shade_planes` — the planar shading expression both
  share, and the plain-XLA render backward built on it;
- :mod:`sdf3d_tpu.ops.render_pallas` — user-facing entry points with the
  implicit-function custom VJP (backward pass needs no march at all).
"""

from sdf3d_tpu.ops.scene_program import compile_scene, scene_param_vector
from sdf3d_tpu.ops.render_kernel import (
    PallasRenderConfig,
    default_pallas_config,
    render_kernel_forward,
)
from sdf3d_tpu.ops.render_pallas import render_pallas, render_pallas_depth, render_pallas_planar

__all__ = [
    "compile_scene",
    "scene_param_vector",
    "PallasRenderConfig",
    "default_pallas_config",
    "render_kernel_forward",
    "render_pallas",
    "render_pallas_planar",
    "render_pallas_depth",
]
