"""User-facing Pallas render entry points with a no-march backward pass.

Forward: the fused kernel (ops/render_kernel.py) — all marches in one
launch.  Backward: **no march at all.**  The forward kernel already
produced the three quantities the gradient needs — hit distance ``t``,
shadow and AO planes — so the VJP re-traces only the *shading* expression
in plain XLA with:

- ``t`` re-attached through the implicit-function theorem (``diff.py``
  semantics: dt = −(∇f·do + t·∇f·dd + f_θ·dθ)/(∇f·d)), giving scene and
  camera-pose gradients through the geometry with one extra SDF eval;
- shadow/AO planes treated as detached factors (``ShadowConfig.grad ==
  "detach"`` semantics — penumbra-shape gradients are dropped, everything
  else flows);
- normals, lighting and material gradients via ordinary AD of the shading
  formulas.

The shading expression is ``shade_planes.shade_tile`` — the same one
the fused fit kernel differentiates in-kernel — so every configuration
(``ShadowConfig.grad == "ad"``, scenes without a kernel emitter) shares
one backward, :func:`shade_planes.shade_backward`.

Cost: forward ≈ the marches (O(steps) SDF evals per ray, zero HBM traffic
between stages); backward ≈ one shading pass (O(1) SDF evals per ray).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sdf3d_tpu.camera import Camera
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.lighting import Material, PointLight
from sdf3d_tpu.ops.render_kernel import (
    PallasRenderConfig,
    _render_kernel_call,
    render_kernel_forward,
)
from sdf3d_tpu.sdf.node import SDFNode


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def render_pallas_planar(
    cfg: RenderConfig,
    pc: PallasRenderConfig,
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
) -> jnp.ndarray:
    """Fused Pallas render, differentiable; returns planar RGB (3, H, W).

    This planar form is the custom-VJP boundary: the incoming cotangent
    arrives channel-planar, so the backward reads contiguous (H, W) planes.
    :func:`render_pallas` wraps this in a transpose for the user-facing
    (H, W, 3) layout.

    Scene families without a kernel emitter (VoxelGrid, NeuralSDF — their
    per-lane gathers/matmuls don't lower to the kernel; docs/performance.md
    §Grid scenes) transparently run the banded-XLA pipeline instead, with
    the same residual planes and the same differentiable API.
    """
    rgb, _, _, _ = _forward_any(cfg, pc, scene, camera, light, mat)
    return rgb


def _forward_any(cfg, pc, scene, camera, light, mat):
    """Forward via the fused kernel, or banded XLA when no emitter exists;
    returns (planar rgb (3,H,W), t, shadow, ao)."""
    if _scene_compiles(scene):
        return render_kernel_forward(scene, camera, light, mat, cfg, pc, planar=True)
    from sdf3d_tpu.render import render_aux_banded

    rgb, t, shadow, ao = render_aux_banded(scene, camera, light, mat, cfg)
    return jnp.transpose(rgb, (2, 0, 1)), t, shadow, ao


def render_pallas(
    cfg: RenderConfig,
    pc: PallasRenderConfig,
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
) -> jnp.ndarray:
    """Fused Pallas render, differentiable; returns RGB (H, W, 3)."""
    return jnp.transpose(render_pallas_planar(cfg, pc, scene, camera, light, mat), (1, 2, 0))


def _fwd(cfg, pc, scene, camera, light, mat):
    rgb, t, shadow, ao = _forward_any(cfg, pc, scene, camera, light, mat)
    return rgb, (scene, camera, light, mat, t, shadow, ao)


def _scene_compiles(scene) -> bool:
    """True when every node has a kernel emitter (fused-kernel eligible)."""
    from sdf3d_tpu.ops.scene_program import compile_scene

    try:
        soa = compile_scene(scene)
        jax.eval_shape(
            lambda: soa(jnp.zeros((1, 1)), jnp.zeros((1, 1)), jnp.zeros((1, 1)), lambda k: jnp.float32(0))
        )
        return True
    except TypeError:
        return False


def _bwd(cfg, pc, residuals, g_rgb):
    from sdf3d_tpu.ops.render_kernel import _U_K, pack_uniforms
    from sdf3d_tpu.ops.scene_program import scene_param_vector
    from sdf3d_tpu.ops.shade_planes import shade_backward

    scene, camera, light, mat, t, shadow, ao = residuals
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    leaf_shapes = tuple(jnp.shape(l) for l in leaves)

    def pack(cam_, light_, mat_):
        u = pack_uniforms(cam_, light_, mat_, cfg.ray_mode)
        return u.at[_U_K].set(jnp.asarray(cfg.shadow.k, jnp.float32))

    uniforms, u_vjp = jax.vjp(pack, camera, light, mat)
    if _scene_compiles(scene):
        # Differentiate at the kernels' parameter-vector boundary, then
        # scatter back to the scene pytree.
        params, p_vjp = jax.vjp(scene_param_vector, scene)
        g_params, g_uni = shade_backward(
            treedef, leaf_shapes, params, uniforms, g_rgb, t, shadow, ao, cfg, pc
        )
        (g_scene,) = p_vjp(g_params)
    else:
        g_scene, g_uni = shade_backward(
            treedef, leaf_shapes, scene, uniforms, g_rgb, t, shadow, ao, cfg, pc
        )
    return (g_scene, *u_vjp(g_uni))


render_pallas_planar.defvjp(_fwd, _bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def render_planar_pu(scene_treedef, leaf_shapes, cfg, pc, params, uniforms):
    """Differentiable fused render at the (params, uniforms) vector boundary.

    The lower-level sibling of :func:`render_pallas_planar` for callers that
    must patch uniforms with *traced* values before the custom-VJP boundary —
    the sharded fit sets ``row0``/``rowstride`` from ``lax.axis_index`` inside
    ``shard_map`` (parallel/shard_render.py), which no pytree-level entry can
    express (cfg/camera are static/structured there).  Backward =
    :func:`shade_planes.shade_backward`, which honors the forward kernel's
    row0/rowstride tile→pixel mapping, so per-slab gradients land at the
    right absolute pixels.
    """
    rgb, _, _, _ = _render_kernel_call(scene_treedef, leaf_shapes, params, uniforms, cfg, pc)
    return rgb


def _pu_fwd(scene_treedef, leaf_shapes, cfg, pc, params, uniforms):
    rgb, t, shadow, ao = _render_kernel_call(scene_treedef, leaf_shapes, params, uniforms, cfg, pc)
    return rgb, (params, uniforms, t, shadow, ao)


def _pu_bwd(scene_treedef, leaf_shapes, cfg, pc, residuals, g_rgb):
    from sdf3d_tpu.ops.shade_planes import shade_backward

    params, uniforms, t, shadow, ao = residuals
    g_params, g_uni = shade_backward(
        scene_treedef, leaf_shapes, params, uniforms, g_rgb, t, shadow, ao, cfg, pc
    )
    return g_params, g_uni


render_planar_pu.defvjp(_pu_fwd, _pu_bwd)


def render_pallas_rows(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    cfg: RenderConfig,
    pc: PallasRenderConfig,
    row0,
    rowstride,
) -> jnp.ndarray:
    """Differentiable fused render of ``cfg.height`` rows of an
    ``cfg.ndc_height``-tall image, starting at absolute row ``row0`` with
    tile rows strided by ``rowstride`` (both may be traced — e.g. derived
    from ``lax.axis_index`` under ``shard_map``).  Returns ``(h, W, 3)``.

    Gradients flow to scene/camera/light/mat through the planar shading
    backward (scene via ``scene_param_vector``'s vjp, the rest via
    ``pack_uniforms``'s vjp); ``row0``/``rowstride`` are positional, not
    differentiable.
    """
    from sdf3d_tpu.ops.render_kernel import _U_K, _U_ROW0, _U_ROWSTRIDE, pack_uniforms
    from sdf3d_tpu.ops.scene_program import scene_param_vector

    leaves, treedef = jax.tree_util.tree_flatten(scene)
    leaf_shapes = tuple(jnp.shape(l) for l in leaves)
    params = scene_param_vector(scene)
    uniforms = pack_uniforms(camera, light, mat, cfg.ray_mode)
    uniforms = uniforms.at[_U_K].set(jnp.asarray(cfg.shadow.k, jnp.float32))
    uniforms = uniforms.at[_U_ROW0].set(jnp.asarray(row0, jnp.float32))
    uniforms = uniforms.at[_U_ROWSTRIDE].set(jnp.asarray(rowstride, jnp.float32))
    rgb = render_planar_pu(treedef, leaf_shapes, cfg, pc, params, uniforms)
    return jnp.transpose(rgb, (1, 2, 0))


def render_pallas_depth(
    cfg: RenderConfig,
    scene: SDFNode,
    camera: Camera,
    pc: PallasRenderConfig = PallasRenderConfig(),
) -> jnp.ndarray:
    """Depth (hit distance) plane from the fused kernel, (H, W)."""
    from sdf3d_tpu.lighting import reference_light, reference_material

    _, t, _, _ = render_kernel_forward(scene, camera, reference_light(), reference_material(), cfg, pc)
    return t


def render_pallas_aux(
    cfg: RenderConfig,
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    pc: PallasRenderConfig = PallasRenderConfig(),
):
    """Non-differentiable forward returning (rgb, t, shadow, ao)."""
    return render_kernel_forward(scene, camera, light, mat, cfg, pc)
