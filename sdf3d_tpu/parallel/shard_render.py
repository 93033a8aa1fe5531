"""Tile-sharded rendering and psum-reduced gradients (`shard_map` over a mesh).

Data parallelism over pixels — the multi-device form of the reference's
implicit per-fragment parallelism (``main.cpp:4-5``,
``voxel_fragment.frag:160``), made explicit over a device mesh:

- the image's **rows** are sharded over the ``"tiles"`` axis (row slabs keep
  whole kernel tiles in both H and W);
- scene / camera / light / material pytrees are **replicated** (a few dozen
  scalars — broadcast once, never touched again);
- each device marches only its own rays; no communication in the forward
  pass at all;
- inverse rendering all-reduces the parameter gradients with one ``psum``
  (NCCL on GPUs) — the only collective in the workload (BASELINE north
  star).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

# Every shard_map body in this module needs ``check_vma=False``, for one of
# two measured reasons (not a blanket convenience):
# - XLA-engine bodies (render_sharded, loss_and_grad_sharded) carry f32 lane
#   masks through the march ``lax.while_loop``; vma inference rejects the
#   carry ("input carry f32[...] vs output f32[...]{V:tiles}") because the
#   loop body mixes replicated uniforms into device-varying planes.
# - Pallas-engine bodies (render_pallas_sharded, fused_loss_and_grad_sharded)
#   call ``pallas_call``, whose ``ShapeDtypeStruct`` outputs carry no vma, so
#   ``check_vma=True`` raises unconditionally.
# If either limitation lifts upstream, re-run the probe in
# tests/test_parallel.py-adjacent history (round 4) before removing this.
shard_map = functools.partial(jax.shard_map, check_vma=False)

from sdf3d_tpu.camera import Camera, camera_rays
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.lighting import Material, PointLight
from sdf3d_tpu.ops.render_kernel import (
    PallasRenderConfig,
    _U_K,
    _U_ROW0,
    _U_ROWSTRIDE,
    _render_kernel_call,
    pack_uniforms,
)
from sdf3d_tpu.ops.scene_program import scene_param_vector
from sdf3d_tpu.parallel.mesh import tile_axis
from sdf3d_tpu.render import render_rays
from sdf3d_tpu.diff import render_rays_diff
from sdf3d_tpu.sdf.node import SDFNode

_REPLICATED = P()


def _row_slab(config: RenderConfig, n: int) -> int:
    if config.height % n != 0:
        raise ValueError(
            f"height {config.height} not divisible by mesh size {n}; "
            "pick a slab-aligned height (pad upstream if needed)"
        )
    return config.height // n


def interleave_rows(x: jnp.ndarray, n: int, th: int) -> jnp.ndarray:
    """Permute leading-axis rows from absolute order to device-slab order.

    After the permutation, contiguous slab ``d`` (rows ``[d·H/n, (d+1)·H/n)``)
    holds exactly the interleaved row blocks device ``d`` renders: absolute
    row ``i·(n·th) + d·th + r`` lands at ``d·(H/n) + i·th + r``.  Used to
    pre-shard targets/ray bundles for interleaved row-block fits so the
    standard ``P(tile_axis, ...)`` row sharding delivers the right rows.
    """
    H = x.shape[0]
    if H % (n * th) != 0:
        raise ValueError(f"rows {H} not divisible by n_devices*tile_h = {n * th}")
    blocks = H // (n * th)
    v = x.reshape((blocks, n, th) + x.shape[1:])
    return jnp.swapaxes(v, 0, 1).reshape((H,) + x.shape[1:])


def deinterleave_rows(x: jnp.ndarray, n: int, th: int) -> jnp.ndarray:
    """Inverse of :func:`interleave_rows` (device-slab order → absolute)."""
    H = x.shape[0]
    if H % (n * th) != 0:
        raise ValueError(f"rows {H} not divisible by n_devices*tile_h = {n * th}")
    blocks = H // (n * th)
    v = x.reshape((n, blocks, th) + x.shape[1:])
    return jnp.swapaxes(v, 0, 1).reshape((H,) + x.shape[1:])


@functools.partial(jax.jit, static_argnames=("config", "mesh", "differentiable"))
def render_sharded(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    mesh: Mesh,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Pure-XLA sharded render: (H, W, 3) with rows sharded over the mesh.

    ``differentiable=True`` routes through the implicit-VJP ray renderer so
    the sharded image is grad-able end-to-end.
    """
    n = mesh.shape[tile_axis]
    _row_slab(config, n)
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    inner = render_rays_diff if differentiable else render_rays

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(_REPLICATED, P(tile_axis, None, None), P(tile_axis, None, None), _REPLICATED, _REPLICATED),
        out_specs=P(tile_axis, None, None),
    )
    def shard_fn(scene_, o, d, light_, mat_):
        return inner(scene_, o, d, light_, mat_, config)

    return shard_fn(scene, origins, directions, light, mat)


def render_pallas_sharded(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    mesh: Mesh,
    pc: PallasRenderConfig = PallasRenderConfig(),
    interleaved: bool = False,
    planar: bool = False,
    layout: str | None = None,
) -> jnp.ndarray:
    """Fused-kernel sharded render.  Returns ``(H, W, 3)`` (planar
    ``(3, H, W)`` when ``planar=True``).

    ``layout`` selects the row layout explicitly: ``"contiguous"`` /
    ``"interleaved"``, or ``"auto"`` — interleaved when the height divides
    into ``n_devices × tile_h`` blocks, else contiguous.  ``None`` keeps the
    ``interleaved`` flag.
    """
    n = mesh.shape[tile_axis]
    if layout is not None:
        if layout == "auto":
            layout = "interleaved" if config.height % (n * pc.tile_h) == 0 else "contiguous"
        if layout not in ("contiguous", "interleaved"):
            raise ValueError(f"unknown layout {layout!r}")
        interleaved = layout == "interleaved"
    return _render_pallas_sharded_rows(
        scene, camera, light, mat, config, mesh, pc, interleaved, planar
    )


@functools.partial(
    jax.jit, static_argnames=("config", "pc", "mesh", "interleaved", "planar")
)
def _render_pallas_sharded_rows(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    mesh: Mesh,
    pc: PallasRenderConfig = PallasRenderConfig(),
    interleaved: bool = False,
    planar: bool = False,
) -> jnp.ndarray:
    """Row-layout sharded render: each device runs the Pallas kernel on its
    share of image rows.

    ``interleaved=False`` (default): device ``d`` renders the contiguous row
    slab ``[d·H/n, (d+1)·H/n)`` — zero data movement, but slabs see very
    different march depths (a sky slab finishes in a handful of steps while
    an object slab runs deep), so scaling efficiency is gated by the slowest
    slab.

    ``interleaved=True``: device ``d`` renders tile-height row *blocks*
    strided by the mesh size — absolute rows ``d·TH + b·(n·TH) + r`` — so
    every device sees a representative mix of sky/ground/object rays (the
    load-balance mitigation from docs/performance.md §Scaling).  The kernel
    maps blocks to absolute rows via the row0/rowstride uniforms; the
    gathered image's rows are un-permuted host-free with one reshape/
    transpose.  Requires ``H % (n · pc.tile_h) == 0``.
    """
    n = mesh.shape[tile_axis]
    slab = _row_slab(config, n)
    th = pc.tile_h
    if interleaved and slab % th != 0:
        raise ValueError(
            f"interleaved sharding needs height divisible by n_devices*tile_h "
            f"({config.height} % {n * th} != 0)"
        )
    import dataclasses as _dc

    # Each device emits `slab` rows mapped through the full-image NDC.
    shard_cfg = _dc.replace(config, height=slab, ndc_height=config.height)
    params = scene_param_vector(scene)
    uniforms = pack_uniforms(camera, light, mat, config.ray_mode)
    uniforms = uniforms.at[_U_K].set(jnp.asarray(config.shadow.k, jnp.float32))
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    leaf_shapes = tuple(jnp.shape(l) for l in leaves)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(_REPLICATED, _REPLICATED),
        out_specs=P(None, tile_axis, None),  # planar (3, rows, W): rows sharded
    )
    def shard_fn(params_, uniforms_):
        idx = jax.lax.axis_index(tile_axis)
        if interleaved:
            row0 = (idx * th).astype(jnp.float32)
            uniforms_ = uniforms_.at[_U_ROWSTRIDE].set(jnp.float32(n * th))
        else:
            row0 = (idx * slab).astype(jnp.float32)
        uniforms_ = uniforms_.at[_U_ROW0].set(row0)
        rgb, _, _, _ = _render_kernel_call(
            treedef, leaf_shapes, params_, uniforms_, shard_cfg, pc
        )
        return rgb

    out = shard_fn(params, uniforms)  # (3, H, W); interleaved rows permuted
    if interleaved:
        # Gathered row g = d·slab + i·TH + r holds absolute row
        # i·(n·TH) + d·TH + r: swap the (device, block) axes back.
        blocks = slab // th
        out = out.reshape(3, n, blocks, th, config.width)
        out = jnp.transpose(out, (0, 2, 1, 3, 4)).reshape(
            3, config.height, config.width
        )
    return out if planar else jnp.transpose(out, (1, 2, 0))


def fused_loss_and_grad_sharded(vag_fn: Callable[..., tuple], mesh: Mesh):
    """Mesh-parallelize a per-slab ``(loss, grads)`` function.

    ``vag_fn(scene, origins_slab, directions_slab, target_slab)`` returns the
    slab's summed loss *and* its gradients directly (e.g. the fused Pallas
    loss+grad kernel, ops/fit_kernel.py — no jax AD at this level).  Loss and
    gradients are ``psum``-ed over the mesh, so every device holds identical
    replicated values; the optimizer then runs replicated with no further
    communication (the psum is the workload's only collective).
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            _REPLICATED,
            P(tile_axis, None, None),
            P(tile_axis, None, None),
            P(tile_axis, None, None),
        ),
        out_specs=(_REPLICATED, _REPLICATED),
    )
    def shard_fn(scene_, o_slab, d_slab, target_slab):
        loss, grads = vag_fn(scene_, o_slab, d_slab, target_slab)
        return jax.lax.psum((loss, grads), tile_axis)

    return shard_fn


def loss_and_grad_sharded(loss_fn: Callable[..., jnp.ndarray], mesh: Mesh):
    """Wrap a per-slab loss into a mesh-parallel value+grad with psum'd grads.

    ``loss_fn(scene, origins_slab, directions_slab, target_slab)`` must
    return the **sum** of per-pixel losses on its row slab (sum — not mean —
    so the psum over devices is the exact full-image loss).  Ray bundles and
    the target image are sharded by rows; the scene is replicated.  Both loss
    and scene gradients are ``psum``-ed over the mesh, so every device holds
    identical replicated grads — the optimizer then runs replicated with no
    further communication (the psum is the workload's only collective).
    """

    def vag_fn(scene_, o_slab, d_slab, target_slab):
        return jax.value_and_grad(loss_fn)(scene_, o_slab, d_slab, target_slab)

    return fused_loss_and_grad_sharded(vag_fn, mesh)
