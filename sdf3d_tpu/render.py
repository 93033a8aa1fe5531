"""The forward rendering pipeline (pure XLA path).

Assembles camera → sphere-trace → normals → soft shadow (+AO) → shade, the
per-fragment program of ``/root/reference/Code/shader/voxel_fragment.frag:160-211``
re-expressed as one jit-compiled array program over the whole image.  The
pixel grid is simply the output array's index space (the reference needs a
geometry-shader fullscreen quad for this, ``voxel_geometry.geom:26-52``; here
it is an iota).

This module is the *reference semantics* path: simple, obviously correct, and
differentiable end-to-end.  The Pallas-fused fast path (``ops/``) is validated
against it; the implicit-gradient march (``diff.py``) swaps in a custom VJP
with identical primal values.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sdf3d_tpu.camera import Camera, camera_rays
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.lighting import Material, PointLight
from sdf3d_tpu.march import (
    ambient_occlusion,
    estimate_normals,
    hit_mask,
    soft_shadow,
    sphere_trace,
)
from sdf3d_tpu.sdf.node import SDFNode, vnormalize
from sdf3d_tpu.shade import blinn_phong, lambert


def shade_pixels(
    scene: SDFNode,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    distances: jnp.ndarray,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    shadow_override: jnp.ndarray | None = None,
    ao_override: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Shade rays given their marched distances; returns RGB ``(..., 3)``.

    Factored out so the differentiable path (``diff.py``) and the Pallas path
    can reuse the exact shading semantics with their own march outputs.
    Mirrors ``voxel_fragment.frag:195-210``: the hit point is
    ``P = origin + d·ray`` — shaded even for misses (no miss branch) unless
    ``config.background`` composites them out.

    ``shadow_override`` / ``ao_override`` substitute precomputed (detached)
    factors for the secondary marches — used by the Pallas custom VJP, whose
    backward pass reuses the forward kernel's shadow/AO planes instead of
    re-marching.
    """
    sdf_fn = scene.distance
    p = origins + distances[..., None] * directions
    n = estimate_normals(sdf_fn, p, config.normals, config.march.epsilon)

    # Per-object materials: Shaded tags in the tree resolve each hit point's
    # material (hard ops select, smooth ops blend; sdf/materials.py); the
    # call's `mat` becomes the default for untagged subtrees.  Scenes without
    # tags skip this entirely (bit-exact with the single-material path).
    from sdf3d_tpu.sdf.materials import material_at, scene_has_materials

    if scene_has_materials(scene):
        mat = material_at(scene, p, mat)

    if shadow_override is not None:
        shadow = shadow_override
    elif config.shadow.enabled:
        # Shadow ray: origin offset 2ε along the normal, toward the light
        # (``voxel_fragment.frag:205``).
        shadow_origin = p + n * (2.0 * config.march.epsilon)
        incident = vnormalize(light.position - p)
        shadow = soft_shadow(sdf_fn, shadow_origin, incident, config.shadow, config.march)
        if config.shadow.grad == "detach":
            shadow = jax.lax.stop_gradient(shadow)
    else:
        shadow = jnp.ones(distances.shape, distances.dtype)

    if ao_override is not None:
        ao = ao_override if config.ao.enabled else None
    else:
        ao = ambient_occlusion(sdf_fn, p, n, config.ao) if config.ao.enabled else None

    if config.shading == "blinn_phong":
        rgb = blinn_phong(p, n, origins, light, mat, shadow, ao)
    elif config.shading == "lambert":
        rgb = lambert(p, n, light, mat, shadow)
    else:
        raise ValueError(f"unknown shading mode: {config.shading!r}")

    if config.background is not None:
        bg = jnp.asarray(config.background, rgb.dtype)
        rgb = jnp.where(hit_mask(distances, config.march)[..., None], rgb, bg)
    return rgb


def render_rays(
    scene: SDFNode,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
) -> jnp.ndarray:
    """March + shade an arbitrary ray bundle ``(..., 3)`` → RGB ``(..., 3)``.

    The tile-sharded multi-chip path calls this per shard — rays are the unit
    of data parallelism, exactly as fragments are the reference's implicit
    parallel axis.
    """
    distances = sphere_trace(scene.distance, origins, directions, config.march)
    return shade_pixels(scene, origins, directions, distances, light, mat, config)


@partial(jax.jit, static_argnames=("config",))
def render(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
) -> jnp.ndarray:
    """Render a full image of shape ``(H, W, 3)`` (the ``gl->plot`` analogue,
    ``main.cpp:95`` — but jit-compiled, stateless, and differentiable)."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return render_rays(scene, origins, directions, light, mat, config)


def render_aa(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    factor: int = 2,
    engine: str = "xla",
) -> jnp.ndarray:
    """Supersampled render: ``factor²`` rays per pixel, box-filtered.

    No reference counterpart (one ray per fragment there); pure capability
    add.  Renders at ``factor×`` resolution — every engine and quirk applies
    unchanged — then average-pools, staying differentiable end-to-end.
    """
    import dataclasses

    big = dataclasses.replace(
        config, width=config.width * factor, height=config.height * factor
    )
    if engine == "pallas":
        from sdf3d_tpu.ops import default_pallas_config, render_pallas

        img = render_pallas(big, default_pallas_config(scene), scene, camera, light, mat)
    elif engine == "diff":
        from sdf3d_tpu.diff import render_diff

        img = render_diff(scene, camera, light, mat, big)
    else:
        img = render(scene, camera, light, mat, big)
    h, w = config.height, config.width
    return img.reshape(h, factor, w, factor, 3).mean(axis=(1, 3))


def render_depth(
    scene: SDFNode,
    camera: Camera,
    config: RenderConfig,
) -> jnp.ndarray:
    """Marched distance per pixel, shape ``(H, W)`` — debugging/AOV output."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return sphere_trace(scene.distance, origins, directions, config.march)


@partial(jax.jit, static_argnames=("config", "band_rows"))
def render_banded(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    band_rows: int = 48,
) -> jnp.ndarray:
    """XLA render with *row-band* early exit: ``lax.map`` over bands of rays.

    The whole-image XLA march keeps every ray stepping until the worst ray
    in the image converges; banding shrinks that coupling to ``band_rows``
    rows per march.  This is the fast path for scene families whose SDF
    evaluation is matmul/gather-shaped (NeuralSDF, VoxelGrid) — XLA runs
    the full-batch MLP as matrix products, and banding recovers most of the
    early-exit advantage.  For analytic scenes use the Pallas engine.
    """
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return render_rays_banded(
        scene, origins, directions, light, mat, config, band_rows
    )


def render_rays_banded(
    scene: SDFNode,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    band_rows: int = 48,
    inner=None,
) -> jnp.ndarray:
    """Row-banded render of an **explicit ray bundle** (h, W, 3)×2 —
    :func:`render_banded`'s early-exit trick for callers that already hold
    their rays, e.g. one device's row slab under ``shard_map`` (the sharded
    NeuralSDF/VoxelGrid fit path, fit.py).  Per-ray values are identical to
    the unbanded render (banding only decouples the whole-batch convergence
    test), so sharded-band partitions reproduce unsharded images exactly up
    to float summation order.  ``inner`` defaults to :func:`render_rays`;
    pass ``diff.render_rays_diff`` for the implicit-VJP differentiable
    path (``lax.map`` differentiates through the band loop).
    """
    fn = inner or render_rays
    H, W = origins.shape[0], origins.shape[1]
    band_rows = min(band_rows, H)
    Hp = ((H + band_rows - 1) // band_rows) * band_rows
    if Hp != H:
        pad = ((0, Hp - H), (0, 0), (0, 0))
        origins = jnp.pad(origins, pad, mode="edge")
        directions = jnp.pad(directions, pad, mode="edge")
    ob = origins.reshape(Hp // band_rows, band_rows, W, 3)
    db = directions.reshape(Hp // band_rows, band_rows, W, 3)
    out = jax.lax.map(lambda od: fn(scene, od[0], od[1], light, mat, config), (ob, db))
    return out.reshape(Hp, W, 3)[:H]


@partial(jax.jit, static_argnames=("config", "band_rows"))
def render_aux_banded(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    band_rows: int = 48,
):
    """Banded XLA render returning ``(rgb (H,W,3), t, shadow, ao)`` planes.

    The XLA counterpart of ``ops.render_kernel_forward``'s aux outputs, for
    scene families whose SDF evaluation is gather/matmul-shaped (VoxelGrid,
    NeuralSDF) — the scene compiler has no emitter for per-lane gathers or
    weight matrices (docs/performance.md §Grid scenes), while XLA gathers
    natively and row-banding recovers the early-exit win.  Lets ``render_pallas`` serve every scene family behind
    one differentiable API.
    """
    from sdf3d_tpu.march import ambient_occlusion, soft_shadow

    H, W = config.height, config.width
    Hp = ((H + band_rows - 1) // band_rows) * band_rows
    origins, directions = camera_rays(camera, W, H, config.ray_mode)
    if Hp != H:
        pad = ((0, Hp - H), (0, 0), (0, 0))
        origins = jnp.pad(origins, pad, mode="edge")
        directions = jnp.pad(directions, pad, mode="edge")
    ob = origins.reshape(Hp // band_rows, band_rows, W, 3)
    db = directions.reshape(Hp // band_rows, band_rows, W, 3)

    def band(od):
        o, d = od
        t = sphere_trace(scene.distance, o, d, config.march)
        p = o + t[..., None] * d
        n = estimate_normals(scene.distance, p, config.normals, config.march.epsilon)
        if config.shadow.enabled:
            sh = soft_shadow(
                scene.distance,
                p + n * (2.0 * config.march.epsilon),
                vnormalize(light.position - p),
                config.shadow,
                config.march,
            )
        else:
            sh = jnp.ones_like(t)
        ao = ambient_occlusion(scene.distance, p, n, config.ao) if config.ao.enabled else jnp.ones_like(t)
        rgb = shade_pixels(scene, o, d, t, light, mat, config, shadow_override=sh, ao_override=ao)
        return rgb, t, sh, ao

    rgb, t, sh, ao = jax.lax.map(band, (ob, db))
    return (
        rgb.reshape(Hp, W, 3)[:H],
        t.reshape(Hp, W)[:H],
        sh.reshape(Hp, W)[:H],
        ao.reshape(Hp, W)[:H],
    )


@partial(jax.jit, static_argnames=("config", "engine", "pc"))
def render_batch(
    scene: SDFNode,
    cameras: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    engine: str = "pallas",
    pc=None,
) -> jnp.ndarray:
    """Render a whole camera batch in ONE dispatch: ``(N, H, W, 3)``.

    ``cameras`` is a Camera pytree with a leading batch axis on every leaf
    (stack poses with ``jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
    *cams)``).  Frames run sequentially on-device via ``lax.map`` — the
    animation/turntable/serving fast path: one host dispatch for N frames
    (docs/architecture.md, dispatch discipline).

    ``pc``: optional PallasRenderConfig for the pallas engine (tile shape /
    interpret-mode overrides — required to run this path on CPU).
    """
    import jax as _jax

    if engine == "pallas":
        from sdf3d_tpu.ops.render_kernel import default_pallas_config, render_kernel_forward

        pc = pc or default_pallas_config(scene)

        def one(cam):
            return render_kernel_forward(scene, cam, light, mat, config, pc)[0]
    else:
        def one(cam):
            return render(scene, cam, light, mat, config)

    return _jax.lax.map(one, cameras)
