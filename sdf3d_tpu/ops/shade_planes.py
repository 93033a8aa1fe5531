"""The planar shading expression shared by the fused fit kernel and the
render backward pass — the one place the shading math is written for AD.

:func:`shade_tile` re-traces ray gen → implicit-function re-attachment of
the stored hit distance ``t`` → normals → AO taps → Blinn-Phong, as a
function of an SDF callable and the uniform scalars.  Inside the fit
kernel (ops/fit_kernel.py) it runs on one ``(TH, TW)`` tile under
``jax.value_and_grad`` at kernel-trace time.  :func:`shade_backward` runs
it on whole ``(H, W)`` planes in plain XLA under ``jax.vjp`` — the
backward of ``render_pallas``: one shading pass with O(1) SDF evals per
ray and no loop, elementwise work XLA fuses without a kernel.

Semantics: ``t`` carries implicit-function gradients (diff.py); AO
flows; shadow is a detached factor unless ``ShadowConfig.grad == "ad"``,
which re-marches it differentiably (never inside the fit kernel, whose
eligibility excludes it); normals/lighting/material by ordinary AD.  The
uniform-vector gradient is scattered back to Camera/PointLight/Material
pytrees by ``jax.vjp(pack_uniforms)`` — the packing layout stays the
single source of truth (ops/render_kernel.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.diff import _DENOM_FLOOR
from sdf3d_tpu.ops.render_kernel import (
    N_UNIFORMS,
    PallasRenderConfig,
    _U_AMB,
    _U_C2W,
    _U_CAM,
    _U_FZ,
    _U_LIGHT,
    _U_MAT_AMB,
    _U_MAT_DIF,
    _U_MAT_REF,
    _U_ROW0,
    _U_ROWSTRIDE,
    _U_SHN,
    _round_up,
)
from sdf3d_tpu.ops.scene_program import compile_scene, compile_scene_material
from sdf3d_tpu.sdf.node import SDFNode


def shade_tile(sdf, uv, gpos, t0, shadow_in, ao_in, *, cfg: RenderConfig, material=None):
    """The planar shading expression of the forward kernel's stages, as a
    function of ``sdf(px, py, pz) -> d`` (closing over the differentiable
    scene parameters) and the uniform list ``uv``.

    ``gpos`` = (rows, cols) absolute pixel-index planes of any shape (one
    kernel tile, or a whole image); ``t0``/``shadow_in``/``ao_in`` are the
    forward pass's residual planes (constants under AD).  ``material``,
    when the scene carries Shaded tags, maps the hit point and the global
    channels ``(amb rgb, dif rgb, spec rgb, shininess)`` to per-lane
    channels.  Returns the (r, g, b) planes.
    """
    f32 = jnp.float32
    sg = jax.lax.stop_gradient
    H = cfg.ndc_height or cfg.height
    W = cfg.ndc_width or cfg.width
    mc = cfg.march
    rows, cols = gpos

    # ---- ray generation (kernel parity) ----
    qx = (2.0 * (cols + 0.5) / f32(W)) - 1.0
    qy = 1.0 - (2.0 * (rows + 0.5) / f32(H))
    ar = f32(W / H)
    vx = qx * ar
    vy = qy
    vz = jnp.full_like(qx, 0.0) + uv[_U_FZ]
    inv = jax.lax.rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    m = [uv[_U_C2W + k] for k in range(9)]
    dx = m[0] * vx + m[1] * vy + m[2] * vz
    dy = m[3] * vx + m[4] * vy + m[5] * vz
    dz = m[6] * vx + m[7] * vy + m[8] * vz
    inv2 = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv2, dy * inv2, dz * inv2
    ox, oy, oz = uv[_U_CAM], uv[_U_CAM + 1], uv[_U_CAM + 2]

    # ---- implicit-function re-attachment of the stored hit distance ----
    px0, py0, pz0 = sg(ox + t0 * dx), sg(oy + t0 * dy), sg(oz + t0 * dz)
    ddx, ddy, ddz = sg(dx), sg(dy), sg(dz)
    _, denom = jax.jvp(sdf, (px0, py0, pz0), (ddx, ddy, ddz))
    denom = sg(denom)
    usable = (t0 <= mc.max_distance) & (jnp.abs(denom) >= _DENOM_FLOOR)
    inv_denom = jnp.where(usable, 1.0 / jnp.where(usable, denom, 1.0), 0.0)
    f_here = sdf(ox + t0 * dx, oy + t0 * dy, oz + t0 * dz)
    t_att = t0 - (f_here - sg(f_here)) * inv_denom

    hx, hy, hz = ox + t_att * dx, oy + t_att * dy, oz + t_att * dz

    # ---- normals (kernel parity) ----
    e = f32(mc.epsilon)
    if cfg.normals == "central":
        nx = sdf(hx + e, hy, hz) - sdf(hx - e, hy, hz)
        ny = sdf(hx, hy + e, hz) - sdf(hx, hy - e, hz)
        nz = sdf(hx, hy, hz + e) - sdf(hx, hy, hz - e)
    elif cfg.normals == "tetrahedron":
        s0 = sdf(hx + e, hy - e, hz - e)
        s1 = sdf(hx - e, hy - e, hz + e)
        s2 = sdf(hx - e, hy + e, hz - e)
        s3 = sdf(hx + e, hy + e, hz + e)
        nx = s0 - s1 - s2 + s3
        ny = -s0 - s1 + s2 + s3
        nz = -s0 + s1 - s2 + s3
    else:
        raise ValueError(f"planar shading supports central/tetrahedron normals, not {cfg.normals!r}")
    ninv = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-24))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv

    # ---- incident light / secondary factors ----
    lx, ly, lz = uv[_U_LIGHT], uv[_U_LIGHT + 1], uv[_U_LIGHT + 2]
    ix, iy, iz = lx - hx, ly - hy, lz - hz
    iinv = jax.lax.rsqrt(jnp.maximum(ix * ix + iy * iy + iz * iz, 1e-24))
    ix, iy, iz = ix * iinv, iy * iinv, iz * iinv

    if cfg.shadow.enabled and cfg.shadow.grad == "ad":
        # Penumbra-shape gradients (matching the XLA path): re-march the
        # shadow ray differentiably with a fixed trip count, then swap in
        # the forward's plane as the primal.  O(shadow.max_steps) residuals
        # under AD: an explicit opt-in for lighting-from-shadow problems.
        from sdf3d_tpu.march import soft_shadow

        sh_o = jnp.stack([hx + 2.0 * e * nx, hy + 2.0 * e * ny, hz + 2.0 * e * nz], axis=-1)
        inc = jnp.stack([ix, iy, iz], axis=-1)
        shadow_ad = soft_shadow(
            lambda p: sdf(p[..., 0], p[..., 1], p[..., 2]), sh_o, inc, cfg.shadow,
            dataclasses.replace(mc, early_exit=False),
        )
        shadow = shadow_ad - sg(shadow_ad) + shadow_in
    else:
        shadow = shadow_in  # detached factor (grad == "detach" semantics)

    if cfg.ao.enabled:
        # AO flows (XLA-path semantics); kernel plane stays the primal.
        occ = jnp.zeros_like(t0)
        weight = 1.0
        for tap in range(1, cfg.ao.samples + 1):
            hh = cfg.ao.step * tap
            sa = sdf(hx + hh * nx, hy + hh * ny, hz + hh * nz)
            occ = occ + weight * (hh - sa)
            weight *= cfg.ao.falloff
        ao_ad = jnp.clip(1.0 - cfg.ao.strength * occ, 0.0, 1.0)
        ao = ao_ad - sg(ao_ad) + ao_in
    else:
        ao = ao_in

    # ---- shading (kernel parity) ----
    wx, wy, wz = ox - hx, oy - hy, oz - hz
    winv = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-24))
    wx, wy, wz = wx * winv, wy * winv, wz * winv
    hwx, hwy, hwz = ix + wx, iy + wy, iz + wz
    hwinv = jax.lax.rsqrt(jnp.maximum(hwx * hwx + hwy * hwy + hwz * hwz, 1e-24))
    hwx, hwy, hwz = hwx * hwinv, hwy * hwinv, hwz * hwinv

    ndoth = jnp.maximum(nx * hwx + ny * hwy + nz * hwz, 0.0)
    dif = jnp.clip(nx * ix + ny * iy + nz * iz, 0.0, 1.0) * shadow
    amb_scale = uv[_U_AMB] * ao if cfg.ao.enabled else uv[_U_AMB] + jnp.zeros_like(dif)

    # Material channels (kernel parity): per-lane when the scene carries
    # Shaded tags, so material-parameter gradients flow through the vjp of
    # the selects/lerps exactly like shape parameters.
    mch = (
        uv[_U_MAT_AMB], uv[_U_MAT_AMB + 1], uv[_U_MAT_AMB + 2],
        uv[_U_MAT_DIF], uv[_U_MAT_DIF + 1], uv[_U_MAT_DIF + 2],
        uv[_U_MAT_REF], uv[_U_MAT_REF + 1], uv[_U_MAT_REF + 2],
        uv[_U_SHN],
    )
    if material is not None:
        mch = material(hx, hy, hz, mch)
    spec = jnp.power(ndoth, mch[9])

    if cfg.shading == "blinn_phong":
        chans = [amb_scale * mch[c] + dif * mch[3 + c] + spec * mch[6 + c] for c in range(3)]
    elif cfg.shading == "lambert":
        chans = [amb_scale * mch[c] + dif * mch[3 + c] for c in range(3)]
    else:
        raise ValueError(f"unknown shading mode {cfg.shading!r}")

    if cfg.background is not None:
        miss = t0 > mc.max_distance
        chans = [jnp.where(miss, f32(bgc), ch) for bgc, ch in zip(cfg.background, chans)]
    return tuple(chans)


def _emitter_geometry(scene_treedef, leaf_shapes):
    """``theta -> (sdf, material)`` for a scene parameter vector ``theta``,
    through the kernels' scene-program emitters."""
    from sdf3d_tpu.sdf.materials import scene_has_materials

    dummies = [jnp.zeros(shape, jnp.float32) for shape in leaf_shapes]
    scene = jax.tree_util.tree_unflatten(scene_treedef, dummies)
    soa = compile_scene(scene)
    mat_soa = compile_scene_material(scene) if scene_has_materials(scene) else None

    def geometry(theta):
        pv = tuple(theta[k] for k in range(theta.shape[0]))

        def getp(k):
            return pv[k]

        def sdf(px, py, pz):
            return soa(px, py, pz, getp)

        if mat_soa is None:
            return sdf, None
        return sdf, lambda hx, hy, hz, mch: mat_soa(hx, hy, hz, getp, mch)[1]

    return geometry


def _tree_geometry(scene: SDFNode):
    """``(sdf, material)`` straight from a scene pytree's ``distance`` —
    for node families without a kernel emitter (VoxelGrid, NeuralSDF)."""
    from sdf3d_tpu.lighting import Material
    from sdf3d_tpu.sdf.materials import material_at, scene_has_materials

    def sdf(px, py, pz):
        return scene.distance(jnp.stack([px, py, pz], axis=-1))

    if not scene_has_materials(scene):
        return sdf, None

    def material(hx, hy, hz, mch):
        default = Material(
            ambient=jnp.stack(mch[0:3]), diffuse=jnp.stack(mch[3:6]),
            specular=jnp.stack(mch[6:9]), shininess=mch[9],
        )
        m = material_at(scene, jnp.stack([hx, hy, hz], axis=-1), default)
        return (
            *(m.ambient[..., c] for c in range(3)),
            *(m.diffuse[..., c] for c in range(3)),
            *(m.specular[..., c] for c in range(3)),
            m.shininess,
        )

    return sdf, material


@functools.partial(jax.jit, static_argnames=("scene_treedef", "leaf_shapes", "cfg", "pc"))
def shade_backward(
    scene_treedef, leaf_shapes, theta, uniforms, g_rgb, t, shadow, ao, cfg: RenderConfig, pc: PallasRenderConfig
):
    """Backward of the forward render: returns ``(g_theta, g_uniforms
    (N_UNIFORMS,))``.

    ``theta`` is the scene parameter vector (P,) for scenes whose nodes all
    have kernel emitters, or the scene pytree itself for the rest (the SDF
    then comes from ``scene.distance``); ``g_theta`` has its structure.
    ``g_rgb`` is the planar (3, H, W) RGB cotangent; ``t``/``shadow``/``ao``
    the forward's residual planes.  Pixel positions follow the same
    row0/rowstride tile mapping as the forward kernel, so sharded slabs
    differentiate at the absolute pixels they rendered.

    For parameter vectors the planes are cut into the kernels' ``(TH, TW)``
    tiles and the vjp is vmapped over tiles, so gradients are reduced per
    tile and then across tiles — the fused fit kernel's summation order,
    which keeps the two gradients comparable to float32 rounding (grazing
    pixels make single per-pixel terms large, so the order of the sum
    shows).  A scene pytree may hold large leaves (MLP weights, voxel
    grids), so it is differentiated over the whole image as one tile.
    Padding lanes get miss values (t = 2·max_distance, shadow = ao = 1) and
    a zero cotangent, so they contribute exact zeros.
    """
    H, W = cfg.height, cfg.width
    if isinstance(theta, SDFNode):
        geometry = _tree_geometry
        TH, TW = H, W
    else:
        geometry = _emitter_geometry(scene_treedef, leaf_shapes)
        TH, TW = pc.tile_h, pc.tile_w
    Hp, Wp = _round_up(H, TH), _round_up(W, TW)
    gh, gw = Hp // TH, Wp // TW

    # Absolute pixel rows: local row i sits in tile row i // TH, which
    # starts at row0 + (i // TH) · rowstride (rowstride defaults to TH —
    # contiguous rows — exactly like the forward kernel's patch).
    stride = jnp.where(uniforms[_U_ROWSTRIDE] > 0.0, uniforms[_U_ROWSTRIDE], jnp.float32(TH))
    local = jnp.arange(Hp, dtype=jnp.int32)
    row_abs = (
        uniforms[_U_ROW0]
        + (local // TH).astype(jnp.float32) * stride
        + (local % TH).astype(jnp.float32)
    )
    rows = jnp.broadcast_to(row_abs[:, None], (Hp, Wp))
    cols = jnp.broadcast_to(jnp.arange(Wp, dtype=jnp.float32)[None, :], (Hp, Wp))

    pad = ((0, Hp - H), (0, Wp - W))

    def tiles(x, fill=0.0):
        x = jnp.pad(x, pad, constant_values=fill) if x.shape != (Hp, Wp) else x
        return x.reshape(gh, TH, gw, TW).transpose(0, 2, 1, 3).reshape(gh * gw, TH, TW)

    def tile_vjp(rows_t, cols_t, t_t, sh_t, ao_t, gr, gg, gb):
        def shade(theta_, uniforms_):
            sdf, material = geometry(theta_)
            uv = tuple(uniforms_[k] for k in range(N_UNIFORMS))
            return shade_tile(
                sdf, uv, gpos=(rows_t, cols_t), t0=t_t, shadow_in=sh_t, ao_in=ao_t,
                cfg=cfg, material=material,
            )

        _, pullback = jax.vjp(shade, theta, uniforms)
        return pullback((gr, gg, gb))

    g_theta, g_uni = jax.vmap(tile_vjp)(
        tiles(rows), tiles(cols), tiles(t, 2.0 * cfg.march.max_distance),
        tiles(shadow, 1.0), tiles(ao, 1.0),
        tiles(g_rgb[0]), tiles(g_rgb[1]), tiles(g_rgb[2]),
    )
    return jax.tree_util.tree_map(lambda g: jnp.sum(g, axis=0), g_theta), jnp.sum(g_uni, axis=0)
