"""Fused L2 loss + gradient kernel: the inverse-rendering hot path in ONE
Pallas launch (Triton route) and zero XLA round-trips.

The generic pallas fit step (ops/render_pallas.py custom VJP) costs, per
frame at 1080p: forward kernel (writes rgb + residual planes, 50 MB) → XLA
loss pass (reads rgb + target, reduces) → XLA cotangent pass (writes
``g_rgb = 2(img − target)``, 25 MB) → XLA backward (reads g_rgb +
residuals, 75 MB).  But the backward *re-traces the whole shading
expression anyway* — and the march/shadow planes it re-attaches are exactly
what the forward kernel computes.  So for the L2 pixel loss the entire fit
step fuses into a single block program:

    march (while_loop)  →  shadow march (while_loop)  →  AO
        →  value_and_grad of   Σ mask · (shade(params) − target)²

with ``jax.value_and_grad`` running at kernel-trace time (AD on the jaxpr
before lowering).  The marches produce the residual planes *in registers*;
the differentiated shading re-attaches them via the implicit-function
theorem (shade_planes.shade_tile).  Per frame vs the two-launch version
this removes the rgb + residual round trip through device memory (~100 MB
at 1080p), the duplicate ray-gen/normals/shading primal, and launches;
memory traffic drops to target reads (25 MB) + one partial vector per
program.

Each program writes one partial vector of length
``next_pow2(P + N_UNIFORMS + 1)`` (grads, then the loss); XLA sums the
partials outside the kernel, so nothing is carried between programs —
Triton programs run in parallel, in no order.

``mask`` zeroes padding lanes (local rows ≥ slab height, cols ≥ W) so padded
tiles contribute exact zeros to both loss and grads — required because the
target is zero-padded, which would otherwise make sky padding "visible".

Beyond the plain L2, the kernel fuses the loss configurations fit.py itself
recommends: the **multiscale pyramid** (per-tile 2×2 mean pooling as a
reshape + sum, recursive odd-edge cropping matching ``fit._avg_pool2``)
and the **silhouette coverage term** (the march carries the ray-min-SDF
plane and its argmin distance; the in-kernel loss adds
``sil_w · Σ(σ((2ε − min_s)/β) − mask)²`` with envelope-theorem gradient
re-attachment identical to ``diff.ray_min_sdf_diff``) — so the recommended
pose-fit configuration (L2 + coverage) runs in ONE launch.  Still XLA-path:
``shadow.grad == "ad"`` (must re-march differentiably).

Used by fit.py (engine='pallas') single-mesh and sharded (the kernel honors
the same row0/rowstride uniforms as the forward — parallel/shard_render.py),
and by the benchmark (sdf3d_tpu/bench.py), whose fwd_bwd metric is exactly
this fit step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.ops.render_kernel import (
    N_UNIFORMS,
    PallasRenderConfig,
    _U_K,
    _U_ROW0,
    _U_ROWSTRIDE,
    _round_up,
    _tile_pixel_planes,
    _tile_primal,
    _tile_rays,
    compiler_params,
    pack_uniforms,
)
from sdf3d_tpu.ops.scene_program import (
    compile_scene,
    compile_scene_material,
    compile_scene_ray,
    scene_param_vector,
)
from sdf3d_tpu.ops.shade_planes import shade_tile


def _pool2(a):
    """2×2 mean pool of an (R, C) plane (R, C even) as a reshape + sum —
    no matrix product, so no TF32 rounding and no minimum dot shape."""
    R, C = a.shape
    return 0.25 * jnp.sum(a.reshape(R // 2, 2, C // 2, 2), axis=(1, 3))


def partial_len(n_params: int) -> int:
    """Length of each program's partial vector: the next power of two
    ≥ P + N_UNIFORMS + 1 (grads, uniform grads, then the loss)."""
    return 1 << (n_params + N_UNIFORMS).bit_length()


def _fit_tile_kernel(
    uni, prm, *refs, soa, soa_ray, mat_soa, n_params, cfg: RenderConfig,
    pc: PallasRenderConfig, wrt_uniforms: bool, loss_kind: str, levels: int,
    sil_w: float, sil_beta, multiview: bool = False, frozen_slots: tuple = (),
):
    """Kernel body: primal march/shadow/AO, then value_and_grad of the masked
    tile loss w.r.t. scalar params and uniforms; writes the program's
    partial vector (grads at their slots, then the loss at P + N_UNIFORMS).

    Loss terms, all inside the one launch:

    - pixel L2 (always), plus the multiscale pyramid when
      ``loss_kind == "multiscale"``: each level 2×2-mean-pools the masked
      residual (``_pool2``) and adds ``4**level`` × the all-real blocks'
      squared means — XLA ``fit.pixel_loss`` semantics, including its
      recursive odd-edge cropping (a pooled block counts iff its pooled
      mask is exactly 1).
    - the silhouette coverage term when ``sil_w > 0``: the march tracks the
      ray-min SDF and its argmin distance (``_march_primary(track_min)``);
      the term re-attaches gradients by the envelope theorem exactly like
      ``diff.ray_min_sdf_diff`` — value from the primal ``min_s``, gradient
      from one extra SDF eval at ``o + t_min·d`` with ``t_min`` as data (and
      ray-gen re-derived from the uniforms, so pose fits get the
      silhouette-motion gradient in-kernel).
    """
    TH, TW = pc.tile_h, pc.tile_w
    f32 = jnp.float32
    sg = jax.lax.stop_gradient
    if sil_w > 0.0:
        tr, tg, tb, tc, out_ref = refs
    else:
        tr, tg, tb, out_ref = refs
        tc = None

    prm_vals = [prm[k] for k in range(n_params)]

    def getp(k):
        return prm_vals[k]

    def sdf(px, py, pz):
        return soa(px, py, pz, getp)

    # Load the uniforms once (per-view row when multiview: the grid's
    # leading axis selects this program's camera/light/material).
    if multiview:
        v = pl.program_id(0)
        uni = tuple(uni[v, k] for k in range(N_UNIFORMS))
    else:
        uni = tuple(uni[k] for k in range(N_UNIFORMS))

    riota = jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 0)
    ciota = jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 1)
    off = 1 if multiview else 0
    i = pl.program_id(off)
    j = pl.program_id(off + 1)
    rows, cols = _tile_pixel_planes(uni, TH, TW, axis_off=off)
    # Padding mask in *local* (slab) coordinates: the grid covers the
    # padded slab, and padded lanes must contribute exact zeros (their
    # target is zero-padded; their absolute rows may even alias another
    # slab's rows).
    local_rows = i * TH + riota
    local_cols = j * TW + ciota
    mask = jnp.where(
        (local_rows < cfg.height) & (local_cols < cfg.width), f32(1.0), f32(0.0)
    )

    # ---- primal pipeline (identical to the forward kernel's) ----
    primal = _tile_primal(
        uni, getp, sdf, soa_ray, rows, cols, cfg, pc, track_min=(sil_w > 0.0)
    )
    _, _, t0, _, _, shadow, ao = primal[:7]
    if sil_w > 0.0:
        min_s, t_min = primal[7], primal[8]

    # Frozen (non-trainable) params enter the loss as trace CONSTANTS, so
    # their entire reverse chains are dead code the compiler never emits —
    # the trainable-mask constant folding of fit.py's ``trainable`` pytrees
    # (the AD section shrinks with the trainable count).
    frozen_set = frozenset(frozen_slots)
    train_idx = tuple(k for k in range(n_params) if k not in frozen_set)
    pv = tuple(prm_vals[k] for k in train_idx)
    uv = uni  # already the loaded scalar tuple

    tgt = (tr[...], tg[...], tb[...])

    def tile_loss(pv_train, uv_):
        it = iter(pv_train)
        pv_ = tuple(
            prm_vals[k] if k in frozen_set else next(it) for k in range(n_params)
        )
        # shade_tile re-derives rays/normals/shading from the *fresh* pv_/uv_
        # arguments under AD; t0/shadow/ao enter as trace constants — exactly
        # the detached-shadow + implicit-function-t semantics of the render
        # backward (they were computed from the same prm/uni values).
        def getp_(k):
            return pv_[k]

        def sdf_(px, py, pz):
            return soa(px, py, pz, getp_)

        material = None
        if mat_soa is not None:
            def material(hx, hy, hz, mch):
                return mat_soa(hx, hy, hz, getp_, mch)[1]

        r, g, b = shade_tile(
            sdf_, uv_, gpos=(rows, cols), t0=t0, shadow_in=shadow, ao_in=ao,
            cfg=cfg, material=material,
        )
        rm = (r - tgt[0]) * mask
        gm = (g - tgt[1]) * mask
        bm = (b - tgt[2]) * mask
        loss = jnp.sum(rm * rm + gm * gm + bm * bm)
        if loss_kind == "multiscale":
            m = mask
            for level in range(1, levels + 1):
                rm, gm, bm, m = _pool2(rm), _pool2(gm), _pool2(bm), _pool2(m)
                # All-real pooled blocks only — matches fit._avg_pool2's
                # recursive odd-edge cropping.  The gate is on the *primal*
                # mask, constant under AD.
                valid = jnp.where(sg(m) > 0.999, f32(1.0), f32(0.0))
                # Residual means were pooled with the mask folded in; for
                # valid (all-real) blocks that IS the pooled-image residual.
                loss = loss + (4.0**level) * jnp.sum(
                    valid * (rm * rm + gm * gm + bm * bm)
                )
        if sil_w > 0.0:
            beta = cfg.march.epsilon / 2.5 if sil_beta is None else sil_beta
            # Envelope re-attachment (diff.ray_min_sdf_diff semantics):
            # value = primal min_s; gradient = ∂f/∂(pv_, uv_) at the argmin
            # point o + t_min·d with t_min data.
            (ox_, oy_, oz_), (dx_, dy_, dz_) = _tile_rays(uv_, rows, cols, cfg, TH, TW)
            f_min = sdf_(ox_ + t_min * dx_, oy_ + t_min * dy_, oz_ + t_min * dz_)
            min_att = f_min - sg(f_min) + min_s
            cov = jax.nn.sigmoid((2.0 * cfg.march.epsilon - min_att) / beta)
            loss = loss + sil_w * jnp.sum(mask * (cov - tc[...]) ** 2)
        return loss

    if wrt_uniforms:
        loss, (d_pv, d_uv) = jax.value_and_grad(tile_loss, argnums=(0, 1))(pv, uv)
    else:
        # Scene-parameter-only fit (the fit.py/bench hot path): uniforms enter
        # as trace constants, so their reverse chains (ray-gen, light,
        # material) and plane reductions are dead code the compiler never
        # emits.
        loss, d_pv = jax.value_and_grad(tile_loss, argnums=0)(pv, uv)
        d_uv = ()
    # Compile-time one-hot scatter into the partial vector: component k
    # lands at slot k, the tile loss at P + N_UNIFORMS.  Frozen slots are
    # never written — their gradient reads as exact zero.
    G = partial_len(n_params)
    slot = jax.lax.broadcasted_iota(jnp.int32, (G,), 0)
    vec = jnp.zeros((G,), f32)
    comps = list(d_pv) + list(d_uv) + [loss]
    slots = (
        list(train_idx)
        + list(range(n_params, n_params + len(d_uv)))
        + [n_params + N_UNIFORMS]
    )
    for k, d in zip(slots, comps):
        vec = vec + jnp.where(slot == k, d, 0.0)
    out_ref[...] = vec


@functools.partial(jax.jit, static_argnames=(
    "scene_treedef", "leaf_shapes", "cfg", "pc", "wrt_uniforms",
    "loss_kind", "levels", "sil_w", "sil_beta", "frozen_slots",
))
def fit_step_kernel(
    scene_treedef, leaf_shapes, params, uniforms, target, cfg: RenderConfig,
    pc: PallasRenderConfig, wrt_uniforms: bool = True, loss_kind: str = "l2",
    levels: int = 3, sil_w: float = 0.0, sil_beta=None, target_coverage=None,
    frozen_slots: tuple = (),
):
    """Single-launch fused fit step: returns ``(loss, g_params (P,),
    g_uniforms (N_UNIFORMS,))``.

    ``target`` is planar (3, H, W) (a slab under sharding).  Padding expands
    to the tile grid with zeros; the in-kernel mask zeroes padded lanes.
    ``wrt_uniforms=False`` skips camera/light/material gradients (returned
    as zeros) — the scene-only fit hot path.  ``loss_kind``/``levels`` add
    the in-kernel multiscale pyramid; ``sil_w``/``sil_beta`` the in-kernel
    silhouette coverage term against the ``target_coverage`` (H, W) mask.
    """
    dummies = [jnp.zeros(shape, jnp.float32) for shape in leaf_shapes]
    scene = jax.tree_util.tree_unflatten(scene_treedef, dummies)
    soa = compile_scene(scene)
    soa_ray = compile_scene_ray(scene) if pc.ray_sdf else None
    from sdf3d_tpu.sdf.materials import scene_has_materials

    mat_soa = compile_scene_material(scene) if scene_has_materials(scene) else None
    H, W = cfg.height, cfg.width
    TH, TW = pc.tile_h, pc.tile_w
    Hp, Wp = _round_up(H, TH), _round_up(W, TW)
    grid = (Hp // TH, Wp // TW)
    P = int(params.shape[0])
    G = P + N_UNIFORMS
    GL = partial_len(P)
    if loss_kind == "multiscale" and (TH % (1 << levels) or TW % (1 << levels)):
        raise ValueError(
            f"fused multiscale needs tile dims divisible by 2^levels "
            f"({(TH, TW)} vs levels={levels})"
        )
    if sil_w > 0.0 and target_coverage is None:
        raise ValueError("sil_w > 0 needs target_coverage")

    # Multi-view: a (V, N_UNIFORMS) uniform matrix + (V, 3, H, W) targets
    # prepend a view axis to the grid — ONE launch for all views per step
    # (fit_scene_multiview's hot path), V·grid partial vectors out.
    multiview = uniforms.ndim == 2
    V = int(uniforms.shape[0]) if multiview else 1

    stride_slot = uniforms[..., _U_ROWSTRIDE]
    stride = jnp.where(stride_slot > 0.0, stride_slot, jnp.float32(TH))
    uniforms = uniforms.at[..., _U_ROWSTRIDE].set(stride)

    pad = ((0, 0),) * (1 if multiview else 0) + ((0, Hp - H), (0, Wp - W))
    planes_in = [jnp.pad(target[..., 0, :, :], pad),
                 jnp.pad(target[..., 1, :, :], pad),
                 jnp.pad(target[..., 2, :, :], pad)]
    if sil_w > 0.0:
        planes_in.append(jnp.pad(jnp.asarray(target_coverage, jnp.float32), pad))

    kernel = functools.partial(
        _fit_tile_kernel, soa=soa, soa_ray=soa_ray, mat_soa=mat_soa, n_params=P, cfg=cfg, pc=pc,
        wrt_uniforms=wrt_uniforms, loss_kind=loss_kind, levels=levels,
        sil_w=float(sil_w), sil_beta=sil_beta, multiview=multiview,
        frozen_slots=tuple(frozen_slots),
    )
    if multiview:
        full_grid = (V,) + grid
        plane = pl.BlockSpec((None, TH, TW), lambda v, i, j: (v, i, j))
        out_spec = pl.BlockSpec((None, None, None, GL), lambda v, i, j: (v, i, j, 0))
        out_shape = jax.ShapeDtypeStruct((V, grid[0], grid[1], GL), jnp.float32)
    else:
        full_grid = grid
        plane = pl.BlockSpec((TH, TW), lambda i, j: (i, j))
        out_spec = pl.BlockSpec((None, None, GL), lambda i, j: (i, j, 0))
        out_shape = jax.ShapeDtypeStruct((grid[0], grid[1], GL), jnp.float32)
    partials = pl.pallas_call(
        kernel,
        grid=full_grid,
        in_specs=[pl.no_block_spec, pl.no_block_spec] + [plane] * len(planes_in),
        out_specs=out_spec,
        out_shape=out_shape,
        backend="triton",
        compiler_params=compiler_params(pc),
        interpret=pc.interpret,
        name="sdf3d_fit_step",
    )(uniforms, params, *planes_in)

    if multiview:
        # Per-view partial sums: scene-parameter grads and loss sum over
        # views; uniform grads stay per view (each view has its own camera).
        per_view = jnp.sum(partials, axis=(1, 2))
        return per_view[:, G].sum(), per_view[:, :P].sum(axis=0), per_view[:, P:G]
    total = jnp.sum(partials, axis=(0, 1))
    return total[G], total[:P], total[P:G]


def fused_l2_eligible(
    cfg: RenderConfig,
    scene,
    loss: str = "l2",
    levels: int = 3,
    sil_w: float = 0.0,
    pc: PallasRenderConfig | None = None,
) -> bool:
    """True when the fused loss+grad path applies: default detached-shadow
    gradients, kernel-supported normals, and a scene every node of which has
    a kernel emitter.  Extended loss
    terms narrow it further:

    - ``loss == "multiscale"``: the tile must pool evenly (tile dims
      divisible by ``2**levels``);
    - ``sil_w > 0`` (silhouette coverage): the min-SDF tracker marches
      unrelaxed, so ``march.relaxation == 1.0`` is required.
    """
    from sdf3d_tpu.ops.render_pallas import _scene_compiles

    if loss == "multiscale":
        tp = pc or PallasRenderConfig()
        if tp.tile_h % (1 << levels) or tp.tile_w % (1 << levels):
            return False
    elif loss != "l2":
        return False
    if sil_w > 0.0 and cfg.march.relaxation != 1.0:
        return False
    return (
        not (cfg.shadow.enabled and cfg.shadow.grad == "ad")
        and cfg.normals in ("central", "tetrahedron")
        and _scene_compiles(scene)
    )


def l2_loss_and_grads(
    cfg: RenderConfig,
    pc: PallasRenderConfig,
    scene,
    camera,
    light,
    mat,
    target,
    row0=0.0,
    rowstride=0.0,
    wrt_uniforms: bool = True,
    loss_kind: str = "l2",
    levels: int = 3,
    sil_w: float = 0.0,
    sil_beta=None,
    target_coverage=None,
    frozen_slots: tuple = (),
):
    """Fused ``(loss, (g_scene, g_camera, g_light, g_mat))`` — ONE kernel
    launch, no XLA loss/cotangent pass and no residual round trip.

    ``target`` is (H, W, 3) (matching ``cfg.height`` rows — a slab under
    sharding).  ``row0``/``rowstride`` may be traced (``lax.axis_index``
    under shard_map); 0 = unsharded defaults.  Gradients are exact matches
    of ``jax.value_and_grad`` through ``render_pallas`` with the same loss
    (``fit.pixel_loss(loss_kind)`` plus ``sil_w · Σ(coverage − mask)²`` —
    the configurations ``fit.py`` recommends now run fused end-to-end).
    ``wrt_uniforms=False`` skips the camera/light/material gradients (zero
    pytrees returned) — pass it when only scene grads are consumed
    (fit.py's scene fit) to skip their reverse chains in the kernel.
    ``target_coverage`` is the (H, W) object mask (sliced/permuted with the
    same row layout as ``target`` under sharding).
    """
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    leaf_shapes = tuple(jnp.shape(l) for l in leaves)
    params, p_vjp = jax.vjp(scene_param_vector, scene)

    def pack(cam_, light_, mat_):
        u = pack_uniforms(cam_, light_, mat_, cfg.ray_mode)
        return u.at[_U_K].set(jnp.asarray(cfg.shadow.k, jnp.float32))

    uniforms, u_vjp = jax.vjp(pack, camera, light, mat)
    uniforms = uniforms.at[_U_ROW0].set(jnp.asarray(row0, jnp.float32))
    uniforms = uniforms.at[_U_ROWSTRIDE].set(jnp.asarray(rowstride, jnp.float32))

    target_planar = jnp.transpose(jnp.asarray(target, jnp.float32), (2, 0, 1))
    loss, g_params, g_uni = fit_step_kernel(
        treedef, leaf_shapes, params, uniforms, target_planar, cfg, pc,
        wrt_uniforms=wrt_uniforms, loss_kind=loss_kind, levels=levels,
        sil_w=float(sil_w), sil_beta=sil_beta, target_coverage=target_coverage,
        frozen_slots=tuple(frozen_slots),
    )
    (g_scene,) = p_vjp(g_params)
    g_cam, g_light, g_mat = u_vjp(g_uni)
    return loss, (g_scene, g_cam, g_light, g_mat)


def multiview_loss_and_grads(
    cfg: RenderConfig,
    pc: PallasRenderConfig,
    scene,
    cameras,
    light,
    mat,
    targets,
    wrt_uniforms: bool = False,
    loss_kind: str = "l2",
    levels: int = 3,
    sil_w: float = 0.0,
    sil_beta=None,
    target_coverages=None,
    frozen_slots: tuple = (),
):
    """Fused **multi-view** fit step: ONE kernel launch for all V views.

    The program grid grows a leading view axis; per-view uniform vectors sit
    as a (V, N_UNIFORMS) matrix and each program reads its view's row —
    V separate launches (and V compiled programs) collapse into one
    (fit.py's ``fit_scene_multiview`` hot path).

    ``cameras``: sequence of V cameras; ``targets``: sequence of V (H, W, 3)
    images (or a stacked (V, H, W, 3) array).  Returns
    ``(loss, (g_scene, g_cameras, g_light, g_mat))`` with the loss and scene
    gradient summed over views and ``g_cameras`` a list of per-view camera
    gradients (zeros unless ``wrt_uniforms``).  Loss options as in
    :func:`l2_loss_and_grads` (multiscale / silhouette fuse too).
    """
    V = len(cameras)
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    leaf_shapes = tuple(jnp.shape(l) for l in leaves)
    params, p_vjp = jax.vjp(scene_param_vector, scene)

    def pack(cam_, light_, mat_):
        u = pack_uniforms(cam_, light_, mat_, cfg.ray_mode)
        return u.at[_U_K].set(jnp.asarray(cfg.shadow.k, jnp.float32))

    uni_rows, u_vjps = [], []
    for cam in cameras:
        u, u_vjp = jax.vjp(pack, cam, light, mat)
        uni_rows.append(u)
        u_vjps.append(u_vjp)
    uniforms = jnp.stack(uni_rows)  # (V, N_UNIFORMS); row0/rowstride stay 0

    targets = jnp.stack([jnp.asarray(t, jnp.float32) for t in targets])
    target_planar = jnp.transpose(targets, (0, 3, 1, 2))  # (V, 3, H, W)
    covs = None
    if sil_w > 0.0:
        covs = jnp.stack([jnp.asarray(c, jnp.float32) for c in target_coverages])

    loss, g_params, g_uni = fit_step_kernel(
        treedef, leaf_shapes, params, uniforms, target_planar, cfg, pc,
        wrt_uniforms=wrt_uniforms, loss_kind=loss_kind, levels=levels,
        sil_w=float(sil_w), sil_beta=sil_beta, target_coverage=covs,
        frozen_slots=tuple(frozen_slots),
    )
    (g_scene,) = p_vjp(g_params)
    g_cams, g_light_total, g_mat_total = [], None, None
    for v in range(V):
        g_cam, g_light_v, g_mat_v = u_vjps[v](g_uni[v])
        g_cams.append(g_cam)
        g_light_total = g_light_v if g_light_total is None else jax.tree_util.tree_map(
            jnp.add, g_light_total, g_light_v
        )
        g_mat_total = g_mat_v if g_mat_total is None else jax.tree_util.tree_map(
            jnp.add, g_mat_total, g_mat_v
        )
    return loss, (g_scene, g_cams, g_light_total, g_mat_total)
