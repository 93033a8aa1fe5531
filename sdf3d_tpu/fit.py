"""Inverse rendering: fit SDF scene parameters to a target image.

The north-star entry point the reference has no counterpart for (its loop
only *displays*, ``/root/reference/Code/src/main.cpp:87-98``): gradient
descent through the differentiable renderer, single-chip or tile-sharded
across a mesh with psum'd gradients (BASELINE config 5).

Pipeline per step: render (implicit-VJP march) → pixel loss → grads via the
custom VJP → optax update → optional checkpoint + metrics line.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from sdf3d_tpu.camera import Camera, camera_rays
from sdf3d_tpu.checkpoint import load_checkpoint, save_checkpoint
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.diff import coverage, render_rays_diff
from sdf3d_tpu.lighting import Material, PointLight
from sdf3d_tpu.parallel.mesh import tile_axis
from sdf3d_tpu.parallel.shard_render import loss_and_grad_sharded
from sdf3d_tpu.sdf.node import SDFNode
from sdf3d_tpu.utils.logging import MetricsLogger


def _avg_pool2(img):
    """2x2 average pool over leading (H, W) axes of an (H, W, C) image."""
    h, w, c = img.shape
    h2, w2 = h - h % 2, w - w % 2
    v = img[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, c)
    return v.mean(axis=(1, 3))


def pixel_loss(img, target, kind: str, levels: int = 3):
    """Sum-of-squares pixel loss, optionally over an average-pool pyramid.

    Each level's loss is scaled by 4**level so every level contributes at
    the same per-original-pixel magnitude.
    """
    loss = jnp.sum((img - target) ** 2)
    if kind == "l2":
        return loss
    if kind != "multiscale":
        raise ValueError(f"unknown loss {kind!r}")
    a, b = img, target
    for level in range(1, levels + 1):
        if min(a.shape[0], a.shape[1]) < 2:
            break
        a, b = _avg_pool2(a), _avg_pool2(b)
        loss = loss + (4.0**level) * jnp.sum((a - b) ** 2)
    return loss


@dataclasses.dataclass(frozen=True)
class FitConfig:
    steps: int = 200
    learning_rate: float = 1e-2
    optimizer: str = "adam"  # adam | sgd
    log_every: int = 10
    checkpoint_every: int = 0  # 0 disables
    checkpoint_dir: str | None = None
    #: Render engine for the loss: "xla" (implicit-VJP ray renderer) or
    #: "pallas" (the fused fit kernel, or the fused forward kernel with the
    #: planar XLA backward where the fused loss does not apply).  Both
    #: compose with ``mesh``: the pallas engine runs one fused step per row
    #: slab under shard_map with one psum over the gradients (BASELINE
    #: config 5).
    engine: str = "xla"
    #: Pallas interpreter mode (CPU tests of the pallas engine).
    pallas_interpret: bool = False
    #: Override the kernel tile shape (tile_h, tile_w), powers of two;
    #: None = the default.  Interleaved sharding of short slabs may need a
    #: smaller tile_h.
    pallas_tile: tuple | None = None
    #: Pixel loss: "l2", or "multiscale" — L2 summed over an average-pool
    #: pyramid.  Plain L2 is silhouette-blind: pixels between the target's
    #: and the current render's silhouettes miss the object entirely and
    #: carry zero parameter gradient, so shrink-past-the-truth overshoots
    #: are attractors.  Pooling mixes those mismatch residuals into blocks
    #: that do contain object pixels, restoring a restoring force.
    loss: str = "l2"
    #: Number of extra 2x-downsampled pyramid levels for "multiscale".
    pyramid_levels: int = 3
    #: Max lax.scan chunk length (device steps per host dispatch).  0 = the
    #: logging cadence (``log_every``), so metrics lines stream with live
    #: timestamps and an interrupted fit keeps its completed chunks; raise it
    #: to amortize dispatch further when live logs don't matter.  Chunks
    #: always also break at checkpoint boundaries.
    chunk_steps: int = 0
    #: Weight of the soft-silhouette (coverage) loss term; 0 disables.
    #: Interior-point gradients are blind to silhouette motion (diff.py), so
    #: image-only fits can walk the wrong way when silhouettes mismatch; the
    #: coverage term compares sigmoid(-min_sdf/beta) against the target's
    #: object mask and restores that force.  Requires a target whose object
    #: mask is known: pass ``target_coverage`` to fit_scene, or use a
    #: render_config with ``background`` set (mask inferred from non-
    #: background pixels).
    silhouette_weight: float = 0.0
    #: Softness (world units) of the coverage sigmoid; None = march_eps/2.5.
    silhouette_beta: float | None = None
    #: With ``mesh`` + ``engine='pallas'``: shard the image as interleaved
    #: tile-height row blocks instead of contiguous slabs, so every device
    #: sees a representative sky/ground/object ray mix (load balance; see
    #: parallel/shard_render.py).  Targets/rays are permuted host-side once.
    shard_interleaved: bool = False


@dataclasses.dataclass
class FitResult:
    scene: SDFNode
    losses: list
    steps_run: int
    rays_per_second: float


@dataclasses.dataclass
class ViewFitResult:
    camera: Camera
    light: PointLight
    mat: Material
    losses: list
    steps_run: int


def _frozen_param_slots(scene0, trainable) -> tuple:
    """Flat scene-param-vector indices of frozen leaves (``trainable`` is a
    per-leaf bool pytree matching ``scene0``).  Fed to the fused fit kernel
    as static ``frozen_slots`` so frozen params enter the in-kernel loss as
    trace constants — their reverse chains are dead code the compiler never emits
    (the AD section shrinks with the trainable count).  Returns ``()`` when
    everything is trainable, or when everything is frozen (a degenerate
    'fit' keeps the conventional all-params path)."""
    if trainable is None:
        return ()
    import numpy as np

    t_leaves = jax.tree_util.tree_leaves(trainable)
    s_leaves = jax.tree_util.tree_leaves(scene0)
    idx, off = [], 0
    for tl, sl in zip(t_leaves, s_leaves):
        n = max(1, int(np.prod(np.shape(sl))))
        if not bool(tl):
            idx.extend(range(off, off + n))
        off += n
    if len(idx) == off:
        return ()
    return tuple(idx)


def _make_optimizer(cfg: FitConfig) -> optax.GradientTransformation:
    if cfg.optimizer == "adam":
        return optax.adam(cfg.learning_rate)
    if cfg.optimizer == "sgd":
        return optax.sgd(cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def fit_scene(
    target: jnp.ndarray,
    scene0: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    render_config: RenderConfig,
    fit_config: FitConfig = FitConfig(),
    mesh=None,
    logger: MetricsLogger | None = None,
    trainable=None,
    target_coverage=None,
) -> FitResult:
    """Fit ``scene0``'s parameters so the render matches ``target`` (H, W, 3).

    ``mesh`` switches on row-sharded data parallelism: each device renders
    and differentiates its slab, gradients are psum'd across devices (see
    parallel/shard_render.py) — the optimizer update then runs replicated.
    Checkpoint/resume: with ``checkpoint_dir`` set, an existing checkpoint is
    restored before the first step and snapshots are written every
    ``checkpoint_every`` steps.

    ``trainable``: optional pytree of bools matching ``scene0`` — ``False``
    leaves are frozen (their gradients zeroed before the update).  Freeze
    parameters with hard constraints the raw parameterization doesn't encode
    (e.g. a plane's unit normal): optimizing them unconstrained de-metrizes
    the SDF and destabilizes the march.

    ``target_coverage``: (H, W) object mask of the target in [0, 1] for the
    silhouette loss term; inferred from non-background pixels when
    ``render_config.background`` is set.

    **Multi-host**: when ``mesh`` spans processes (``jax.process_count() > 1``
    after ``parallel.launch.initialize``), inputs are built per host — each
    process generates only the ray rows its local devices own and ``target``
    may be a *callable* ``(abs_rows) -> (len(abs_rows), W, 3)`` block loader
    so no host ever materializes the full image (``target_coverage`` may be a
    callable too).  Checkpoints are written by process 0 only (checkpoint.py)
    and metrics stream from process 0 only.
    """
    opt = _make_optimizer(fit_config)
    sil_w = fit_config.silhouette_weight
    multihost = mesh is not None and jax.process_count() > 1

    def _make_pc():
        from sdf3d_tpu.ops import default_pallas_config

        if fit_config.pallas_tile is not None:
            return default_pallas_config(
                scene0,
                tile_h=fit_config.pallas_tile[0],
                tile_w=fit_config.pallas_tile[1],
                interpret=fit_config.pallas_interpret,
            )
        return default_pallas_config(scene0, interpret=fit_config.pallas_interpret)

    def _cov_missing():
        return ValueError(
            "silhouette_weight > 0 needs an object mask: pass "
            "target_coverage, or set render_config.background so the "
            "mask can be inferred from non-background pixels"
        )

    # Interleaved row blocks apply to the sharded pallas engine only.
    interleaved = (
        mesh is not None and fit_config.engine == "pallas" and fit_config.shard_interleaved
    )

    if multihost:
        import numpy as np

        from sdf3d_tpu.parallel import launch

        if logger is not None and not launch.is_primary():
            logger = None  # exactly one metrics writer (checkpoint.py gates its own)

        def _target_rows(abs_rows):
            idx = np.asarray(abs_rows)
            rgb = target(idx) if callable(target) else jnp.asarray(target, jnp.float32)[idx]
            rgb = jnp.asarray(rgb, jnp.float32)
            if sil_w <= 0.0:
                return rgb
            if target_coverage is None:
                if render_config.background is None:
                    raise _cov_missing()
                bg = jnp.asarray(render_config.background, jnp.float32)
                cov = (jnp.max(jnp.abs(rgb - bg), axis=-1) > 1e-3).astype(jnp.float32)
            elif callable(target_coverage):
                cov = jnp.asarray(target_coverage(idx), jnp.float32)
            else:
                cov = jnp.asarray(target_coverage, jnp.float32)[idx]
            # Coverage rides as a 4th channel, sharded with the image rows.
            return jnp.concatenate([rgb, cov[..., None]], axis=-1)

        origins, directions, target = launch.fit_arrays(
            mesh, camera, render_config, None, target_fn=_target_rows,
            interleaved=interleaved,
            tile_h=_make_pc().tile_h if fit_config.engine == "pallas" else 0,
        )
    else:
        origins, directions = camera_rays(camera, render_config.width, render_config.height, render_config.ray_mode)
        target = jnp.asarray(target, jnp.float32)
        if sil_w > 0.0:
            if target_coverage is None:
                if render_config.background is None:
                    raise _cov_missing()
                bg = jnp.asarray(render_config.background, jnp.float32)
                target_coverage = (
                    jnp.max(jnp.abs(target - bg), axis=-1) > 1e-3
                ).astype(jnp.float32)
            target_coverage = jnp.asarray(target_coverage, jnp.float32)
            # Ride along as a 4th target channel so the sharded path slices it
            # with the same row sharding as the image.
            target = jnp.concatenate([target, target_coverage[..., None]], axis=-1)

    def _split_target(tgt_):
        if sil_w > 0.0:
            return tgt_[..., :3], tgt_[..., 3]
        return tgt_, None

    def _sil_term(scene_, o_, d_, cov_t):
        if sil_w <= 0.0:
            return 0.0
        cov = coverage(render_config.march, scene_, o_, d_, fit_config.silhouette_beta)
        return sil_w * jnp.sum((cov - cov_t) ** 2)

    if mesh is not None and fit_config.loss == "multiscale":
        # The pyramid pools *within* each device's rows (both engines pool
        # per slab/tile under shard_map).  Its blocks coincide with the
        # unsharded objective's only when every device row-run starts and
        # ends on a 2**levels boundary — otherwise the sharded fit silently
        # optimizes a different (misaligned-block) loss than the same config
        # without mesh.  Engine-independent gate (round-4 advisory: the xla
        # engine slipped through the pallas-branch-only check).
        n_ms = mesh.shape[tile_axis]
        if render_config.height % n_ms != 0:
            raise ValueError(
                f"height {render_config.height} not divisible by mesh size {n_ms}"
            )
        if interleaved:
            run = _make_pc().tile_h
        else:
            run = render_config.height // n_ms
        lv = 1 << fit_config.pyramid_levels
        if run % lv != 0:
            what = "tile_h" if interleaved else "slab height (height/n_devices)"
            raise ValueError(
                f"multiscale loss under row sharding needs the {what} "
                f"({run}) divisible by 2**pyramid_levels ({lv}) so pooled "
                "blocks align with the unsharded objective; adjust "
                "height/pyramid_levels/tile or fit unsharded"
            )

    if fit_config.engine == "pallas":
        from sdf3d_tpu.ops import render_pallas

        pc = _make_pc()

        # The fused loss+grad kernel (ops/fit_kernel.py) computes the loss
        # and its gradients in the same launch as the march — no XLA loss,
        # cotangent or backward pass.  Covers the plain pixel L2, the
        # multiscale pyramid (in-tile pooling), and the silhouette coverage
        # term (in-march min-SDF tracking) whenever the scene/config
        # qualify.
        from sdf3d_tpu.ops.fit_kernel import fused_l2_eligible, l2_loss_and_grads

        use_fused_loss = fused_l2_eligible(
            render_config, scene0, loss=fit_config.loss,
            levels=fit_config.pyramid_levels, sil_w=sil_w, pc=pc,
        )
        frozen_slots = _frozen_param_slots(scene0, trainable)

        def _fused_args(tgt_):
            rgb_t, cov_t = _split_target(tgt_)
            return rgb_t, dict(
                wrt_uniforms=False, loss_kind=fit_config.loss,
                levels=fit_config.pyramid_levels, sil_w=float(sil_w),
                sil_beta=fit_config.silhouette_beta, target_coverage=cov_t,
                frozen_slots=frozen_slots,
            )

        if mesh is not None:
            # Sharded fused-engine fit (BASELINE config 5): each device runs
            # the fused fit kernel on its row slab (the row0/rowstride
            # uniforms map slab tiles to absolute pixels), grads are
            # all-reduced once per step.
            from sdf3d_tpu.ops.render_pallas import render_pallas_rows
            from sdf3d_tpu.parallel.shard_render import (
                fused_loss_and_grad_sharded,
                interleave_rows,
            )

            n_dev = mesh.shape[tile_axis]
            if render_config.height % n_dev != 0:
                raise ValueError(
                    f"height {render_config.height} not divisible by mesh size {n_dev}"
                )
            slab = render_config.height // n_dev
            th = pc.tile_h
            if interleaved and slab % th != 0:
                raise ValueError(
                    "interleaved sharding needs height divisible by "
                    f"n_devices*tile_h ({render_config.height} % {n_dev * th} != 0)"
                )
            slab_cfg = dataclasses.replace(
                render_config, height=slab, ndc_height=render_config.height
            )

            # NOTE: this closure is traced lazily inside run_chunk, so it
            # must only capture names that are never rebound later in this
            # function — the round-4 code captured ``n``, which the chunk
            # loop shadows with the chunk step count, silently turning the
            # interleaved rowstride into chunk_steps·tile_h (a WRONG
            # objective).  Regression-pinned by
            # test_fit.py::test_pallas_engine_sharded_interleaved_matches_unsharded.
            def _slab_row0_stride():
                idx = jax.lax.axis_index(tile_axis)
                if interleaved:
                    return (idx * th).astype(jnp.float32), jnp.float32(n_dev * th)
                return (idx * slab).astype(jnp.float32), jnp.float32(th)

            if use_fused_loss:
                def slab_vag(scene_, o_, d_, tgt_):
                    row0, stride = _slab_row0_stride()
                    rgb_t, kw = _fused_args(tgt_)
                    loss, grads = l2_loss_and_grads(
                        slab_cfg, pc, scene_, camera, light, mat, rgb_t, row0, stride,
                        **kw,
                    )
                    return loss, grads[0]

                value_and_grad = fused_loss_and_grad_sharded(slab_vag, mesh)
            else:
                from sdf3d_tpu.ops.render_pallas import _scene_compiles

                if _scene_compiles(scene0):
                    def slab_loss(scene_, o_, d_, tgt_):
                        row0, stride = _slab_row0_stride()
                        img = render_pallas_rows(
                            scene_, camera, light, mat, slab_cfg, pc, row0, stride
                        )
                        rgb_t, cov_t = _split_target(tgt_)
                        return pixel_loss(
                            img, rgb_t, fit_config.loss, fit_config.pyramid_levels
                        ) + _sil_term(scene_, o_, d_, cov_t)
                else:
                    # Scene families without a kernel emitter (NeuralSDF,
                    # VoxelGrid): each device renders its row slab with the
                    # banded-XLA differentiable path — the same delegation
                    # render_pallas makes unsharded — and the MLP/grid
                    # gradient pytree all-reduces once per step.
                    from sdf3d_tpu.render import render_rays_banded

                    def slab_loss(scene_, o_, d_, tgt_):
                        img = render_rays_banded(
                            scene_, o_, d_, light, mat, render_config,
                            inner=render_rays_diff,
                        )
                        rgb_t, cov_t = _split_target(tgt_)
                        return pixel_loss(
                            img, rgb_t, fit_config.loss, fit_config.pyramid_levels
                        ) + _sil_term(scene_, o_, d_, cov_t)

                value_and_grad = loss_and_grad_sharded(slab_loss, mesh)
            if interleaved and not multihost:
                # Row-permute once so each device's contiguous P(tile_axis)
                # shard holds exactly the interleaved rows it renders.
                # (Multi-host inputs are built directly in permuted order —
                # launch.abs_rows_for_block — so no global pass is needed.)
                origins = interleave_rows(origins, n_dev, th)
                directions = interleave_rows(directions, n_dev, th)
                target = interleave_rows(target, n_dev, th)
        elif use_fused_loss:
            def value_and_grad(scene_, o_, d_, tgt_):
                rgb_t, kw = _fused_args(tgt_)
                loss, grads = l2_loss_and_grads(
                    render_config, pc, scene_, camera, light, mat, rgb_t, **kw
                )
                return loss, grads[0]
        else:
            def value_and_grad(scene_, o_, d_, tgt_):
                def loss(sc):
                    img = render_pallas(render_config, pc, sc, camera, light, mat)
                    rgb_t, cov_t = _split_target(tgt_)
                    return pixel_loss(img, rgb_t, fit_config.loss, fit_config.pyramid_levels) + _sil_term(sc, o_, d_, cov_t)

                return jax.value_and_grad(loss)(scene_)
    else:
        def slab_loss(scene_, o_, d_, tgt_):
            img = render_rays_diff(scene_, o_, d_, light, mat, render_config)
            rgb_t, cov_t = _split_target(tgt_)
            return pixel_loss(img, rgb_t, fit_config.loss, fit_config.pyramid_levels) + _sil_term(scene_, o_, d_, cov_t)

        if mesh is not None:
            value_and_grad = loss_and_grad_sharded(slab_loss, mesh)
        else:
            def value_and_grad(scene_, o_, d_, tgt_):
                return jax.value_and_grad(slab_loss)(scene_, o_, d_, tgt_)

    if trainable is not None:
        mask = jax.tree_util.tree_map(lambda m: jnp.float32(1.0 if m else 0.0), trainable)
    else:
        mask = None

    # Steps run in lax.scan chunks: one host dispatch per logging/checkpoint
    # interval instead of per step, so the loop is kernel-bound rather than
    # dispatch-bound.  The ray bundles and
    # target are explicit jit arguments (not closure captures): under
    # multi-host execution they are global arrays spanning non-addressable
    # devices, which jit may consume only as inputs.
    @functools.partial(jax.jit, static_argnames=("n",))
    def run_chunk(scene_, opt_state_, origins_, directions_, target_, n):
        def body(carry, _):
            sc, st = carry
            loss, grads = value_and_grad(sc, origins_, directions_, target_)
            if mask is not None:
                grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, mask)
            updates, st = opt.update(grads, st, sc)
            sc = optax.apply_updates(sc, updates)
            return (sc, st), loss

        (scene_, opt_state_), chunk_losses = jax.lax.scan(
            body, (scene_, opt_state_), None, length=n
        )
        return scene_, opt_state_, chunk_losses

    scene = scene0
    opt_state = opt.init(scene)
    start_step = 0
    losses: list = []

    # Fingerprint ties a checkpoint to the fit setup: resuming under a
    # different loss/engine/renderer silently continues a stale (possibly
    # diverged) trajectory otherwise.  Fields that are legitimate to change
    # across resumes (total steps, logging/checkpoint cadence, paths) are
    # excluded.
    fingerprint = repr((
        fit_config.learning_rate, fit_config.optimizer, fit_config.engine,
        fit_config.loss, fit_config.pyramid_levels,
        fit_config.silhouette_weight, fit_config.silhouette_beta,
        render_config, jax.tree_util.tree_structure(scene0),
    ))
    if fit_config.checkpoint_dir:
        restored, manifest = load_checkpoint(fit_config.checkpoint_dir, (scene, opt_state))
        if restored is not None:
            if manifest.get("fingerprint") == fingerprint:
                scene, opt_state = restored
                start_step = manifest["step"]
                losses = list(manifest.get("losses", []))
            else:
                import warnings

                warnings.warn(
                    f"checkpoint at {fit_config.checkpoint_dir} was written by a "
                    "different fit configuration; starting fresh (it will be "
                    "overwritten)",
                    stacklevel=2,
                )
        if multihost:
            # Only process 0 *writes* checkpoints (checkpoint.py), so on
            # resume process 0's view is authoritative.  Without this
            # broadcast, a host whose filesystem lacks (or has a stale copy
            # of) the checkpoint would start at a different step with
            # different parameters and issue mismatched collective programs
            # — a hang, not an error.
            from jax.experimental import multihost_utils

            scene, opt_state, start_step = multihost_utils.broadcast_one_to_all(
                (scene, opt_state, jnp.int32(start_step))
            )
            start_step = int(start_step)
            # Loss history lengths can differ across processes (that is the
            # failure being repaired), so broadcast into a step-sized buffer
            # plus the true entry count: with log_every > 1 the logged
            # history is shorter than start_step, and keeping the zero
            # padding would corrupt FitResult.losses (and the losses meta of
            # subsequent checkpoints) on every multihost resume.
            buf = jnp.zeros((start_step,), jnp.float32)
            n_vals = 0
            if losses:
                vals = jnp.asarray(losses[:start_step], jnp.float32)
                buf = buf.at[: vals.shape[0]].set(vals)
                n_vals = int(vals.shape[0])
            buf, n_vals = multihost_utils.broadcast_one_to_all(
                (buf, jnp.int32(n_vals))
            )
            losses = [float(x) for x in buf[: int(n_vals)]]

    n_pixels = render_config.width * render_config.height
    t0 = time.perf_counter()
    steps_run = 0
    ckpt_every = fit_config.checkpoint_every if fit_config.checkpoint_dir else 0
    step = start_step
    chunk_cap = fit_config.chunk_steps or max(fit_config.log_every, 1)
    while step < fit_config.steps:
        # Chunk ends at the next checkpoint boundary (sync point) or after
        # ``chunk_cap`` steps — capping keeps metrics lines streaming at the
        # logging cadence (real timestamps, partial results on interrupt)
        # instead of all arriving after the whole fit completes.
        end = min(fit_config.steps, step + chunk_cap)
        if ckpt_every:
            end = min(end, ((step // ckpt_every) + 1) * ckpt_every)
        n_steps = end - step
        scene, opt_state, chunk_losses = run_chunk(
            scene, opt_state, origins, directions, target, n_steps
        )
        chunk_losses = jax.device_get(chunk_losses).tolist()  # one host sync per chunk
        steps_run += n_steps
        for i, loss_val in enumerate(chunk_losses):
            gstep = step + i
            if gstep % fit_config.log_every == 0 or gstep == fit_config.steps - 1:
                losses.append(loss_val)
                if logger is not None:
                    logger.log(step=gstep, loss=loss_val)
        step = end
        if ckpt_every and step % ckpt_every == 0:
            save_checkpoint(
                fit_config.checkpoint_dir, (scene, opt_state), step,
                meta={"losses": [float(x) for x in losses], "fingerprint": fingerprint},
            )

    from sdf3d_tpu.utils.profiling import force_completion

    force_completion(scene)
    elapsed = time.perf_counter() - t0
    rays_s = n_pixels * steps_run / max(elapsed, 1e-9)
    return FitResult(scene=scene, losses=losses, steps_run=steps_run, rays_per_second=rays_s)


def fit_scene_multiview(
    targets,
    scene0: SDFNode,
    cameras,
    light: PointLight,
    mat: Material,
    render_config: RenderConfig,
    fit_config: FitConfig = FitConfig(),
    logger: MetricsLogger | None = None,
    trainable=None,
    target_coverages=None,
) -> FitResult:
    """Fit scene parameters against **several views jointly**: the loss is the
    sum of per-view pixel losses, so silhouette ambiguities of a single
    viewpoint (depth/scale trade-offs along the eye ray) are constrained by
    the others — standard multi-view inverse rendering.  No reference
    counterpart (single fixed arcball view, ``main.cpp:87-98``).

    ``targets``: sequence of (H, W, 3) arrays; ``cameras``: sequence of
    :class:`Camera` of the same length (a static view count — each view's
    render compiles once).  Engines as in :func:`fit_scene`: the pallas
    engine runs one single-launch fused fit kernel per view per step and sums
    the gradient vectors; the xla engine differentiates the summed loss.
    ``trainable`` freezes scene leaves exactly like :func:`fit_scene`.
    ``fit_config.silhouette_weight > 0`` adds the per-view coverage term
    (same semantics as :func:`fit_scene`): pass ``target_coverages`` (one
    (H, W) mask per view) or set ``render_config.background`` so masks can be
    inferred from non-background pixels.
    """
    if len(targets) != len(cameras):
        raise ValueError(f"{len(targets)} targets vs {len(cameras)} cameras")
    if len(targets) == 0:
        raise ValueError("need at least one view")
    targets = [jnp.asarray(t, jnp.float32) for t in targets]

    sil_w = fit_config.silhouette_weight
    ray_bundles = []
    if sil_w > 0.0:
        if target_coverages is None:
            if render_config.background is None:
                raise ValueError(
                    "silhouette_weight > 0 needs per-view object masks: pass "
                    "target_coverages, or set render_config.background so "
                    "masks can be inferred from non-background pixels"
                )
            bg = jnp.asarray(render_config.background, jnp.float32)
            target_coverages = [
                (jnp.max(jnp.abs(t - bg), axis=-1) > 1e-3).astype(jnp.float32)
                for t in targets
            ]
        if len(target_coverages) != len(targets):
            raise ValueError(
                f"{len(target_coverages)} coverage masks vs {len(targets)} targets"
            )
        target_coverages = [jnp.asarray(c, jnp.float32) for c in target_coverages]

    def _sil_total(scene_):
        if sil_w <= 0.0:
            return 0.0
        # Ray bundles only exist on the non-fused paths that march them in
        # XLA (the fused kernel re-derives rays from uniforms in-kernel, so
        # eagerly building V full-image (H, W, 3) pairs there would waste
        # ~2V·H·W·3 floats of device memory per fit).
        if not ray_bundles:
            ray_bundles.extend(
                camera_rays(cam, render_config.width, render_config.height, render_config.ray_mode)
                for cam in cameras
            )
        total = 0.0
        for (o_v, d_v), cov_t in zip(ray_bundles, target_coverages):
            cov = coverage(render_config.march, scene_, o_v, d_v, fit_config.silhouette_beta)
            total = total + sil_w * jnp.sum((cov - cov_t) ** 2)
        return total

    if fit_config.engine == "pallas":
        from sdf3d_tpu.ops import default_pallas_config, render_pallas
        from sdf3d_tpu.ops.fit_kernel import fused_l2_eligible, multiview_loss_and_grads

        if fit_config.pallas_tile is not None:
            pc = default_pallas_config(
                scene0,
                tile_h=fit_config.pallas_tile[0],
                tile_w=fit_config.pallas_tile[1],
                interpret=fit_config.pallas_interpret,
            )
        else:
            pc = default_pallas_config(scene0, interpret=fit_config.pallas_interpret)

        if fused_l2_eligible(
            render_config, scene0, loss=fit_config.loss,
            levels=fit_config.pyramid_levels, sil_w=sil_w, pc=pc,
        ):
            # ONE kernel launch per step for all V views (view-axis grid),
            # not a per-view Python loop of V launches/compiled programs.
            frozen_slots = _frozen_param_slots(scene0, trainable)

            def value_and_grad(scene_):
                loss, grads = multiview_loss_and_grads(
                    render_config, pc, scene_, cameras, light, mat, targets,
                    wrt_uniforms=False, loss_kind=fit_config.loss,
                    levels=fit_config.pyramid_levels, sil_w=float(sil_w),
                    sil_beta=fit_config.silhouette_beta,
                    target_coverages=target_coverages if sil_w > 0.0 else None,
                    frozen_slots=frozen_slots,
                )
                return loss, grads[0]
        else:
            def loss_fn(scene_):
                return sum(
                    pixel_loss(
                        render_pallas(render_config, pc, scene_, cam, light, mat),
                        tgt, fit_config.loss, fit_config.pyramid_levels,
                    )
                    for cam, tgt in zip(cameras, targets)
                ) + _sil_total(scene_)

            value_and_grad = jax.value_and_grad(loss_fn)
    else:
        from sdf3d_tpu.diff import render_diff

        def loss_fn(scene_):
            return sum(
                pixel_loss(
                    render_diff(scene_, cam, light, mat, render_config),
                    tgt, fit_config.loss, fit_config.pyramid_levels,
                )
                for cam, tgt in zip(cameras, targets)
            ) + _sil_total(scene_)

        value_and_grad = jax.value_and_grad(loss_fn)

    if trainable is not None:
        mask = jax.tree_util.tree_map(lambda m: jnp.float32(1.0 if m else 0.0), trainable)
    else:
        mask = None

    opt = _make_optimizer(fit_config)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_chunk(scene_, st, n):
        def body(carry, _):
            sc, st_ = carry
            loss, g = value_and_grad(sc)
            if mask is not None:
                g = jax.tree_util.tree_map(lambda gg, m: gg * m, g, mask)
            updates, st_ = opt.update(g, st_, sc)
            sc = optax.apply_updates(sc, updates)
            return (sc, st_), loss

        (scene_, st), chunk_losses = jax.lax.scan(body, (scene_, st), None, length=n)
        return scene_, st, chunk_losses

    scene = scene0
    opt_state = opt.init(scene)
    losses: list = []
    step = 0
    t0 = time.perf_counter()
    chunk_cap = fit_config.chunk_steps or max(fit_config.log_every, 1)
    while step < fit_config.steps:
        n = min(fit_config.steps, step + chunk_cap) - step
        scene, opt_state, chunk_losses = run_chunk(scene, opt_state, n)
        for i, loss_val in enumerate(jax.device_get(chunk_losses).tolist()):
            gstep = step + i
            if gstep % fit_config.log_every == 0 or gstep == fit_config.steps - 1:
                losses.append(loss_val)
                if logger is not None:
                    logger.log(step=gstep, loss=loss_val)
        step += n

    from sdf3d_tpu.utils.profiling import force_completion

    force_completion(scene)
    elapsed = time.perf_counter() - t0
    n_rays = render_config.width * render_config.height * len(cameras)
    return FitResult(
        scene=scene, losses=losses, steps_run=step,
        rays_per_second=n_rays * step / max(elapsed, 1e-9),
    )


def fit_view(
    target: jnp.ndarray,
    scene: SDFNode,
    camera0: Camera,
    light0: PointLight,
    mat0: Material,
    render_config: RenderConfig,
    fit_config: FitConfig = FitConfig(),
    optimize: tuple = ("camera",),
    logger: MetricsLogger | None = None,
    target_coverage=None,
) -> ViewFitResult:
    """Inverse rendering of *view* parameters — camera pose, field of view,
    light, and/or material — against a target image, with the scene geometry
    fixed.  The complement of :func:`fit_scene` (which fits geometry under a
    fixed view); together they cover every differentiable input of the
    renderer.  No reference counterpart (the reference only *displays*,
    ``main.cpp:87-98``); classic applications are pose estimation and light/
    material estimation from photographs.

    **Pose fits want the silhouette term.**  The pixel-L2 gradient through
    the renderer captures only the *smooth* image dependence (hit points
    sliding along surfaces); the discontinuous terms — object silhouettes
    and the ground-plane horizon sweeping across pixels as the camera moves
    — are invisible to it, and at moderate resolutions they dominate, so a
    plain-L2 pose fit stalls or drifts (measured: position error *grows* at
    48×32).  ``fit_config.silhouette_weight > 0`` adds the coverage loss
    (``diff.coverage`` — smooth in ray origins/directions via the min-SDF
    implicit VJP), which restores exactly that silhouette-motion gradient;
    measured at 128×96 it takes the same fit from stalled to a 700× loss
    reduction.  Supply ``target_coverage`` (H, W) or set
    ``render_config.background`` so the mask can be inferred.

    ``optimize`` selects parameter groups:

    - ``"camera"`` — eye position + a delta rotation in the SO(3) tangent
      space (axis-angle composed onto ``camera0.c2w``, so the rotation stays
      exactly orthonormal at every step and the parameterization is singular-
      ity-free at the start point).
    - ``"fov"`` — vertical field of view (degrees).
    - ``"light"`` — light position and ambient intensity.
    - ``"material"`` — Blinn-Phong ambient/diffuse/specular/shininess.

    Engines: ``fit_config.engine == "pallas"`` with the plain L2 loss runs
    the single-launch fused fit kernel (``ops/fit_kernel.py``) with
    ``wrt_uniforms=True`` and pulls the uniform-vector gradients back through
    the pose parameterization with one ``jax.vjp``; otherwise gradients come
    from ``jax.value_and_grad`` through the differentiable renderer (implicit
    -function VJP w.r.t. ray origins/directions — diff.py).
    """
    from sdf3d_tpu.sdf.transforms import rotvec_to_matrix

    target = jnp.asarray(target, jnp.float32)
    groups = set(optimize)
    unknown = groups - {"camera", "fov", "light", "material"}
    if unknown:
        raise ValueError(f"unknown optimize groups {sorted(unknown)}")
    if not groups:
        raise ValueError("optimize must select at least one parameter group")

    params0: dict = {}
    if "camera" in groups:
        params0["cam_pos"] = jnp.asarray(camera0.position, jnp.float32)
        params0["cam_rotvec"] = jnp.zeros(3, jnp.float32)
    if "fov" in groups:
        params0["fov_deg"] = jnp.asarray(camera0.fov_deg, jnp.float32)
    if "light" in groups:
        params0["light_pos"] = jnp.asarray(light0.position, jnp.float32)
        params0["light_ambient"] = jnp.asarray(light0.ambient, jnp.float32)
    if "material" in groups:
        params0["mat_ambient"] = jnp.asarray(mat0.ambient, jnp.float32)
        params0["mat_diffuse"] = jnp.asarray(mat0.diffuse, jnp.float32)
        params0["mat_specular"] = jnp.asarray(mat0.specular, jnp.float32)
        params0["mat_shininess"] = jnp.asarray(mat0.shininess, jnp.float32)

    def build_view(p: dict):
        cam = camera0
        if "camera" in groups:
            cam = Camera(
                position=p["cam_pos"],
                # Delta rotation composed onto the start rotation: exactly
                # orthonormal for any rotvec, identity at p=0.
                c2w=rotvec_to_matrix(p["cam_rotvec"]) @ camera0.c2w,
                fov_deg=cam.fov_deg,
            )
        if "fov" in groups:
            cam = dataclasses.replace(cam, fov_deg=p["fov_deg"])
        light = light0
        if "light" in groups:
            light = dataclasses.replace(
                light, position=p["light_pos"], ambient=p["light_ambient"]
            )
        mat = mat0
        if "material" in groups:
            mat = Material(
                ambient=p["mat_ambient"],
                diffuse=p["mat_diffuse"],
                specular=p["mat_specular"],
                shininess=p["mat_shininess"],
            )
        return cam, light, mat

    sil_w = fit_config.silhouette_weight
    if sil_w > 0.0:
        if target_coverage is None:
            if render_config.background is None:
                raise ValueError(
                    "silhouette_weight > 0 needs an object mask: pass "
                    "target_coverage, or set render_config.background so the "
                    "mask can be inferred from non-background pixels"
                )
            bg = jnp.asarray(render_config.background, jnp.float32)
            target_coverage = (
                jnp.max(jnp.abs(target - bg), axis=-1) > 1e-3
            ).astype(jnp.float32)
        target_coverage = jnp.asarray(target_coverage, jnp.float32)

    def _sil_term(cam):
        if sil_w <= 0.0:
            return 0.0
        o, d = camera_rays(cam, render_config.width, render_config.height, render_config.ray_mode)
        cov = coverage(render_config.march, scene, o, d, fit_config.silhouette_beta)
        return sil_w * jnp.sum((cov - target_coverage) ** 2)

    use_fused = False
    if fit_config.engine == "pallas":
        from sdf3d_tpu.ops import default_pallas_config, render_pallas
        from sdf3d_tpu.ops.fit_kernel import fused_l2_eligible, l2_loss_and_grads

        if fit_config.pallas_tile is not None:
            pc = default_pallas_config(
                scene,
                tile_h=fit_config.pallas_tile[0],
                tile_w=fit_config.pallas_tile[1],
                interpret=fit_config.pallas_interpret,
            )
        else:
            pc = default_pallas_config(scene, interpret=fit_config.pallas_interpret)
        use_fused = fused_l2_eligible(
            render_config, pc=pc, scene=scene, loss=fit_config.loss,
            levels=fit_config.pyramid_levels, sil_w=sil_w,
        )

    if use_fused:
        # The recommended pose-fit configuration (L2 + silhouette coverage,
        # docstring above) runs entirely in the single-launch fused kernel:
        # the coverage term's camera gradient comes from the in-kernel
        # envelope re-attachment through the uniform vector.
        def value_and_grad(p):
            (cam, light, mat), view_vjp = jax.vjp(build_view, p)
            loss, (_g_scene, g_cam, g_light, g_mat) = l2_loss_and_grads(
                render_config, pc, scene, cam, light, mat, target,
                loss_kind=fit_config.loss, levels=fit_config.pyramid_levels,
                sil_w=float(sil_w), sil_beta=fit_config.silhouette_beta,
                target_coverage=target_coverage if sil_w > 0.0 else None,
            )
            (g_p,) = view_vjp((g_cam, g_light, g_mat))
            return loss, g_p
    elif fit_config.engine == "pallas":
        def loss_fn(p):
            cam, light, mat = build_view(p)
            img = render_pallas(render_config, pc, scene, cam, light, mat)
            return pixel_loss(
                img, target, fit_config.loss, fit_config.pyramid_levels
            ) + _sil_term(cam)

        value_and_grad = jax.value_and_grad(loss_fn)
    else:
        from sdf3d_tpu.diff import render_diff

        def loss_fn(p):
            cam, light, mat = build_view(p)
            img = render_diff(scene, cam, light, mat, render_config)
            return pixel_loss(
                img, target, fit_config.loss, fit_config.pyramid_levels
            ) + _sil_term(cam)

        value_and_grad = jax.value_and_grad(loss_fn)

    opt = _make_optimizer(fit_config)
    opt_state = opt.init(params0)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_chunk(p, st, n):
        def body(carry, _):
            p_, st_ = carry
            loss, g = value_and_grad(p_)
            updates, st_ = opt.update(g, st_, p_)
            p_ = optax.apply_updates(p_, updates)
            return (p_, st_), loss

        (p, st), chunk_losses = jax.lax.scan(body, (p, st), None, length=n)
        return p, st, chunk_losses

    params = params0
    losses: list = []
    step = 0
    chunk_cap = fit_config.chunk_steps or max(fit_config.log_every, 1)
    while step < fit_config.steps:
        n = min(fit_config.steps, step + chunk_cap) - step
        params, opt_state, chunk_losses = run_chunk(params, opt_state, n)
        for i, loss_val in enumerate(jax.device_get(chunk_losses).tolist()):
            gstep = step + i
            if gstep % fit_config.log_every == 0 or gstep == fit_config.steps - 1:
                losses.append(loss_val)
                if logger is not None:
                    logger.log(step=gstep, loss=loss_val)
        step += n

    from sdf3d_tpu.utils.profiling import force_completion

    force_completion(params)
    cam, light, mat = build_view(params)
    return ViewFitResult(camera=cam, light=light, mat=mat, losses=losses, steps_run=step)
