"""Sphere-trace, soft-shadow, AO marches and normal estimation (pure XLA).

This is the batched re-design of the per-fragment loops in
``/root/reference/Code/shader/voxel_fragment.frag``:

- ``raymarch`` (``:86-103``)  → :func:`sphere_trace`
- ``shadow``   (``:105-132``) → :func:`soft_shadow`
- ``normal``   (``:134-155``) → :func:`normal_central` (plus tetrahedron /
  autodiff variants, north-star choices)
- (no AO in the reference)    → :func:`ambient_occlusion`

Design: the GLSL loops `break` per pixel; a whole-array XLA program has no
per-lane break, so every march is a *masked* loop — all lanes step together, a boolean
``active`` lane-mask freezes finished rays, and (optionally) the whole loop
exits once no lane is active (`lax.while_loop` with an `any` reduction —
the batch-level analogue of the per-fragment break, free of data-dependent
shapes).  The masked updates are ordered exactly as the reference's loop
bodies so results are bitwise comparable.

All functions take ``sdf_fn: (..., 3) -> (...)`` — typically
``scene.distance`` — and broadcast over any batch shape.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from sdf3d_tpu.config import AOConfig, MarchConfig, ShadowConfig
from sdf3d_tpu.sdf.node import vnormalize

SDFFn = Callable[[jnp.ndarray], jnp.ndarray]

#: Attenuation used when the shadow step is degenerate (see soft_shadow).
_NO_DARKEN = 1e30
_TINY = 1e-30

#: Closest-approach estimates beyond this are degenerate (the update is
#: discarded anyway); capping them keeps inf out of the AD graph.
_INTER_CAP = 1e15


@jax.custom_jvp
def _sqrt_grad_safe(x):
    """``sqrt`` with the exact primal but a finite derivative at 0.

    The shadow march computes ``d_est = sqrt(max(d2, 0))`` where ``d2 == 0``
    exactly on every step that marches straight away from a plane
    (``sdf_new = 2·sdf_prev`` ⇒ closest approach 0).  Plain ``sqrt`` has an
    infinite derivative there; under reverse AD the tie-splitting
    ``maximum`` passes it half the cotangent and the whole gradient goes
    NaN.  The subgradient 0 at x = 0 is the correct choice: the primal sits
    at the clamp boundary where the update is about to be discarded.
    """
    return jnp.sqrt(x)


@_sqrt_grad_safe.defjvp
def _sqrt_grad_safe_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(x)
    return y, jnp.where(x > 0, 0.5 / jnp.maximum(y, 1e-20), 0.0) * dx


def _run_masked_loop(cfg_steps: int, early_exit: bool, body, carry):
    """Run ``body(i, carry)`` ``cfg_steps`` times; with ``early_exit`` the loop
    stops once ``carry[-1]`` (the active mask) is all-False."""
    if early_exit:
        def cond(state):
            i, carry = state
            return jnp.logical_and(i < cfg_steps, jnp.any(carry[-1]))

        def wbody(state):
            i, carry = state
            return i + 1, body(i, carry)

        _, carry = lax.while_loop(cond, wbody, (jnp.int32(0), carry))
        return carry
    return lax.fori_loop(0, cfg_steps, body, carry)


def sphere_trace(sdf_fn: SDFFn, origins: jnp.ndarray, directions: jnp.ndarray, cfg: MarchConfig) -> jnp.ndarray:
    """Sphere-trace march; returns the marched distance per ray, shape ``(...,)``.

    Replicates ``raymarch`` (``voxel_fragment.frag:86-103``) exactly: each
    step evaluates the SDF at the current point, **unconditionally adds it to
    the distance**, then terminates the lane when
    ``distance > max_distance or sdf < epsilon``.  Like the reference there is
    no hit/miss flag — misses simply carry a distance beyond ``max_distance``
    (test with :func:`hit_mask`).

    With ``cfg.relaxation > 1`` the march runs Keinert-style over-relaxed
    sphere tracing instead (see :class:`MarchConfig`): same termination
    criteria, fewer steps, final distances within a few ε of the exact march.
    """
    batch = jnp.broadcast_shapes(origins.shape[:-1], directions.shape[:-1])
    dtype = origins.dtype

    if cfg.relaxation != 1.0:
        return _sphere_trace_relaxed(sdf_fn, origins, directions, cfg)

    def body(i, carry):
        dist, active = carry
        p = origins + dist[..., None] * directions
        s = sdf_fn(p)
        dist_new = jnp.where(active, dist + s, dist)
        done = (dist_new > cfg.max_distance) | (s < cfg.epsilon)
        active_new = active & ~done
        return dist_new, active_new

    dist0 = jnp.zeros(batch, dtype)
    active0 = jnp.ones(batch, jnp.bool_)
    dist, _ = _run_masked_loop(cfg.max_steps, cfg.early_exit, body, (dist0, active0))
    return dist


def _sphere_trace_relaxed(sdf_fn: SDFFn, origins: jnp.ndarray, directions: jnp.ndarray, cfg: MarchConfig) -> jnp.ndarray:
    """Over-relaxed sphere trace (Keinert et al. 2014).

    Steps ``ω·s``; when consecutive bounding spheres stop overlapping
    (``|s| + prev_radius < step_len``) the over-relaxed step provably jumped
    a surface, so the lane steps back by ``(ω−1)·step_len`` and continues
    conservatively with ω=1.  A lane lands exactly (``+s``, like the
    reference) on the step that terminates it.  Termination matches the
    reference criteria: ``t > max_distance`` or ``s < ε`` (the latter only on
    non-fallback steps — a fallback's sample point is beyond the validated
    interval).
    """
    batch = jnp.broadcast_shapes(origins.shape[:-1], directions.shape[:-1])
    dtype = origins.dtype
    omega0 = jnp.asarray(cfg.relaxation, dtype)

    def body(i, carry):
        t, prev_r, step_len, om, active = carry
        p = origins + t[..., None] * directions
        s = sdf_fn(p)
        fail = (om > 1.0) & (jnp.abs(s) + prev_r < step_len)
        hit = ~fail & (s < cfg.epsilon)
        new_step = jnp.where(fail, step_len * (1.0 - om), om * s)
        new_step = jnp.where(hit, s, new_step)  # land on the surface like the exact march
        om = jnp.where(fail, 1.0, om)
        t_new = jnp.where(active, t + new_step, t)
        done = hit | (t_new > cfg.max_distance)
        return t_new, jnp.abs(s), jnp.where(active, new_step, step_len), om, active & ~done

    carry0 = (
        jnp.zeros(batch, dtype),
        jnp.zeros(batch, dtype),
        jnp.zeros(batch, dtype),
        jnp.full(batch, omega0.astype(dtype)),
        jnp.ones(batch, jnp.bool_),
    )
    t, _, _, _, _ = _run_masked_loop(cfg.max_steps, cfg.early_exit, body, carry0)
    return t


def hit_mask(distance: jnp.ndarray, cfg: MarchConfig) -> jnp.ndarray:
    """True where the march converged on a surface (did not exceed range)."""
    return distance <= cfg.max_distance


def ray_min_sdf(sdf_fn: SDFFn, origins: jnp.ndarray, directions: jnp.ndarray, cfg: MarchConfig):
    """Minimum SDF along each ray's march trajectory and its distance.

    Returns ``(min_s, t_at_min)``, both shape ``(...,)``: the closest
    approach of the march to any surface and the marched distance where it
    occurred.  Hit rays give min_s ≈ ε (or below); miss rays give a positive
    closest approach.  This is the *silhouette quantity*:
    ``sigmoid(−min_s/β)`` is a smooth coverage that moves with silhouettes.
    Not differentiable itself (early-exit loop) — use
    :func:`sdf3d_tpu.diff.ray_min_sdf_diff` for gradients (custom VJP: the
    min's derivative is ∂f/∂θ at the argmin point, one extra eval).
    """
    batch = jnp.broadcast_shapes(origins.shape[:-1], directions.shape[:-1])
    dtype = origins.dtype

    def body(i, carry):
        dist, min_s, t_min, active = carry
        p = origins + dist[..., None] * directions
        s = sdf_fn(p)
        better = active & (s < min_s)
        min_s = jnp.where(better, s, min_s)
        t_min = jnp.where(better, dist, t_min)
        dist_new = jnp.where(active, dist + s, dist)
        done = (dist_new > cfg.max_distance) | (s < cfg.epsilon)
        return dist_new, min_s, t_min, active & ~done

    carry0 = (
        jnp.zeros(batch, dtype),
        jnp.full(batch, jnp.inf, dtype),
        jnp.zeros(batch, dtype),
        jnp.ones(batch, jnp.bool_),
    )
    _, min_s, t_min, _ = _run_masked_loop(cfg.max_steps, cfg.early_exit, body, carry0)
    return min_s, t_min


def soft_shadow(
    sdf_fn: SDFFn,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    cfg: ShadowConfig,
    march: MarchConfig,
) -> jnp.ndarray:
    """Quilez *improved* soft shadow, replicating ``voxel_fragment.frag:105-132``.

    Per step (``:118-126``): with previous/current SDF samples ``sdf`` /
    ``sdf_new``,

    - ``intersection = sdf_new²/(2·sdf)`` (0 on the first step),
    - ``d_est = sqrt(sdf_new² − intersection²)`` — the estimated closest
      approach of the ray to the surface,
    - ``shadow = min(shadow, k·d_est / max(0, distance − intersection))``,
    - advance ``distance += sdf_new``; lane stops when
      ``distance > max_distance or shadow < epsilon``.

    Deviation from raw GLSL (documented, mirrored by the oracles): the sqrt
    argument is clamped at 0, and the attenuation update is skipped (huge
    value under ``min``) whenever ``distance − intersection ≤ 0``.  GLSL
    divides by ``max(0, ·)`` there (``:122``) producing +inf (harmless under
    ``min``) or 0/0 = NaN — and GPU ``min(x, NaN)`` conventionally returns
    ``x``, i.e. *no darkening*, which is exactly the branch we make explicit.
    This case occurs on every ray marching straight away from a plane
    (``sdf_new = 2·sdf_prev`` ⇒ ``d_est = 0`` and ``denom = 0``).
    Returns the shadow factor clamped to [0, 1] (``:129``).
    """
    batch = jnp.broadcast_shapes(origins.shape[:-1], directions.shape[:-1])
    dtype = origins.dtype
    k = jnp.asarray(cfg.k, dtype)

    def body(i, carry):
        dist, prev_sdf, shadow, active = carry
        p = origins + dist[..., None] * directions
        s = sdf_fn(p)
        intersection = jnp.where(
            i == 0,
            jnp.zeros_like(s),
            s * s / (2.0 * jnp.where(prev_sdf == 0.0, _TINY, prev_sdf)),
        )
        # Cap the degenerate prev≈0 blow-up before squaring: primal-identical
        # (|inter| > 1e15 means d2 < 0 and denom < 0 either way, so the step
        # is discarded by ``valid``), but without the cap ``inter²``
        # overflows to inf and reverse AD produces 0·inf = NaN cotangents.
        inter_c = jnp.clip(intersection, -_INTER_CAP, _INTER_CAP)
        d2 = s * s - inter_c * inter_c
        d_est = _sqrt_grad_safe(jnp.maximum(d2, 0.0))
        denom = dist - inter_c
        # Valid update only when the closest-approach estimate is real
        # (d2 ≥ 0; GLSL's sqrt of a negative gives NaN, and min(x, NaN) keeps
        # x — i.e. no darkening) and the denominator is positive (GLSL's
        # max(0,·) otherwise yields ±inf/NaN, again no darkening under min).
        valid = (denom > 0.0) & (d2 >= 0.0)
        atten = jnp.where(valid, k * d_est / jnp.where(valid, denom, 1.0), _NO_DARKEN)
        shadow_new = jnp.where(active, jnp.minimum(shadow, atten), shadow)
        dist_new = jnp.where(active, dist + s, dist)
        done = (dist_new > march.max_distance) | (shadow_new < march.epsilon)
        active_new = active & ~done
        return dist_new, jnp.where(active, s, prev_sdf), shadow_new, active_new

    carry0 = (
        jnp.zeros(batch, dtype),
        jnp.full(batch, jnp.inf, dtype),
        jnp.ones(batch, dtype),
        jnp.ones(batch, jnp.bool_),
    )
    _, _, shadow, _ = _run_masked_loop(cfg.max_steps, march.early_exit, body, carry0)
    return jnp.clip(shadow, 0.0, 1.0)


def ambient_occlusion(sdf_fn: SDFFn, points: jnp.ndarray, normals: jnp.ndarray, cfg: AOConfig) -> jnp.ndarray:
    """Classic N-tap SDF ambient occlusion (north-star capability; the
    reference has none).

    Samples the field at ``points + i·step·normals`` for ``i = 1..samples``;
    occlusion accumulates ``falloff**(i-1) · (i·step − sdf)`` and the result is
    ``clamp(1 − strength·occ, 0, 1)`` — a fixed-trip, fully vectorized loop
    (unrolled: ``samples`` is small and static).
    """
    occ = jnp.zeros(points.shape[:-1], points.dtype)
    weight = 1.0
    for i in range(1, cfg.samples + 1):
        h = cfg.step * i
        s = sdf_fn(points + h * normals)
        occ = occ + weight * (h - s)
        weight *= cfg.falloff
    return jnp.clip(1.0 - cfg.strength * occ, 0.0, 1.0)


def normal_central(sdf_fn: SDFFn, points: jnp.ndarray, eps: float) -> jnp.ndarray:
    """Central-difference normals — 6 SDF taps at ``±eps`` per axis,
    replicating ``normal`` (``voxel_fragment.frag:134-155``, offsets
    ``DX/DY/DZ`` at ``:21-23``)."""
    offs = jnp.eye(3, dtype=points.dtype) * eps
    comps = [
        sdf_fn(points + offs[a]) - sdf_fn(points - offs[a])
        for a in range(3)
    ]
    return vnormalize(jnp.stack(comps, axis=-1))


def normal_tetrahedron(sdf_fn: SDFFn, points: jnp.ndarray, eps: float) -> jnp.ndarray:
    """Tetrahedron-offset normals — 4 SDF taps (north-star scheme; cheaper
    than central differences and isotropic)."""
    dtype = points.dtype
    k = jnp.array(
        [[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0], [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0]],
        dtype=dtype,
    )
    n = sum(k[i] * sdf_fn(points + eps * k[i])[..., None] for i in range(4))
    return vnormalize(n)


def normal_autodiff(sdf_fn: SDFFn, points: jnp.ndarray) -> jnp.ndarray:
    """Exact SDF gradient normals via ``jax.grad`` — free under autodiff and
    the cleanest choice (no epsilon, 1 forward + 1 reverse sweep).

    Works for any batch shape because the SDF is pointwise: the gradient of
    ``sum(sdf(p))`` w.r.t. ``p`` is the per-point gradient.
    """
    g = jax.grad(lambda q: jnp.sum(sdf_fn(q)))(points)
    return vnormalize(g)


def estimate_normals(sdf_fn: SDFFn, points: jnp.ndarray, mode: str, eps: float) -> jnp.ndarray:
    """Dispatch on the configured normal scheme."""
    if mode == "central":
        return normal_central(sdf_fn, points, eps)
    if mode == "tetrahedron":
        return normal_tetrahedron(sdf_fn, points, eps)
    if mode == "autodiff":
        return normal_autodiff(sdf_fn, points)
    raise ValueError(f"unknown normals mode: {mode!r}")
