"""The fused Pallas render kernel: ray-gen → march → normals → shadow → AO → shade.

One program renders one block of rays with no device-memory traffic
between stages — the fused re-design of the per-fragment program at
``/root/reference/Code/shader/voxel_fragment.frag:160-211`` (and the compute
slot ``Code/kernel/thekernel_1.cl`` the reference left empty).  It is
written for Pallas's Triton route (``backend="triton"``).  Design notes:

- **Grid** = image blocks ``(H/TH, W/TW)``; each program computes ``TH×TW``
  rays (powers of two, as Triton requires).  Rays exist only in registers:
  generated from the program ids (the pixel grid *is* the output index
  space — no fullscreen-quad scaffold, cf. ``voxel_geometry.geom:26-52``).
  Programs are independent and run in any order on the card's SMs.
- **SoA planes**: every per-ray quantity is a ``(TH, TW)`` float32 plane
  (see ops/scene_program.py for why no ``(...,3)`` axis ever appears).
- **Early exit**: the march is a ``while_loop`` over steps whose condition
  ANDs ``step < max_steps`` with ``max(active) > 0.5`` — per-ray breaks
  become an f32 0/1 mask and a whole block stops once all of its rays have
  converged, which is effective because adjacent rays are coherent.
- **Parameters**: scene params and camera/light/material uniforms are flat
  float32 vectors in device memory; each program loads them once as
  scalars — the analogue of the reference's GLSL uniforms
  (``voxel_fragment.frag:5-7``) and of its CL/GL shared parameter buffers
  (``main.cpp:55-62``).

Outputs: r / g / b planes plus aux planes t / shadow / ao ``(H, W)`` — the
aux planes are exactly the residuals the custom VJP needs, so the backward
pass never re-marches (ops/render_pallas.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.ops.scene_program import (
    compile_scene,
    compile_scene_material,
    compile_scene_ray,
    scene_param_vector,
)
from sdf3d_tpu.sdf.node import SDFNode

# Uniform vector layout (indices into the (N_UNIFORMS,) = (30,) vector).
_U_CAM = 0        # camera position (3)
_U_C2W = 3        # camera-to-world rotation, row-major (9)
_U_FZ = 12        # focal z (1)
_U_LIGHT = 13     # light position (3)
_U_AMB = 16       # light ambient intensity (1)
_U_MAT_AMB = 17   # material ambient rgb (3)
_U_MAT_DIF = 20   # material diffuse rgb (3)
_U_MAT_REF = 23   # material specular rgb (3)
_U_SHN = 26       # shininess (1)
_U_K = 27         # shadow sharpness k (1)
_U_ROW0 = 28      # absolute row offset of this shard's slab (1; 0 unsharded)
_U_ROWSTRIDE = 29  # absolute rows between successive tile rows (tile_h
                   # contiguous; n_devices*tile_h for interleaved sharding)
N_UNIFORMS = 30


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class PallasRenderConfig:
    """Static kernel parameters (hashable → jit static arg).

    ``tile_h × tile_w`` rays per program, both powers of two (Triton block
    shapes).  The kernel pads the image up to whole tiles and crops.
    ``num_warps`` goes to ``triton.CompilerParams``.  The
    defaults were chosen by a sweep on an H100 at 1080p (PERF.md): (8, 64)
    with 4 warps gave the fastest fused fit step of the shapes tried, and
    1080p divides into it without padding.

    ``check_every``: march-loop convergence (the block-wide ``max(active)``
    reduction + scalar loop test) is only evaluated every N steps; the N
    inner steps are unrolled straight-line code.  Per-ray semantics are
    unchanged — lanes self-freeze via their mask, and a scalar
    ``step_idx < max_steps`` guard keeps the final partial chunk exact — so
    any value yields reference-parity images.

    ``ray_sdf`` (default True): march SDF evals use the ray-parameterized
    scene program (scene_program.py ray emitters) — per-ray constants are
    hoisted out of the loop (plane = 1 FMA, sphere = 2 FMA + sqrt,
    transforms free).  Algebraically identical to the point program but
    rounds differently by ~1 ulp, so a measure-zero set of razor-edge rays
    may flip one march step.  ``False`` restores point-form evals for
    oracle-parity work.

    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """

    tile_h: int = 8
    tile_w: int = 64
    num_warps: int = 4
    check_every: int = 4
    ray_sdf: bool = True
    interpret: bool = False
    #: Evaluate the primary-march stop predicate (2 compares + or + select)
    #: only every N-th unrolled step.  N > 1 is a declared NON-PARITY knob
    #: for the fast profile: lanes overstep the surface by up to N−1 extra
    #: steps before freezing (each overstep moves the hit point by
    #: ≤ |sdf| < ε after the first crossing, so the image error is
    #: ε-scale; PSNR measured in benchmarks/fast_profile).  Requires
    #: check_every % stop_every == 0.  Parity paths keep 1.
    stop_every: int = 1

    def __post_init__(self):
        if not (_is_pow2(self.tile_h) and _is_pow2(self.tile_w)):
            raise ValueError(
                f"tile ({self.tile_h}, {self.tile_w}) must be powers of two"
            )


def _walk_nodes(node):
    yield node
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, SDFNode):
            yield from _walk_nodes(v)


#: Kernel config for expression-heavy scenes (the Mandelbulb's unrolled
#: distance estimator): smaller blocks and no unrolled march steps keep the
#: fit kernel's AD section within the register file.  Measured on an H100
#: at 1080p (PERF.md): 14.4 ms/step vs 19.3 ms with the default config,
#: and a shorter Triton compile.
HEAVY_SCENE_CONFIG = dict(tile_h=4, tile_w=32, check_every=1)


def default_pallas_config(scene=None, **overrides) -> PallasRenderConfig:
    """A :class:`PallasRenderConfig` with scene-aware defaults: fractal
    scenes get :data:`HEAVY_SCENE_CONFIG`.  Explicit ``overrides`` always
    win."""
    from sdf3d_tpu.sdf.primitives import Mandelbulb

    if scene is not None and any(isinstance(n, Mandelbulb) for n in _walk_nodes(scene)):
        overrides = {**HEAVY_SCENE_CONFIG, **overrides}
    return PallasRenderConfig(**overrides)


def pack_uniforms(camera, light, mat, ray_mode: str = "reference") -> jnp.ndarray:
    """Flatten camera/light/material pytrees into the (N_UNIFORMS,) = (30,)
    uniform vector (layout above; row0/rowstride slots are patched later)."""
    from sdf3d_tpu.camera import focal_z  # local import to avoid cycle

    return jnp.concatenate(
        [
            jnp.ravel(camera.position.astype(jnp.float32)),
            jnp.ravel(camera.c2w.astype(jnp.float32)),
            jnp.ravel(focal_z(camera.fov_deg, ray_mode)[None].astype(jnp.float32)),
            jnp.ravel(light.position.astype(jnp.float32)),
            jnp.ravel(jnp.asarray(light.ambient, jnp.float32)[None]),
            jnp.ravel(mat.ambient.astype(jnp.float32)),
            jnp.ravel(mat.diffuse.astype(jnp.float32)),
            jnp.ravel(mat.specular.astype(jnp.float32)),
            jnp.ravel(jnp.asarray(mat.shininess, jnp.float32)[None]),
            jnp.ravel(jnp.asarray(0.0, jnp.float32)[None]),  # shadow k, patched below
            jnp.ravel(jnp.asarray(0.0, jnp.float32)[None]),  # row0, patched when sharded
            jnp.ravel(jnp.asarray(0.0, jnp.float32)[None]),  # row stride, patched per-kernel
        ]
    )


def _rsqrt(x):
    return jax.lax.rsqrt(x)


def _tile_pixel_planes(uni, TH, TW, axis_off: int = 0):
    """Absolute (rows, cols) pixel-index planes for the current grid tile.

    row0/rowstride map the tile to absolute image rows: contiguous slabs
    use stride == TH; interleaved row-block sharding strides tiles by
    n_devices*TH so each device sees a representative row mix.
    ``axis_off`` shifts the tile axes in the program grid (the multi-view
    fit kernel prepends a view axis: grid = (V, rows, cols))."""
    f32 = jnp.float32
    i = pl.program_id(axis_off)
    j = pl.program_id(axis_off + 1)
    rows = uni[_U_ROW0] + i.astype(f32) * uni[_U_ROWSTRIDE] + jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 0).astype(f32)
    cols = (j * TW + jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 1)).astype(f32)
    return rows, cols


def _tile_rays(uni, rows, cols, cfg, TH, TW):
    """Ray generation for one tile: returns origin scalars and direction
    planes.  NDC uses the *logical* W/H (padded tiles produce off-screen rays
    cropped by the caller); camera-frame ray normalized, rotated to world by
    c2w, re-normalized (parity with voxel_fragment.frag:191-192)."""
    f32 = jnp.float32
    H = cfg.ndc_height or cfg.height
    W = cfg.ndc_width or cfg.width
    qx = (2.0 * (cols + 0.5) / f32(W)) - 1.0
    qy = 1.0 - (2.0 * (rows + 0.5) / f32(H))
    ar = f32(W / H)

    vx = qx * ar
    vy = qy
    vz = jnp.full((TH, TW), uni[_U_FZ], f32)
    inv = _rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    m = [uni[_U_C2W + k] for k in range(9)]
    dx = m[0] * vx + m[1] * vy + m[2] * vz
    dy = m[3] * vx + m[4] * vy + m[5] * vz
    dz = m[6] * vx + m[7] * vy + m[8] * vz
    inv2 = _rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv2, dy * inv2, dz * inv2

    ox, oy, oz = uni[_U_CAM], uni[_U_CAM + 1], uni[_U_CAM + 2]
    return (ox, oy, oz), (dx, dy, dz)


def _march_primary(ev_primary, mc, chk, TH, TW, track_min: bool = False, stop_every: int = 1):
    """Primary sphere-trace march (voxel_fragment.frag:86-103 semantics).

    Lane masks are carried as f32 0/1 planes (``dist += active * s`` is one
    FMA), and the loop condition reduces the mask with max() so only a
    *scalar* boolean decides whether the block keeps stepping.

    ``track_min=True`` additionally carries the ray's minimum SDF value and
    the marched distance where it occurred (``march.ray_min_sdf`` semantics
    — the silhouette quantity for the fused coverage loss,
    ops/fit_kernel.py); returns ``(t, min_s, t_min)``.  Requires the
    reference march (``relaxation == 1.0``), matching the XLA silhouette
    path which always marches unrelaxed.
    """
    f32 = jnp.float32
    if track_min and mc.relaxation != 1.0:
        raise ValueError("min-SDF tracking requires march.relaxation == 1.0")

    def march_cond(state):
        step, _, active = state
        return jnp.logical_and(step < mc.max_steps, jnp.max(active) > 0.5)

    def min_cond(state):
        step, _, _, _, active = state
        return jnp.logical_and(step < mc.max_steps, jnp.max(active) > 0.5)

    def min_body(state):
        # march_body plus the min tracker: min/argmin updates gated by the
        # same effective-active mask (ray_min_sdf semantics: s is evaluated
        # at the pre-update distance, winners must be active lanes).
        step, dist, min_s, t_min, active = state
        for i in range(chk):
            s = ev_primary(dist)
            eff = active
            if mc.max_steps % chk != 0:
                eff = active * jnp.where(step + i < mc.max_steps, 1.0, 0.0)
            better = (eff > 0.5) & (s < min_s)
            min_s = jnp.where(better, s, min_s)
            t_min = jnp.where(better, dist, t_min)
            dist = dist + eff * s
            stop = (dist > mc.max_distance) | (s < mc.epsilon)
            if mc.max_steps % chk != 0:
                active = jnp.where(stop, active - eff, active)
            else:
                active = jnp.where(stop, 0.0, active)
        return step + chk, dist, min_s, t_min, active

    def relaxed_cond(state):
        step, _, _, _, _, active = state
        return jnp.logical_and(step < mc.max_steps, jnp.max(active) > 0.5)

    def relaxed_body(state):
        # Keinert over-relaxed sphere tracing (march.py::_sphere_trace_relaxed
        # semantics, f32 lane masks/ω).
        step, t, prev_r, step_len, om, active = state
        for i in range(chk):
            s = ev_primary(t)
            fail = (om > 1.0) & (jnp.abs(s) + prev_r < step_len)
            hit = ~fail & (s < mc.epsilon)
            new_step = jnp.where(fail, step_len * (1.0 - om), om * s)
            new_step = jnp.where(hit, s, new_step)
            om = jnp.where(fail, 1.0, om)
            take = active > 0.5
            if mc.max_steps % chk != 0:
                take = take & (step + i < mc.max_steps)
            t = jnp.where(take, t + new_step, t)
            prev_r = jnp.where(take, jnp.abs(s), prev_r)
            step_len = jnp.where(take, new_step, step_len)
            active = jnp.where(take & (hit | (t > mc.max_distance)), 0.0, active)
        return step + chk, t, prev_r, step_len, om, active

    def march_body(state):
        # ``chk`` unrolled steps per convergence check: the cross-lane
        # max(active) reduction and scalar loop test are amortized over a
        # straight-line vector block.  Lanes self-freeze *arithmetically*:
        # ``dist += active * s`` is one FMA (frozen lanes add 0, and stay
        # NaN/inf-safe because their position no longer moves), and the stop
        # predicate clears ``active`` directly — where(stop, 0, active)
        # keeps already-frozen lanes at 0 without a ``take`` pre-mask.  The
        # scalar step guard is only needed when the chunk can straddle
        # max_steps (chk ∤ max_steps).
        step, dist, active = state
        for i in range(chk):
            s = ev_primary(dist)
            eff = active
            if mc.max_steps % chk != 0:
                eff = active * jnp.where(step + i < mc.max_steps, 1.0, 0.0)
            dist = dist + eff * s
            if (i + 1) % stop_every != 0:
                # Fast-profile stop-thinning (pc.stop_every > 1): skip the
                # predicate on this unrolled step — lanes overstep and
                # freeze at the next evaluated predicate.
                continue
            stop = (dist > mc.max_distance) | (s < mc.epsilon)
            if mc.max_steps % chk != 0:
                # Guarded-off steps must not freeze on a stale predicate.
                active = jnp.where(stop, active - eff, active)
            else:
                active = jnp.where(stop, 0.0, active)
        return step + chk, dist, active

    if track_min:
        _, t, min_s, t_min, _ = jax.lax.while_loop(
            min_cond,
            min_body,
            (
                jnp.int32(0),
                jnp.zeros((TH, TW), f32),
                jnp.full((TH, TW), jnp.inf, f32),
                jnp.zeros((TH, TW), f32),
                jnp.ones((TH, TW), f32),
            ),
        )
        return t, min_s, t_min
    if mc.relaxation != 1.0:
        _, t, _, _, _, _ = jax.lax.while_loop(
            relaxed_cond,
            relaxed_body,
            (
                jnp.int32(0),
                jnp.zeros((TH, TW), f32),
                jnp.zeros((TH, TW), f32),
                jnp.zeros((TH, TW), f32),
                jnp.full((TH, TW), f32(mc.relaxation)),
                jnp.ones((TH, TW), f32),
            ),
        )
    else:
        _, t, _ = jax.lax.while_loop(
            march_cond,
            march_body,
            (jnp.int32(0), jnp.zeros((TH, TW), f32), jnp.ones((TH, TW), f32)),
        )
    return t


def _tile_normals(sdf, hx, hy, hz, cfg):
    """Normalized surface normal at the hit point (central or tetrahedron)."""
    e = jnp.float32(cfg.march.epsilon)
    if cfg.normals == "central":
        nx = sdf(hx + e, hy, hz) - sdf(hx - e, hy, hz)
        ny = sdf(hx, hy + e, hz) - sdf(hx, hy - e, hz)
        nz = sdf(hx, hy, hz + e) - sdf(hx, hy, hz - e)
    elif cfg.normals == "tetrahedron":
        # 4 taps at (1,-1,-1),(-1,-1,1),(-1,1,-1),(1,1,1)·e.
        s0 = sdf(hx + e, hy - e, hz - e)
        s1 = sdf(hx - e, hy - e, hz + e)
        s2 = sdf(hx - e, hy + e, hz - e)
        s3 = sdf(hx + e, hy + e, hz + e)
        nx = s0 - s1 - s2 + s3
        ny = -s0 - s1 + s2 + s3
        nz = -s0 + s1 - s2 + s3
    else:  # pragma: no cover - validated by RenderConfig
        raise ValueError(f"pallas path supports central/tetrahedron normals, not {cfg.normals!r}")
    ninv = _rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-24))
    return nx * ninv, ny * ninv, nz * ninv


def _march_shadow(ev_shadow, uni, cfg, chk, ndoti, TH, TW):
    """Soft shadow march (voxel_fragment.frag:105-132 semantics).

    ndoti gates the march: the shadow factor only ever multiplies
    ``clamp(dot(N,I),0,1)`` (frag:205), so lanes with dot(N,I) <= 0 (sky
    shaded at the far point, back-facing surfaces) produce *identical*
    images whether marched or not — those lanes start inactive, and
    whole-sky tiles skip the march at the first convergence check.  Their
    shadow plane reads 1.0 (the factor is undefined-by-unused there).
    """
    f32 = jnp.float32
    mc = cfg.march
    k = uni[_U_K]

    def sh_cond(state):
        step, _, _, _, active = state
        return jnp.logical_and(step < cfg.shadow.max_steps, jnp.max(active) > 0.5)

    k2 = k * k
    eps2 = mc.epsilon * mc.epsilon

    def sh_body(state):
        # Runs in the *squared*-attenuation domain: tracking
        # sh² = min(sh², k²·d²/denom²) is order-identical to the
        # reference's sh = min(sh, k·√d²/denom) (min commutes with the
        # monotonic sqrt; one sqrt at loop exit replaces one per step).
        # The per-ray early-out ``sh < ε`` becomes ``sh² < ε²`` exactly.
        # First-step semantics (reference: intersection = 0) fall out of
        # the prev = +inf init: s²/(2·inf) == 0.
        step, dist, prev, sh2, active = state
        for i in range(chk):
            s = ev_shadow(dist)
            s2 = s * s
            inter = s2 / (2.0 * jnp.where(prev == 0.0, 1e-30, prev))
            d2 = s2 - inter * inter
            denom = dist - inter
            valid = (denom > 0.0) & (d2 >= 0.0)
            att2 = jnp.where(valid, k2 * jnp.maximum(d2, 0.0) / (denom * denom), 1e30)
            take = active > 0.5
            if cfg.shadow.max_steps % chk != 0:
                take = take & (step + i < cfg.shadow.max_steps)
                eff = jnp.where(take, active, 0.0)
            else:
                eff = active
            sh2 = jnp.where(take, jnp.minimum(sh2, att2), sh2)
            dist = dist + eff * s
            prev = jnp.where(take, s, prev)
            active = jnp.where((dist > mc.max_distance) | (sh2 < eps2), 0.0, active)
        return step + chk, dist, prev, sh2, active

    _, _, _, shadow2, _ = jax.lax.while_loop(
        sh_cond,
        sh_body,
        (
            jnp.int32(0),
            jnp.zeros((TH, TW), f32),
            jnp.full((TH, TW), jnp.inf, f32),
            jnp.ones((TH, TW), f32),
            jnp.where(ndoti > 0.0, 1.0, 0.0).astype(f32),
        ),
    )
    return jnp.sqrt(jnp.clip(shadow2, 0.0, 1.0))


def _tile_ao(sdf, hx, hy, hz, nx, ny, nz, cfg, TH, TW):
    """Ambient-occlusion factor (optional; north-star capability)."""
    occ = jnp.zeros((TH, TW), jnp.float32)
    weight = 1.0
    for tap in range(1, cfg.ao.samples + 1):
        h = cfg.ao.step * tap
        sa = sdf(hx + h * nx, hy + h * ny, hz + h * nz)
        occ = occ + weight * (h - sa)
        weight *= cfg.ao.falloff
    return jnp.clip(1.0 - cfg.ao.strength * occ, 0.0, 1.0)


def _tile_primal(uni, getp, sdf, soa_ray, rows, cols, cfg, pc, track_min: bool = False):
    """The full primal pipeline for one tile: rays → march → normals →
    shadow → AO.  Shared by the forward kernel and the fused fit kernel
    (ops/fit_kernel.py).  Returns (origin, direction, t, normals, incident,
    shadow, ao) — everything the shading stage consumes — plus
    ``(min_s, t_min)`` appended when ``track_min`` (the silhouette planes
    for the fused coverage loss)."""
    TH, TW = pc.tile_h, pc.tile_w
    f32 = jnp.float32
    mc = cfg.march
    chk = max(1, pc.check_every)

    (ox, oy, oz), (dx, dy, dz) = _tile_rays(uni, rows, cols, cfg, TH, TW)

    # Ray-parameterized scene program (pc.ray_sdf): per-ray constants are
    # hoisted out of the loop and each step evaluates distance directly
    # from t (scene_program.py ray emitters — plane = 1 FMA, sphere = 2 FMA
    # + sqrt, no per-step position math).  Point form is the bit-exact
    # fallback.
    if pc.ray_sdf:
        ev_primary = soa_ray((ox, oy, oz), (dx, dy, dz), getp)
    else:
        def ev_primary(t):
            return sdf(ox + t * dx, oy + t * dy, oz + t * dz)

    stop_every = max(1, pc.stop_every)
    if stop_every > 1:
        if chk % stop_every != 0:
            raise ValueError(
                f"stop_every ({stop_every}) must divide check_every ({chk})"
            )
        if mc.relaxation != 1.0:
            # The relaxed body has its own fail/hit bookkeeping per step;
            # silently ignoring the knob would let users attribute its
            # documented PSNR cost to images that never ran thinned.
            raise ValueError(
                "stop_every > 1 applies to the plain march only "
                "(march.relaxation == 1.0)"
            )
        if track_min:
            raise ValueError(
                "stop_every > 1 is incompatible with the silhouette "
                "min-SDF tracker (per-step predicate gating)"
            )
    min_planes = ()
    if track_min:
        # The min-SDF tracker needs the per-step predicate (argmin gating);
        # stop-thinning applies only to the plain parity-shape march.
        t, min_s, t_min = _march_primary(ev_primary, mc, chk, TH, TW, track_min=True)
        min_planes = (min_s, t_min)
    else:
        t = _march_primary(ev_primary, mc, chk, TH, TW, stop_every=stop_every)

    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    nx, ny, nz = _tile_normals(sdf, hx, hy, hz, cfg)

    # ---- incident light direction ----
    lx, ly, lz = uni[_U_LIGHT], uni[_U_LIGHT + 1], uni[_U_LIGHT + 2]
    ix, iy, iz = lx - hx, ly - hy, lz - hz
    iinv = _rsqrt(jnp.maximum(ix * ix + iy * iy + iz * iz, 1e-24))
    ix, iy, iz = ix * iinv, iy * iinv, iz * iinv

    ndoti = nx * ix + ny * iy + nz * iz
    if cfg.shadow.enabled:
        e = f32(mc.epsilon)
        sox, soy, soz = hx + 2.0 * e * nx, hy + 2.0 * e * ny, hz + 2.0 * e * nz
        if pc.ray_sdf:
            ev_shadow = soa_ray((sox, soy, soz), (ix, iy, iz), getp)
        else:
            def ev_shadow(ts):
                return sdf(sox + ts * ix, soy + ts * iy, soz + ts * iz)

        shadow = _march_shadow(ev_shadow, uni, cfg, chk, ndoti, TH, TW)
    else:
        shadow = jnp.ones((TH, TW), f32)

    if cfg.ao.enabled:
        ao = _tile_ao(sdf, hx, hy, hz, nx, ny, nz, cfg, TH, TW)
    else:
        ao = jnp.ones((TH, TW), f32)

    return ((ox, oy, oz), (dx, dy, dz), t, (nx, ny, nz), (ix, iy, iz), shadow, ao) + min_planes


def _forward_tile_tail(uni, getp, sdf, soa_ray, mat_soa, rows, cols, cfg, pc):
    """The forward pipeline for one tile given its absolute pixel planes:
    rays → march → normals → shadow → AO → shade.  Returns
    ``(r, g, b, t, shadow, ao)`` planes."""
    f32 = jnp.float32
    mc = cfg.march
    (ox, oy, oz), (dx, dy, dz), t, (nx, ny, nz), (ix, iy, iz), shadow, ao = _tile_primal(
        uni, getp, sdf, soa_ray, rows, cols, cfg, pc
    )
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    ndoti = nx * ix + ny * iy + nz * iz

    # ---- shading (voxel_fragment.frag:199-210) ----
    wx, wy, wz = ox - hx, oy - hy, oz - hz
    winv = _rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-24))
    wx, wy, wz = wx * winv, wy * winv, wz * winv
    hwx, hwy, hwz = ix + wx, iy + wy, iz + wz
    hwinv = _rsqrt(jnp.maximum(hwx * hwx + hwy * hwy + hwz * hwz, 1e-24))
    hwx, hwy, hwz = hwx * hwinv, hwy * hwinv, hwz * hwinv

    ndoth = jnp.maximum(nx * hwx + ny * hwy + nz * hwz, 0.0)
    dif = jnp.clip(ndoti, 0.0, 1.0) * shadow

    # Material channels: 10 uniform scalars normally; with Shaded tags in the
    # scene the material program resolves per-lane channels at the hit point
    # (one extra scene traversal of selects/FMAs — ops/scene_program.py).
    mch = (
        uni[_U_MAT_AMB], uni[_U_MAT_AMB + 1], uni[_U_MAT_AMB + 2],
        uni[_U_MAT_DIF], uni[_U_MAT_DIF + 1], uni[_U_MAT_DIF + 2],
        uni[_U_MAT_REF], uni[_U_MAT_REF + 1], uni[_U_MAT_REF + 2],
        uni[_U_SHN],
    )
    if mat_soa is not None:
        _, mch = mat_soa(hx, hy, hz, getp, mch)
    spec = jnp.power(ndoth, mch[9])

    amb_scale = uni[_U_AMB] * ao if cfg.ao.enabled else uni[_U_AMB]
    if cfg.shading == "blinn_phong":
        r = amb_scale * mch[0] + dif * mch[3] + spec * mch[6]
        g = amb_scale * mch[1] + dif * mch[4] + spec * mch[7]
        b = amb_scale * mch[2] + dif * mch[5] + spec * mch[8]
    elif cfg.shading == "lambert":
        r = amb_scale * mch[0] + dif * mch[3]
        g = amb_scale * mch[1] + dif * mch[4]
        b = amb_scale * mch[2] + dif * mch[5]
    else:  # pragma: no cover
        raise ValueError(f"unknown shading mode {cfg.shading!r}")

    if cfg.background is not None:
        miss = t > mc.max_distance
        bg = cfg.background
        r = jnp.where(miss, f32(bg[0]), r)
        g = jnp.where(miss, f32(bg[1]), g)
        b = jnp.where(miss, f32(bg[2]), b)
    return r, g, b, t, shadow, ao


def _hoist_params(prm, n_params):
    prm_vals = [prm[k] for k in range(n_params)]

    def getp(k):
        return prm_vals[k]

    return getp


def _render_tile_kernel(uni, prm, r_ref, g_ref, b_ref, t_ref, sh_ref, ao_ref, *, soa, soa_ray, mat_soa, n_params, cfg: RenderConfig, pc: PallasRenderConfig):
    """Kernel body. ``soa(px,py,pz,getp)`` is the compiled scene program."""
    TH, TW = pc.tile_h, pc.tile_w

    # Load every parameter and uniform once, in the kernel preamble: the
    # scene program evaluates ``getp`` inside the march loops (100s of
    # times), and loop-invariant scalars then live in registers.
    getp = _hoist_params(prm, n_params)
    uni = tuple(uni[k] for k in range(N_UNIFORMS))

    def sdf(px, py, pz):
        return soa(px, py, pz, getp)

    rows, cols = _tile_pixel_planes(uni, TH, TW)
    r, g, b, t, shadow, ao = _forward_tile_tail(
        uni, getp, sdf, soa_ray, mat_soa, rows, cols, cfg, pc
    )
    r_ref[...] = r
    g_ref[...] = g
    b_ref[...] = b
    t_ref[...] = t
    sh_ref[...] = shadow
    ao_ref[...] = ao


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compiler_params(pc: PallasRenderConfig):
    """The Triton compiler parameters every kernel of this package uses (one
    pipeline stage: the kernels issue no loads inside their loops)."""
    return pltriton.CompilerParams(num_warps=pc.num_warps, num_stages=1)


@functools.partial(jax.jit, static_argnames=("scene_treedef", "leaf_shapes", "cfg", "pc"))
def _render_kernel_call(scene_treedef, leaf_shapes, params, uniforms, cfg: RenderConfig, pc: PallasRenderConfig):
    """jit-compiled pallas_call wrapper keyed on the static scene structure.

    The scene is rebuilt from (treedef, leaf_shapes) with dummy leaves — the
    emitted program depends only on node types and leaf shapes; values are
    read from the ``params`` vector at run time, so parameter updates never
    recompile.  Returns planar rgb ``(3, H, W)`` and t / shadow / ao.
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

    # Row stride between successive tile rows: TH for contiguous layouts
    # (the default — pack_uniforms leaves the slot 0); interleaved row-block
    # sharding pre-sets it to n_devices*TH (parallel/shard_render.py).
    stride = jnp.where(
        uniforms[_U_ROWSTRIDE] > 0.0, uniforms[_U_ROWSTRIDE], jnp.float32(TH)
    )
    uniforms = uniforms.at[_U_ROWSTRIDE].set(stride)

    kernel = functools.partial(
        _render_tile_kernel, soa=soa, soa_ray=soa_ray, mat_soa=mat_soa,
        n_params=int(params.shape[0]), cfg=cfg, pc=pc,
    )
    plane = pl.BlockSpec((TH, TW), lambda i, j: (i, j))
    r, g, b, t, sh, ao = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[pl.no_block_spec, pl.no_block_spec],
        out_specs=[plane] * 6,
        out_shape=[jax.ShapeDtypeStruct((Hp, Wp), jnp.float32)] * 6,
        backend="triton",
        compiler_params=compiler_params(pc),
        interpret=pc.interpret,
        name="sdf3d_render",
    )(uniforms, params)

    # Planar (3, H, W) — AoS consumers transpose in render_kernel_forward
    # (keeping the VJP boundary planar, see
    # ops/render_pallas.py::render_pallas_planar).
    rgb = jnp.stack([r[:H, :W], g[:H, :W], b[:H, :W]])
    return rgb, t[:H, :W], sh[:H, :W], ao[:H, :W]


@functools.partial(jax.jit, static_argnames=("scene_treedef", "leaf_shapes", "cfg", "pc"))
def _render_kernel_entry(scene_treedef, leaf_shapes, leaves, camera, light, mat, cfg, pc):
    """Single-jit entry: parameter/uniform packing traces into the same
    program as the pallas_call instead of ~10 tiny eager dispatches per
    frame."""
    scene = jax.tree_util.tree_unflatten(scene_treedef, leaves)
    params = scene_param_vector(scene)
    uniforms = pack_uniforms(camera, light, mat, cfg.ray_mode)
    uniforms = uniforms.at[_U_K].set(jnp.asarray(cfg.shadow.k, jnp.float32))
    return _render_kernel_call(scene_treedef, leaf_shapes, params, uniforms, cfg, pc)


def render_kernel_forward(
    scene: SDFNode,
    camera,
    light,
    mat,
    cfg: RenderConfig,
    pc: PallasRenderConfig = PallasRenderConfig(),
    planar: bool = False,
):
    """Fused forward render. Returns ``(rgb, t, shadow, ao)`` with rgb
    ``(H, W, 3)``, or the planar ``(3, H, W)`` when ``planar=True``.

    The kernel is recompiled per (scene structure, cfg, pc); scene/camera/
    light/material *values* are runtime inputs — no recompilation when
    parameters change (the inverse-rendering hot path).
    """
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    leaf_shapes = tuple(jnp.shape(l) for l in leaves)
    rgb, t, sh, ao = _render_kernel_entry(treedef, leaf_shapes, tuple(leaves), camera, light, mat, cfg, pc)
    if not planar:
        rgb = jnp.transpose(rgb, (1, 2, 0))
    return rgb, t, sh, ao
