"""Scene compiler: SDF pytree → structure-of-arrays kernel program.

The reference compiles its scene by handing GLSL text to the driver
(``sceneSDF`` at ``/root/reference/Code/shader/voxel_fragment.frag:73-81``,
built at ``main.cpp:74-77``).  The equivalent here is staged tracing:
:func:`compile_scene` walks the scene pytree **once at trace time** and emits
a closed function

    ``dist = emit(px, py, pz, getp)``

over *component planes* ``px, py, pz`` (each an ``(TH, TW)`` tile) and a
scalar-parameter accessor ``getp(i)`` (a scalar loaded once per kernel
program, a vector index outside).  Two properties make this the right shape
for a fused kernel:

- **SoA layout**: no ``(..., 3)`` trailing axis anywhere — a 3-vector as a
  last dim is not a power of two and would split every op into strided
  lanes.  Every intermediate is a full ``(TH, TW)`` plane.
- **Scalar parameters**: shape parameters are read through ``getp`` as true
  scalars, so the emitted program is one fused elementwise expression
  per tile with zero parameter-broadcast traffic.

Parameter order matches ``jax.tree_util.tree_flatten(scene)`` exactly (struct
dataclasses flatten in field order; each handler consumes its params in field
order), so :func:`scene_param_vector` round-trips with ``ravel_pytree`` and
kernel gradients line up with the pytree structure.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from sdf3d_tpu.sdf import csg, materials, primitives, transforms
from sdf3d_tpu.sdf.node import SDFNode

# getp(i) -> scalar parameter i;  emit(px,py,pz,getp) -> distance plane.
GetP = Callable[[int], jnp.ndarray]


def scene_param_vector(scene: SDFNode) -> jnp.ndarray:
    """Flatten every numeric leaf of the scene into one (P,) float32 vector
    (tree_flatten order — the order :func:`compile_scene` consumes)."""
    leaves = jax.tree_util.tree_leaves(scene)
    return jnp.concatenate([jnp.ravel(jnp.asarray(l, jnp.float32)) for l in leaves]) if leaves else jnp.zeros((0,), jnp.float32)


def unflatten_scene_params(scene: SDFNode, vec: jnp.ndarray) -> SDFNode:
    """Rebuild a scene pytree (same structure as ``scene``) from a flat vector."""
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    out, i = [], 0
    for l in leaves:
        n = int(np.prod(np.shape(l))) if np.ndim(l) else 1
        out.append(jnp.reshape(vec[i : i + n], np.shape(l)))
        i += n
    return jax.tree_util.tree_unflatten(treedef, out)


def count_params(node: SDFNode) -> int:
    """Number of scalar parameters in a subtree."""
    return sum(int(np.prod(np.shape(l)) or 1) for l in jax.tree_util.tree_leaves(node))


# ---------------------------------------------------------------------------
# SoA math helpers (all on (TH, TW) planes / scalars)
# ---------------------------------------------------------------------------


def _len3(x, y, z):
    return jnp.sqrt(x * x + y * y + z * z)


def _len2(x, y):
    return jnp.sqrt(x * x + y * y)


def _nearest(x):
    """Nearest integer as floor(x + 0.5): Triton has no round primitive.
    Differs from ``jnp.round`` (half to even) only at exact .5 ties, where
    a repetition fold is symmetric anyway."""
    return jnp.floor(x + 0.5)


def _smooth_mix(da, db, k, sign):
    """Quilez polynomial smooth min/max — scalar k, plane distances
    (mirrors sdf/csg.py::_smooth_mix)."""
    k = jnp.maximum(k, 1e-6)
    h = jnp.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
    return db + (da - db) * h - sign * k * h * (1.0 - h)


# ---------------------------------------------------------------------------
# Emit handlers: node type -> (px,py,pz,getp,offset) -> distance plane.
# Each consumes parameters at consecutive indices in dataclass-field order.
# ---------------------------------------------------------------------------


def _emit(node, px, py, pz, getp: GetP, off: int):
    t = type(node)
    h = _HANDLERS.get(t)
    if h is None:
        raise TypeError(
            f"no Pallas emitter for scene node {t.__name__}; register one in "
            "sdf3d_tpu/ops/scene_program.py"
        )
    return h(node, px, py, pz, getp, off)


def _sphere(n, px, py, pz, getp, off):
    cx, cy, cz, r = getp(off), getp(off + 1), getp(off + 2), getp(off + 3)
    return _len3(px - cx, py - cy, pz - cz) - r


def _plane(n, px, py, pz, getp, off):
    nx, ny, nz, d = getp(off), getp(off + 1), getp(off + 2), getp(off + 3)
    return px * nx + py * ny + pz * nz - d


def _box_core(px, py, pz, cx, cy, cz, hx, hy, hz):
    qx = jnp.abs(px - cx) - hx
    qy = jnp.abs(py - cy) - hy
    qz = jnp.abs(pz - cz) - hz
    ox = jnp.maximum(qx, 0.0)
    oy = jnp.maximum(qy, 0.0)
    oz = jnp.maximum(qz, 0.0)
    outside = _len3(ox, oy, oz)
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    return outside + inside


def _box(n, px, py, pz, getp, off):
    return _box_core(px, py, pz, *(getp(off + i) for i in range(6)))


def _round_box(n, px, py, pz, getp, off):
    return _box_core(px, py, pz, *(getp(off + i) for i in range(6))) - getp(off + 6)


def _torus(n, px, py, pz, getp, off):
    cx, cy, cz, major, minor = (getp(off + i) for i in range(5))
    ring = _len2(px - cx, pz - cz) - major
    return _len2(ring, py - cy) - minor


def _capsule(n, px, py, pz, getp, off):
    ax, ay, az, bx, by, bz, r = (getp(off + i) for i in range(7))
    pax, pay, paz = px - ax, py - ay, pz - az
    bax, bay, baz = bx - ax, by - ay, bz - az
    denom = jnp.maximum(bax * bax + bay * bay + baz * baz, 1e-12)
    h = jnp.clip((pax * bax + pay * bay + paz * baz) / denom, 0.0, 1.0)
    return _len3(pax - bax * h, pay - bay * h, paz - baz * h) - r


def _cylinder(n, px, py, pz, getp, off):
    cx, cy, cz, r, hh = (getp(off + i) for i in range(5))
    radial = _len2(px - cx, pz - cz) - r
    axial = jnp.abs(py - cy) - hh
    outside = _len2(jnp.maximum(radial, 0.0), jnp.maximum(axial, 0.0))
    inside = jnp.minimum(jnp.maximum(radial, axial), 0.0)
    return outside + inside


def _ellipsoid(n, px, py, pz, getp, off):
    cx, cy, cz, rx, ry, rz = (getp(off + i) for i in range(6))
    qx, qy, qz = px - cx, py - cy, pz - cz
    k0 = _len3(qx / rx, qy / ry, qz / rz)
    k1 = _len3(qx / (rx * rx), qy / (ry * ry), qz / (rz * rz))
    return k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-12)


def _mandelbulb(n, px, py, pz, getp, off):
    from sdf3d_tpu.sdf.primitives import _mandelbulb_de

    cx, cy, cz, sc = (getp(off + i) for i in range(4))
    inv = 1.0 / sc
    d = _mandelbulb_de((px - cx) * inv, (py - cy) * inv, (pz - cz) * inv, n.iterations)
    return d * sc


def _binary(op):
    def h(n, px, py, pz, getp, off):
        da = _emit(n.a, px, py, pz, getp, off)
        db = _emit(n.b, px, py, pz, getp, off + count_params(n.a))
        return op(da, db)

    return h


def _smooth(sign, neg_b=False):
    def h(n, px, py, pz, getp, off):
        na = count_params(n.a)
        nb = count_params(n.b)
        da = _emit(n.a, px, py, pz, getp, off)
        db = _emit(n.b, px, py, pz, getp, off + na)
        if neg_b:
            db = -db
        k = getp(off + na + nb)
        return _smooth_mix(da, db, k, sign)

    return h


def _translate(n, px, py, pz, getp, off):
    nc = count_params(n.child)
    ox, oy, oz = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
    return _emit(n.child, px - ox, py - oy, pz - oz, getp, off)


def _rodrigues_scalars(wx, wy, wz):
    """Rodrigues rotation matrix entries on scalars (series-safe near 0,
    matching transforms.py); returns the 9 entries of R row-major."""
    t2 = wx * wx + wy * wy + wz * wz
    small = t2 < 1e-8
    safe2 = jnp.where(small, 1.0, t2)
    theta = jnp.sqrt(safe2)
    sinc = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(theta) / theta)
    cosc = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(theta)) / safe2)
    # R = I + sinc*K + cosc*K².
    r00 = 1.0 + cosc * (-(wy * wy + wz * wz))
    r01 = -sinc * wz + cosc * (wx * wy)
    r02 = sinc * wy + cosc * (wx * wz)
    r10 = sinc * wz + cosc * (wx * wy)
    r11 = 1.0 + cosc * (-(wx * wx + wz * wz))
    r12 = -sinc * wx + cosc * (wy * wz)
    r20 = -sinc * wy + cosc * (wx * wz)
    r21 = sinc * wx + cosc * (wy * wz)
    r22 = 1.0 + cosc * (-(wx * wx + wy * wy))
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def _rotate_query(px, py, pz, r):
    """Apply R⁻¹ = Rᵀ to the query point (row i of Rᵀ is column i of R)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    qx = r00 * px + r10 * py + r20 * pz
    qy = r01 * px + r11 * py + r21 * pz
    qz = r02 * px + r12 * py + r22 * pz
    return qx, qy, qz


def _rotate(n, px, py, pz, getp, off):
    nc = count_params(n.child)
    wx, wy, wz = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
    qx, qy, qz = _rotate_query(px, py, pz, _rodrigues_scalars(wx, wy, wz))
    return _emit(n.child, qx, qy, qz, getp, off)


def _scale(n, px, py, pz, getp, off):
    nc = count_params(n.child)
    s = jnp.maximum(getp(off + nc), 1e-12)
    return _emit(n.child, px / s, py / s, pz / s, getp, off) * s


def _round(n, px, py, pz, getp, off):
    nc = count_params(n.child)
    return _emit(n.child, px, py, pz, getp, off) - getp(off + nc)


def _onion(n, px, py, pz, getp, off):
    nc = count_params(n.child)
    return jnp.abs(_emit(n.child, px, py, pz, getp, off)) - getp(off + nc)


def _elongate(n, px, py, pz, getp, off):
    nc = count_params(n.child)
    ax, ay, az = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
    qx = px - jnp.clip(px, -ax, ax)
    qy = py - jnp.clip(py, -ay, ay)
    qz = pz - jnp.clip(pz, -az, az)
    return _emit(n.child, qx, qy, qz, getp, off)


def _repeat(n, px, py, pz, getp, off):
    nc = count_params(n.child)

    def fold(p, period):
        safe = jnp.where(period > 0.0, period, 1.0)
        return jnp.where(period > 0.0, p - period * _nearest(p / safe), p)

    qx = fold(px, getp(off + nc))
    qy = fold(py, getp(off + nc + 1))
    qz = fold(pz, getp(off + nc + 2))
    return _emit(n.child, qx, qy, qz, getp, off)


def _shaded(n, px, py, pz, getp, off):
    # Distance-transparent: child params sit at off; the 10 material params
    # (ambient/diffuse/specular rgb + shininess) follow and are consumed only
    # by the material program (compile_scene_material).
    return _emit(n.child, px, py, pz, getp, off)


def _ray_shaded(n, ox, oy, oz, dx, dy, dz, getp, off):
    return _ray_emit(n.child, ox, oy, oz, dx, dy, dz, getp, off)


_HANDLERS = {
    materials.Shaded: _shaded,
    primitives.Sphere: _sphere,
    primitives.Plane: _plane,
    primitives.Box: _box,
    primitives.RoundBox: _round_box,
    primitives.Torus: _torus,
    primitives.Capsule: _capsule,
    primitives.Cylinder: _cylinder,
    primitives.Ellipsoid: _ellipsoid,
    primitives.Mandelbulb: _mandelbulb,
    csg.Union: _binary(jnp.minimum),
    csg.Intersection: _binary(jnp.maximum),
    csg.Subtraction: _binary(lambda a, b: jnp.maximum(a, -b)),
    csg.SmoothUnion: _smooth(+1.0),
    csg.SmoothIntersection: _smooth(-1.0),
    csg.SmoothSubtraction: _smooth(-1.0, neg_b=True),
    transforms.Translate: _translate,
    transforms.Rotate: _rotate,
    transforms.Scale: _scale,
    transforms.Round: _round,
    transforms.Onion: _onion,
    transforms.Elongate: _elongate,
    transforms.RepeatInfinite: _repeat,
}


def compile_scene(scene: SDFNode):
    """Stage the scene into ``soa_fn(px, py, pz, getp) -> distance plane``.

    The tree walk happens once (Python time); the returned closure traces to
    one fused elementwise expression.  ``getp`` abstracts where parameters
    live: scalars loaded inside a Pallas kernel, the flat vector elsewhere.
    """

    def soa_fn(px, py, pz, getp: GetP):
        return _emit(scene, px, py, pz, getp, 0)

    return soa_fn


# ---------------------------------------------------------------------------
# Ray-parameterized emitters: distance as a function of march parameter t.
#
# Inside a march every SDF eval happens at ``p = o + t·d`` with (o, d) fixed
# per ray.  Substituting that into each primitive turns per-step work into a
# polynomial/affine form whose coefficients depend only on (o, d) — hoisted
# out of the march loop:
#
# - plane:   n·(o + t·d) − dc            = at + b               (1 FMA/step)
# - sphere:  |o + t·d − c| − r           = √(qa·t² + 2·qb·t + qc) − r
#                                          (2 FMA + sqrt + sub/step — no
#                                           3-component position math at all)
# - torus/cylinder/capsule/ellipsoid: the same quadratic-in-t structure per
#   squared length; box: per-axis |affine|.
# - translate/rotate/scale fold into (o, d) at setup time and cost ZERO per
#   step (vs a full vector transform per eval in point form).
#
# Numerics: algebraically identical to the point form, but float rounding
# differs by ~1 ulp (e.g. qa·t² + 2qb·t + qc vs Σ(pᵢ−cᵢ)²), so images agree
# to ~1e-6 rather than bitwise; a razor-edge ray may flip one march step.
# Point form (compile_scene) remains the oracle-parity reference.
#
# Nodes with no ray handler (position folds like Elongate/RepeatInfinite, or
# data-dependent nodes) fall back to computing the position planes per step
# and point-emitting that subtree — compile_scene_ray always succeeds when
# compile_scene does.
# ---------------------------------------------------------------------------


def _ray_fallback(node, ox, oy, oz, dx, dy, dz, getp: GetP, off: int):
    def ev(t):
        return _emit(node, ox + t * dx, oy + t * dy, oz + t * dz, getp, off)

    return ev


def _quad_coeffs(ax, ay, az, bx, by, bz):
    """Coefficients of |a + t·b|² = qa·t² + 2·qb·t + qc (any of the three
    axes may be dropped by passing zeros)."""
    qa = bx * bx + by * by + bz * bz
    qb = ax * bx + ay * by + az * bz
    qc = ax * ax + ay * ay + az * az
    return qa, qb, qc


def _quad_eval(qa, qb, qc, t):
    return t * (qa * t + 2.0 * qb) + qc


def _ray_sphere(n, ox, oy, oz, dx, dy, dz, getp, off):
    # Completed-square form (round-5 march-op diet): |o + t·d − c| − r
    # = A·sqrt((t+B)² + C) − r with A = |d|, B = qb/qa, C = qc/qa − B²,
    # all per-ray setup constants hoisted out of the march loop.  Per step:
    # add + FMA + sqrt + FMA (A and −r fold into one) = 3 vector ops +
    # sqrt, vs 5 for the raw quadratic — and C is clamped ≥ 0 at setup, so
    # (t+B)² + C can never round negative and the per-step max() guard
    # drops too.  Rounding differs from the point form by the documented
    # ray-form ~1 ulp (razor-edge pixel budget, tests/test_gpu_parity.py).
    cx, cy, cz, r = getp(off), getp(off + 1), getp(off + 2), getp(off + 3)
    qa, qb, qc = _quad_coeffs(ox - cx, oy - cy, oz - cz, dx, dy, dz)
    inv_qa = 1.0 / jnp.maximum(qa, 1e-24)
    A = jnp.sqrt(qa)
    B = qb * inv_qa
    C = jnp.maximum(qc * inv_qa - B * B, 0.0)

    def ev(t):
        u = t + B
        return A * jnp.sqrt(u * u + C) - r

    return ev


def _ray_plane(n, ox, oy, oz, dx, dy, dz, getp, off):
    nx, ny, nz, d = getp(off), getp(off + 1), getp(off + 2), getp(off + 3)
    a = dx * nx + dy * ny + dz * nz
    b = ox * nx + oy * ny + oz * nz - d

    def ev(t):
        return a * t + b

    return ev


def _ray_box_core(ox, oy, oz, dx, dy, dz, cx, cy, cz, hx, hy, hz):
    ax, ay, az = ox - cx, oy - cy, oz - cz

    def ev(t):
        qx = jnp.abs(ax + t * dx) - hx
        qy = jnp.abs(ay + t * dy) - hy
        qz = jnp.abs(az + t * dz) - hz
        mx = jnp.maximum(qx, 0.0)
        my = jnp.maximum(qy, 0.0)
        mz = jnp.maximum(qz, 0.0)
        outside = jnp.sqrt(mx * mx + my * my + mz * mz)
        inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
        return outside + inside

    return ev


def _ray_box(n, ox, oy, oz, dx, dy, dz, getp, off):
    return _ray_box_core(ox, oy, oz, dx, dy, dz, *(getp(off + i) for i in range(6)))


def _ray_round_box(n, ox, oy, oz, dx, dy, dz, getp, off):
    ev0 = _ray_box_core(ox, oy, oz, dx, dy, dz, *(getp(off + i) for i in range(6)))
    r = getp(off + 6)
    return lambda t: ev0(t) - r


def _ray_torus(n, ox, oy, oz, dx, dy, dz, getp, off):
    cx, cy, cz, major, minor = (getp(off + i) for i in range(5))
    qa, qb, qc = _quad_coeffs(ox - cx, jnp.zeros_like(oy - cy), oz - cz, dx, jnp.zeros_like(dy), dz)
    ay, by = oy - cy, dy

    def ev(t):
        ring = jnp.sqrt(jnp.maximum(_quad_eval(qa, qb, qc, t), 0.0)) - major
        y = ay + t * by
        return jnp.sqrt(ring * ring + y * y) - minor

    return ev


def _ray_capsule(n, ox, oy, oz, dx, dy, dz, getp, off):
    axp, ayp, azp, bxp, byp, bzp, r = (getp(off + i) for i in range(7))
    bax, bay, baz = bxp - axp, byp - ayp, bzp - azp
    inv = 1.0 / jnp.maximum(bax * bax + bay * bay + baz * baz, 1e-12)
    # h(t) = clip((o−a+t·d)·(b−a)·inv, 0, 1) — affine in t before the clip.
    h0 = ((ox - axp) * bax + (oy - ayp) * bay + (oz - azp) * baz) * inv
    h1 = (dx * bax + dy * bay + dz * baz) * inv
    wx0, wy0, wz0 = ox - axp, oy - ayp, oz - azp

    def ev(t):
        h = jnp.clip(h0 + t * h1, 0.0, 1.0)
        ux = wx0 + t * dx - bax * h
        uy = wy0 + t * dy - bay * h
        uz = wz0 + t * dz - baz * h
        return jnp.sqrt(ux * ux + uy * uy + uz * uz) - r

    return ev


def _ray_cylinder(n, ox, oy, oz, dx, dy, dz, getp, off):
    cx, cy, cz, r, hh = (getp(off + i) for i in range(5))
    zero = jnp.zeros_like(oy)
    qa, qb, qc = _quad_coeffs(ox - cx, zero, oz - cz, dx, jnp.zeros_like(dy), dz)
    ay, by = oy - cy, dy

    def ev(t):
        radial = jnp.sqrt(jnp.maximum(_quad_eval(qa, qb, qc, t), 0.0)) - r
        axial = jnp.abs(ay + t * by) - hh
        mr = jnp.maximum(radial, 0.0)
        ma = jnp.maximum(axial, 0.0)
        outside = jnp.sqrt(mr * mr + ma * ma)
        inside = jnp.minimum(jnp.maximum(radial, axial), 0.0)
        return outside + inside

    return ev


def _ray_ellipsoid(n, ox, oy, oz, dx, dy, dz, getp, off):
    cx, cy, cz, rx, ry, rz = (getp(off + i) for i in range(6))
    # k0 uses q/rᵢ, k1 uses q/rᵢ² — two quadratics with scaled (o−c, d).
    qa0, qb0, qc0 = _quad_coeffs((ox - cx) / rx, (oy - cy) / ry, (oz - cz) / rz, dx / rx, dy / ry, dz / rz)
    rx2, ry2, rz2 = rx * rx, ry * ry, rz * rz
    qa1, qb1, qc1 = _quad_coeffs(
        (ox - cx) / rx2, (oy - cy) / ry2, (oz - cz) / rz2, dx / rx2, dy / ry2, dz / rz2
    )

    def ev(t):
        k0 = jnp.sqrt(jnp.maximum(_quad_eval(qa0, qb0, qc0, t), 0.0))
        k1 = jnp.sqrt(jnp.maximum(_quad_eval(qa1, qb1, qc1, t), 0.0))
        return k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-12)

    return ev


def _ray_binary(op):
    def h(n, ox, oy, oz, dx, dy, dz, getp, off):
        ea = _ray_emit(n.a, ox, oy, oz, dx, dy, dz, getp, off)
        eb = _ray_emit(n.b, ox, oy, oz, dx, dy, dz, getp, off + count_params(n.a))
        return lambda t: op(ea(t), eb(t))

    return h


def _ray_smooth(sign, neg_b=False):
    def h(n, ox, oy, oz, dx, dy, dz, getp, off):
        na = count_params(n.a)
        nb = count_params(n.b)
        ea = _ray_emit(n.a, ox, oy, oz, dx, dy, dz, getp, off)
        eb = _ray_emit(n.b, ox, oy, oz, dx, dy, dz, getp, off + na)
        k = getp(off + na + nb)

        def ev(t):
            db = eb(t)
            if neg_b:
                db = -db
            return _smooth_mix(ea(t), db, k, sign)

        return ev

    return h


def _ray_translate(n, ox, oy, oz, dx, dy, dz, getp, off):
    nc = count_params(n.child)
    tx, ty, tz = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
    return _ray_emit(n.child, ox - tx, oy - ty, oz - tz, dx, dy, dz, getp, off)


def _ray_rotate(n, ox, oy, oz, dx, dy, dz, getp, off):
    nc = count_params(n.child)
    wx, wy, wz = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
    r = _rodrigues_scalars(wx, wy, wz)
    qox, qoy, qoz = _rotate_query(ox, oy, oz, r)
    qdx, qdy, qdz = _rotate_query(dx, dy, dz, r)
    return _ray_emit(n.child, qox, qoy, qoz, qdx, qdy, qdz, getp, off)


def _ray_scale(n, ox, oy, oz, dx, dy, dz, getp, off):
    nc = count_params(n.child)
    s = jnp.maximum(getp(off + nc), 1e-12)
    ev = _ray_emit(n.child, ox / s, oy / s, oz / s, dx / s, dy / s, dz / s, getp, off)
    return lambda t: ev(t) * s


def _ray_round(n, ox, oy, oz, dx, dy, dz, getp, off):
    nc = count_params(n.child)
    ev = _ray_emit(n.child, ox, oy, oz, dx, dy, dz, getp, off)
    r = getp(off + nc)
    return lambda t: ev(t) - r


def _ray_onion(n, ox, oy, oz, dx, dy, dz, getp, off):
    nc = count_params(n.child)
    ev = _ray_emit(n.child, ox, oy, oz, dx, dy, dz, getp, off)
    r = getp(off + nc)
    return lambda t: jnp.abs(ev(t)) - r


_RAY_HANDLERS = {
    materials.Shaded: _ray_shaded,
    primitives.Sphere: _ray_sphere,
    primitives.Plane: _ray_plane,
    primitives.Box: _ray_box,
    primitives.RoundBox: _ray_round_box,
    primitives.Torus: _ray_torus,
    primitives.Capsule: _ray_capsule,
    primitives.Cylinder: _ray_cylinder,
    primitives.Ellipsoid: _ray_ellipsoid,
    csg.Union: _ray_binary(jnp.minimum),
    csg.Intersection: _ray_binary(jnp.maximum),
    csg.Subtraction: _ray_binary(lambda a, b: jnp.maximum(a, -b)),
    csg.SmoothUnion: _ray_smooth(+1.0),
    csg.SmoothIntersection: _ray_smooth(-1.0),
    csg.SmoothSubtraction: _ray_smooth(-1.0, neg_b=True),
    transforms.Translate: _ray_translate,
    transforms.Rotate: _ray_rotate,
    transforms.Scale: _ray_scale,
    transforms.Round: _ray_round,
    transforms.Onion: _ray_onion,
}


def _ray_emit(node, ox, oy, oz, dx, dy, dz, getp: GetP, off: int):
    h = _RAY_HANDLERS.get(type(node))
    if h is None:
        # Point-emitter fallback (Elongate/RepeatInfinite/...): position per
        # step + point program.  Raises TypeError for truly unsupported nodes
        # exactly like _emit.
        return _ray_fallback(node, ox, oy, oz, dx, dy, dz, getp, off)
    return h(node, ox, oy, oz, dx, dy, dz, getp, off)


def compile_scene_ray(scene: SDFNode):
    """Stage the scene into ``setup(o, d, getp) -> eval(t)`` for marches.

    ``o`` / ``d`` are (ox, oy, oz) / (dx, dy, dz) tuples of planes or
    scalars; ``eval(t) -> distance plane`` closes over per-ray constants
    hoisted out of the march loop.  See the module comment above for the
    per-primitive forms and the ~1-ulp numerics caveat vs compile_scene.
    """

    def setup(o, d, getp: GetP):
        return _ray_emit(scene, o[0], o[1], o[2], d[0], d[1], d[2], getp, 0)

    return setup


# ---------------------------------------------------------------------------
# Material program: SoA fold resolving the per-lane material channels.
#
# Mirrors sdf/materials.py::_fold in scene-program form: 10 channels
# (ambient rgb, diffuse rgb, specular rgb, shininess) carried as
# scalars-or-planes next to the distance.  Hard CSG selects the winning
# side's channels, smooth CSG lerps them with the same ``h`` weight the
# smooth-min applies to distances, subtraction keeps ``a``'s material.
# Pure vector selects/FMAs; evaluated ONCE per ray at the
# hit point (the marches never touch it).
# ---------------------------------------------------------------------------

N_MAT_CHANNELS = 10  # amb rgb, dif rgb, spec rgb, shininess


def _mat_select(cond, ca, cb):
    return tuple(jnp.where(cond, a, b) for a, b in zip(ca, cb))


def _mat_lerp(h, ca, cb):
    return tuple(b + (a - b) * h for a, b in zip(ca, cb))


def _emit_mat(node, px, py, pz, getp: GetP, off: int, default):
    """Return ``(distance, channels)``; ``default`` is the 10-channel tuple
    used for untagged subtrees (the render call's global material)."""
    if not materials.scene_has_materials(node):
        return _emit(node, px, py, pz, getp, off), default

    t = type(node)
    if t is materials.Shaded:
        nc = count_params(node.child)
        own = tuple(getp(off + nc + i) for i in range(N_MAT_CHANNELS))
        return _emit_mat(node.child, px, py, pz, getp, off, own)

    if t is csg.Union:
        da, ca = _emit_mat(node.a, px, py, pz, getp, off, default)
        db, cb = _emit_mat(node.b, px, py, pz, getp, off + count_params(node.a), default)
        return jnp.minimum(da, db), _mat_select(da <= db, ca, cb)
    if t is csg.Intersection:
        da, ca = _emit_mat(node.a, px, py, pz, getp, off, default)
        db, cb = _emit_mat(node.b, px, py, pz, getp, off + count_params(node.a), default)
        return jnp.maximum(da, db), _mat_select(da >= db, ca, cb)
    if t is csg.Subtraction:
        da, ca = _emit_mat(node.a, px, py, pz, getp, off, default)
        db = _emit(node.b, px, py, pz, getp, off + count_params(node.a))
        return jnp.maximum(da, -db), ca
    if t in (csg.SmoothUnion, csg.SmoothIntersection, csg.SmoothSubtraction):
        na, nb = count_params(node.a), count_params(node.b)
        sign = +1.0 if t is csg.SmoothUnion else -1.0
        da, ca = _emit_mat(node.a, px, py, pz, getp, off, default)
        if t is csg.SmoothSubtraction:
            db = -_emit(node.b, px, py, pz, getp, off + na)
            cb = ca  # the carve reveals a's interior
        else:
            db, cb = _emit_mat(node.b, px, py, pz, getp, off + na, default)
        k = jnp.maximum(getp(off + na + nb), 1e-6)
        h = jnp.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
        return _smooth_mix(da, db, k, sign), _mat_lerp(h, ca, cb)

    if t is transforms.Translate:
        nc = count_params(node.child)
        ox_, oy_, oz_ = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
        return _emit_mat(node.child, px - ox_, py - oy_, pz - oz_, getp, off, default)
    if t is transforms.Rotate:
        nc = count_params(node.child)
        wx, wy, wz = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
        qx, qy, qz = _rotate_query(px, py, pz, _rodrigues_scalars(wx, wy, wz))
        return _emit_mat(node.child, qx, qy, qz, getp, off, default)
    if t is transforms.Scale:
        nc = count_params(node.child)
        s = jnp.maximum(getp(off + nc), 1e-12)
        d, ch = _emit_mat(node.child, px / s, py / s, pz / s, getp, off, default)
        return d * s, ch
    if t is transforms.Round:
        nc = count_params(node.child)
        d, ch = _emit_mat(node.child, px, py, pz, getp, off, default)
        return d - getp(off + nc), ch
    if t is transforms.Onion:
        nc = count_params(node.child)
        d, ch = _emit_mat(node.child, px, py, pz, getp, off, default)
        return jnp.abs(d) - getp(off + nc), ch
    if t is transforms.Elongate:
        nc = count_params(node.child)
        ax, ay, az = getp(off + nc), getp(off + nc + 1), getp(off + nc + 2)
        qx = px - jnp.clip(px, -ax, ax)
        qy = py - jnp.clip(py, -ay, ay)
        qz = pz - jnp.clip(pz, -az, az)
        return _emit_mat(node.child, qx, qy, qz, getp, off, default)
    if t is transforms.RepeatInfinite:
        nc = count_params(node.child)

        def fold(p, period):
            safe = jnp.where(period > 0.0, period, 1.0)
            return jnp.where(period > 0.0, p - period * _nearest(p / safe), p)

        qx = fold(px, getp(off + nc))
        qy = fold(py, getp(off + nc + 1))
        qz = fold(pz, getp(off + nc + 2))
        return _emit_mat(node.child, qx, qy, qz, getp, off, default)

    raise TypeError(
        f"no material emitter for scene node {t.__name__}; register one in "
        "sdf3d_tpu/ops/scene_program.py::_emit_mat"
    )


def compile_scene_material(scene: SDFNode):
    """Stage the scene into ``mat_fn(px, py, pz, getp, default) ->
    (distance, 10-channel tuple)`` — the per-lane material resolver evaluated
    once at the hit point.  ``default`` supplies the untagged-subtree
    channels (the uniform material inside the kernel)."""

    def mat_fn(px, py, pz, getp: GetP, default):
        return _emit_mat(scene, px, py, pz, getp, 0, default)

    return mat_fn
