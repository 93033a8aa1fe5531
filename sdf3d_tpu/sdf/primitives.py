"""Analytic SDF primitives as differentiable pytree nodes.

The reference ships exactly two primitives — a hard-coded sphere and the
``y = 0`` ground plane (``/root/reference/Code/shader/voxel_fragment.frag:54-71``).
This module supplies those two with *runtime, differentiable* parameters plus
the standard analytic family (box, rounded box, torus, capsule, cylinder) the
north-star configs require.  All distance fields are exact (true Euclidean
distance) except where noted.
"""

from __future__ import annotations

from sdf3d_tpu import pytree as struct
import jax
import jax.numpy as jnp

from sdf3d_tpu.sdf.node import SDFNode, as_f32, vlength, vlength_safe


@struct.dataclass
class Sphere(SDFNode):
    """Sphere: ``length(p - center) - radius``.

    Reference: ``sphereSDF`` at ``voxel_fragment.frag:54-64`` (center
    (0, 0.4, 0), r = 0.2 hard-coded there; parameters here).
    """

    center: jnp.ndarray  # (3,)
    radius: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return vlength(p - self.center) - self.radius


@struct.dataclass
class Plane(SDFNode):
    """Half-space bounded by the plane ``dot(normal, p) - offset = 0``.

    ``normal`` must be unit length for a true distance.  The reference's
    ground plane (``planeSDF`` returning ``position.y``,
    ``voxel_fragment.frag:66-71``) is ``Plane(normal=(0,1,0), offset=0)``.
    """

    normal: jnp.ndarray  # (3,)
    offset: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.sum(p * self.normal, axis=-1) - self.offset


@struct.dataclass
class Box(SDFNode):
    """Axis-aligned box, exact SDF (Quilez ``sdBox``).

    ``q = |p - center| - half_extents``;
    ``d = length(max(q, 0)) + min(max_component(q), 0)``.
    """

    center: jnp.ndarray  # (3,)
    half_extents: jnp.ndarray  # (3,)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = jnp.abs(p - self.center) - self.half_extents
        outside = vlength_safe(jnp.maximum(q, 0.0))
        inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return outside + inside


@struct.dataclass
class RoundBox(SDFNode):
    """Box with rounded edges: box SDF minus corner radius."""

    center: jnp.ndarray  # (3,)
    half_extents: jnp.ndarray  # (3,)
    corner_radius: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = jnp.abs(p - self.center) - self.half_extents
        outside = vlength_safe(jnp.maximum(q, 0.0))
        inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return outside + inside - self.corner_radius


@struct.dataclass
class Torus(SDFNode):
    """Torus in the xz-plane: major radius ``major``, tube radius ``minor``."""

    center: jnp.ndarray  # (3,)
    major: jnp.ndarray  # ()
    minor: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = p - self.center
        ring = jnp.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - self.major
        return jnp.sqrt(ring**2 + q[..., 1] ** 2) - self.minor


@struct.dataclass
class Capsule(SDFNode):
    """Capsule between endpoints ``a`` and ``b`` with given ``radius``."""

    a: jnp.ndarray  # (3,)
    b: jnp.ndarray  # (3,)
    radius: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        pa = p - self.a
        ba = self.b - self.a
        denom = jnp.maximum(jnp.sum(ba * ba, axis=-1), 1e-12)
        h = jnp.clip(jnp.sum(pa * ba, axis=-1) / denom, 0.0, 1.0)
        return vlength(pa - ba * h[..., None]) - self.radius


@struct.dataclass
class Cylinder(SDFNode):
    """Capped vertical (y-axis) cylinder, exact SDF (Quilez ``sdCappedCylinder``)."""

    center: jnp.ndarray  # (3,)
    radius: jnp.ndarray  # ()
    half_height: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = p - self.center
        radial = jnp.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - self.radius
        axial = jnp.abs(q[..., 1]) - self.half_height
        dx = jnp.maximum(radial, 0.0)
        dy = jnp.maximum(axial, 0.0)
        outside = vlength_safe(jnp.stack([dx, dy], axis=-1))
        inside = jnp.minimum(jnp.maximum(radial, axial), 0.0)
        return outside + inside


@struct.dataclass
class Ellipsoid(SDFNode):
    """Ellipsoid, Quilez bound-improved approximation (not exact off-axis)."""

    center: jnp.ndarray  # (3,)
    radii: jnp.ndarray  # (3,)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = p - self.center
        k0 = vlength(q / self.radii)
        k1 = vlength(q / (self.radii * self.radii))
        return k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-12)


# ---------------------------------------------------------------------------
# Factory helpers — coerce python numbers to float32 leaves so every scene is
# a clean f32 pytree (ready for ravel_pytree / the Pallas parameter vector).
# ---------------------------------------------------------------------------


def sphere(center=(0.0, 0.0, 0.0), radius=1.0) -> Sphere:
    return Sphere(center=as_f32(center), radius=as_f32(radius))


def plane(normal=(0.0, 1.0, 0.0), offset=0.0) -> Plane:
    return Plane(normal=as_f32(normal), offset=as_f32(offset))


def ground_plane() -> Plane:
    """The reference's ground plane ``y = 0`` (``voxel_fragment.frag:66-71``)."""
    return plane((0.0, 1.0, 0.0), 0.0)


def box(half_extents=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> Box:
    return Box(center=as_f32(center), half_extents=as_f32(half_extents))


def round_box(half_extents=(1.0, 1.0, 1.0), corner_radius=0.1, center=(0.0, 0.0, 0.0)) -> RoundBox:
    return RoundBox(
        center=as_f32(center),
        half_extents=as_f32(half_extents),
        corner_radius=as_f32(corner_radius),
    )


def torus(major=1.0, minor=0.25, center=(0.0, 0.0, 0.0)) -> Torus:
    return Torus(center=as_f32(center), major=as_f32(major), minor=as_f32(minor))


def capsule(a=(0.0, 0.0, 0.0), b=(0.0, 1.0, 0.0), radius=0.25) -> Capsule:
    return Capsule(a=as_f32(a), b=as_f32(b), radius=as_f32(radius))


def cylinder(radius=0.5, half_height=0.5, center=(0.0, 0.0, 0.0)) -> Cylinder:
    return Cylinder(center=as_f32(center), radius=as_f32(radius), half_height=as_f32(half_height))


def ellipsoid(radii=(1.0, 0.5, 0.5), center=(0.0, 0.0, 0.0)) -> Ellipsoid:
    return Ellipsoid(center=as_f32(center), radii=as_f32(radii))


def _mandelbulb_de(qx, qy, qz, iterations: int, bailout: float = 4.0):
    r"""Trig-free power-8 Mandelbulb distance estimator on components.

    The triplex power map with the y polar axis is
    ``w^n = rho^n (sin n\theta cos n\phi, cos n\theta, sin n\theta sin n\phi)`` for
    ``w = rho (sin\theta cos\phi, cos\theta, sin\theta sin\phi)``; with n = 8 all four
    ``sin/cos(8\alpha)`` terms come from three angle doublings
    ``(c, s) -> (c^2 - s^2, 2cs)`` of the *algebraic* sines/cosines
    ``cos\theta = y/rho, sin\theta = k/rho, cos\phi = x/k, sin\phi = z/k`` (k = sqrt(x^2+z^2)) — so
    the whole estimator is mul/add/sqrt/rsqrt/log, every op the kernel
    backends lower (no transcendental trig, kernel-safe).  The escape-time derivative
    accumulates ``dr <- 8 rho^7 dr + 1`` and the distance is the standard
    Hubbard-Douady estimate ``0.5 log(rho) rho / dr`` — a conservative
    underestimate of true distance, i.e. sphere-trace safe (validated by
    the statistical Lipschitz test).

    Runs fixed-unrolled with f32 escape masks (no data-dependent break):
    escaped lanes freeze ``w``/``dr`` and keep their escape radius, exactly
    the masked-march discipline of the render kernels.
    """
    f32 = jnp.float32
    eps = f32(1e-12)
    wx, wy, wz = qx, qy, qz
    dr = jnp.ones_like(qx)
    r_kept = jnp.full_like(qx, eps)
    active = jnp.ones_like(qx)  # f32 0/1 mask (the kernels' mask discipline)
    b2 = f32(bailout * bailout)
    for _ in range(iterations):
        m = wx * wx + wy * wy + wz * wz
        m = jnp.maximum(m, eps)
        r = jnp.sqrt(m)
        # Top-of-loop radius counts even on the escaping iteration (the
        # scalar reference breaks *after* reading r).
        r_kept = jnp.where(active > 0.5, r, r_kept)
        stay = active * jnp.where(m <= b2, 1.0, 0.0)
        # dr <- 8 r^7 dr + 1   (r^7 = m^3 r)
        m2 = m * m
        dr = jnp.where(stay > 0.5, 8.0 * (m2 * m) * r * dr + 1.0, dr)
        # w <- w^8 + q, via three doublings per angle.
        inv_r = jax.lax.rsqrt(m)
        k2 = jnp.maximum(wx * wx + wz * wz, eps)
        inv_k = jax.lax.rsqrt(k2)
        ct, st = wy * inv_r, jnp.sqrt(k2) * inv_r
        cp, sp = wx * inv_k, wz * inv_k
        for _dbl in range(3):
            ct, st = ct * ct - st * st, 2.0 * ct * st
            cp, sp = cp * cp - sp * sp, 2.0 * cp * sp
        r8 = m2 * m2
        wx = jnp.where(stay > 0.5, r8 * st * cp + qx, wx)
        wy = jnp.where(stay > 0.5, r8 * ct + qy, wy)
        wz = jnp.where(stay > 0.5, r8 * st * sp + qz, wz)
        active = stay
    est = 0.5 * jnp.log(r_kept) * r_kept / dr
    # The escape-time estimate is NOT 1-Lipschitz (measured worst secant
    # ratio 1.39 over the sampling box) — raw, it can overshoot surfaces.
    # 0.5x brings the measured worst to ~0.7 (sphere-trace safe, passes
    # debug.check_lipschitz); the exact bounding-sphere bound keeps the far
    # field fast: the power-8 set lies within radius 2^(1/7) ~= 1.104
    # (R^7 > 2 escapes), so |q| - 1.2 is a true lower bound with slope 1,
    # and max() of two lower bounds is a lower bound.
    # eps-clamped like m/k2 above: the raw sqrt's reverse-mode derivative is
    # NaN when a sample coincides exactly with the bulb center, poisoning
    # center-trainable fit steps.
    d_bound = jnp.sqrt(jnp.maximum(qx * qx + qy * qy + qz * qz, eps)) - 1.2
    return jnp.maximum(0.5 * est, d_bound)


@struct.dataclass
class Mandelbulb(SDFNode):
    """Power-8 Mandelbulb fractal (escape-time distance *estimate*).

    No reference counterpart — a deliberately **eval-dominated** model
    family (~300 VPU ops per evaluation vs ~10 for the analytic scene):
    the regime where over-relaxed marching and per-step cost dominate, the
    complement of the reference's eval-cheap scenes.  ``center`` and
    ``scale`` are differentiable; ``iterations`` is static (a different
    unroll is a different compiled scene).
    """

    center: jnp.ndarray  # (3,)
    scale: jnp.ndarray  # ()
    iterations: int = struct.field(pytree_node=False, default=6)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = (p - self.center) / self.scale
        d = _mandelbulb_de(q[..., 0], q[..., 1], q[..., 2], self.iterations)
        return d * self.scale


def mandelbulb(center=(0.0, 0.0, 0.0), scale=1.0, iterations=6) -> Mandelbulb:
    return Mandelbulb(center=as_f32(center), scale=as_f32(scale), iterations=int(iterations))
