"""Spatial and shape transforms over SDF nodes.

No counterpart in the reference (its scene is fixed in world space;
``/root/reference/Code/shader/voxel_fragment.frag:54-81``) — these are the
standard SDF-domain operators that make the scene graph composable, each kept
differentiable w.r.t. its parameters (offsets, rotation vectors, scales).
"""

from __future__ import annotations

from sdf3d_tpu import pytree as struct
import jax.numpy as jnp

from sdf3d_tpu.sdf.node import SDFNode, as_f32, mat_vec, vlength


def rotvec_to_matrix(rotvec: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle vector → 3×3 rotation matrix (Rodrigues), differentiable.

    Uses the series-safe form near zero angle so gradients are finite at
    ``rotvec = 0``.
    """
    theta2 = jnp.sum(rotvec * rotvec)
    small = theta2 < 1e-8
    # Double-where: evaluate the exact branch at a safe θ when small, so its
    # (unselected) derivative stays finite and the series branch's gradient
    # survives the where.
    safe2 = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(safe2)
    # sin(θ)/θ and (1-cos(θ))/θ² with small-angle series fallback.
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    cosc = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe2)
    wx, wy, wz = rotvec[0], rotvec[1], rotvec[2]
    K = jnp.array(
        [
            [0.0, -wz, wy],
            [wz, 0.0, -wx],
            [-wy, wx, 0.0],
        ],
        dtype=rotvec.dtype,
    )
    return jnp.eye(3, dtype=rotvec.dtype) + sinc * K + cosc * (K @ K)


@struct.dataclass
class Translate(SDFNode):
    """Translate the child by ``offset``: ``d(p) = child(p - offset)``."""

    child: SDFNode
    offset: jnp.ndarray  # (3,)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.child.distance(p - self.offset)


@struct.dataclass
class Rotate(SDFNode):
    """Rotate the child about the origin by axis-angle ``rotvec``.

    Evaluates the child at ``R⁻¹ p`` (inverse rotation of the query point).
    """

    child: SDFNode
    rotvec: jnp.ndarray  # (3,)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        R = rotvec_to_matrix(self.rotvec)
        # R⁻¹ = Rᵀ; apply to trailing axis of p.
        # p @ R = Rᵀ p per vector; mat_vec keeps it f32 on the VPU.
        return self.child.distance(mat_vec(R.T, p))


@struct.dataclass
class Scale(SDFNode):
    """Uniform scale: ``d(p) = child(p / s) * s`` (keeps the field metric)."""

    child: SDFNode
    factor: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        s = jnp.maximum(self.factor, 1e-12)
        return self.child.distance(p / s) * s


@struct.dataclass
class Round(SDFNode):
    """Round all edges of the child by ``radius`` (subtract radius)."""

    child: SDFNode
    radius: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.child.distance(p) - self.radius


@struct.dataclass
class Onion(SDFNode):
    """Hollow the child into a shell of given ``thickness``: ``|d| - t``."""

    child: SDFNode
    thickness: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.abs(self.child.distance(p)) - self.thickness


@struct.dataclass
class Elongate(SDFNode):
    """Stretch the child along each axis by clamping the query point."""

    child: SDFNode
    amount: jnp.ndarray  # (3,)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        q = p - jnp.clip(p, -self.amount, self.amount)
        return self.child.distance(q)


@struct.dataclass
class RepeatInfinite(SDFNode):
    """Infinite lattice repetition with per-axis ``period`` (0 disables an axis).

    Exact only when the child fits within half a period; the standard
    domain-repetition operator.
    """

    child: SDFNode
    period: jnp.ndarray  # (3,)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        period = self.period
        q = jnp.where(
            period > 0.0,
            p - period * jnp.round(p / jnp.where(period > 0.0, period, 1.0)),
            p,
        )
        return self.child.distance(q)


def translate(child: SDFNode, offset) -> Translate:
    return Translate(child=child, offset=as_f32(offset))


def rotate(child: SDFNode, rotvec) -> Rotate:
    return Rotate(child=child, rotvec=as_f32(rotvec))


def scale(child: SDFNode, factor) -> Scale:
    return Scale(child=child, factor=as_f32(factor))


def round_edges(child: SDFNode, radius) -> Round:
    return Round(child=child, radius=as_f32(radius))


def onion(child: SDFNode, thickness) -> Onion:
    return Onion(child=child, thickness=as_f32(thickness))


def elongate(child: SDFNode, amount) -> Elongate:
    return Elongate(child=child, amount=as_f32(amount))


def repeat_infinite(child: SDFNode, period) -> RepeatInfinite:
    return RepeatInfinite(child=child, period=as_f32(period))
