"""CSG combinators over SDF nodes.

The reference composes its scene with a seeded hard union:
``sdf = min(INF, plane); sdf = min(sdf, sphere)``
(``/root/reference/Code/shader/voxel_fragment.frag:73-81``).  Here the hard
operators (min / max) are joined by the smooth (polynomial) variants required
by the north star — the smooth ops are C1 and therefore give usable gradients
for inverse rendering where the hard ``min`` has a kink.
"""

from __future__ import annotations

from sdf3d_tpu import pytree as struct
import jax.numpy as jnp

from sdf3d_tpu.sdf.node import SDFNode, as_f32


@struct.dataclass
class Union(SDFNode):
    """Hard union: ``min(a, b)`` (``voxel_fragment.frag:77-78``)."""

    a: SDFNode
    b: SDFNode

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.minimum(self.a.distance(p), self.b.distance(p))


@struct.dataclass
class Intersection(SDFNode):
    """Hard intersection: ``max(a, b)``."""

    a: SDFNode
    b: SDFNode

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.maximum(self.a.distance(p), self.b.distance(p))


@struct.dataclass
class Subtraction(SDFNode):
    """Carve ``b`` out of ``a``: ``max(a, -b)``."""

    a: SDFNode
    b: SDFNode

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.maximum(self.a.distance(p), -self.b.distance(p))


def _smooth_mix(da: jnp.ndarray, db: jnp.ndarray, k: jnp.ndarray, sign: float) -> jnp.ndarray:
    """Quilez polynomial smooth min (sign=+1) / smooth max (sign=-1)."""
    k = jnp.maximum(k, 1e-6)
    h = jnp.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
    mixed = db + (da - db) * h
    return mixed - sign * k * h * (1.0 - h)


@struct.dataclass
class SmoothUnion(SDFNode):
    """Polynomial smooth union with blend radius ``k`` (differentiable union)."""

    a: SDFNode
    b: SDFNode
    k: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return _smooth_mix(self.a.distance(p), self.b.distance(p), self.k, +1.0)


@struct.dataclass
class SmoothIntersection(SDFNode):
    """Polynomial smooth intersection with blend radius ``k``."""

    a: SDFNode
    b: SDFNode
    k: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return _smooth_mix(self.a.distance(p), self.b.distance(p), self.k, -1.0)


@struct.dataclass
class SmoothSubtraction(SDFNode):
    """Polynomial smooth subtraction (carve ``b`` out of ``a``) with radius ``k``."""

    a: SDFNode
    b: SDFNode
    k: jnp.ndarray  # ()

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return _smooth_mix(self.a.distance(p), -self.b.distance(p), self.k, -1.0)


def union(*nodes: SDFNode) -> SDFNode:
    """Left-fold hard union of any number of nodes."""
    out = nodes[0]
    for n in nodes[1:]:
        out = Union(a=out, b=n)
    return out


def intersection(*nodes: SDFNode) -> SDFNode:
    out = nodes[0]
    for n in nodes[1:]:
        out = Intersection(a=out, b=n)
    return out


def subtraction(a: SDFNode, b: SDFNode) -> SDFNode:
    return Subtraction(a=a, b=b)


def smooth_union(a: SDFNode, b: SDFNode, k=0.25) -> SmoothUnion:
    return SmoothUnion(a=a, b=b, k=as_f32(k))


def smooth_intersection(a: SDFNode, b: SDFNode, k=0.25) -> SmoothIntersection:
    return SmoothIntersection(a=a, b=b, k=as_f32(k))


def smooth_subtraction(a: SDFNode, b: SDFNode, k=0.25) -> SmoothSubtraction:
    return SmoothSubtraction(a=a, b=b, k=as_f32(k))
