"""Base machinery for differentiable SDF scene graphs.

The reference renderer hard-codes its scene as GLSL functions
(``/root/reference/Code/shader/voxel_fragment.frag:54-81``): ``sphereSDF`` /
``planeSDF`` composed by ``sceneSDF = min(plane, sphere)``.  Here the scene is a
*pytree* of dataclass nodes instead: the tree **structure** is static (baked
into the XLA trace) while every numeric field is a differentiable JAX leaf.
This is the array-program analogue — one traced, fully-fused expression per scene,
with gradients w.r.t. every shape parameter for free.

Conventions
-----------
- ``distance(p)`` takes points of shape ``(..., 3)`` and returns signed
  distances of shape ``(...,)``; everything broadcasts, so the same scene
  evaluates a single point, a pixel tile, or a whole image without change.
- All numeric fields are float32 leaves (coerced by the factory helpers), so
  :func:`jax.flatten_util.ravel_pytree` yields a flat f32 parameter vector —
  the form the Pallas kernels consume and the optimizer updates.
"""

from __future__ import annotations

import jax.numpy as jnp


def as_f32(x) -> jnp.ndarray:
    """Coerce python scalars / lists / arrays to a float32 jnp array."""
    return jnp.asarray(x, dtype=jnp.float32)


def vlength(v: jnp.ndarray) -> jnp.ndarray:
    """Euclidean norm over the last axis (the GLSL ``length``)."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def vlength_safe(v: jnp.ndarray) -> jnp.ndarray:
    """Euclidean norm with a well-defined (zero) gradient at ``v = 0``.

    Plain ``sqrt(sum(v²))`` has a ``0·inf = NaN`` gradient at the origin —
    which every box/cylinder-style SDF hits for all *interior* points, where
    the clamped outside vector is exactly zero.  The double-``where`` guards
    both branches of the derivative.
    """
    sq = jnp.sum(v * v, axis=-1)
    positive = sq > 0.0
    return jnp.where(positive, jnp.sqrt(jnp.where(positive, sq, 1.0)), 0.0)


def vnormalize(v: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Unit vector over the last axis, safe at zero (the GLSL ``normalize``)."""
    return v / jnp.maximum(vlength(v), eps)[..., None]


def vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dot product over the last axis (the GLSL ``dot``)."""
    return jnp.sum(a * b, axis=-1)


def mat_vec(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply a (3,3) (or (4,4)) matrix to vectors ``v`` of shape (..., N).

    Implemented as a broadcast multiply + reduce rather than
    ``jnp.matmul``: a K=3 matmul is a poor fit for the matrix units and
    JAX's default matmul precision may round operands (TF32 on GPUs), which
    costs ~3 decimal digits on every ray direction.  The explicit sum stays
    in float32.
    """
    return jnp.sum(M * v[..., None, :], axis=-1)


class SDFNode:
    """Mixin base for every SDF scene-graph node.

    Concrete nodes are ``sdf3d_tpu.pytree.dataclass`` pytrees; this mixin only
    supplies the evaluation protocol and CSG operator sugar:

    ``a | b``  hard union (``min``),   ``a & b``  intersection (``max``),
    ``a - b``  subtraction (``max(a, -b)``).
    """

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        """Signed distance from points ``p`` of shape ``(..., 3)``."""
        raise NotImplementedError

    def __call__(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.distance(p)

    # --- CSG sugar (lazy imports avoid a module cycle) -------------------
    def __or__(self, other: "SDFNode") -> "SDFNode":
        from sdf3d_tpu.sdf.csg import Union

        return Union(a=self, b=other)

    def __and__(self, other: "SDFNode") -> "SDFNode":
        from sdf3d_tpu.sdf.csg import Intersection

        return Intersection(a=self, b=other)

    def __sub__(self, other: "SDFNode") -> "SDFNode":
        from sdf3d_tpu.sdf.csg import Subtraction

        return Subtraction(a=self, b=other)

    # --- transform sugar -------------------------------------------------
    def translate(self, offset) -> "SDFNode":
        from sdf3d_tpu.sdf.transforms import Translate

        return Translate(child=self, offset=as_f32(offset))

    def rotate(self, rotvec) -> "SDFNode":
        from sdf3d_tpu.sdf.transforms import Rotate

        return Rotate(child=self, rotvec=as_f32(rotvec))

    def scale(self, factor) -> "SDFNode":
        from sdf3d_tpu.sdf.transforms import Scale

        return Scale(child=self, factor=as_f32(factor))

    def round(self, radius) -> "SDFNode":
        from sdf3d_tpu.sdf.transforms import Round

        return Round(child=self, radius=as_f32(radius))

    def shell(self, thickness) -> "SDFNode":
        from sdf3d_tpu.sdf.transforms import Onion

        return Onion(child=self, thickness=as_f32(thickness))

    def smooth_union(self, other: "SDFNode", k) -> "SDFNode":
        from sdf3d_tpu.sdf.csg import SmoothUnion

        return SmoothUnion(a=self, b=other, k=as_f32(k))
