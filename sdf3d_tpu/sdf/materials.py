"""Per-object materials on the SDF scene graph.

The reference shades every surface with ONE global material
(``/root/reference/Code/shader/voxel_fragment.frag:186-189``: a single
``Material`` literal used for all hits).  The framework renders scenes with
many primitives, so this module adds a per-object material channel as a
scene-graph capability:

- :class:`Shaded` wraps any subtree with its own :class:`Material`.  It is
  transparent to distance evaluation (marching never sees it) and its
  material fields are ordinary differentiable leaves — inverse rendering can
  fit per-object colors exactly like shape parameters.
- :func:`material_at` resolves the material governing each query point by
  folding over the CSG tree: hard ops select the winning side's material,
  smooth ops **blend** materials with the same ``h`` weight the smooth-min
  uses for distances (so a smooth-union seam shades with a continuous
  material transition), subtractions keep the base object's material (the
  carve reveals ``a``'s interior).
- Subtrees without any :class:`Shaded` tag shade with the render call's
  default material — existing scenes are untouched (identical to ~1 ulp;
  scenes with no tags at all skip the fold entirely and stay bit-exact).

The Pallas kernels consume the same semantics through the scene compiler
(``ops/scene_program.compile_scene_material``); this module is the
reference/XLA implementation and the API surface.
"""

from __future__ import annotations

import dataclasses

from sdf3d_tpu import pytree as struct
import jax.numpy as jnp

from sdf3d_tpu.lighting import Material, material
from sdf3d_tpu.sdf import csg, transforms
from sdf3d_tpu.sdf.node import SDFNode, mat_vec


@struct.dataclass
class Shaded(SDFNode):
    """Tag a subtree with its own material; distance-transparent."""

    child: SDFNode
    material: Material

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.child.distance(p)


def shaded(child: SDFNode, mat: Material | None = None, **mat_kwargs) -> Shaded:
    """Wrap ``child`` with a material (a :class:`Material` or
    ``material(...)`` keyword arguments, e.g. ``diffuse=(1, 0, 0)``)."""
    if mat is None:
        mat = material(**mat_kwargs)
    elif mat_kwargs:
        mat = dataclasses.replace(mat, **{k: jnp.asarray(v, jnp.float32) for k, v in mat_kwargs.items()})
    return Shaded(child=child, material=mat)


def scene_has_materials(scene: SDFNode) -> bool:
    """True when any :class:`Shaded` node appears in the tree (static walk)."""
    if isinstance(scene, Shaded):
        return True
    for attr in ("child", "a", "b"):
        sub = getattr(scene, attr, None)
        if isinstance(sub, SDFNode) and scene_has_materials(sub):
            return True
    return False


def _bcast(mat: Material, shape) -> Material:
    """Broadcast a scalar material to per-point planes of ``shape``."""
    return Material(
        ambient=jnp.broadcast_to(mat.ambient, shape + (3,)),
        diffuse=jnp.broadcast_to(mat.diffuse, shape + (3,)),
        specular=jnp.broadcast_to(mat.specular, shape + (3,)),
        shininess=jnp.broadcast_to(mat.shininess, shape),
    )


def _select(cond, ma: Material, mb: Material) -> Material:
    c3 = cond[..., None]
    return Material(
        ambient=jnp.where(c3, ma.ambient, mb.ambient),
        diffuse=jnp.where(c3, ma.diffuse, mb.diffuse),
        specular=jnp.where(c3, ma.specular, mb.specular),
        shininess=jnp.where(cond, ma.shininess, mb.shininess),
    )


def _lerp(h, ma: Material, mb: Material) -> Material:
    """``h = 1`` → ``ma``; matches the smooth-min mix ``db + (da − db)·h``."""
    h3 = h[..., None]
    return Material(
        ambient=mb.ambient + (ma.ambient - mb.ambient) * h3,
        diffuse=mb.diffuse + (ma.diffuse - mb.diffuse) * h3,
        specular=mb.specular + (ma.specular - mb.specular) * h3,
        shininess=mb.shininess + (ma.shininess - mb.shininess) * h,
    )


def _smooth_h(da, db, k, sign):
    """The Quilez smooth-mix weight (csg._smooth_mix's ``h``)."""
    k = jnp.maximum(k, 1e-6)
    return jnp.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)


def _fold(node: SDFNode, p: jnp.ndarray, default: Material):
    """Return ``(distance, Material-of-planes)`` at points ``p`` (..., 3)."""
    shape = p.shape[:-1]
    if not scene_has_materials(node):
        return node.distance(p), _bcast(default, shape)

    if isinstance(node, Shaded):
        # The tag simply swaps the default for its subtree; nested Shaded
        # nodes deeper down override it again.
        return _fold(node.child, p, node.material)

    if isinstance(node, csg.Union):
        da, ma = _fold(node.a, p, default)
        db, mb = _fold(node.b, p, default)
        return jnp.minimum(da, db), _select(da <= db, ma, mb)
    if isinstance(node, csg.Intersection):
        da, ma = _fold(node.a, p, default)
        db, mb = _fold(node.b, p, default)
        return jnp.maximum(da, db), _select(da >= db, ma, mb)
    if isinstance(node, csg.Subtraction):
        # The carve reveals a's interior: material is always a's.
        da, ma = _fold(node.a, p, default)
        return jnp.maximum(da, -node.b.distance(p)), ma
    if isinstance(node, csg.SmoothUnion):
        da, ma = _fold(node.a, p, default)
        db, mb = _fold(node.b, p, default)
        h = _smooth_h(da, db, node.k, +1.0)
        return csg._smooth_mix(da, db, node.k, +1.0), _lerp(h, ma, mb)
    if isinstance(node, csg.SmoothIntersection):
        da, ma = _fold(node.a, p, default)
        db, mb = _fold(node.b, p, default)
        h = _smooth_h(da, db, node.k, -1.0)
        return csg._smooth_mix(da, db, node.k, -1.0), _lerp(h, ma, mb)
    if isinstance(node, csg.SmoothSubtraction):
        da, ma = _fold(node.a, p, default)
        return csg._smooth_mix(da, -node.b.distance(p), node.k, -1.0), ma

    if isinstance(node, transforms.Translate):
        return _fold(node.child, p - node.offset, default)
    if isinstance(node, transforms.Rotate):
        R = transforms.rotvec_to_matrix(node.rotvec)
        return _fold(node.child, mat_vec(R.T, p), default)
    if isinstance(node, transforms.Scale):
        s = jnp.maximum(node.factor, 1e-12)
        d, m = _fold(node.child, p / s, default)
        return d * s, m
    if isinstance(node, transforms.Round):
        d, m = _fold(node.child, p, default)
        return d - node.radius, m
    if isinstance(node, transforms.Onion):
        d, m = _fold(node.child, p, default)
        return jnp.abs(d) - node.thickness, m
    if isinstance(node, transforms.Elongate):
        q = p - jnp.clip(p, -node.amount, node.amount)
        return _fold(node.child, q, default)
    if isinstance(node, transforms.RepeatInfinite):
        period = node.period
        q = jnp.where(
            period > 0.0,
            p - period * jnp.round(p / jnp.where(period > 0.0, period, 1.0)),
            p,
        )
        return _fold(node.child, q, default)

    raise TypeError(
        f"material fold does not know node {type(node).__name__}; "
        "add a case in sdf3d_tpu/sdf/materials.py::_fold"
    )


def material_at(scene: SDFNode, p: jnp.ndarray, default: Material) -> Material:
    """Material governing each query point ``p`` of shape ``(..., 3)``.

    Returns a :class:`Material` whose leaves carry per-point planes
    (``(..., 3)`` colors, ``(...,)`` shininess) — the exact shape
    :func:`sdf3d_tpu.shade.blinn_phong` broadcasts over.  Differentiable
    w.r.t. every material and shape parameter in the tree.
    """
    _, m = _fold(scene, p, default)
    return m
