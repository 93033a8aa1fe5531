"""Lights and materials as differentiable pytrees.

The reference hard-codes one point light and one material in the fragment
shader (``/root/reference/Code/shader/voxel_fragment.frag:33-49,182-189``).
Here they are runtime pytree inputs, so lighting gradients flow in inverse
rendering.
"""

from __future__ import annotations

from sdf3d_tpu import pytree as struct
import jax.numpy as jnp

from sdf3d_tpu.sdf.node import as_f32


@struct.dataclass
class PointLight:
    """Point light (``voxel_fragment.frag:33-40``).

    Note: the reference sets ``light.col = (0.7, 0.7, 0.7)`` but never uses it
    in shading (``:183`` — set, no reads); we carry ``color`` for the extended
    shading mode and faithfully ignore it in parity mode.
    """

    position: jnp.ndarray  # (3,)
    color: jnp.ndarray  # (3,)
    ambient: jnp.ndarray  # ()


@struct.dataclass
class Material:
    """Blinn-Phong material (``voxel_fragment.frag:43-49``)."""

    ambient: jnp.ndarray  # (3,)
    diffuse: jnp.ndarray  # (3,)
    specular: jnp.ndarray  # (3,)
    shininess: jnp.ndarray  # ()


def point_light(position=(5.0, 5.0, 0.0), color=(0.7, 0.7, 0.7), ambient=0.1) -> PointLight:
    return PointLight(position=as_f32(position), color=as_f32(color), ambient=as_f32(ambient))


def material(ambient=(0.0, 0.2, 0.8), diffuse=(0.0, 0.2, 0.8), specular=(0.5, 0.5, 0.5), shininess=12.0) -> Material:
    return Material(
        ambient=as_f32(ambient),
        diffuse=as_f32(diffuse),
        specular=as_f32(specular),
        shininess=as_f32(shininess),
    )


def reference_light() -> PointLight:
    """The reference's light: pos (5,5,0), ambient 0.1 (``voxel_fragment.frag:182-184``)."""
    return point_light()


def reference_material() -> Material:
    """The reference's blue material (``voxel_fragment.frag:186-189``)."""
    return material()
