"""Pinhole camera and ray-bundle generation.

The reference generates rays per fragment
(``/root/reference/Code/shader/voxel_fragment.frag:177-192``): a billboard quad
UV ∈ [−1,1]² (``voxel_geometry.geom:32-49``) becomes
``ray = normalize(quad.x·AR, quad.y, −2/tan(fov·π/360))``, and the arcball view
matrix is applied *inversely* to both camera position (as a point) and ray (as
a direction).  Here the pixel grid **is** the output array's index space — rays
are generated vectorized over (H, W) — and the camera pose is a differentiable
pytree (position + camera-to-world rotation), so pose gradients for inverse
rendering come for free.
"""

from __future__ import annotations

import math

from sdf3d_tpu import pytree as struct
import jax.numpy as jnp

from sdf3d_tpu.sdf.node import as_f32, mat_vec, vnormalize
from sdf3d_tpu.sdf.transforms import rotvec_to_matrix

#: The reference app's base eye position (``voxel_fragment.frag:178-179``) —
#: the single source of truth shared by Camera.reference/from_view_matrix and
#: the host-side numpy pose math in interact/app.py.
REFERENCE_BASE_POSITION = (0.0, 0.2, 2.0)


@struct.dataclass
class Camera:
    """Differentiable pinhole camera.

    ``position``: world-space eye, shape (3,).
    ``c2w``: camera-to-world rotation, shape (3,3) (rows/cols orthonormal).
    ``fov_deg``: nominal vertical field of view in degrees, shape ().

    The reference's defaults are eye (0, 0.2, 2), fov 60°
    (``voxel_fragment.frag:178-179``) with ``c2w = inverse(V_mat)[:3,:3]``.
    """

    position: jnp.ndarray
    c2w: jnp.ndarray
    fov_deg: jnp.ndarray

    @staticmethod
    def reference(view_matrix=None) -> "Camera":
        """The reference app's camera (``voxel_fragment.frag:178-180``).

        ``view_matrix`` is the 4×4 arcball view matrix ``V_mat`` (identity at
        startup: orbit/pan init all zero, ``main.cpp:7-11``); both eye and ray
        directions are transformed by its inverse, exactly as the shader does.
        """
        base_pos = jnp.asarray(REFERENCE_BASE_POSITION, dtype=jnp.float32)
        if view_matrix is None:
            return Camera(
                position=base_pos,
                c2w=jnp.eye(3, dtype=jnp.float32),
                fov_deg=jnp.float32(60.0),
            )
        return Camera.from_view_matrix(view_matrix, base_position=base_pos, fov_deg=60.0)

    @staticmethod
    def from_view_matrix(view_matrix, base_position=None, fov_deg=60.0) -> "Camera":
        """Build from a 4×4 view matrix, applying ``inverse(V_mat)`` to the
        base eye (point) and keeping its rotation block for directions —
        mirrors ``voxel_fragment.frag:180,192``."""
        V = as_f32(view_matrix)
        Vinv = jnp.linalg.inv(V)
        base = as_f32(REFERENCE_BASE_POSITION if base_position is None else base_position)
        pos = mat_vec(Vinv, jnp.append(base, 1.0))[:3]
        return Camera(position=pos, c2w=Vinv[:3, :3], fov_deg=as_f32(fov_deg))

    @staticmethod
    def orbit(azimuth_deg=0.0, elevation_deg=0.0, radius=2.0, target=(0.0, 0.2, 0.0), fov_deg=60.0) -> "Camera":
        """Arcball-style orbit camera: the replacement for the
        reference's interactive mouse/gamepad navigation
        (``main.cpp:93-94``) — pose is an explicit, differentiable input
        instead of accumulated mouse state."""
        az = math.radians(azimuth_deg)
        el = math.radians(elevation_deg)
        # Eye on the sphere of given radius around target.
        eye_dir = jnp.array(
            [
                math.cos(el) * math.sin(az),
                math.sin(el),
                math.cos(el) * math.cos(az),
            ],
            dtype=jnp.float32,
        )
        target = as_f32(target)
        position = target + radius * eye_dir
        return Camera.look_at(position, target, fov_deg=fov_deg)

    @staticmethod
    def look_at(position, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fov_deg=60.0) -> "Camera":
        """Camera at ``position`` looking toward ``target`` (−z forward)."""
        position = as_f32(position)
        target = as_f32(target)
        up = as_f32(up)
        forward = vnormalize(target - position)  # camera -z
        right = vnormalize(jnp.cross(forward, up))
        true_up = jnp.cross(right, forward)
        # Columns are the camera axes expressed in world space.
        c2w = jnp.stack([right, true_up, -forward], axis=-1)
        return Camera(position=position, c2w=c2w, fov_deg=as_f32(fov_deg))

    @staticmethod
    def from_pose(position, rotvec=(0.0, 0.0, 0.0), fov_deg=60.0) -> "Camera":
        """Pose from position + axis-angle rotation (differentiable in both)."""
        return Camera(
            position=as_f32(position),
            c2w=rotvec_to_matrix(as_f32(rotvec)),
            fov_deg=as_f32(fov_deg),
        )


def pixel_grid(width: int, height: int, dtype=jnp.float32):
    """NDC coordinates of every pixel center, row 0 at the *top*.

    Mirrors GL fragment interpolation of the fullscreen quad's UV
    (``voxel_geometry.geom:32-49``): fragment (x+½, y+½) with GL's
    bottom-left origin interpolates to ``quad = (2(x+½)/W−1, 2(y+½)/H−1)``;
    flipping y gives image-row order.  Returns ``(qx, qy)`` each of shape
    (H, W).
    """
    xs = (2.0 * (jnp.arange(width, dtype=dtype) + 0.5) / width) - 1.0
    ys = 1.0 - (2.0 * (jnp.arange(height, dtype=dtype) + 0.5) / height)
    qx = jnp.broadcast_to(xs[None, :], (height, width))
    qy = jnp.broadcast_to(ys[:, None], (height, width))
    return qx, qy


def focal_z(fov_deg: jnp.ndarray, ray_mode: str) -> jnp.ndarray:
    """The (negative) z-component of the unnormalized camera-frame ray.

    ``"reference"`` replicates ``-2/tan(fov·π/360)``
    (``voxel_fragment.frag:191`` — note the factor 2, which halves the
    effective FOV); ``"pinhole"`` is the standard ``-1/tan(fov/2)``.
    """
    half_angle = fov_deg * (jnp.pi / 360.0)
    scale = {"reference": 2.0, "pinhole": 1.0}[ray_mode]
    return -scale / jnp.tan(half_angle)


def generate_rays(camera: Camera, qx: jnp.ndarray, qy: jnp.ndarray, aspect_ratio: float, ray_mode: str = "reference"):
    """Ray directions for NDC coords ``(qx, qy)`` (any broadcastable shape).

    Camera-frame direction ``normalize(qx·AR, qy, focal_z)`` rotated to world
    by ``c2w`` and re-normalized — both normalizations kept to match
    ``voxel_fragment.frag:191-192`` bit-for-bit (the second is a no-op up to
    rounding, but parity is the point).  Returns directions of shape
    ``qx.shape + (3,)``.
    """
    z = jnp.broadcast_to(focal_z(camera.fov_deg, ray_mode), qx.shape)
    cam_dir = vnormalize(jnp.stack([qx * aspect_ratio, qy, z], axis=-1))
    world_dir = mat_vec(camera.c2w, cam_dir)
    return vnormalize(world_dir)


def camera_rays(camera: Camera, width: int, height: int, ray_mode: str = "reference"):
    """Full-image ray bundle: returns (origins, directions) of shape (H, W, 3).

    Origins broadcast the eye; directions come from :func:`generate_rays` over
    the pixel grid with ``AR = W/H``.
    """
    qx, qy = pixel_grid(width, height)
    directions = generate_rays(camera, qx, qy, width / height, ray_mode)
    origins = jnp.broadcast_to(camera.position, directions.shape)
    return origins, directions


def camera_rays_for_rows(camera: Camera, width: int, height: int, rows, ray_mode: str = "reference"):
    """Ray bundle for a *subset* of absolute image rows: (R, W, 3) arrays.

    ``rows`` is a sequence/array of absolute row indices into the full
    ``height``-row image (need not be contiguous — interleaved row-block
    sharding passes its permuted layout directly).  Row ``rows[k]`` of the
    result is bitwise-identical to row ``rows[k]`` of :func:`camera_rays`:
    the NDC mapping always uses the full image extent.  This is the
    multi-host building block (parallel/launch.py): each process generates
    only the rays its local devices march, never the full-image bundle.
    """
    rows = jnp.asarray(rows, jnp.float32)
    xs = (2.0 * (jnp.arange(width, dtype=jnp.float32) + 0.5) / width) - 1.0
    ys = 1.0 - (2.0 * (rows + 0.5) / height)
    r = rows.shape[0]
    qx = jnp.broadcast_to(xs[None, :], (r, width))
    qy = jnp.broadcast_to(ys[:, None], (r, width))
    directions = generate_rays(camera, qx, qy, width / height, ray_mode)
    origins = jnp.broadcast_to(camera.position, directions.shape)
    return origins, directions
