"""Dense voxel-grid SDF: a free-form, fittable shape representation.

The reference is named "SDF3D" and renders *analytic* fields only
(``/root/reference/Code/shader/voxel_fragment.frag:54-81``); this module adds
the voxel model family the name suggests: a regular grid of SDF samples,
trilinearly interpolated, with every sample a differentiable parameter.
That turns inverse rendering (fit.py) into free-form shape recovery — the
grid is the classic discrete precursor of neural SDFs, and its evaluation
is a fully vectorized gather + lerp chain.

Design notes:

- ``values`` is ``(Nz, Ny, Nx)`` indexed ``[z, y, x]``; sample ``[0,0,0]``
  sits at ``origin`` and neighbors are ``spacing`` apart.
- Inside the sample box the field is the trilinear interpolation of the 8
  surrounding samples — C0, exact at samples, and a valid *lower-bound-ish*
  marching field as long as the sampled function was 1-Lipschitz (trilinear
  interpolation of a 1-Lipschitz function stays 1-Lipschitz in each cell up
  to the usual O(spacing) sampling error; sphere tracing with ``epsilon ≥
  spacing/2`` is safe in practice — validated by the parity test vs the
  analytic scene).
- Outside the box the clamped boundary sample is *added to* the Euclidean
  distance to the box, so far-away rays march at full speed and the field
  stays continuous across the boundary.
- The XLA render/diff/sharded paths support grids end-to-end (gather is
  native XLA).  The fused Pallas kernel does **not** — its scene compiler
  emits elementwise code over scalar parameters and has no 3-D indexed
  load — so ``compile_scene`` raises its standard "no Pallas emitter"
  error for grid scenes, and ``render_pallas`` delegates them to the
  banded XLA path.
"""

from __future__ import annotations

from sdf3d_tpu import pytree as struct
import jax.numpy as jnp

from sdf3d_tpu.sdf.node import SDFNode, as_f32, vlength_safe


@struct.dataclass
class VoxelGrid(SDFNode):
    """Trilinearly interpolated SDF sample grid (all samples differentiable)."""

    values: jnp.ndarray  # (Nz, Ny, Nx) SDF samples at grid nodes
    origin: jnp.ndarray  # (3,) world position (x, y, z) of sample [0, 0, 0]
    spacing: jnp.ndarray  # () node-to-node distance (uniform)

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        nz, ny, nx = self.values.shape
        spacing = jnp.maximum(self.spacing, 1e-12)
        u = (p - self.origin) / spacing  # (..., 3) in sample coordinates (x, y, z)

        # Cell index + fraction, clamped so the boundary cell extrapolates
        # flatly (the exterior term below carries the real far-field).
        dims = jnp.asarray([nx, ny, nz], jnp.float32)
        uc = jnp.clip(u, 0.0, dims - 1.0)
        i0 = jnp.clip(jnp.floor(uc), 0.0, dims - 2.0)
        f = jnp.clip(uc - i0, 0.0, 1.0)
        ix, iy, iz = (i0[..., k].astype(jnp.int32) for k in range(3))
        fx, fy, fz = (f[..., k] for k in range(3))

        def at(dz, dy, dx):
            return self.values[iz + dz, iy + dy, ix + dx]

        c00 = at(0, 0, 0) * (1 - fx) + at(0, 0, 1) * fx
        c01 = at(0, 1, 0) * (1 - fx) + at(0, 1, 1) * fx
        c10 = at(1, 0, 0) * (1 - fx) + at(1, 0, 1) * fx
        c11 = at(1, 1, 0) * (1 - fx) + at(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        inside = c0 * (1 - fz) + c1 * fz

        # Exterior: Euclidean distance to the sample box, added to the
        # clamped boundary sample (continuous at the boundary, full-speed
        # marching far away).
        lo = self.origin
        hi = self.origin + spacing * (dims - 1.0)
        q = jnp.maximum(jnp.maximum(lo - p, p - hi), 0.0)
        return inside + vlength_safe(q)


def voxel_grid(values, origin=(-1.0, -1.0, -1.0), spacing=None, extent=None) -> VoxelGrid:
    """Build a :class:`VoxelGrid` from raw samples.

    Give either ``spacing`` (node distance) or ``extent`` (world size of the
    whole box per axis — scalar means cubic); defaults to extent 2.0.
    """
    values = as_f32(values)
    if values.ndim != 3:
        raise ValueError(f"values must be (Nz, Ny, Nx), got shape {values.shape}")
    if spacing is None:
        if extent is None:
            extent = 2.0
        n_max = max(values.shape) - 1
        spacing = float(extent) / max(n_max, 1)
    return VoxelGrid(values=values, origin=as_f32(origin), spacing=as_f32(spacing))


def voxelize(scene: SDFNode, resolution: int = 64, lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0)) -> VoxelGrid:
    """Bake any scene into a :class:`VoxelGrid` by sampling ``scene.distance``
    on a regular ``resolution³`` node grid over the box ``[lo, hi]``.

    The classic use: author with analytic CSG, bake, then *fit* the baked
    grid freely (every sample is now an independent parameter).
    """
    lo = as_f32(lo)
    hi = as_f32(hi)
    n = int(resolution)
    if n < 2:
        raise ValueError("resolution must be >= 2")
    xs = jnp.linspace(lo[0], hi[0], n)
    ys = jnp.linspace(lo[1], hi[1], n)
    zs = jnp.linspace(lo[2], hi[2], n)
    # points[z, y, x] — matches the (Nz, Ny, Nx) storage order.
    pz, py, px = jnp.meshgrid(zs, ys, xs, indexing="ij")
    pts = jnp.stack([px, py, pz], axis=-1)
    values = scene.distance(pts)
    import numpy as _np

    spans = _np.asarray(hi) - _np.asarray(lo)
    if not _np.allclose(spans, spans[0]):
        raise ValueError(
            f"voxelize needs a cubic box (uniform spacing), got spans {spans}; "
            "use different resolutions per axis via voxel_grid() directly"
        )
    spacing = (hi[0] - lo[0]) / (n - 1)
    return VoxelGrid(values=values, origin=lo, spacing=as_f32(spacing))
