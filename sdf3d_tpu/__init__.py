"""sdf3d-tpu: a differentiable signed-distance-field renderer for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
SDF renderer at ``/root/reference`` (ezorzin/SDF3D) — analytic SDF scenes with
CSG, sphere-trace rendering with soft shadows and Blinn-Phong shading —
extended with the capabilities the reference lacks: end-to-end
differentiability (implicit-function gradients through the march), fused
Pallas (Triton) kernels, multi-device tile sharding over a mesh, and inverse
rendering.
"""

from sdf3d_tpu import sdf
from sdf3d_tpu.camera import Camera, camera_rays, generate_rays, pixel_grid
from sdf3d_tpu.config import (
    AOConfig,
    MarchConfig,
    REFERENCE_CONFIG,
    RenderConfig,
    ShadowConfig,
    fast_config,
)
from sdf3d_tpu.lighting import (
    Material,
    PointLight,
    material,
    point_light,
    reference_light,
    reference_material,
)
from sdf3d_tpu.march import (
    ambient_occlusion,
    estimate_normals,
    hit_mask,
    normal_autodiff,
    normal_central,
    normal_tetrahedron,
    soft_shadow,
    sphere_trace,
)
from sdf3d_tpu.diff import (
    coverage,
    depth_implicit,
    ray_min_sdf_diff,
    render_diff,
    render_rays_diff,
    sphere_trace_implicit,
)
from sdf3d_tpu.render import render, render_aa, render_banded, render_batch, render_depth, render_rays, shade_pixels
from sdf3d_tpu.stereo import render_stereo, stereo_cameras
from sdf3d_tpu.scenes import (
    capsule_chain,
    csg_showcase,
    flagship_scene,
    fractal_scene,
    lattice_scene,
    materials_scene,
    random_blobs,
    reference_scene,
    sphere_scene,
)
from sdf3d_tpu.fit import (
    FitConfig,
    FitResult,
    ViewFitResult,
    fit_scene,
    fit_scene_multiview,
    fit_view,
)
from sdf3d_tpu.checkpoint import load_checkpoint, save_checkpoint

__version__ = "0.1.0"

__all__ = [
    "sdf",
    "Camera", "camera_rays", "generate_rays", "pixel_grid",
    "AOConfig", "MarchConfig", "REFERENCE_CONFIG", "RenderConfig", "ShadowConfig", "fast_config",
    "Material", "PointLight", "material", "point_light",
    "reference_light", "reference_material",
    "ambient_occlusion", "estimate_normals", "hit_mask", "normal_autodiff",
    "normal_central", "normal_tetrahedron", "soft_shadow", "sphere_trace",
    "coverage", "depth_implicit", "ray_min_sdf_diff",
    "render_diff", "render_rays_diff", "sphere_trace_implicit",
    "render", "render_aa", "render_banded", "render_batch", "render_depth", "render_rays", "shade_pixels",
    "render_stereo", "stereo_cameras",
    "capsule_chain", "csg_showcase", "flagship_scene", "fractal_scene", "lattice_scene",
    "materials_scene", "random_blobs", "reference_scene", "sphere_scene",
    "FitConfig", "FitResult", "ViewFitResult", "fit_scene", "fit_scene_multiview", "fit_view",
    "load_checkpoint", "save_checkpoint",
    "__version__",
]
