"""The Triton-route forward kernel in interpret mode against XLA ``render``:
every scene family in both scene-program forms, and image sizes that do
not divide into whole tiles (the wrapper pads and crops)."""

import dataclasses

import jax
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.render_kernel import render_kernel_forward

CAM = s.Camera.reference()
LIGHT, MAT = s.reference_light(), s.reference_material()
CFG = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=32)

SCENES = {
    "reference": s.reference_scene,
    "sphere": s.sphere_scene,
    "flagship": s.flagship_scene,
    "csg_showcase": s.csg_showcase,
    "materials": s.materials_scene,
    "lattice": s.lattice_scene,
    "capsule_chain": s.capsule_chain,
    "fractal": lambda: s.fractal_scene(iterations=3),
}


def _compare(kernel_rgb, ref_rgb, edge_px: int = 2):
    """All but ``edge_px`` silhouette pixels (a march that ends one step
    apart) agree to 1e-3; none is off by more than the shading range."""
    err = np.abs(np.asarray(kernel_rgb) - np.asarray(ref_rgb)).max(axis=-1)
    assert np.all(np.isfinite(np.asarray(kernel_rgb)))
    assert int((err > 1e-3).sum()) <= edge_px, f"{int((err > 1e-3).sum())} px > 1e-3"
    assert float(err.mean()) < 1e-3


@pytest.mark.parametrize("ray_sdf", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_forward_kernel_matches_xla(name, ray_sdf):
    scene = SCENES[name]()
    cam = s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, radius=2.5) if name == "lattice" else CAM
    pc = PallasRenderConfig(interpret=True, ray_sdf=ray_sdf)
    rgb, t, sh, ao = render_kernel_forward(scene, cam, LIGHT, MAT, CFG, pc)
    assert rgb.shape == (CFG.height, CFG.width, 3)
    assert t.shape == sh.shape == ao.shape == (CFG.height, CFG.width)
    _compare(rgb, s.render(scene, cam, LIGHT, MAT, CFG))


@pytest.mark.parametrize("hw", [(19, 37), (9, 50), (33, 33)])
def test_forward_kernel_pads_odd_sizes(hw):
    """Heights/widths that are not multiples of the default (8, 64) tile: the grid
    covers the padded image and the wrapper crops back to (H, W)."""
    h, w = hw
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=w, height=h)
    pc = PallasRenderConfig(interpret=True, ray_sdf=False)
    rgb, t, _, _ = render_kernel_forward(s.reference_scene(), CAM, LIGHT, MAT, cfg, pc)
    assert rgb.shape == (h, w, 3) and t.shape == (h, w)
    _compare(rgb, s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg), edge_px=0)


@pytest.mark.parametrize("tile", [(8, 12), (6, 32), (0, 32)])
def test_tile_must_be_power_of_two(tile):
    with pytest.raises(ValueError, match="powers of two"):
        PallasRenderConfig(tile_h=tile[0], tile_w=tile[1])


def test_forward_is_one_triton_call():
    """The forward lowers to exactly one Triton kernel for CUDA — checked by
    lowering on this host, where no GPU is needed to build the Triton IR."""
    pc = PallasRenderConfig()
    fn = jax.jit(lambda sc: render_kernel_forward(sc, CAM, LIGHT, MAT, CFG, pc)[0])
    text = fn.trace(s.reference_scene()).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
