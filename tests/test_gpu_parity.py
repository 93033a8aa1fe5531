"""On-card validation of every Triton-compiled kernel against the oracles.

The interpret-mode parity suite (test_oracle_parity.py, test_pallas.py) runs
the *same block programs* on the CPU; this tier runs the kernels as Triton
compiles them for the GPU and pins them to the same golden images and
gradients.  Triton may use approximate division, so these tests state their
own budgets.

All tests carry ``@pytest.mark.gpu`` and skip, from inside the ``gpu``
fixture, where JAX finds no GPU.  On the card they run inside
``python chip_smoke.py`` (its last phase), in the process that already
holds the card — never as a second process beside it.

Reference math being pinned: ``voxel_fragment.frag:54-211`` via the NumPy
oracle (``oracle/numpy_oracle.py``) and the XLA renderer (itself oracle-
pinned at the parity profile by test_oracle_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu.oracle import render_reference_numpy

W, H = 192, 144

pytestmark = pytest.mark.gpu


def _pix_err(a, b):
    """Per-pixel max-channel abs error (H, W)."""
    return np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)


@pytest.fixture(scope="module")
def setup():
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = s.reference_scene()
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    return cam, light, mat, scene, cfg


@pytest.mark.parametrize("ray_sdf", [False, True])
def test_forward_kernel_vs_numpy_oracle_onchip(setup, gpu, ray_sdf):
    """Triton-compiled forward kernel == NumPy oracle golden image, parity
    profile, both scene-program forms.  Point form (``ray_sdf=False``) is the
    exact path; the ray form may flip a measure-zero set of razor-edge steps
    (render_kernel.py), so it gets a pixel budget."""
    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.ops.render_kernel import render_kernel_forward

    cam, light, mat, scene, cfg = setup
    golden = render_reference_numpy(W, H)
    with jax.default_device(gpu):
        pc = PallasRenderConfig(ray_sdf=ray_sdf)
        rgb, _, _, _ = render_kernel_forward(scene, cam, light, mat, cfg, pc)
        rgb = np.asarray(jax.device_get(rgb))
    err = _pix_err(rgb, golden)
    bad = int((err > 1e-3).sum())
    if ray_sdf:
        # Ray-form budget: ≤ 0.05% of pixels may sit on a flipped razor-edge
        # march step.
        assert bad <= W * H * 5e-4, f"{bad} px > 1e-3 (ray form)"
    else:
        assert bad == 0, f"{bad} px > 1e-3 (point form is the exact path)"
    assert float(err.mean()) < 1e-4


@pytest.mark.parametrize("ray_sdf", [False, True])
def test_forward_kernel_fast_profile_onchip(setup, gpu, ray_sdf):
    """Fast profile (tetrahedron normals + 32-step shadow cap) on the card ==
    the XLA renderer with the identical config (the XLA march/shade path is
    the CPU-validated reference for non-parity profiles)."""
    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.ops.render_kernel import render_kernel_forward

    cam, light, mat, scene, cfg = setup
    fcfg = s.fast_config(cfg)
    # Runs on CPU: conftest pins jax_default_device to cpu for the suite.
    ref = np.asarray(s.render(scene, cam, light, mat, fcfg))
    with jax.default_device(gpu):
        pc = PallasRenderConfig(ray_sdf=ray_sdf)
        rgb, _, _, _ = render_kernel_forward(scene, cam, light, mat, fcfg, pc)
        rgb = np.asarray(jax.device_get(rgb))
    err = _pix_err(rgb, ref)
    bad = int((err > 1e-3).sum())
    assert bad <= W * H * 5e-4, f"{bad} px > 1e-3 (fast profile, ray_sdf={ray_sdf})"
    assert float(err.mean()) < 1e-4


def test_fused_fit_grads_vs_xla_onchip(setup, gpu):
    """The single-launch fit kernel on the card: loss + scene gradients must
    match XLA ``value_and_grad`` through the differentiable renderer (the
    bench.py metric rests on exactly this kernel)."""
    import jax.flatten_util as fu

    from sdf3d_tpu.diff import render_diff
    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

    cam, light, mat, scene, cfg = setup
    # A target the scene does NOT match, so gradients are well away from 0.
    target = jnp.tile(
        jnp.asarray([0.25, 0.1, 0.4], jnp.float32), (cfg.height, cfg.width, 1)
    )
    fit_scene0 = s.sdf.union(
        s.sdf.ground_plane(), s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)
    )
    with jax.default_device(gpu):
        pc = PallasRenderConfig()
        loss_f, grads = l2_loss_and_grads(
            cfg, pc, fit_scene0, cam, light, mat, target, wrt_uniforms=False
        )

        def loss(sc):
            img = render_diff(sc, cam, light, mat, cfg)
            return jnp.sum((img - target) ** 2)

        loss_x, g_x = jax.value_and_grad(loss)(fit_scene0)
        a, _ = fu.ravel_pytree(grads[0])
        b, _ = fu.ravel_pytree(g_x)
        a, b = np.asarray(jax.device_get(a)), np.asarray(jax.device_get(b))
        loss_f = float(loss_f)
        loss_x = float(loss_x)
    assert loss_f == pytest.approx(loss_x, rel=1e-4)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * max(1.0, np.abs(b).max()))


def test_multiview_kernel_vs_per_view_sum_onchip(setup, gpu):
    """The view-axis-grid multiview kernel on the card == the sum of
    per-view single-launch fit kernels (same kernel, V=1)."""
    import jax.flatten_util as fu

    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads, multiview_loss_and_grads

    _, light, mat, scene, cfg = setup
    cams = [s.Camera.orbit(azimuth_deg=a, radius=2.0) for a in (0.0, 90.0, 210.0)]
    rng = np.random.default_rng(5)
    targets = [
        jnp.asarray(rng.uniform(0, 1, (cfg.height, cfg.width, 3)), jnp.float32)
        for _ in cams
    ]
    with jax.default_device(gpu):
        pc = PallasRenderConfig()
        loss_mv, (g_mv, _, _, _) = multiview_loss_and_grads(
            cfg, pc, scene, cams, light, mat, targets, wrt_uniforms=False
        )
        loss_sum = 0.0
        g_sum = None
        for cam, tgt in zip(cams, targets):
            l, (g, _, _, _) = l2_loss_and_grads(
                cfg, pc, scene, cam, light, mat, tgt, wrt_uniforms=False
            )
            loss_sum += float(l)
            g_sum = g if g_sum is None else jax.tree_util.tree_map(jnp.add, g_sum, g)
        a, _ = fu.ravel_pytree(g_mv)
        b, _ = fu.ravel_pytree(g_sum)
        a, b = np.asarray(jax.device_get(a)), np.asarray(jax.device_get(b))
        loss_mv = float(loss_mv)
    assert loss_mv == pytest.approx(loss_sum, rel=1e-5)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))


@pytest.mark.slow
def test_1080p_ray_form_parity_budget_onchip(setup, gpu):
    """The documented ray-form deviation is a *regression budget*, not a
    docstring: at 1080p the ray-parameterized kernel may differ from the
    exact point form on ≤ 8 of 2M pixels by > 1e-4 (render_kernel.py) — a
    Triton lowering change that widens this shows up here first."""
    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.ops.render_kernel import render_kernel_forward

    cam, light, mat, scene, _ = setup
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=1920, height=1080)
    with jax.default_device(gpu):
        imgs = {}
        for ray_sdf in (False, True):
            pc = PallasRenderConfig(ray_sdf=ray_sdf)
            rgb, _, _, _ = render_kernel_forward(scene, cam, light, mat, cfg, pc)
            imgs[ray_sdf] = np.asarray(jax.device_get(rgb))
    err = _pix_err(imgs[True], imgs[False])
    bad = int((err > 1e-4).sum())
    print(f"1080p ray form vs point form: {bad} px > 1e-4, max {float(err.max()):.3g}")
    assert bad <= 8, f"ray-form deviation budget exceeded: {bad} px > 1e-4"
