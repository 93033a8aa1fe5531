"""Mandelbulb fractal SDF (sdf/primitives.py::Mandelbulb): the
eval-dominated model family.  No reference counterpart (capability add);
the trig-free power-8 distance estimator must be sphere-trace safe
(1-Lipschitz), render identically through XLA and the fused kernel, and
stay differentiable end-to-end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig, default_pallas_config, render_pallas
from sdf3d_tpu.sdf import mandelbulb

CAM, LIGHT, MAT = s.Camera.reference(), s.reference_light(), s.reference_material()


class TestMandelbulbDE:
    def test_sign_and_far_field(self):
        mb = mandelbulb(scale=1.0)
        inside = np.asarray(mb.distance(jnp.array([[0.0, 0.0, 0.0], [0.4, 0.0, 0.0]])))
        assert (inside <= 0.0).all()
        far = np.asarray(mb.distance(jnp.array([[0.0, 0.0, 5.0], [3.0, 3.0, 3.0]])))
        assert (far > 0.0).all()
        # Far field rides the exact bounding-sphere bound (|q| - 1.2).
        assert far[0] == pytest.approx(5.0 - 1.2, abs=1e-5)

    def test_lipschitz_safe(self):
        """The raw escape-time estimate overshoots (measured worst secant
        ratio 1.39); the shipped 0.5x + bounding-sphere max must pass the
        statistical 1-Lipschitz check that gates sphere-trace safety."""
        from sdf3d_tpu.debug import check_lipschitz

        ok, worst = check_lipschitz(s.fractal_scene())
        assert ok, f"worst secant ratio {worst}"

    def test_scale_center_semantics(self):
        mb = mandelbulb(center=(1.0, 2.0, 3.0), scale=0.5)
        ref = mandelbulb(scale=1.0)
        p = jnp.array([[1.3, 2.1, 3.4], [1.0, 2.9, 3.0]])
        q = (p - jnp.array([1.0, 2.0, 3.0])) / 0.5
        np.testing.assert_allclose(
            np.asarray(mb.distance(p)), 0.5 * np.asarray(ref.distance(q)), rtol=1e-5
        )

    def test_gradients_flow_and_finite(self):
        pts = jnp.array([[0.8, 0.3, 0.2], [0.0, 1.5, 0.0], [2.0, 0.0, 0.5]])
        g = jax.grad(lambda mb: jnp.sum(mb.distance(pts)))(mandelbulb(scale=0.8))
        flat = np.concatenate([np.ravel(np.asarray(g.center)), [float(g.scale)]])
        assert np.isfinite(flat).all() and np.abs(flat).max() > 0.0

    def test_iterations_static_field(self):
        mb = mandelbulb(iterations=4)
        leaves = jax.tree_util.tree_leaves(mb)
        assert len(leaves) == 2  # center, scale — iterations is aux, not a param
        assert mb.iterations == 4


class TestFractalRender:
    @pytest.mark.slow
    def test_kernel_matches_xla(self):
        """Same `_mandelbulb_de` core in both paths; residual delta is march
        order-of-ops in f32 amplified at fractal silhouettes."""
        cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=128, height=96)
        pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
        a = np.asarray(s.render(s.fractal_scene(), CAM, LIGHT, MAT, cfg))
        b = np.asarray(render_pallas(cfg, pc, s.fractal_scene(), CAM, LIGHT, MAT))
        assert np.max(np.abs(a - b)) < 2e-2
        assert np.mean(np.abs(a - b)) < 1e-3

    def test_renders_structure(self):
        cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=96, height=72)
        d = np.asarray(s.render_depth(s.fractal_scene(), CAM, cfg))
        hit = d[:48] < 2.5  # bulb rows (above the plane horizon)
        assert 200 < hit.sum() < 48 * 96  # a real blob, not empty/everything

    def test_scene_io_roundtrip(self):
        from sdf3d_tpu.sdf.io import scene_from_json, scene_to_json

        mb = mandelbulb(center=(0.1, 0.2, 0.3), scale=0.7, iterations=5)
        back = scene_from_json(scene_to_json(mb))
        assert back.iterations == 5
        p = jnp.array([[0.5, 0.6, 0.7]])
        np.testing.assert_allclose(
            np.asarray(mb.distance(p)), np.asarray(back.distance(p)), rtol=1e-6
        )


class TestFractalFit:
    def test_default_pallas_config_raises_vmem(self):
        """Scene-aware defaults: fractal scenes get the heavy-scene kernel
        config (smaller blocks, no unrolled march steps — the fit kernel's
        AD section must fit the register file); cheap scenes keep the
        plain defaults."""
        from sdf3d_tpu.ops import default_pallas_config
        from sdf3d_tpu.ops.render_kernel import HEAVY_SCENE_CONFIG

        heavy = default_pallas_config(s.fractal_scene())
        assert {k: getattr(heavy, k) for k in HEAVY_SCENE_CONFIG} == HEAVY_SCENE_CONFIG
        assert default_pallas_config(s.reference_scene()) == PallasRenderConfig()
        # An explicit override always wins.
        assert default_pallas_config(s.fractal_scene(), tile_h=16).tile_h == 16

    def test_fused_fit_eligible(self):
        """The fractal scene is eligible for the single-launch fused fit
        kernel (its emitter compiles).  Grad parity itself runs on the card
        below: the fractal's AD section makes the interpret-mode kernel
        pathologically slow on CPU."""
        from sdf3d_tpu.ops.fit_kernel import fused_l2_eligible

        assert fused_l2_eligible(s.REFERENCE_CONFIG, s.fractal_scene())

    @pytest.mark.slow
    def test_xla_fit_grads_finite(self):
        """CPU-runnable stand-in: XLA-path fit grads of the fractal scene
        are finite and nonzero at a small resolution."""
        from sdf3d_tpu.diff import render_diff

        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG,
            width=48,
            height=32,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=24),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, max_steps=12),
        )
        scene = s.fractal_scene(iterations=4)
        target = jnp.zeros((32, 48, 3), jnp.float32)

        def loss(sc):
            img = render_diff(sc, CAM, LIGHT, MAT, cfg)
            return jnp.sum((img - target) ** 2)

        import jax.flatten_util as fu

        _, g = jax.value_and_grad(loss)(scene)
        flat, _ = fu.ravel_pytree(g)
        flat = np.asarray(flat)
        assert np.isfinite(flat).all() and np.abs(flat).max() > 0.0

    @pytest.mark.slow
    def test_scale_recovery(self):
        """Inverse rendering on the fractal: recover a perturbed bulb scale
        from the target image (plane + center frozen via the trainable
        mask).  Free-form shape recovery on the eval-dominated family."""
        from sdf3d_tpu.fit import FitConfig, fit_scene

        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG,
            width=48,
            height=36,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=24),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
        )
        true_scene = s.fractal_scene(iterations=4)
        target = s.render(true_scene, CAM, LIGHT, MAT, cfg)
        bulb0 = dataclasses.replace(true_scene.b, scale=jnp.float32(0.52))
        scene0 = dataclasses.replace(true_scene, b=bulb0)
        trainable = jax.tree_util.tree_map(lambda _: False, scene0)
        trainable = dataclasses.replace(
            trainable, b=dataclasses.replace(trainable.b, scale=True)
        )
        result = fit_scene(
            target, scene0, CAM, LIGHT, MAT, cfg,
            FitConfig(steps=60, learning_rate=5e-3, log_every=1000),
            trainable=trainable,
        )
        assert float(result.scene.b.scale) == pytest.approx(0.45, abs=0.01)
        assert result.losses[-1] < 0.2 * result.losses[0]

    @pytest.mark.gpu
    def test_fused_grads_match_xla_on_gpu(self, gpu):
        """Single-launch fused fit grads == XLA value_and_grad on the card
        (the fractal's AD section is the largest of any scene, so register
        pressure is worst here)."""
        from sdf3d_tpu.diff import render_diff
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        with jax.default_device(gpu):
            cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=128, height=96)
            scene = s.fractal_scene(iterations=4)
            pc = default_pallas_config(scene)
            target = jnp.zeros((96, 128, 3), jnp.float32)
            loss_f, grads = l2_loss_and_grads(
                cfg, pc, scene, CAM, LIGHT, MAT, target, wrt_uniforms=False
            )

            def loss(sc):
                img = render_diff(sc, CAM, LIGHT, MAT, cfg)
                return jnp.sum((img - target) ** 2)

            loss_x, g_x = jax.value_and_grad(loss)(scene)
            import jax.flatten_util as fu

            a, _ = fu.ravel_pytree(grads[0])
            b, _ = fu.ravel_pytree(g_x)
            assert float(loss_f) == pytest.approx(float(loss_x), rel=1e-4)
            # rtol: fractal-silhouette pixels whose march step count flips
            # between the two pipelines carry O(1) grad deltas.
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-2, atol=1e-2
            )
