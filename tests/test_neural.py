"""Neural SDF family: geometric init, distillation, rendering, image fit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import sdf3d_tpu as s
from sdf3d_tpu import sdf
from sdf3d_tpu.sdf import NeuralSDF, distill, neural_sdf


class TestInit:
    def test_geometric_init_approximates_sphere(self):
        m = neural_sdf(key=0, hidden=64, depth=3, radius=0.5)
        rng = np.random.default_rng(1)
        pts = jnp.asarray(rng.uniform(-1, 1, (512, 3)), jnp.float32)
        d_m = np.asarray(m.distance(pts))
        d_s = np.asarray(jnp.linalg.norm(pts, axis=-1) - 0.5)
        # Init is approximate — what matters is sign agreement away from the
        # surface and a usable magnitude for marching.
        away = np.abs(d_s) > 0.15
        assert np.mean(np.sign(d_m[away]) == np.sign(d_s[away])) > 0.9
        assert np.mean(np.abs(d_m - d_s)) < 0.35

    def test_batched_shapes_and_grad(self):
        m = neural_sdf(key=0, hidden=16, depth=2)
        pts = jnp.zeros((4, 5, 3))
        assert m.distance(pts).shape == (4, 5)
        g = jax.grad(lambda mm: jnp.sum(mm.distance(pts)))(m)
        assert any(float(jnp.sum(jnp.abs(w))) > 0 for w in g.weights)

    def test_depth_validation(self):
        import pytest

        with pytest.raises(ValueError):
            neural_sdf(depth=1)


class TestDistill:
    def test_distill_sphere_accurate_near_surface(self):
        target = sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
        m0 = neural_sdf(key=0, hidden=64, depth=3, radius=0.3)
        # Recenter via distillation box around the target.
        m, losses = distill(
            m0, target, key=1, steps=300, batch=2048,
            lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6),
        )
        assert losses[-1] < losses[0] * 0.2
        rng = np.random.default_rng(2)
        pts = jnp.asarray(rng.uniform(-0.4, 0.4, (512, 3)), jnp.float32) + jnp.array([0, 0.4, 0])
        err = np.abs(np.asarray(m.distance(pts)) - np.asarray(target.distance(pts)))
        assert np.mean(err) < 0.02

    def test_distilled_renders_like_analytic(self):
        target = sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
        m0 = neural_sdf(key=0, hidden=64, depth=3, radius=0.3)
        m, _ = distill(
            m0, target, key=1, steps=400, batch=2048,
            lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6),
        )
        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG, width=64, height=48,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=64),
        )
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        img_n = np.asarray(s.render(sdf.ground_plane() | m, cam, light, mat, cfg))
        img_a = np.asarray(s.render(sdf.ground_plane() | target, cam, light, mat, cfg))
        # The neural surface sits within a couple epsilon of the analytic one;
        # most pixels must agree closely.
        assert np.mean(np.abs(img_n - img_a).max(-1) > 0.1) < 0.05


class TestImageFit:
    def test_neural_scene_fits_from_images(self):
        # fit_scene treats the MLP like any scene pytree: a few steps of
        # image-space fine-tuning must reduce the loss.
        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG, width=48, height=36,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=48),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
        )
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        target_scene = sdf.sphere(center=(0.05, 0.42, 0.0), radius=0.23)
        target = s.render(target_scene, cam, light, mat, cfg)

        m0, _ = distill(
            neural_sdf(key=0, hidden=32, depth=3, radius=0.3),
            sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2),
            key=1, steps=150, batch=1024,
            lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6),
        )
        from sdf3d_tpu.fit import FitConfig, fit_scene

        result = fit_scene(
            target, m0, cam, light, mat, cfg,
            FitConfig(steps=10, learning_rate=1e-4, log_every=5),
        )
        assert result.losses[-1] < result.losses[0]
        assert isinstance(result.scene, NeuralSDF)


class TestShardedNeuralFit:
    """Neural scenes × the distributed layer (round-5 VERDICT item 4): the
    sharded fit runs the banded-XLA differentiable path per row slab and
    all-reduces the MLP gradient pytree with the Pallas rings."""

    def _setup(self):
        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG, width=64, height=48,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=32),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
        )
        cam = s.Camera.reference()
        light, mat = s.reference_light(), s.reference_material()
        target = s.render(
            sdf.sphere(center=(0.05, 0.42, 0.0), radius=0.23), cam, light, mat, cfg
        )
        m0 = neural_sdf(key=0, hidden=16, depth=3, radius=0.3)
        return cfg, cam, light, mat, target, m0

    def test_sharded_neural_fit_matches_unsharded(self):
        from sdf3d_tpu.fit import FitConfig, fit_scene
        from sdf3d_tpu.parallel import make_mesh

        cfg, cam, light, mat, target, m0 = self._setup()
        mesh = make_mesh(jax.devices("cpu"), n_devices=8)
        common = dict(steps=2, learning_rate=1e-4, log_every=1, engine="pallas")
        ref = fit_scene(target, m0, cam, light, mat, cfg, FitConfig(**common))
        got = fit_scene(
            target, m0, cam, light, mat, cfg, FitConfig(**common), mesh=mesh,
        )
        np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
        import jax.flatten_util as fu

        a, _ = fu.ravel_pytree(got.scene)
        b, _ = fu.ravel_pytree(ref.scene)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
        assert isinstance(got.scene, NeuralSDF)


def test_render_banded_matches_render():
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=40)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = s.reference_scene()
    a = np.asarray(s.render(scene, cam, light, mat, cfg))
    b = np.asarray(s.render_banded(scene, cam, light, mat, cfg, band_rows=16))  # 40 % 16 != 0: pad path
    np.testing.assert_allclose(a, b, atol=1e-5)
