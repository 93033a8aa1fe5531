"""Voxel-grid SDF: trilinear sampling, baking, gradients, fit, render parity."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu import sdf
from sdf3d_tpu.sdf import VoxelGrid, voxel_grid, voxelize


def _sphere():
    return sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)


class TestSampling:
    def test_exact_at_grid_nodes(self):
        g = voxelize(_sphere(), resolution=16, lo=(-1, -1, -1), hi=(1, 1, 1))
        # Node [z, y, x] lives at origin + spacing * (x, y, z).
        for node in [(0, 0, 0), (3, 7, 5), (15, 15, 15)]:
            z, y, x = node
            p = g.origin + g.spacing * jnp.array([x, y, z], jnp.float32)
            got = float(g.distance(p))
            assert abs(got - float(g.values[z, y, x])) < 1e-6

    def test_trilinear_converges_to_analytic(self):
        sph = _sphere()
        rng = np.random.default_rng(0)
        pts = jnp.asarray(rng.uniform(-0.8, 0.8, (256, 3)), jnp.float32)
        exact = np.asarray(sph.distance(pts))
        errs = []
        for res in (16, 32, 64):
            g = voxelize(sph, resolution=res)
            errs.append(np.max(np.abs(np.asarray(g.distance(pts)) - exact)))
        # O(spacing^2) interpolation error: refining the grid shrinks it.
        assert errs[2] < errs[0]
        assert errs[2] < 5e-3

    def test_exterior_is_box_distance_plus_boundary(self):
        g = voxelize(_sphere(), resolution=16)
        p = jnp.array([0.0, 0.0, 5.0], jnp.float32)  # 4 beyond the +z face
        d = float(g.distance(p))
        boundary = float(g.distance(jnp.array([0.0, 0.0, 1.0])))
        assert abs(d - (boundary + 4.0)) < 1e-4

    def test_batched_shapes(self):
        g = voxelize(_sphere(), resolution=8)
        pts = jnp.zeros((4, 5, 3))
        assert g.distance(pts).shape == (4, 5)


class TestGradients:
    def test_grad_flows_to_values_as_trilinear_weights(self):
        g = voxelize(_sphere(), resolution=8)
        p = jnp.array([0.1, 0.2, 0.3], jnp.float32)
        grad = jax.grad(lambda gr: gr.distance(p))(g)
        w = np.asarray(grad.values)
        # Exactly the 8 surrounding nodes get weight, summing to 1.
        assert (w != 0).sum() == 8
        assert abs(w.sum() - 1.0) < 1e-5

    def test_grad_wrt_point_approximates_normal(self):
        g = voxelize(_sphere(), resolution=64)
        p = jnp.array([0.0, 0.4, 0.35], jnp.float32)  # near +z pole
        n = jax.grad(lambda q: g.distance(q))(p)
        n = np.asarray(n / jnp.linalg.norm(n))
        assert np.allclose(n, [0.0, 0.0, 1.0], atol=0.05)


class TestRender:
    def test_voxelized_scene_renders_close_to_analytic(self):
        # Voxelize only the sphere (the plane is unbounded); union with the
        # analytic plane and compare full renders.
        cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=96, height=72)
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        analytic = sdf.ground_plane() | _sphere()
        baked = sdf.ground_plane() | voxelize(
            _sphere(), resolution=64, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5)
        )
        img_a = np.asarray(s.render(analytic, cam, light, mat, cfg))
        img_b = np.asarray(s.render(baked, cam, light, mat, cfg))
        # Grid discretization moves silhouettes sub-pixel; most pixels agree.
        assert np.mean(np.abs(img_a - img_b) > 0.05) < 0.02

    def test_pallas_engine_rejects_grids_with_clear_error(self):
        from sdf3d_tpu.ops.scene_program import compile_scene

        soa = compile_scene(voxelize(_sphere(), resolution=8))
        with pytest.raises(TypeError, match="no Pallas emitter"):
            soa(jnp.zeros((8, 8)), jnp.zeros((8, 8)), jnp.zeros((8, 8)), lambda k: 0.0)


class TestFit:
    def test_grid_fit_recovers_shape(self):
        # Free-form inverse rendering: start from a sphere-ish grid, fit
        # toward a target rendered from a *shifted* sphere; loss must drop.
        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG,
            width=48,
            height=36,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=48),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
        )
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        target_scene = sdf.sphere(center=(0.08, 0.45, 0.0), radius=0.22)
        target = s.render(target_scene, cam, light, mat, cfg)

        from sdf3d_tpu.fit import FitConfig, fit_scene

        g0 = voxelize(_sphere(), resolution=12, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5))
        result = fit_scene(
            target, g0, cam, light, mat, cfg,
            FitConfig(steps=8, learning_rate=3e-3, log_every=4),
        )
        assert result.losses[-1] < result.losses[0]
        assert isinstance(result.scene, VoxelGrid)


class TestShardedGrid:
    """Grid scenes × the distributed layer (round-5 VERDICT item 8): grids
    delegate to banded XLA, and that delegation must hold under shard_map —
    sharded render == unsharded, sharded fit == unsharded."""

    def _setup(self):
        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG, width=64, height=48,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=32),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
        )
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        g0 = voxelize(_sphere(), resolution=12, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5))
        return cfg, cam, light, mat, g0

    def test_sharded_grid_render_matches_unsharded(self):
        from sdf3d_tpu.parallel import make_mesh, render_sharded

        cfg, cam, light, mat, g0 = self._setup()
        mesh = make_mesh(jax.devices("cpu"), n_devices=8)
        ref = s.render(g0, cam, light, mat, cfg)
        img = render_sharded(g0, cam, light, mat, cfg, mesh)
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(ref), atol=1e-6, rtol=1e-6
        )

    def test_sharded_grid_fit_matches_unsharded(self):
        from sdf3d_tpu.fit import FitConfig, fit_scene
        from sdf3d_tpu.parallel import make_mesh

        cfg, cam, light, mat, g0 = self._setup()
        mesh = make_mesh(jax.devices("cpu"), n_devices=8)
        target = s.render(
            sdf.sphere(center=(0.08, 0.45, 0.0), radius=0.22), cam, light, mat, cfg
        )
        common = dict(steps=2, learning_rate=3e-3, log_every=1, engine="pallas")
        ref = fit_scene(target, g0, cam, light, mat, cfg, FitConfig(**common))
        got = fit_scene(
            target, g0, cam, light, mat, cfg,
            FitConfig(**common), mesh=mesh,
        )
        np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(got.scene.values), np.asarray(ref.scene.values),
            rtol=1e-4, atol=1e-7,
        )
        assert isinstance(got.scene, VoxelGrid)


def test_voxel_grid_factory_validation():
    with pytest.raises(ValueError):
        voxel_grid(jnp.zeros((4, 4)))
    with pytest.raises(ValueError):
        voxelize(_sphere(), resolution=1)
    with pytest.raises(ValueError):
        voxelize(_sphere(), resolution=8, lo=(-1, -1, -1), hi=(1, 2, 1))


class TestPallasEntryDelegation:
    """render_pallas serves grid scenes via transparent banded-XLA delegation
    (the fast entry must not raise for grids; the scene compiler has no
    in-kernel gather emitter — docs/performance.md)."""

    def _scene(self):
        return sdf.ground_plane() | voxelize(
            _sphere(), resolution=32, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5)
        )

    def test_render_pallas_grid_matches_xla(self):
        from sdf3d_tpu.ops import PallasRenderConfig, render_pallas

        cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=96, height=48)
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        scene = self._scene()
        a = np.asarray(render_pallas(cfg, PallasRenderConfig(interpret=True), scene, cam, light, mat))
        b = np.asarray(s.render(scene, cam, light, mat, cfg))
        np.testing.assert_allclose(a, b, atol=2e-5)

    @pytest.mark.slow
    def test_render_pallas_grid_gradients_flow_to_samples(self):
        from sdf3d_tpu.ops import PallasRenderConfig, render_pallas

        cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=32)
        cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
        scene = self._scene()

        def loss(sc):
            return jnp.sum(render_pallas(cfg, PallasRenderConfig(interpret=True), sc, cam, light, mat))

        g = jax.grad(loss)(scene)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
        # grid sample gradients must be nonzero somewhere
        total = sum(float(np.abs(np.asarray(l)).sum()) for l in leaves)
        assert total > 0.0
