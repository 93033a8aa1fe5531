"""Sharded rendering on the 8-virtual-CPU mesh (SURVEY.md §4: distributed
logic without a cluster): sharded == unsharded, psum'd grads == full grads."""

import dataclasses

import jax
import jax.flatten_util as fu
import jax.numpy as jnp
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu.camera import camera_rays
from sdf3d_tpu.diff import render_rays_diff
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.parallel import (
    loss_and_grad_sharded,
    make_mesh,
    render_pallas_sharded,
    render_sharded,
)

CFG = dataclasses.replace(s.REFERENCE_CONFIG, width=128, height=96)
CAM, LIGHT, MAT = s.Camera.reference(), s.reference_light(), s.reference_material()


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(jax.devices("cpu"), n_devices=8)


class TestShardedRender:
    def test_xla_sharded_equals_unsharded_bitwise(self, mesh8):
        a = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, CFG))
        b = np.asarray(render_sharded(s.reference_scene(), CAM, LIGHT, MAT, CFG, mesh8))
        np.testing.assert_array_equal(a, b)

    @pytest.mark.smoke
    def test_pallas_sharded_matches_xla(self, mesh8):
        pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
        a = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, CFG))
        b = np.asarray(
            render_pallas_sharded(s.reference_scene(), CAM, LIGHT, MAT, CFG, mesh8, pc)
        )
        np.testing.assert_allclose(a, b, atol=1e-4)

    @pytest.mark.slow
    def test_pallas_interleaved_matches_contiguous(self, mesh8):
        """Interleaved row-block sharding is a pure layout change: the
        un-permuted image must equal the contiguous-slab one bitwise."""
        pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
        cfg = dataclasses.replace(CFG, height=128)  # 128 % (8 devs * 8 rows) == 0
        a = np.asarray(
            render_pallas_sharded(s.flagship_scene(), CAM, LIGHT, MAT, cfg, mesh8, pc)
        )
        b = np.asarray(
            render_pallas_sharded(
                s.flagship_scene(), CAM, LIGHT, MAT, cfg, mesh8, pc, interleaved=True
            )
        )
        np.testing.assert_array_equal(a, b)

    def test_pallas_interleaved_indivisible_raises(self, mesh8):
        pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
        cfg = dataclasses.replace(CFG, height=96)  # 96 % 64 != 0
        with pytest.raises(ValueError, match="interleaved"):
            render_pallas_sharded(
                s.reference_scene(), CAM, LIGHT, MAT, cfg, mesh8, pc, interleaved=True
            )

    def test_mesh_size_sweep(self):
        """Sharded output is invariant to the mesh size (1, 2, 4 devices)."""
        base = np.asarray(s.render(s.flagship_scene(), CAM, LIGHT, MAT, CFG))
        for n in (1, 2, 4):
            mesh = make_mesh(jax.devices("cpu"), n_devices=n)
            out = np.asarray(render_sharded(s.flagship_scene(), CAM, LIGHT, MAT, CFG, mesh))
            np.testing.assert_array_equal(base, out)

    def test_indivisible_height_raises(self, mesh8):
        cfg = dataclasses.replace(CFG, height=100)  # 100 % 8 != 0
        with pytest.raises(ValueError, match="not divisible"):
            render_sharded(s.reference_scene(), CAM, LIGHT, MAT, cfg, mesh8)


class Test4KSharded:
    """BASELINE configs[4]: 'tile-sharded 4K render'.  Full-resolution
    3840x2160 across the 8-device mesh, truncated march so the CPU fakes
    finish in seconds; the full-depth 4K numbers are benched on the chip
    (docs/performance.md)."""

    @pytest.mark.slow
    def test_4k_sharded_equals_unsharded(self, mesh8):
        cfg = dataclasses.replace(
            s.REFERENCE_CONFIG,
            width=3840,
            height=2160,
            march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=6),
            shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, enabled=False),
        )
        a = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg))
        b = np.asarray(render_sharded(s.reference_scene(), CAM, LIGHT, MAT, cfg, mesh8))
        assert a.shape == (2160, 3840, 3)
        np.testing.assert_array_equal(a, b)


class TestShardedGradients:
    @pytest.mark.slow
    def test_psum_grads_match_unsharded(self, mesh8):
        o, d = camera_rays(CAM, CFG.width, CFG.height)
        target = s.render(s.reference_scene(), CAM, LIGHT, MAT, CFG)
        scene = s.sdf.union(
            s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.25)
        )

        def loss_fn(scene_, o_, d_, tgt_):
            img = render_rays_diff(scene_, o_, d_, LIGHT, MAT, CFG)
            return jnp.sum((img - tgt_) ** 2)

        l_sh, g_sh = loss_and_grad_sharded(loss_fn, mesh8)(scene, o, d, target)
        l_un, g_un = jax.value_and_grad(lambda sc: loss_fn(sc, o, d, target))(scene)
        assert float(l_sh) == pytest.approx(float(l_un), rel=1e-5)
        gs, _ = fu.ravel_pytree(g_sh)
        gu, _ = fu.ravel_pytree(g_un)
        np.testing.assert_allclose(np.asarray(gs), np.asarray(gu), rtol=1e-4, atol=1e-4)


class TestShardedPallasGradients:
    """The sharded differentiable fused-engine composition: per-slab fused
    forward + fused backward under shard_map with psum'd grads must match
    the unsharded fused path and the XLA implicit-VJP path — contiguous
    *and* interleaved row-block layouts (the backward kernel's rowstride)."""

    def _setup(self):
        cfg = dataclasses.replace(CFG, height=128)  # 128 % (8 devs * 8 rows) == 0
        scene = s.sdf.union(
            s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.25)
        )
        target = s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg)
        return cfg, scene, target

    @pytest.mark.parametrize("interleaved", [False, True])
    @pytest.mark.smoke
    @pytest.mark.slow
    def test_grads_match_unsharded_pallas_and_xla(self, mesh8, interleaved):
        from sdf3d_tpu.ops import render_pallas
        from sdf3d_tpu.ops.render_pallas import render_pallas_rows
        from sdf3d_tpu.parallel.mesh import tile_axis
        from sdf3d_tpu.parallel.shard_render import interleave_rows

        cfg, scene, target = self._setup()
        pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
        n, th = 8, pc.tile_h
        slab = cfg.height // n
        slab_cfg = dataclasses.replace(cfg, height=slab, ndc_height=cfg.height)

        def slab_loss(scene_, o_, d_, tgt_):
            idx = jax.lax.axis_index(tile_axis)
            if interleaved:
                row0, stride = (idx * th).astype(jnp.float32), jnp.float32(n * th)
            else:
                row0, stride = (idx * slab).astype(jnp.float32), jnp.float32(th)
            img = render_pallas_rows(scene_, CAM, LIGHT, MAT, slab_cfg, pc, row0, stride)
            return jnp.sum((img - tgt_) ** 2)

        o, d = camera_rays(CAM, cfg.width, cfg.height)
        tgt = interleave_rows(target, n, th) if interleaved else target
        l_sh, g_sh = loss_and_grad_sharded(slab_loss, mesh8)(scene, o, d, tgt)

        def loss_pallas(sc):
            img = render_pallas(cfg, pc, sc, CAM, LIGHT, MAT)
            return jnp.sum((img - target) ** 2)

        l_un, g_un = jax.value_and_grad(loss_pallas)(scene)
        assert float(l_sh) == pytest.approx(float(l_un), rel=1e-5)
        gs, _ = fu.ravel_pytree(g_sh)
        gu, _ = fu.ravel_pytree(g_un)
        np.testing.assert_allclose(np.asarray(gs), np.asarray(gu), rtol=1e-4, atol=1e-6)

        def loss_xla(sc):
            img = render_rays_diff(sc, o, d, LIGHT, MAT, cfg)
            return jnp.sum((img - target) ** 2)

        _, g_xla = jax.value_and_grad(loss_xla)(scene)
        gx, _ = fu.ravel_pytree(g_xla)
        np.testing.assert_allclose(np.asarray(gs), np.asarray(gx), rtol=5e-3, atol=1e-3)

    @pytest.mark.parametrize("interleaved", [False, True])
    @pytest.mark.slow
    def test_fused_loss_grad_sharded_matches_unsharded(self, mesh8, interleaved):
        """The fused L2 loss+grad kernel (ops/fit_kernel.py) under shard_map:
        per-slab fused loss/grads psum to the unsharded fused values."""
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads
        from sdf3d_tpu.parallel.mesh import tile_axis
        from sdf3d_tpu.parallel.shard_render import (
            fused_loss_and_grad_sharded,
            interleave_rows,
        )

        cfg, scene, target = self._setup()
        pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
        n, th = 8, pc.tile_h
        slab = cfg.height // n
        slab_cfg = dataclasses.replace(cfg, height=slab, ndc_height=cfg.height)

        def slab_vag(scene_, o_, d_, tgt_):
            idx = jax.lax.axis_index(tile_axis)
            if interleaved:
                row0, stride = (idx * th).astype(jnp.float32), jnp.float32(n * th)
            else:
                row0, stride = (idx * slab).astype(jnp.float32), jnp.float32(th)
            loss, grads = l2_loss_and_grads(
                slab_cfg, pc, scene_, CAM, LIGHT, MAT, tgt_, row0, stride
            )
            return loss, grads[0]

        o, d = camera_rays(CAM, cfg.width, cfg.height)
        tgt = interleave_rows(target, n, th) if interleaved else target
        l_sh, g_sh = fused_loss_and_grad_sharded(slab_vag, mesh8)(scene, o, d, tgt)
        l_un, (g_un, *_) = l2_loss_and_grads(cfg, pc, scene, CAM, LIGHT, MAT, target)
        assert float(l_sh) == pytest.approx(float(l_un), rel=1e-5)
        gs, _ = fu.ravel_pytree(g_sh)
        gu, _ = fu.ravel_pytree(g_un)
        np.testing.assert_allclose(np.asarray(gs), np.asarray(gu), rtol=1e-4, atol=1e-6)

    def test_interleave_roundtrip(self):
        from sdf3d_tpu.parallel.shard_render import deinterleave_rows, interleave_rows

        x = jnp.arange(128 * 3, dtype=jnp.float32).reshape(128, 3)
        y = interleave_rows(x, 8, 8)
        np.testing.assert_array_equal(np.asarray(deinterleave_rows(y, 8, 8)), np.asarray(x))
        # Device 1's first block (rows 8..16 of the permuted layout) must be
        # absolute rows 8..16's counterpart: i=0, d=1 -> absolute rows 8..16.
        np.testing.assert_array_equal(np.asarray(y[16:24]), np.asarray(x[8:16]))


class TestGraftEntry:
    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_entry_signature(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        assert callable(fn) and len(args) == 4


def _psum_rows(mesh, num, x):
    """All-reduce row ``d`` of ``x`` from device ``d`` with ``lax.psum``
    under ``shard_map`` — the gradient all-reduce of the sharded fits."""
    import functools

    from jax.sharding import PartitionSpec as PS

    from sdf3d_tpu.parallel.mesh import tile_axis

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=PS(tile_axis, None),
        out_specs=PS(tile_axis, None), check_vma=False,
    )
    def f(local):
        return jax.lax.psum(local[0], tile_axis)[None]

    return np.asarray(f(x))


class TestPsumAllReduce:
    """The sharded fits all-reduce loss and gradients with ``lax.psum``
    (NCCL on GPUs); on the CPU mesh it must equal the plain sum."""

    def test_ring_allreduce_matches_sum(self, mesh8):
        x = jnp.arange(8 * 37, dtype=jnp.float32).reshape(8, 37)
        out = _psum_rows(mesh8, 8, x)
        np.testing.assert_allclose(
            out, np.broadcast_to(np.asarray(jnp.sum(x, 0)), (8, 37)), rtol=1e-6
        )


class TestRsAgCollective:
    """Payload sizes and mesh sizes of the psum all-reduce."""

    @pytest.mark.parametrize("n_elems", [1, 130, 20000, 70001])
    def test_matches_sum_ragged_payloads(self, mesh8, n_elems):
        rng = np.random.default_rng(n_elems)
        x = jnp.asarray(rng.standard_normal((8, n_elems)), jnp.float32)
        out = _psum_rows(mesh8, 8, x)
        want = np.broadcast_to(np.asarray(jnp.sum(x, 0)), out.shape)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("num", [2, 3, 5, 8])
    def test_odd_and_even_mesh_sizes(self, num):
        mesh = make_mesh(jax.devices("cpu"), n_devices=num)
        rng = np.random.default_rng(num)
        x = jnp.asarray(rng.standard_normal((num, 5000)), jnp.float32)
        out = _psum_rows(mesh, num, x)
        want = np.broadcast_to(np.asarray(jnp.sum(x, 0)), out.shape)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
