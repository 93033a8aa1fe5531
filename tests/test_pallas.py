"""Fused Pallas kernel: parity with the XLA path and custom-VJP gradients.

Runs in Pallas interpreter mode on CPU (SURVEY.md §4: distributed/kernel
logic tested without the accelerator); the same kernel compiles for the GPU
through Triton with ``interpret=False`` (tests/test_gpu_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu.config import AOConfig, MarchConfig
from sdf3d_tpu.ops import PallasRenderConfig, render_pallas
from sdf3d_tpu.ops.render_pallas import render_pallas_aux
from sdf3d_tpu.ops.scene_program import (
    compile_scene,
    count_params,
    scene_param_vector,
    unflatten_scene_params,
)

#: Default production config (ray-parameterized march SDFs): bit-exact for
#: everything except a measure-zero set of silhouette rays that may flip one
#: march step on ~1-ulp rounding differences — strict-allclose tests below
#: pin ``ray_sdf=False`` (point-form evals, the oracle-parity contract).
PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
PC_EXACT = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, ray_sdf=False)
CFG = dataclasses.replace(s.REFERENCE_CONFIG, width=128, height=96)


def assert_images_match(a, b, atol=1e-4, edge_frac=5e-4, hard=0.05):
    """Quantile image comparison for the ray-march fast path: all but a
    handful of silhouette-edge pixels agree to ``atol``; no pixel is off by
    more than ``hard``."""
    diff = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    assert (diff > atol).mean() < edge_frac, f"{(diff > atol).sum()} pixels off"
    assert diff.max() < hard
CAM = s.Camera.reference()
LIGHT, MAT = s.reference_light(), s.reference_material()


def _kitchen_sink_scene():
    """Every node type the emitter registry supports."""
    return (
        s.sdf.smooth_subtraction(
            s.sdf.rotate(s.sdf.box((0.3, 0.2, 0.1), center=(0, 0.3, 0)), (0.3, 0.5, 0.1)).translate((0.1, 0, 0)),
            s.sdf.torus(0.4, 0.1).scale(1.2).round(0.02),
            k=0.1,
        )
        | s.sdf.capsule((0, 0, 0), (0.2, 0.5, 0.1), 0.1)
        | s.sdf.cylinder(0.2, 0.3, center=(0.5, 0.2, 0)).shell(0.02)
        | s.sdf.ellipsoid((0.3, 0.2, 0.1), center=(-0.5, 0.3, 0))
        | s.sdf.elongate(s.sdf.sphere(radius=0.1), (0.2, 0.0, 0.0))
        | s.sdf.repeat_infinite(s.sdf.sphere(radius=0.05), (2.0, 0.0, 2.0))
        | s.sdf.smooth_intersection(s.sdf.sphere(radius=0.3), s.sdf.box((0.2, 0.2, 0.2)), k=0.05)
    )


class TestSceneProgram:
    @pytest.mark.parametrize(
        "scene_fn", [s.reference_scene, s.flagship_scene, _kitchen_sink_scene]
    )
    def test_soa_matches_pytree_distance(self, scene_fn):
        scene = scene_fn()
        vec = scene_param_vector(scene)
        soa = compile_scene(scene)
        pts = jax.random.uniform(jax.random.PRNGKey(0), (16, 128, 3), minval=-2, maxval=2)
        d_soa = soa(pts[..., 0], pts[..., 1], pts[..., 2], lambda i: vec[i])
        d_ref = scene.distance(pts)
        np.testing.assert_allclose(np.asarray(d_soa), np.asarray(d_ref), atol=1e-6)

    def test_param_vector_roundtrip(self):
        scene = s.flagship_scene()
        vec = scene_param_vector(scene)
        assert vec.shape == (count_params(scene),)
        rebuilt = unflatten_scene_params(scene, vec)
        pts = jax.random.uniform(jax.random.PRNGKey(1), (8, 128, 3), minval=-1, maxval=1)
        np.testing.assert_allclose(
            np.asarray(rebuilt.distance(pts)), np.asarray(scene.distance(pts)), atol=0
        )

    def test_unknown_node_raises(self):
        class Weird(s.sdf.SDFNode):
            pass

        soa = compile_scene(Weird())
        with pytest.raises(TypeError, match="no Pallas emitter"):
            soa(jnp.zeros((8, 128)), jnp.zeros((8, 128)), jnp.zeros((8, 128)), lambda i: 0.0)


class TestKernelParity:
    @pytest.mark.smoke
    def test_reference_scene_matches_xla(self):
        rgb, t, _, _ = render_pallas_aux(CFG, s.reference_scene(), CAM, LIGHT, MAT, PC_EXACT)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, CFG))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)

    def test_reference_scene_ray_mode(self):
        # Default (ray-parameterized) march: quantile parity (module docstring).
        rgb, *_ = render_pallas_aux(CFG, s.reference_scene(), CAM, LIGHT, MAT, PC)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, CFG))
        assert_images_match(rgb, img)

    @pytest.mark.slow
    def test_kitchen_sink_scene_ray_mode(self):
        # Every node type through the ray emitters (incl. the point-eval
        # fallback for Elongate/RepeatInfinite).
        rgb, *_ = render_pallas_aux(CFG, _kitchen_sink_scene(), CAM, LIGHT, MAT, PC)
        img = np.asarray(s.render(_kitchen_sink_scene(), CAM, LIGHT, MAT, CFG))
        assert_images_match(rgb, img)

    def test_flagship_scene_matches_xla(self):
        rgb, *_ = render_pallas_aux(CFG, s.flagship_scene(), CAM, LIGHT, MAT, PC_EXACT)
        img = np.asarray(s.render(s.flagship_scene(), CAM, LIGHT, MAT, CFG))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)

    def test_tetrahedron_normals_and_ao(self):
        cfg = dataclasses.replace(
            CFG, normals="tetrahedron", ao=AOConfig(enabled=True)
        )
        rgb, *_ = render_pallas_aux(cfg, s.flagship_scene(), CAM, LIGHT, MAT, PC_EXACT)
        img = np.asarray(s.render(s.flagship_scene(), CAM, LIGHT, MAT, cfg))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)

    def test_background_compositing(self):
        cfg = dataclasses.replace(CFG, background=(1.0, 0.0, 1.0))
        rgb, *_ = render_pallas_aux(cfg, s.reference_scene(), CAM, LIGHT, MAT, PC_EXACT)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)
        assert np.allclose(np.asarray(rgb)[0, 64], [1.0, 0.0, 1.0])  # sky pixel

    def test_lambert_shading(self):
        cfg = dataclasses.replace(CFG, shading="lambert")
        rgb, *_ = render_pallas_aux(cfg, s.reference_scene(), CAM, LIGHT, MAT, PC_EXACT)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)

    def test_non_divisible_image_padded_and_cropped(self):
        cfg = dataclasses.replace(CFG, width=100, height=75)
        rgb, t, _, _ = render_pallas_aux(cfg, s.reference_scene(), CAM, LIGHT, MAT, PC_EXACT)
        assert rgb.shape == (75, 100, 3)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)

    def test_rotated_camera(self):
        cam = s.Camera.orbit(azimuth_deg=40.0, elevation_deg=20.0, radius=2.0)
        rgb, *_ = render_pallas_aux(CFG, s.flagship_scene(), cam, LIGHT, MAT, PC)
        img = np.asarray(s.render(s.flagship_scene(), cam, LIGHT, MAT, CFG))
        diff = np.abs(np.asarray(rgb) - img).max(-1)
        # A handful of silhouette rays may flip a march step on last-bit
        # rounding differences; everything else must agree tightly.
        assert (diff > 1e-4).mean() < 5e-4, f"{(diff > 1e-4).sum()} pixels off"
        assert diff.max() < 0.05

    def test_pinhole_ray_mode_matches_xla(self):
        # The kernel must honor cfg.ray_mode (it once hardcoded the
        # reference focal term, silently diverging from the XLA engine
        # for pinhole configs).
        cfg = dataclasses.replace(CFG, ray_mode="pinhole")
        rgb, *_ = render_pallas_aux(cfg, s.reference_scene(), CAM, LIGHT, MAT, PC_EXACT)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg))
        np.testing.assert_allclose(np.asarray(rgb), img, atol=1e-4)

    def test_relaxed_march_matches_xla_relaxed(self):
        # Opt-in over-relaxed march: kernel and XLA implement the identical
        # Keinert algorithm, so they agree to float tolerance; and both stay
        # close to the exact march on converged rays (tests/test_march.py).
        mc = dataclasses.replace(CFG.march, relaxation=1.6)
        cfg = dataclasses.replace(CFG, march=mc)
        rgb, t, _, _ = render_pallas_aux(cfg, s.reference_scene(), CAM, LIGHT, MAT, PC)
        img = np.asarray(s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg))
        diff = np.abs(np.asarray(rgb) - img).max(-1)
        assert (diff > 1e-4).mean() < 5e-4, f"{(diff > 1e-4).sum()} pixels off"

    def test_param_change_no_new_structure_needed(self):
        """Same tree structure, different values — runs through the same
        compiled kernel (values are runtime inputs)."""
        a, *_ = render_pallas_aux(CFG, s.reference_scene(), CAM, LIGHT, MAT, PC)
        scene2 = s.sdf.union(
            s.sdf.ground_plane(), s.sdf.sphere(center=(0.3, 0.4, 0.0), radius=0.25)
        )
        b, *_ = render_pallas_aux(CFG, scene2, CAM, LIGHT, MAT, PC)
        assert np.abs(np.asarray(a) - np.asarray(b)).max() > 0.01


class TestKernelGradients:
    def _patch(self, img):
        return img[40:56, 56:72]

    @pytest.mark.smoke
    def test_scene_gradient_matches_render_diff(self):
        def loss_p(r):
            sc = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=r))
            return jnp.sum(self._patch(render_pallas(CFG, PC, sc, CAM, LIGHT, MAT)))

        def loss_d(r):
            sc = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=r))
            return jnp.sum(self._patch(s.render_diff(sc, CAM, LIGHT, MAT, CFG)))

        gp = jax.grad(loss_p)(jnp.float32(0.2))
        gd = jax.grad(loss_d)(jnp.float32(0.2))
        assert gp == pytest.approx(float(gd), rel=1e-3)

    def test_camera_gradient_flows(self):
        def loss(z):
            cam = s.Camera(position=jnp.array([0.0, 0.2, z]), c2w=jnp.eye(3), fov_deg=jnp.float32(60.0))
            return jnp.sum(self._patch(render_pallas(CFG, PC, s.reference_scene(), cam, LIGHT, MAT)))

        g = jax.grad(loss)(jnp.float32(2.0))
        assert np.isfinite(g) and g != 0.0

    def test_light_and_material_gradients_flow(self):
        def loss(lx, shn):
            light = s.point_light(position=(lx, 5.0, 0.0))
            mat = s.material(shininess=shn)
            return jnp.sum(render_pallas(CFG, PC, s.reference_scene(), CAM, light, mat))

        gl, gm = jax.grad(loss, argnums=(0, 1))(jnp.float32(5.0), jnp.float32(12.0))
        assert np.isfinite(gl) and gl != 0.0
        assert np.isfinite(gm) and gm != 0.0


class TestFusedBackwardKernel:
    """The backward at the kernels' parameter-vector boundary (scene-program
    emitters, tiled like the fit kernel) must produce the same gradients as
    the same shading expression driven by ``scene.distance`` over the whole
    image — the route of scenes without a kernel emitter."""

    @pytest.mark.smoke
    @pytest.mark.slow
    def test_matches_planar_backward_all_inputs(self):
        import importlib

        rp = importlib.import_module("sdf3d_tpu.ops.render_pallas")
        scene = s.reference_scene()

        def loss(sc, c, l, m):
            img = render_pallas(CFG, PC_EXACT, sc, c, l, m)
            w = jnp.linspace(0.5, 1.5, img.size).reshape(img.shape)
            return jnp.sum(img * w)

        g_fused = jax.grad(loss, argnums=(0, 1, 2, 3))(scene, CAM, LIGHT, MAT)
        orig = rp._scene_compiles
        rp._scene_compiles = lambda scene: False  # force the planar fallback
        try:
            g_planar = jax.grad(loss, argnums=(0, 1, 2, 3))(scene, CAM, LIGHT, MAT)
        finally:
            rp._scene_compiles = orig

        for gf, gp in zip(jax.tree_util.tree_leaves(g_fused), jax.tree_util.tree_leaves(g_planar)):
            a, b = np.asarray(gf), np.asarray(gp)
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5 * max(1.0, np.abs(b).max()))

    @pytest.mark.slow
    def test_matches_planar_backward_with_ao_and_background(self):
        import importlib

        rp = importlib.import_module("sdf3d_tpu.ops.render_pallas")
        cfg = dataclasses.replace(
            CFG, ao=AOConfig(enabled=True), background=(0.1, 0.2, 0.3)
        )
        scene = s.reference_scene()

        def loss(sc, l):
            return jnp.sum(render_pallas(cfg, PC_EXACT, sc, CAM, l, MAT))

        g_fused = jax.grad(loss, argnums=(0, 1))(scene, LIGHT)
        orig = rp._scene_compiles
        rp._scene_compiles = lambda scene: False
        try:
            g_planar = jax.grad(loss, argnums=(0, 1))(scene, LIGHT)
        finally:
            rp._scene_compiles = orig
        for gf, gp in zip(jax.tree_util.tree_leaves(g_fused), jax.tree_util.tree_leaves(g_planar)):
            a, b = np.asarray(gf), np.asarray(gp)
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5 * max(1.0, np.abs(b).max()))


class TestFusedLossGradKernel:
    """ops/fit_kernel.py: the fused L2 loss+grad kernel must reproduce
    jax.value_and_grad through render_pallas exactly (same math, no XLA
    loss/cotangent pass), including padded tiles and sharded slabs."""

    def _scene_and_target(self, cfg):
        scene = s.sdf.union(
            s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.25)
        )
        target = s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg)
        return scene, target

    def _reference_vag(self, cfg, pc, scene, target):
        def loss(sc, cam_, light_, mat_):
            img = render_pallas(cfg, pc, sc, cam_, light_, mat_)
            return jnp.sum((img - target) ** 2)

        l, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(scene, CAM, LIGHT, MAT)
        return l, g

    @pytest.mark.smoke
    @pytest.mark.slow
    def test_matches_generic_value_and_grad(self):
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        scene, target = self._scene_and_target(CFG)
        l_f, g_f = l2_loss_and_grads(CFG, PC_EXACT, scene, CAM, LIGHT, MAT, target)
        l_r, g_r = self._reference_vag(CFG, PC_EXACT, scene, target)
        assert float(l_f) == pytest.approx(float(l_r), rel=1e-6)
        for gf, gr in zip(jax.tree_util.tree_leaves(g_f), jax.tree_util.tree_leaves(g_r)):
            a, b = np.asarray(gf), np.asarray(gr)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(b).max()))

    def test_frozen_slots_fold_to_constants(self):
        """``frozen_slots`` (fit.py trainable masks) must yield exactly-zero
        gradients at the frozen slots, bit-identical loss, and unchanged
        gradients at the trainable slots — the frozen params' reverse chains
        are constant-folded out of the kernel, not just masked after."""
        import jax.flatten_util as fu

        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        cfg = dataclasses.replace(CFG, width=128, height=48)
        scene, target = self._scene_and_target(cfg)
        l_all, g_all = l2_loss_and_grads(
            cfg, PC_EXACT, scene, CAM, LIGHT, MAT, target, wrt_uniforms=False
        )
        frozen = (0, 1, 2, 3)  # the ground plane's 4 params
        l_fr, g_fr = l2_loss_and_grads(
            cfg, PC_EXACT, scene, CAM, LIGHT, MAT, target, wrt_uniforms=False,
            frozen_slots=frozen,
        )
        assert float(l_fr) == pytest.approx(float(l_all), rel=1e-6)
        a, _ = fu.ravel_pytree(g_all[0])
        b, _ = fu.ravel_pytree(g_fr[0])
        a, b = np.asarray(a), np.asarray(b)
        assert np.all(b[list(frozen)] == 0.0)
        live = [k for k in range(a.shape[0]) if k not in frozen]
        np.testing.assert_allclose(b[live], a[live], rtol=1e-5, atol=1e-6)

        # End-to-end: fit_scene with a trainable mask routes the mask into
        # the kernel (frozen leaves stay bit-identical through steps).
        from sdf3d_tpu.fit import FitConfig, fit_scene

        trainable = jax.tree_util.tree_map(lambda _: True, scene)
        trainable = trainable.replace(
            a=jax.tree_util.tree_map(lambda _: False, scene.a)
        )
        result = fit_scene(
            target, scene, CAM, LIGHT, MAT, cfg,
            FitConfig(steps=2, engine="pallas", pallas_interpret=True,
                      pallas_tile=(8, 128), log_every=1),
            trainable=trainable,
        )
        for la, lb in zip(
            jax.tree_util.tree_leaves(scene.a),
            jax.tree_util.tree_leaves(result.scene.a),
        ):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
        assert result.losses[-1] <= result.losses[0]

    @pytest.mark.slow
    def test_padded_tiles_masked(self):
        """Width/height not tile multiples: padding lanes (whose target is
        zero-padded) must contribute exactly nothing."""
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        cfg = dataclasses.replace(CFG, width=100, height=70)  # 100%128, 70%8
        scene, target = self._scene_and_target(cfg)
        l_f, g_f = l2_loss_and_grads(cfg, PC_EXACT, scene, CAM, LIGHT, MAT, target)
        l_r, g_r = self._reference_vag(cfg, PC_EXACT, scene, target)
        assert float(l_f) == pytest.approx(float(l_r), rel=1e-6)
        for gf, gr in zip(jax.tree_util.tree_leaves(g_f), jax.tree_util.tree_leaves(g_r)):
            a, b = np.asarray(gf), np.asarray(gr)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(b).max()))

    def test_wrt_uniforms_false_scene_grads_only(self):
        """wrt_uniforms=False (the fit.py/bench scene-fit hot path): scene
        grads identical to the full path; camera/light/material grads zero."""
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        scene, target = self._scene_and_target(CFG)
        l_f, g_f = l2_loss_and_grads(
            CFG, PC_EXACT, scene, CAM, LIGHT, MAT, target, wrt_uniforms=False
        )
        l_r, (g_scene_r, *g_uni_r) = l2_loss_and_grads(
            CFG, PC_EXACT, scene, CAM, LIGHT, MAT, target
        )
        assert float(l_f) == pytest.approx(float(l_r), rel=1e-6)
        for gf, gr in zip(
            jax.tree_util.tree_leaves(g_f[0]), jax.tree_util.tree_leaves(g_scene_r)
        ):
            # Same math; the argnums=0 jaxpr fuses differently → ~1-ulp drift.
            np.testing.assert_allclose(np.asarray(gf), np.asarray(gr), rtol=1e-5)
        for leaf in jax.tree_util.tree_leaves(g_f[1:]):
            np.testing.assert_array_equal(np.asarray(leaf), 0.0)

    def test_eligibility_gate(self):
        from sdf3d_tpu.config import ShadowConfig
        from sdf3d_tpu.ops.fit_kernel import fused_l2_eligible

        scene, _ = self._scene_and_target(CFG)
        assert fused_l2_eligible(CFG, scene)
        cfg_ad = dataclasses.replace(
            CFG, shadow=dataclasses.replace(CFG.shadow, grad="ad")
        )
        assert not fused_l2_eligible(cfg_ad, scene)
        # Extended losses narrow eligibility: relaxed march has no min-SDF
        # tracker; pyramid needs tile dims divisible by 2^levels.
        assert fused_l2_eligible(CFG, scene, sil_w=1.0)
        cfg_rel = dataclasses.replace(
            CFG, march=dataclasses.replace(CFG.march, relaxation=1.6)
        )
        assert not fused_l2_eligible(cfg_rel, scene, sil_w=1.0)
        assert fused_l2_eligible(CFG, scene, loss="multiscale", levels=3, pc=PC_EXACT)
        assert not fused_l2_eligible(CFG, scene, loss="multiscale", levels=4, pc=PC_EXACT)

    def test_multiscale_matches_ad(self):
        """Fused in-tile pooling pyramid == XLA pixel_loss('multiscale'),
        including padded (odd-size) images and their recursive cropping."""
        from sdf3d_tpu.fit import pixel_loss
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        cfg = dataclasses.replace(CFG, width=100, height=70)  # padded tiles
        scene, target = self._scene_and_target(cfg)
        l_f, g_f = l2_loss_and_grads(
            cfg, PC_EXACT, scene, CAM, LIGHT, MAT, target,
            wrt_uniforms=False, loss_kind="multiscale", levels=3,
        )

        def loss(sc):
            img = render_pallas(cfg, PC_EXACT, sc, CAM, LIGHT, MAT)
            return pixel_loss(img, target, "multiscale", 3)

        l_r, g_r = jax.value_and_grad(loss)(scene)
        assert float(l_f) == pytest.approx(float(l_r), rel=1e-5)
        for gf, gr in zip(jax.tree_util.tree_leaves(g_f[0]), jax.tree_util.tree_leaves(g_r)):
            a, b = np.asarray(gf), np.asarray(gr)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))

    def test_silhouette_scene_grads_match_ad(self):
        """Fused coverage term (in-march min-SDF + envelope re-attachment)
        == the XLA diff.coverage path, scene gradients."""
        from sdf3d_tpu.camera import camera_rays
        from sdf3d_tpu.diff import coverage
        from sdf3d_tpu.fit import pixel_loss
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

        cfg = dataclasses.replace(CFG, background=(0.0, 0.0, 0.0))
        scene, _ = self._scene_and_target(cfg)
        target = s.render(s.reference_scene(), CAM, LIGHT, MAT, cfg)
        cov_t = (jnp.max(jnp.abs(target), axis=-1) > 1e-3).astype(jnp.float32)
        o, d = camera_rays(CAM, cfg.width, cfg.height, cfg.ray_mode)

        l_f, g_f = l2_loss_and_grads(
            cfg, PC_EXACT, scene, CAM, LIGHT, MAT, target,
            wrt_uniforms=False, sil_w=0.7, target_coverage=cov_t,
        )

        def loss(sc):
            img = render_pallas(cfg, PC_EXACT, sc, CAM, LIGHT, MAT)
            cov = coverage(cfg.march, sc, o, d, None)
            return pixel_loss(img, target, "l2") + 0.7 * jnp.sum((cov - cov_t) ** 2)

        l_r, g_r = jax.value_and_grad(loss)(scene)
        assert float(l_f) == pytest.approx(float(l_r), rel=1e-5)
        for gf, gr in zip(jax.tree_util.tree_leaves(g_f[0]), jax.tree_util.tree_leaves(g_r)):
            a, b = np.asarray(gf), np.asarray(gr)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))

    def test_silhouette_camera_grads_match_ad(self):
        """Pose-path parity: camera gradients of the fused L2+coverage loss
        match AD through render_pallas + diff.coverage — the recommended
        pose-fit configuration now runs in one launch (VERDICT r3 item 3)."""
        from sdf3d_tpu.camera import camera_rays
        from sdf3d_tpu.diff import coverage
        from sdf3d_tpu.fit import pixel_loss
        from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads
        from sdf3d_tpu.sdf.transforms import rotvec_to_matrix

        cfg = dataclasses.replace(CFG, background=(0.0, 0.0, 0.0))
        scene = s.sdf.union(
            s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
        )
        target = s.render(scene, CAM, LIGHT, MAT, cfg)
        cov_t = (jnp.max(jnp.abs(target), axis=-1) > 1e-3).astype(jnp.float32)
        cam0 = s.Camera(
            position=CAM.position + 0.05 * jnp.asarray([1.0, -0.7, 1.3]),
            c2w=rotvec_to_matrix(0.05 * jnp.asarray([0.3, 0.8, -0.3])) @ CAM.c2w,
            fov_deg=CAM.fov_deg,
        )

        _, (_, g_cam_f, _, _) = l2_loss_and_grads(
            cfg, PC_EXACT, scene, cam0, LIGHT, MAT, target,
            sil_w=0.7, target_coverage=cov_t,
        )

        def loss(cam):
            img = render_pallas(cfg, PC_EXACT, scene, cam, LIGHT, MAT)
            o, d = camera_rays(cam, cfg.width, cfg.height, cfg.ray_mode)
            cov = coverage(cfg.march, scene, o, d, None)
            return pixel_loss(img, target, "l2") + 0.7 * jnp.sum((cov - cov_t) ** 2)

        g_cam_r = jax.grad(loss)(cam0)
        for gf, gr in zip(
            jax.tree_util.tree_leaves(g_cam_f), jax.tree_util.tree_leaves(g_cam_r)
        ):
            a, b = np.asarray(gf), np.asarray(gr)
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4 * max(1.0, np.abs(b).max()))


class TestPallasShadowADGradients:
    """ShadowConfig.grad == 'ad' on the pallas engine: penumbra-shape
    gradients flow (VERDICT r1 item 4).  FD-validated on shadowed pixels."""

    def test_penumbra_gradient_matches_fd(self):
        cfg = dataclasses.replace(
            CFG, shadow=dataclasses.replace(CFG.shadow, grad="ad")
        )

        def scene_of(r):
            return s.sdf.union(
                s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=r)
            )

        # Find penumbra pixels: plane hits whose shadow factor is interior.
        _, t, sh, _ = render_pallas_aux(CFG, scene_of(jnp.float32(0.2)), CAM, LIGHT, MAT, PC_EXACT)
        sh, t = np.asarray(sh), np.asarray(t)
        mask = (sh > 0.05) & (sh < 0.8) & (t < 50.0)
        assert mask.sum() > 10, "no penumbra pixels found at this resolution"
        mask = jnp.asarray(mask, jnp.float32)

        def loss(r, config):
            img = render_pallas(config, PC_EXACT, scene_of(r), CAM, LIGHT, MAT)
            return jnp.sum(img * mask[..., None])

        g_ad = jax.grad(loss)(jnp.float32(0.2), cfg)
        e = 1e-3
        fd = (loss(jnp.float32(0.2 + e), CFG) - loss(jnp.float32(0.2 - e), CFG)) / (2 * e)
        # detach drops most of this gradient; ad must match FD.
        assert float(g_ad) == pytest.approx(float(fd), rel=0.1)

    def test_ad_mode_primal_is_bit_exact_with_detach(self):
        cfg_ad = dataclasses.replace(CFG, shadow=dataclasses.replace(CFG.shadow, grad="ad"))
        a = render_pallas(CFG, PC_EXACT, s.reference_scene(), CAM, LIGHT, MAT)
        b = render_pallas(cfg_ad, PC_EXACT, s.reference_scene(), CAM, LIGHT, MAT)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
