"""The Triton-route fused fit kernel in interpret mode against XLA
``jax.value_and_grad``, and its partial-vector layout."""

import dataclasses

import jax
import jax.flatten_util as fu
import jax.numpy as jnp
import numpy as np
import pytest

import sdf3d_tpu as s
from sdf3d_tpu.diff import render_diff
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import (
    l2_loss_and_grads,
    multiview_loss_and_grads,
    partial_len,
)
from sdf3d_tpu.ops.render_kernel import N_UNIFORMS

CAM = s.Camera.reference()
LIGHT, MAT = s.reference_light(), s.reference_material()
CFG = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=32)
PC = PallasRenderConfig(interpret=True, ray_sdf=False)
SCENE0 = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))


def _target(cam=CAM):
    return s.render(s.reference_scene(), cam, LIGHT, MAT, CFG)


def _xla_loss(scene, cam, target, coverage=None, sil_w=0.0):
    loss = jnp.sum((render_diff(scene, cam, LIGHT, MAT, CFG) - target) ** 2)
    if sil_w > 0.0:
        o, d = s.camera_rays(cam, CFG.width, CFG.height)
        loss = loss + sil_w * jnp.sum((s.coverage(CFG.march, scene, o, d) - coverage) ** 2)
    return loss


def _assert_close(loss_a, g_a, loss_b, g_b):
    a, b = np.asarray(fu.ravel_pytree(g_a)[0]), np.asarray(fu.ravel_pytree(g_b)[0])
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-5)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * max(1.0, np.abs(b).max()))


def test_l2_matches_xla_value_and_grad():
    target = _target()
    loss_f, grads = l2_loss_and_grads(CFG, PC, SCENE0, CAM, LIGHT, MAT, target, wrt_uniforms=False)
    loss_x, g_x = jax.value_and_grad(_xla_loss)(SCENE0, CAM, target)
    _assert_close(loss_f, grads[0], loss_x, g_x)


def test_silhouette_matches_xla_value_and_grad():
    target = _target()
    cov = (jnp.max(jnp.abs(target - _target(s.Camera.orbit(azimuth_deg=180.0))), axis=-1) > 1e-3)
    cov = cov.astype(jnp.float32)
    loss_f, grads = l2_loss_and_grads(
        CFG, PC, SCENE0, CAM, LIGHT, MAT, target, wrt_uniforms=False,
        sil_w=0.5, target_coverage=cov,
    )
    loss_x, g_x = jax.value_and_grad(_xla_loss)(SCENE0, CAM, target, cov, 0.5)
    _assert_close(loss_f, grads[0], loss_x, g_x)


def test_multiview_two_views_matches_xla_value_and_grad():
    cams = [s.Camera.orbit(azimuth_deg=a, radius=2.0) for a in (0.0, 120.0)]
    targets = [_target(c) for c in cams]
    loss_f, (g_f, _, _, _) = multiview_loss_and_grads(
        CFG, PC, SCENE0, cams, LIGHT, MAT, targets, wrt_uniforms=False
    )
    loss_x, g_x = jax.value_and_grad(
        lambda sc: sum(_xla_loss(sc, c, t) for c, t in zip(cams, targets))
    )(SCENE0)
    _assert_close(loss_f, g_f, loss_x, g_x)


def test_frozen_slots_match_xla_value_and_grad():
    """Frozen slots read exactly zero; the trainable ones match XLA."""
    target = _target()
    frozen = (0, 1, 2, 3)  # the ground plane's parameters
    loss_f, grads = l2_loss_and_grads(
        CFG, PC, SCENE0, CAM, LIGHT, MAT, target, wrt_uniforms=False, frozen_slots=frozen
    )
    loss_x, g_x = jax.value_and_grad(_xla_loss)(SCENE0, CAM, target)
    a = np.asarray(fu.ravel_pytree(grads[0])[0])
    b = np.array(fu.ravel_pytree(g_x)[0])
    assert np.all(a[list(frozen)] == 0.0)
    b[list(frozen)] = 0.0
    _assert_close(loss_f, a, loss_x, b)


def test_uniform_grads_match_xla_value_and_grad():
    """``wrt_uniforms=True``: camera, light and material gradients too."""
    target = _target()
    loss_f, (g_sc, g_cam, g_light, g_mat) = l2_loss_and_grads(
        CFG, PC, SCENE0, CAM, LIGHT, MAT, target, wrt_uniforms=True
    )

    def loss(sc, cam, light, mat):
        return jnp.sum((render_diff(sc, cam, light, mat, CFG) - target) ** 2)

    loss_x, g_x = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(SCENE0, CAM, LIGHT, MAT)
    for got, want in zip((g_sc, g_light, g_mat), (g_x[0], g_x[2], g_x[3])):
        _assert_close(loss_f, got, loss_x, want)


@pytest.mark.parametrize("n_params", [0, 1, 2, 33, 34, 97, 200])
def test_partial_len_is_next_power_of_two(n_params):
    """Each program's partial vector holds P grads, N_UNIFORMS uniform grads
    and the loss, in the smallest power-of-two length that fits."""
    n = partial_len(n_params)
    need = n_params + N_UNIFORMS + 1
    assert n & (n - 1) == 0
    assert n >= need and n // 2 < need


def test_fit_kernel_is_one_triton_call():
    """The fused fit step lowers to exactly one Triton kernel for CUDA."""
    target = _target()
    fn = jax.jit(lambda sc: l2_loss_and_grads(
        CFG, PallasRenderConfig(), sc, CAM, LIGHT, MAT, target, wrt_uniforms=False))
    text = fn.trace(SCENE0).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
