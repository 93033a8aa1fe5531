"""Debugging & validation: the analogues of sanitizers (SURVEY.md §5).

The reference has no error handling at all (``main.cpp:34-110``) and GPU
debugging meant looking at the screen.  Here:

- :func:`checked_render` — ``checkify``-instrumented render that *reports*
  NaN/Inf/OOB instead of silently propagating them;
- :func:`check_lipschitz` — statistical test that a scene is a metric SDF
  (|f(a)−f(b)| ≤ ‖a−b‖).  Sphere tracing's correctness depends on this
  bound; a non-unit plane normal or a bad custom primitive breaks it and
  destabilizes the march (exactly the failure mode seen when optimizing a
  raw plane normal — fit.py's ``trainable`` docs);
- :func:`finite_params` — every scene leaf is finite.

Pallas kernels run in the interpreter through their own switches
(``PallasRenderConfig.interpret``, ``FitConfig.pallas_interpret``).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from sdf3d_tpu.camera import Camera
from sdf3d_tpu.config import RenderConfig
from sdf3d_tpu.lighting import Material, PointLight
from sdf3d_tpu.render import render
from sdf3d_tpu.sdf.node import SDFNode


def checked_render(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
):
    """Render with float checks; returns ``(error, image)``.

    ``error.throw()`` raises with a located message if any NaN/Inf appeared
    anywhere in the pipeline — the debugging path for new primitives or
    suspicious fits (not for production: checks cost throughput).
    """
    f = checkify.checkify(
        lambda sc: render(sc, camera, light, mat, config), errors=checkify.float_checks
    )
    return f(scene)


def finite_params(scene: SDFNode) -> bool:
    """True iff every numeric leaf of the scene is finite."""
    leaves = jax.tree_util.tree_leaves(scene)
    return all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)


def check_lipschitz(
    scene: SDFNode,
    key=None,
    n_samples: int = 4096,
    box: float = 3.0,
    tol: float = 1.01,
) -> tuple[bool, float]:
    """Sample point pairs and verify the 1-Lipschitz bound.

    Returns ``(ok, worst_ratio)`` where ratio = |f(a)−f(b)| / ‖a−b‖; a true
    SDF keeps it ≤ 1 (`tol` absorbs float noise).  Ratios > 1 mean sphere
    tracing can overshoot surfaces: fix the scene (normalize plane normals,
    use bound-correct primitives) or shrink march steps.
    """
    key = jax.random.PRNGKey(0) if key is None else key
    ka, kb = jax.random.split(key)
    a = jax.random.uniform(ka, (n_samples, 3), minval=-box, maxval=box)
    b = a + jax.random.normal(kb, (n_samples, 3)) * 0.1
    fa = scene.distance(a)
    fb = scene.distance(b)
    dist = jnp.linalg.norm(a - b, axis=-1)
    ratio = jnp.abs(fa - fb) / jnp.maximum(dist, 1e-9)
    worst = float(jnp.max(ratio))
    return worst <= tol, worst


def validate_scene(scene: SDFNode, strict: bool = False) -> list[str]:
    """Run all static scene checks; returns a list of warning strings.

    ``strict=True`` raises on the first problem instead.
    """
    problems = []
    if not finite_params(scene):
        problems.append("scene has non-finite parameters")
    ok, worst = check_lipschitz(scene)
    if not ok:
        problems.append(
            f"scene violates the 1-Lipschitz SDF bound (worst ratio {worst:.3f}); "
            "sphere tracing may overshoot — check plane normals/custom primitives"
        )
    if strict and problems:
        raise ValueError("; ".join(problems))
    return problems


@contextlib.contextmanager
def nan_debugging():
    """Enable jax_debug_nans inside the context (immediate NaN tracebacks)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
