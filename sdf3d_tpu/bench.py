"""Benchmark harness: rays/s for forward and forward+backward renders.

The reference publishes no numbers (BASELINE.md); the north star's target
is ≥1e9 rays/s per device at 1080p sphere-trace fwd+bwd.  ``vs_baseline``
reports the measured value against that 1e9 target.  Every result names
the device it ran on.
"""

from __future__ import annotations

import dataclasses
import subprocess

import jax
import jax.numpy as jnp


def card_label() -> str:
    """``name, power.limit`` of the first NVIDIA card as ``nvidia-smi``
    reports them (a child process that never imports JAX); ``"unknown"``
    when there is no driver."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0].strip() if out else "unknown"


def slope_seconds_per_frame(make_fn, args, k_small: int, k_large: int, rounds: int = 5) -> float:
    """Per-frame seconds by two-point differencing: time a ``k_small``-frame
    and a ``k_large``-frame dispatch and divide the *difference* by the
    extra frames, which subtracts the constant per-window cost (dispatch and
    the final sync).  Returns the median slope over ``rounds`` rounds."""
    from sdf3d_tpu.utils.profiling import benchmark_fn

    fn_s, fn_l = make_fn(k_small), make_fn(k_large)
    benchmark_fn(fn_s, *args, warmup=2, iters=1)
    benchmark_fn(fn_l, *args, warmup=2, iters=1)
    slopes = []
    for _ in range(rounds):
        t_s = benchmark_fn(fn_s, *args, warmup=0, iters=2)
        t_l = benchmark_fn(fn_l, *args, warmup=0, iters=2)
        slopes.append((t_l - t_s) / (k_large - k_small))
    slopes.sort()
    return slopes[len(slopes) // 2]


def run_benchmark(
    width: int = 1920,
    height: int = 1080,
    engine: str = "pallas",
    interpret: bool = False,
    scene_name: str = "reference",
    mode: str = "fwd_bwd",
    iters: int = 10,
    frames_per_dispatch: int = 16,
    profile: str = "parity",
    pc_overrides: dict | None = None,
) -> dict:
    """Time the renderer; returns the one-line JSON payload (BASELINE metric:
    rays/s at 1080p sphere-trace fwd+bwd, target 1e9 per device).

    Frames are pipelined ``frames_per_dispatch`` per jit call, in the shape
    the production paths actually execute:

    - ``fwd_bwd``: a K-step gradient-descent fit chunk — ``lax.scan`` where
      each step renders, takes scene-parameter grads of a pixel loss, and
      updates the params.  This is byte-for-byte the ``fit.py`` hot loop
      (``run_chunk``); the data dependence between steps also makes the
      measurement un-hoistable (XLA cannot CSE the frames away).
    - ``fwd``: a turntable batch — ``lax.map`` over per-frame cameras, the
      ``render_batch`` animation/serving path.  Each frame reduces to a
      per-frame checksum so the measurement is compute-, not copy-, bound.
      Camera ``i`` is the same pose at every K (golden-angle azimuths,
      K-independent), so the K-frame set is exactly a prefix of the 4K set
      and the two slope windows time the same per-frame workload.

    Why pipelined: no production workload of this framework renders one
    frame per host round trip — fits scan (fit.py), animation batches
    (render_batch) — so the metric times the device, not the dispatch.
    ``frames_per_dispatch=1`` measures per-dispatch latency instead.
    """
    import sdf3d_tpu as s

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=width, height=height)
    if profile == "fast":
        # The declared non-parity fast profile (config.fast_config):
        # tetrahedron normals + 32-step shadows.  The headline metric stays
        # on "parity"; this knob powers benchmarks/fast_profile.
        cfg = s.fast_config(cfg)
    elif profile != "parity":
        raise ValueError(f"profile must be 'parity' or 'fast', not {profile!r}")
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = {"reference": s.reference_scene, "flagship": s.flagship_scene,
             "sphere": s.sphere_scene, "fractal": s.fractal_scene}[scene_name]()
    K = max(1, frames_per_dispatch)

    if engine == "pallas":
        from sdf3d_tpu.ops import default_pallas_config, render_pallas

        # pc_overrides: kernel-knob experiments (e.g. the fast profile's
        # stop_every thinning) without a config-surface change.
        pc = default_pallas_config(scene, interpret=interpret,
                                   **(pc_overrides or {}))

        def render_one(sc, camera):
            return render_pallas(cfg, pc, sc, camera, light, mat)
    else:
        def render_one(sc, camera):
            return s.render_diff(sc, camera, light, mat, cfg)

    if mode == "fwd":
        # Turntable: K distinct camera poses per dispatch (render_batch shape).
        if engine == "pallas":
            from sdf3d_tpu.ops.render_kernel import render_kernel_forward

            def one(c):
                return render_kernel_forward(scene, c, light, mat, cfg, pc)[0].mean()
        else:
            def one(c):
                return s.render(scene, c, light, mat, cfg).mean()

        def make_fn(k):
            # Golden-angle azimuths: camera i is identical for every k, so a
            # K-frame window is a strict prefix of the 4K-frame window and the
            # two-point slope subtracts like from like.
            cams = [s.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0) for i in range(k)]
            cameras = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
            return jax.jit(lambda _sc: jax.lax.map(one, cameras))

        args = (scene,)
    else:
        # K-step fit chunk: the fit.py run_chunk hot loop (lax.scan with a
        # parameter update per step — serial data dependence between frames).
        target = jnp.zeros((height, width, 3), jnp.float32)

        if engine == "pallas":
            # fit.py's engine='pallas' L2 path: the fused single-launch
            # loss+grad kernel (ops/fit_kernel.py) — no XLA loss/cotangent
            # pass; uniform grads skipped (fit consumes scene grads only).
            from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads

            def value_and_grad_loss(sc):
                loss_val, grads = l2_loss_and_grads(
                    cfg, pc, sc, cam, light, mat, target, wrt_uniforms=False
                )
                return loss_val, grads[0]
        else:
            def loss(sc):
                img = render_one(sc, cam)
                return jnp.sum((img - target) ** 2)

            value_and_grad_loss = jax.value_and_grad(loss)

        # The per-step update keeps frames serially dependent (no hoisting)
        # but its scale must be negligible: a real step size deforms the
        # scene away from the reference workload — march step counts change
        # and the metric stops measuring the benchmark scene.
        def make_fn(k):
            @jax.jit
            def fn(sc):
                def body(sc_, _):
                    val, g = value_and_grad_loss(sc_)
                    sc_ = jax.tree_util.tree_map(lambda p, gg: p - 1e-30 * gg, sc_, g)
                    return sc_, val

                _, vals = jax.lax.scan(body, sc, None, length=k)
                return vals

            return fn

        args = (scene,)

    if K >= 4:
        # Two-point slope: subtracts the constant window overhead (final
        # sync + dispatch) — see slope_seconds_per_frame.
        seconds = slope_seconds_per_frame(make_fn, args, k_small=K, k_large=4 * K,
                                          rounds=max(3, iters // 2))
    else:
        from sdf3d_tpu.utils.profiling import benchmark_fn

        seconds = benchmark_fn(make_fn(K), *args, iters=max(1, iters)) / K
    rays_s = width * height / seconds
    # Report the device compute actually ran on (jax_default_device may
    # redirect away from default_backend()).
    device = next(iter(jnp.zeros(1).devices()))
    return {
        "metric": f"rays_per_second_{height}p_{mode}_{engine}",
        "value": rays_s,
        "unit": "rays/s",
        "vs_baseline": rays_s / 1e9,
        "seconds_per_frame": seconds,
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
        "card": card_label() if device.platform == "gpu" else None,
    }
