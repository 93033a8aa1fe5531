"""Row-slab sharded render on an 8-virtual-device CPU mesh."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

import _common  # noqa: E402,F401  (sys.path bootstrap)

import jax  # noqa: E402

import sdf3d_tpu as s  # noqa: E402
from sdf3d_tpu.parallel import make_mesh, render_sharded  # noqa: E402


def main():
    devices = jax.devices("cpu")
    mesh = make_mesh(devices, n_devices=min(8, len(devices)))
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=256, height=192)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = s.flagship_scene()

    # Pin the single-device reference to the same (CPU) backend as the mesh:
    # cross-backend float arithmetic differs in last bits, and the claim
    # being demonstrated is bitwise equality of sharded vs unsharded.
    with jax.default_device(devices[0]):
        single = np.asarray(s.render(scene, cam, light, mat, cfg))
    sharded = np.asarray(render_sharded(scene, cam, light, mat, cfg, mesh))
    equal = np.array_equal(single, sharded)
    print(f"mesh: {mesh.shape}")
    print(f"sharded == single-device: {equal}")
    print(f"output shape: {sharded.shape}")
    assert equal, "sharded render must be bitwise identical on the same backend"

    # The fused Triton kernel per row slab (interpret mode on the CPU mesh),
    # interleaved row blocks so every device sees a representative mix.
    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.parallel import render_pallas_sharded

    pc = PallasRenderConfig(interpret=True)
    kernel_img = np.asarray(
        render_pallas_sharded(scene, cam, light, mat, cfg, mesh, pc, layout="interleaved")
    )
    # Ray-form kernel vs the XLA reference: agreement to the documented
    # ~1-ulp-per-step class (a few razor-edge pixels land ~1e-5).
    err = np.abs(kernel_img - single).max(axis=-1)
    print(f"kernel sharded vs single-device: max |err| {err.max():.2e}, "
          f"pixels > 1e-3: {(err > 1e-3).sum()}")
    assert (err > 1e-3).sum() == 0 and float(err.mean()) < 1e-5

if __name__ == "__main__":
    main()
