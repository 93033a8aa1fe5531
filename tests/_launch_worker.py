"""Worker process for the real 2-process ``jax.distributed`` test
(tests/test_launch.py).  Run as::

    python tests/_launch_worker.py <port> <process_id> <outdir>

Each worker initializes the distributed runtime against a localhost
coordinator, runs a short sharded fit over the *global* (2 processes × 2
CPU devices) mesh, and writes its observations to ``out_p<id>.json``.
Checkpoint dirs are per-process on purpose: host-0 gating means only
``ckpt_p0`` may ever appear.
"""

import json
import os
import sys


def main() -> None:
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    from sdf3d_tpu.parallel import launch

    launch.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)

    import dataclasses

    import jax
    import numpy as np

    import sdf3d_tpu as s
    from sdf3d_tpu.fit import FitConfig, fit_scene

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()
    mesh = launch.global_mesh()

    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=48)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = np.asarray(s.render(s.reference_scene(), cam, light, mat, cfg))
    scene0 = s.sdf.union(
        s.sdf.ground_plane(),
        s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25),
    )

    # Production multi-host shape: a row-block loader, so no host ever feeds
    # the full image (the array above exists only to back the test loader).
    def target_rows(abs_rows):
        return target[np.asarray(abs_rows)]

    ckpt = os.path.join(outdir, f"ckpt_p{pid}")
    result = fit_scene(
        target_rows, scene0, cam, light, mat, cfg,
        # log_every=2: the logged loss history is SHORTER than the step
        # count, so the resume broadcast must carry the true entry count
        # (round-4 advisory: zero-padding corrupted resumed histories).
        FitConfig(steps=4, learning_rate=1e-2, log_every=2,
                  checkpoint_every=2, checkpoint_dir=ckpt),
        mesh=mesh,
    )

    out = {
        "process": int(jax.process_index()),
        "losses": [float(x) for x in result.losses],
        "radius": float(result.scene.b.radius),
        "steps_run": int(result.steps_run),
        "ckpt_state_written": os.path.exists(os.path.join(ckpt, "state.npz")),
    }
    with open(os.path.join(outdir, f"out_p{pid}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
