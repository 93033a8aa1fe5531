"""Device-mesh construction helpers.

One logical axis — ``"tiles"`` — data-parallel over image row-slabs.  A 1-D
mesh suits GPUs joined all-to-all by NVLink: every device reaches every
other at the same rate.  Across hosts the compiled program is the same:
``jax.devices()`` spans hosts and `shard_map` lowers the ``psum`` to the
collective library (SURVEY.md §5).  The multi-host *runtime* pieces — distributed
bootstrap, per-host data construction, primary-only side effects — live in
:mod:`sdf3d_tpu.parallel.launch`.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

#: The single data-parallel axis name used across the framework.
tile_axis = "tiles"


def make_mesh(devices=None, n_devices: int | None = None) -> Mesh:
    """1-D mesh over ``devices`` (default: all of ``jax.devices()``).

    ``n_devices`` truncates — handy for scaling-efficiency sweeps (1/2/4/8…)
    and for CPU fakes (``--xla_force_host_platform_device_count``).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (tile_axis,))
