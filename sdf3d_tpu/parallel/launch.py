"""Multi-host (multi-process) execution: the cross-host axis of the BASELINE
scaling story.

The reference is a single-process desktop app (SURVEY.md §2: no multi-device
code of any kind); the BASELINE scaling row targets 1 device → 1 host (8
devices) → 4 hosts (32 devices).  Within one process, everything in
parallel/shard_render.py already spans hosts *transparently* —
`jax.devices()` is global and `shard_map`'s psum lowers to the collective
library (NCCL between GPUs) —
but a real multi-host run needs three things no single-process code path
provides, and this module supplies them:

1. **Bootstrap** (:func:`initialize`): every process must call
   ``jax.distributed.initialize`` with the same coordinator before any JAX
   computation, so the processes agree on the global device topology.
2. **Per-host data construction** (:func:`row_sharded`,
   :func:`fit_arrays`): global inputs must be assembled from *process-local*
   shards with ``jax.make_array_from_single_device_arrays`` — materializing
   the full-image ray bundle / target on every host would multiply host
   memory and H2D traffic by the process count for no reason (each host only
   marches its own rows).
3. **Primary-only side effects** (:func:`is_primary`): checkpoint and
   metrics writes must happen on exactly one process — every process racing
   ``os.replace`` on the same checkpoint directory is corruption waiting for
   a shared filesystem (checkpoint.py gates on this).

Verified by a real 2-process CPU ``jax.distributed`` test
(tests/test_launch.py): subprocess-spawned workers, localhost coordinator,
one fit step parity vs the single-process run, exactly one checkpoint writer.

Launch recipe (one command per host)::

    # host 0                                  # host k
    python fit_job.py --coordinator h0:1234 \\
        --num-processes 4 --process-id 0      ... --process-id k

    # fit_job.py
    from sdf3d_tpu.parallel import launch
    launch.initialize(args.coordinator, args.num_processes, args.process_id)
    mesh = launch.global_mesh()
    fit_scene(target, scene0, cam, light, mat, cfg, fit_cfg, mesh=mesh)
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdf3d_tpu.parallel.mesh import make_mesh, tile_axis


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               **kwargs) -> None:
    """Bootstrap multi-process JAX (idempotent).

    On CPU/GPU clusters pass the coordinator ``host:port``, the process
    count, and this process's id (nothing discovers them for you).  Must
    run before the first JAX computation on every process.
    """
    # NOTE: must not touch jax.devices()/process_count() here — any backend
    # query initializes XLA and makes jax.distributed.initialize illegal.
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def is_primary() -> bool:
    """True on exactly one process (process_index 0) — the checkpoint/metrics
    writer.  Also true in ordinary single-process runs."""
    return jax.process_index() == 0


def global_mesh(n_devices: int | None = None) -> Mesh:
    """1-D ``"tiles"`` mesh over the *global* device set (all processes).

    Identical to :func:`parallel.mesh.make_mesh` — ``jax.devices()`` already
    spans processes after :func:`initialize` — provided here so launch
    scripts read naturally.
    """
    return make_mesh(n_devices=n_devices)


def abs_rows_for_block(row_lo: int, row_hi: int, height: int, n: int,
                       interleaved: bool = False, tile_h: int = 0) -> np.ndarray:
    """Absolute image rows held by global row block ``[row_lo, row_hi)``.

    Contiguous sharding: the identity ``arange(row_lo, row_hi)``.
    Interleaved row-block sharding (parallel/shard_render.py): the global
    array is stored in device-slab order, where permuted row
    ``g = d·slab + i·tile_h + r`` holds absolute row
    ``i·(n·tile_h) + d·tile_h + r`` — this returns that inverse map, so
    per-host data can be built directly in permuted order with no global
    ``interleave_rows`` pass.
    """
    g = np.arange(row_lo, row_hi)
    if not interleaved:
        return g
    if tile_h <= 0:
        raise ValueError("interleaved layout needs tile_h > 0")
    slab = height // n
    d, rem = g // slab, g % slab
    i, r = rem // tile_h, rem % tile_h
    return i * (n * tile_h) + d * tile_h + r


def row_sharded(mesh: Mesh, global_shape: tuple, make_block,
                dtype=jnp.float32) -> jax.Array:
    """Global array sharded by rows over ``mesh``, assembled from per-process
    blocks — each process calls ``make_block(row_lo, row_hi)`` only for the
    row ranges its *local* devices own and never materializes the full array.

    ``make_block(lo, hi)`` returns a ``(hi - lo,) + global_shape[1:]`` array.
    Single-process meshes work too (every device is local), so the same code
    path is testable on the 8-virtual-device CPU mesh.
    """
    spec = P(tile_axis, *([None] * (len(global_shape) - 1)))
    sharding = NamedSharding(mesh, spec)
    shards = []
    for dev, idx in sharding.addressable_devices_indices_map(global_shape).items():
        rs = idx[0]
        lo = rs.start if rs.start is not None else 0
        hi = rs.stop if rs.stop is not None else global_shape[0]
        block = jnp.asarray(make_block(int(lo), int(hi)), dtype)
        if block.shape != (hi - lo,) + tuple(global_shape[1:]):
            raise ValueError(
                f"make_block({lo}, {hi}) returned shape {block.shape}, "
                f"expected {(hi - lo,) + tuple(global_shape[1:])}"
            )
        shards.append(jax.device_put(block, dev))
    return jax.make_array_from_single_device_arrays(
        tuple(global_shape), sharding, shards
    )


def fit_arrays(mesh: Mesh, camera, render_config, target, target_fn=None,
               interleaved: bool = False, tile_h: int = 0):
    """Per-host construction of the row-sharded fit inputs: returns global
    ``(origins, directions, target)`` arrays for :func:`sdf3d_tpu.fit.fit_scene`.

    Ray bundles are generated per local row block
    (:func:`camera.camera_rays_for_rows`) — never full-image.  The target:

    - ``target_fn(abs_rows) -> (len(abs_rows), W, C)``: fully local — each
      host loads/produces only its own target rows (pass ``target=None``).
      This is the production multi-host shape (e.g. reading row windows of
      an image file per host).
    - ``target`` array ``(H, W, C)``: convenience — sliced per block (the
      host-side full image exists transiently on each host; fine for tests
      and small images).

    ``interleaved``/``tile_h`` build the device-slab-permuted layout of
    parallel/shard_render.py directly (no global permutation pass).
    """
    from sdf3d_tpu.camera import camera_rays_for_rows

    H, W = render_config.height, render_config.width
    n = mesh.shape[tile_axis]

    def rows_of(lo, hi):
        return abs_rows_for_block(lo, hi, H, n, interleaved, tile_h)

    if target_fn is None:
        if target is None:
            raise ValueError("pass target or target_fn")
        target = jnp.asarray(target, jnp.float32)

        def target_fn(abs_rows):
            return target[np.asarray(abs_rows)]

        channels = int(target.shape[-1])
    else:
        probe = np.asarray(target_fn(np.asarray([0])))
        channels = int(probe.shape[-1])

    # One ray-gen per block: camera_rays_for_rows returns both bundles, so
    # cache per (lo, hi) instead of regenerating for the directions pass.
    ray_cache: dict = {}

    def rays_block(lo, hi):
        if (lo, hi) not in ray_cache:
            ray_cache[(lo, hi)] = camera_rays_for_rows(
                camera, W, H, rows_of(lo, hi), render_config.ray_mode
            )
        return ray_cache[(lo, hi)]

    origins = row_sharded(mesh, (H, W, 3), lambda lo, hi: rays_block(lo, hi)[0])
    directions = row_sharded(mesh, (H, W, 3), lambda lo, hi: rays_block(lo, hi)[1])
    ray_cache.clear()
    target_g = row_sharded(
        mesh, (H, W, channels), lambda lo, hi: target_fn(rows_of(lo, hi))
    )
    return origins, directions, target_g
