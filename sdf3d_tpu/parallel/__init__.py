"""Multi-device execution: tile-sharded rendering over a device mesh.

The reference is single-process, single-GPU (SURVEY.md §2: no distributed
code anywhere in its tree); its only parallel axis is the fragment grid.  The
scaling story here keeps exactly that axis: **shard the pixel grid** across
devices (rows of the image → row slabs per device) while scene / camera /
light / material parameters stay replicated, and all-reduce parameter
gradients with ``psum`` (NCCL between GPUs; BASELINE north star).

Multi-host execution lives in :mod:`sdf3d_tpu.parallel.launch`:
``jax.distributed`` bootstrap, per-host row-shard construction of ray
bundles/targets, and the process-0 side-effect gate — imported lazily here
(``from sdf3d_tpu.parallel import launch``) because touching
``jax.distributed`` state at import time is wrong for single-process users.
"""

from sdf3d_tpu.parallel.mesh import make_mesh, tile_axis
from sdf3d_tpu.parallel.shard_render import (
    render_sharded,
    render_pallas_sharded,
    loss_and_grad_sharded,
)

__all__ = [
    "make_mesh",
    "tile_axis",
    "render_sharded",
    "render_pallas_sharded",
    "loss_and_grad_sharded",
]
