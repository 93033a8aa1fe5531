#!/usr/bin/env python
"""Benchmark: one JSON line — 1080p sphere-trace fit step (fwd+bwd) rays/s.

Runs the fused fit kernel (``engine="pallas"``) on the GPU in this one
process.  Without a GPU it exits non-zero and prints no number: a number
from another device would not be this benchmark.

    python bench.py
"""

import json
import sys


def main() -> int:
    import jax

    from sdf3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench.py: JAX found no GPU (platform {platform!r})", file=sys.stderr)
        return 2
    from sdf3d_tpu.bench import run_benchmark

    print(json.dumps(run_benchmark(engine="pallas", mode="fwd_bwd")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
