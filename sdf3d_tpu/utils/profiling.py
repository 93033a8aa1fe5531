"""Profiling: wall-clock benchmarking and the rays/s meter.

The reference's entire instrumentation is a µs tic/toc pair per frame
(``Code/src/main.cpp:89,97`` in the reference).  Replacements here
(SURVEY.md §5): a wall-clock harness ended by a device-sync barrier
(compile excluded via warmup), the rays/s metric itself, and a thin
``jax.profiler`` trace hook for Perfetto/XProf capture.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


class Timer:
    """Context-manager wall timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


def force_completion(out) -> None:
    """Completion barrier for ``out`` (any pytree of arrays): returns once
    every leaf has been computed on the device."""
    jax.block_until_ready(out)


def benchmark_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs) -> float:
    """Amortized wall-clock seconds per call of ``fn`` (device-synchronized).

    ``warmup`` calls absorb jit compilation and autotuning (including the
    tiny sync executable).  The timed section enqueues ``iters`` calls
    back-to-back and forces completion of the *last* result: the device
    executes the queue serially, so elapsed/iters is steady-state per-call
    time with the host→device round-trip amortized away.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    if out is not None:
        force_completion(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    force_completion(out)
    return (time.perf_counter() - t0) / iters


def benchmark_fn_latency(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs) -> float:
    """Median per-call latency including one full host sync per call.

    Use for interactive-frame-time questions; use :func:`benchmark_fn` for
    throughput (rays/s) questions.
    """
    for _ in range(warmup):
        force_completion(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force_completion(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def rays_per_second(width: int, height: int, seconds_per_frame: float, frames: int = 1) -> float:
    """Primary rays per second — the benchmark metric (BASELINE.md)."""
    return width * height * frames / max(seconds_per_frame, 1e-12)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``jax.profiler`` trace (view in XProf/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
