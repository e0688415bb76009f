"""Profiling / tracing utilities.

The reference's only performance tooling is CUDA-event timing in
measure_inference_speed.py (reference :25-47).  Here: ``jax.profiler``
traces (viewable in TensorBoard/Perfetto), XLA cost analysis (FLOPs /
bytes per compiled step), and one host-clock timer whose every timed
window ends in ``jax.block_until_ready`` (JAX dispatch returns before the
device finishes, so a window without it measures the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Union

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace around a block of work."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """FLOPs / bytes of the compiled ``fn`` at the example shapes."""
    compiled = jax.jit(fn).lower(*example_args).compile()
    ca = compiled.cost_analysis() or {}
    return {
        "flops": float(ca.get("flops", 0.0)),
        "bytes_accessed": float(ca.get("bytes accessed", 0.0)),
    }


def timed_per_exec(
    fn: Callable,
    *args,
    reps: int = 20,
    warmup: int = 1,
    per_rep: bool = False,
) -> Union[float, List[float]]:
    """Host-clock seconds per call of ``fn(*args)`` after ``warmup`` calls
    (the first one compiles).

    ``per_rep=False``: ``reps`` calls are dispatched back to back and the
    window ends when the last result is ready; returns the mean seconds per
    call.  ``per_rep=True``: each call is timed alone and synced before the
    next (the reference's per-rep device sync); returns every rep's
    seconds.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    if per_rep:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        return times
    t0 = time.perf_counter()
    r = None
    for _ in range(reps):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / reps


def throughput_report(fn: Callable, *args, batch_size: int, reps: int = 20) -> dict:
    """Per-exec seconds, items/sec, and achieved FLOP/s + bytes/s."""
    per_exec = timed_per_exec(fn, *args, reps=reps)
    costs = cost_analysis(fn, *args)
    return {
        "sec_per_exec": per_exec,
        "items_per_sec": batch_size / per_exec,
        "tflops_per_sec": costs["flops"] / per_exec / 1e12,
        "gbytes_per_sec": costs["bytes_accessed"] / per_exec / 1e9,
    }
