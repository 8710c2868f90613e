"""Profiling hooks: jax.profiler traces + wall-clock timers.

Usage:
  with trace("chiprun_out/trace"):    # view in Perfetto/TensorBoard
      run_step()
  with timer() as t: run_step()
  print(t.elapsed)
  stats = time_call(step_fn, *args)   # median of runs after warm-up
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class timer(contextlib.AbstractContextManager):
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def time_call(fn: Callable, *args, warmup: int = 2, iters: int = 10
              ) -> Dict[str, float]:
    """Wall-clock statistics of `fn(*args)`, each call ended by
    `jax.block_until_ready`, after `warmup` untimed calls (which include
    the compilation). Returns median, quartiles, min and max in ms."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ms = np.asarray(ts) * 1e3
    return {
        "median_ms": float(np.median(ms)),
        "q25_ms": float(np.percentile(ms, 25)),
        "q75_ms": float(np.percentile(ms, 75)),
        "min_ms": float(ms.min()),
        "max_ms": float(ms.max()),
        "n": iters,
    }


def format_time(stats: Dict[str, float]) -> str:
    return (
        f"median {stats['median_ms']:.3f} ms (IQR {stats['q25_ms']:.3f}-"
        f"{stats['q75_ms']:.3f}, min {stats['min_ms']:.3f}, "
        f"max {stats['max_ms']:.3f}, n={stats['n']})"
    )
