"""Profiling — jax.profiler traces + stage timers.

The reference has only hand-rolled wall-clock timing (SURVEY.md §5.1:
``LatencyTracker`` + ``_timed``). Here that surface is kept
(``recommendit_tpu.utils.latency``, orchestrator ``_timed``) and extended
with the JAX-native tool: ``jax.profiler`` device traces viewable in
TensorBoard/Perfetto, plus a lightweight device-time measurement helper for
kernel benchmarking.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict

import jax

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/jax-trace", enabled: bool = True):
    """Capture a jax.profiler trace (open with TensorBoard or Perfetto).

    Usage::

        with device_trace("/tmp/trace"):
            train_step(...)
    """
    if not enabled:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("Profiler trace written to %s", log_dir)


def time_jitted(fn: Callable, *args, iters: int = 50, warmup: int = 2) -> Dict:
    """Steady-state wall time of a jitted callable (median over iters,
    post-warmup, blocking on the final result)."""
    import numpy as np

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "median_ms": float(np.median(times) * 1e3),
        "p10_ms": float(np.percentile(times, 10) * 1e3),
        "p90_ms": float(np.percentile(times, 90) * 1e3),
        "iters": iters,
    }


class StageTimer:
    """Named stage wall-clock accounting (orchestrator/_timed analogue,
    reusable anywhere)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def report(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self.times.items()}
