"""Phase timers and profiler integration.

The reference's observability is manual wall-clock segmentation of the
training step (SURVEY.md §5: forward/backward/optimizer timed inside
``run_training_step``, fed into AverageMeters). This module provides the
equivalents:

- ``PhaseTimer``: named wall-clock segments with device-sync fencing
  (``block_until_ready``) so async dispatch doesn't hide work;
- ``trace``: a context manager around ``jax.profiler`` emitting an XPlane
  trace for TensorBoard when enabled (no-op otherwise) — the profiler
  integration the reference lacks.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    """Accumulate wall-clock per named phase.

    Usage::

        timer = PhaseTimer()
        with timer.phase("forward", sync=loss):
            loss = fwd(...)
        timer.averages()  # {'forward': seconds}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def averages(self) -> Dict[str, float]:
        return {
            k: self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with jax.profiler when ``log_dir`` is set
    (view with TensorBoard); no-op when None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
