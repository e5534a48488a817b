"""Step-time / throughput counters and a ``torch.profiler`` trace hook.

Counterpart of ``enf_pde_tpu/utils/profiling.py``:

- ``StepTimer``: wall-clock EMA of the step time and the derived throughput, as in the
  JAX package;
- ``trace``: a context manager around ``torch.profiler`` in place of ``jax.profiler``.
  It records host operations and, where a CUDA device is present, the device's kernels
  and copies, and writes them as a Chrome trace, ``<log_dir>/trace.json``, which
  ``chrome://tracing`` or Perfetto opens. It yields the profiler, whose
  ``key_averages()`` sums the time of each operation.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["StepTimer", "trace"]


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._avg: Optional[float] = None
        self._t: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the EMA step time in seconds (None on first)."""
        now = time.perf_counter()
        if self._t is not None:
            dt = now - self._t
            self._avg = dt if self._avg is None else self.ema * self._avg + (1 - self.ema) * dt
        self._t = now
        return self._avg

    def throughput(self, items_per_step: int) -> Optional[float]:
        return items_per_step / self._avg if self._avg else None


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('outputs/trace') as prof: step(...)``; the device's
    work is waited for before the trace is written to ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
