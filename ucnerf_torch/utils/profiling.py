"""Tracing and rate counting, the port of ``ucnerf_tpu.utils.profiling``.

- ``trace(logdir)``: ``torch.profiler`` over the block (the host and, on a
  card, the device), written as a chrome trace into ``logdir``.
- ``RateMeter``: running rays/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class RateMeter:
    """Exponentially smoothed rate counter (items/s)."""

    def __init__(self, smoothing: float = 0.9):
        self._t = None
        self._rate = None
        self._smoothing = smoothing
        self.total = 0

    def update(self, n_items: int) -> float:
        now = time.perf_counter()
        self.total += n_items
        if self._t is not None:
            inst = n_items / max(now - self._t, 1e-9)
            self._rate = (inst if self._rate is None else
                          self._smoothing * self._rate
                          + (1 - self._smoothing) * inst)
        self._t = now
        return self._rate or 0.0

    @property
    def rate(self) -> float:
        return self._rate or 0.0
