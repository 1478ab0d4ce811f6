"""Tracing and step timing.

``trace(logdir)`` records a ``torch.profiler`` window (host and card
activity) and writes it as a Chrome trace into ``logdir``
(``trace.json``; open it in Perfetto or chrome://tracing); with no
``logdir`` it does nothing.  ``StepTimer`` reports step-time percentiles
and items per second (``transeditor_tpu/utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the body: CPU activity, and the card's when CUDA is
    available; the trace lands in ``logdir/trace.json``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Rolling step-time stats; call tick() once per step."""

    def __init__(self, window: int = 200, items_per_step: int = 1):
        self.window = window
        self.items = items_per_step
        self.times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def stats(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "step_ms_p50": float(np.percentile(t, 50) * 1e3),
            "step_ms_p95": float(np.percentile(t, 95) * 1e3),
            "items_per_sec": self.items / float(np.mean(t)),
        }
