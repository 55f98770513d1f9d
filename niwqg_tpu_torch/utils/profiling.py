"""Profiling and runtime counters (port of ``niwqg_tpu/utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler plugin
  and ``chrome://tracing`` read) into ``logdir``; the card's kernels are
  traced when CUDA is available;
- :class:`StepTimer`: wall time per step (steps/s, grid-point steps/s)
  with percentile summaries. Where CUDA is available it synchronises the
  card when a step is entered and left, so that each sample is the step's
  device work and not only its launches.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed code into
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Wall-time accounting for simulation steps: ``with timer:`` around
    each step. Where CUDA is available the current card is synchronised
    at both ends of a sample (a mesh rank's current card is its own)."""

    def __init__(self, grid_points: int):
        self.grid_points = grid_points
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def steps(self) -> int:
        return len(self.samples)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = np.asarray(self.samples)
        med = float(np.median(s))
        return {
            "steps": int(s.size),
            "median_s": med,
            "p10_s": float(np.percentile(s, 10)),
            "p90_s": float(np.percentile(s, 90)),
            "steps_per_s": 1.0 / med,
            "grid_point_steps_per_s": self.grid_points / med,
        }
