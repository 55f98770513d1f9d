"""Profiling and runtime counters (port of ``niwqg_tpu/utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler plugin
  and ``chrome://tracing`` read) into ``logdir``; the card's kernels are
  traced when CUDA is available;
- :class:`StepTimer`: wall time per step (steps/s, grid-point steps/s)
  with percentile summaries. Where CUDA is available it synchronises the
  card when a step is entered and left, so that each sample is the step's
  device work and not only its launches;
- :func:`host_peak_gb`: this process's peak resident memory on the host;
- :func:`span` and :func:`count`: the program's own spans and host
  counters, kept in memory and read with :func:`spans` and
  :func:`counters` (:func:`reset` clears both).

A span is named ``layer.what`` (``model.init``, ``runner.capture``,
``shell.chunk``, ...) and times set-up and the run loop's host work
between chunks, never a step: a replayed graph runs no host code, so a
span inside a step would time only its capture. The one exception is
set-up that an eager step reaches the first time it meets a shape: K2's
plans (``mesh.k2_group``) and a kernel library's first load
(``cuda_build.load``), neither ever made in a capture. A span records
its name, its start and end on ``time.perf_counter_ns()`` and its parent,
the innermost span open in its thread. Each name keeps its totals (calls and
seconds); the first :data:`MAX_SPANS` spans are kept one by one, later ones
count in the totals only. While a ``torch.profiler`` is active (:func:`trace`,
say) a span also opens a ``record_function`` of its name, so that it lies
in the trace on the clock of the card's kernels; otherwise it costs two
clock reads and an update of its totals. Counters count what has no object
to hang on and no span counts already (a span's ``calls`` in
:func:`spans`' totals): the ETDRK4 table cache (``etdrk4.cache_hit``,
``etdrk4.cache_miss``, ``etdrk4.built``) and the kernels' builds by nvcc
(``cuda_build.built``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

# the spans kept one by one, in the order they opened (totals count all)
MAX_SPANS = 4096

_lock = threading.Lock()
_local = threading.local()
_totals: dict = {}    # name -> [calls, ns]
_records: list = []   # [name, parent record, start ns, end ns]
_dropped = 0
_counters: dict = {}


def _open(name: str) -> list:
    global _dropped
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    rec = [name, stack[-1] if stack else None, time.perf_counter_ns(), None]
    with _lock:
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            _dropped += 1
    stack.append(rec)
    return rec


def _close(rec: list) -> None:
    rec[3] = time.perf_counter_ns()
    _local.stack.pop()
    with _lock:
        t = _totals.setdefault(rec[0], [0, 0])
        t[0] += 1
        t[1] += rec[3] - rec[2]


@contextlib.contextmanager
def span(name: str):
    """Time the enclosed code (or, as a decorator, each call of the
    function) as the span ``name``."""
    rec = _open(name)
    try:
        if _profiler_enabled():
            with record_function(name):
                yield
        else:
            yield
    finally:
        _close(rec)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> dict:
    """What the spans recorded: ``totals`` (``{name: {"calls", "s"}}``),
    ``list``, the first :data:`MAX_SPANS` spans in the order they opened
    (each ``{"name", "parent", "start_ns", "end_ns"}``: ``parent`` the
    index of its parent in the list or ``None``, ``end_ns`` ``None`` while
    it is open), and ``dropped``, the spans left out of the list."""
    with _lock:
        recs = list(_records)
        totals = {k: {"calls": c, "s": ns * 1e-9}
                  for k, (c, ns) in _totals.items()}
        dropped = _dropped
    index = {id(r): i for i, r in enumerate(recs)}
    return {"totals": totals, "dropped": dropped,
            "list": [{"name": n, "parent": index.get(id(p)),
                      "start_ns": t0, "end_ns": t1}
                     for n, p, t0, t1 in recs]}


def counters() -> dict:
    """The host counters: ``{name: count}``."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    global _dropped
    with _lock:
        _totals.clear()
        _records.clear()
        _counters.clear()
        _dropped = 0


def host_peak_gb() -> float:
    """This process's peak resident memory on the host, in GB: Linux's
    ``VmHWM``, which starts anew in a spawned process (``ru_maxrss`` keeps
    the parent's peak across the exec), else ``ru_maxrss``."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


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
