"""The step runner of ``run``, ``run_with_snapshots`` and ``run_steps``:
on one card, replayed CUDA graphs of a model's step (the counterpart of
the JAX package's compiled ``lax.scan`` chunks, ``niwqg_tpu/api.py``
``_chunk`` and ``_chunk_with_diags``).

A :class:`StepRunner` advances its model's state ``n`` steps at a time,
between two host events (a status line, a snapshot, a yield). A step whose
*pre-step* counter is a multiple of ``tdiags`` also evaluates the active
diagnostics into one vector, stored as a row of a buffer on the device,
and, in the stale-gradient mode, refreshes the wave gradients after that
evaluation (the reference's order). The rows are fetched in one transfer
at the end of the chunk (``SeriesAccumulator.append_rows``). The state,
the series and their sample times come out as the per-step loop
(``_ModelBase._step_forward``) makes them.

On one CUDA card (``device.type == "cuda"`` and no mesh) every step is a
replay of one of two graphs that read and write one set of static state
buffers, one per tensor leaf of the state:

  A  one step;
  B  one step and a diagnostics sample (the vector ``B.vec``), the
     refresh after it in the stale-gradient mode.

Each is captured after a step of its kind has run eagerly on the runner's
side stream, as PyTorch documents for the warm-up: that step is a real
step of the run, and it creates cuFFT plans, cuBLAS workspaces, K1's
library state and its launch counters before the capture. B is captured
again when the active diagnostics change (it is keyed by their names).
Both graphs share one memory pool; that is safe because the only tensors
that outlive a replay are the static buffers (allocated outside the pool)
and ``B.vec``, which is copied into its row right after each replay of
B. A chunk copies the model's state into the static buffers, replays, and
copies the state out into fresh tensors: a state a caller holds never
aliases the buffers.
The step counter ``tc`` is a Python integer that the runner keeps on the
host (inside a graph ``tc + 1`` would be frozen at capture).

A failed capture or replay raises; nothing retries without the graph.
Where there is no graph (``device.type == "cpu"``) or the model lies on a
mesh, the same chunks call the step and the diagnostics directly: K2's
launches pass a target, epoch and buffer parity that the host counts per
call, which a replay would repeat, and a gloo group cannot be captured.

K1 counts its launches on the card (``ops.csplit_mm.counts``), so its
counts are the launches that replays ran; K2, whose counts grow at the
host's call, never runs in a graph.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Optional

import torch


def _is_state(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(s):
    """The tensor leaves of a state ``NamedTuple`` (nested ones too), in
    field order; ``tc`` and ``None`` are not leaves."""
    out = []
    for v in s:
        if _is_state(v):
            out += _leaves(v)
        elif torch.is_tensor(v):
            out.append(v)
    return out


def _rebuild(template, leaves):
    """``template`` with its tensor leaves replaced, in order, from the
    iterator ``leaves``."""
    vals = []
    for v in template:
        if _is_state(v):
            v = _rebuild(v, leaves)
        elif torch.is_tensor(v):
            v = next(leaves)
        vals.append(v)
    return type(template)(*vals)


def _buffer_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor with ``t``'s sizes, strides and storage
    offset, so that a step reads a copy in the layout it reads ``t`` in
    (reductions pick their order by layout)."""
    extent = t.storage_offset() + 1 + sum(
        (n - 1) * st for n, st in zip(t.shape, t.stride()))
    return torch.empty(extent, dtype=t.dtype, device=t.device).as_strided(
        t.shape, t.stride(), t.storage_offset())


def _copy_of(s):
    """A state of fresh tensors with the values and layouts of ``s``."""
    return _rebuild(s, iter([_buffer_like(t).copy_(t) for t in _leaves(s)]))


def _diag_vector(values: dict) -> torch.Tensor:
    """The diagnostics of one sample as one vector, in ``values``' order.
    Every value must be a tensor on the model's device: inside a CUDA graph
    a host number would be a constant fixed at capture."""
    parts = []
    for name, v in values.items():
        if not torch.is_tensor(v):
            raise TypeError(
                f"diagnostic {name!r} returned a {type(v).__name__}, not a "
                "tensor: a run evaluates the diagnostics on the device, "
                "where a host value would be a constant")
        parts.append(v.reshape(()))
    return torch.stack(parts)


class _Samples:
    """The diagnostics samples of one chunk: rows of a buffer on the
    device, in the order of ``names``."""

    def __init__(self, n: int):
        self.n, self.j = n, 0
        self.rows = self.names = None

    def add(self, names, vec):
        if self.rows is None:
            self.rows = vec.new_empty((self.n, vec.numel()))
        self.rows[self.j].copy_(vec)
        self.names, self.j = names, self.j + 1


class _Graph:
    """A captured step (A) or step with a diagnostics sample (B): the
    graph and, for B, its vector and the vector's names."""

    __slots__ = ("graph", "names", "vec", "capture_ms")

    def __init__(self, graph, names, vec, capture_ms):
        self.graph = graph
        self.names = names
        self.vec = vec
        self.capture_ms = capture_ms


class StepRunner:
    """Advances one model (``api._ModelBase``) in chunks; see the module
    docstring. ``graphs`` is true on one CUDA card without a mesh, and
    nowhere else."""

    def __init__(self, model):
        # no reference cycle: a model that is dropped frees its graphs at
        # once, not in a garbage collection that might fall inside another
        # model's capture (which refuses the graphs' destruction)
        self._model = weakref.ref(model)
        device = model.kernel.device
        self.graphs = device.type == "cuda" and model._mesh is None
        self.device = device
        self._static = None
        self._stream = None
        self._pool = None
        self._step_graph: Optional[_Graph] = None
        self._diag_graph: Optional[_Graph] = None
        self.replays = 0

    # -- what one step does, called directly ---------------------------------
    @property
    def model(self):
        return self._model()

    def _active_names(self):
        return tuple(k for k, d in self.model.registry.entries.items()
                     if d.active)

    def _direct(self, s, sampled: bool):
        """One step of ``s`` (with a diagnostics sample where ``sampled``):
        ``(state, names, vector or None)``."""
        m, K = self.model, self.model.kernel
        t_prev = s.t
        s = K.step(s)
        if not sampled:
            return s, None, None
        values = m._diag_fn(s, t_prev)
        vec = _diag_vector(values)
        if m._stale_grads:
            # after the evaluation, as the reference's pe_niw does
            s = K.refresh_phi_gradients(s)
        return s, tuple(values), vec

    # -- the chunk -------------------------------------------------------------
    def advance(self, n: int, diags: bool = True):
        """Advance the model's state ``n`` steps, sampling the diagnostics
        (where ``diags``) at every pre-step counter that is a multiple of
        ``tdiags``; the samples reach the model's series in one fetch."""
        m = self.model
        if n <= 0:
            return
        tc0 = m.state.tc
        tdiags = m.params.tdiags
        sampled = [diags and (tc0 + i) % tdiags == 0 for i in range(n)]
        samples = _Samples(sum(sampled))
        if not self.graphs:
            s = m.state
            for smp in sampled:
                s, names, vec = self._direct(s, smp)
                if smp:
                    samples.add(names, vec)
            m.state = s
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            try:
                with torch.cuda.stream(self._stream):
                    s = self._replay_chunk(m.state, tc0, sampled, samples)
            finally:
                # the caller's stream waits for the chunk before the old
                # state can be freed into its pool and reused
                cur.wait_stream(self._stream)
            m.state = s
        if samples.rows is not None:
            m._diag_acc.append_rows(samples.names, samples.rows)

    def _replay_chunk(self, s, tc0, sampled, samples):
        """The chunk on the side stream: replays, and an eager step of a
        kind not captured yet, followed by its capture."""
        resident = False  # the static buffers hold the current state
        for i, smp in enumerate(sampled):
            g = self._graph_for(smp)
            if g is None:
                if resident:
                    s = _copy_of(self._static._replace(tc=tc0 + i))
                    resident = False
                s, names, vec = self._direct(s, smp)
                if smp:
                    samples.add(names, vec)
                self._capture(smp, s)
                continue
            if not resident:
                for buf, t in zip(_leaves(self._static), _leaves(s)):
                    buf.copy_(t)
                resident = True
            g.graph.replay()
            self.replays += 1
            if smp:
                samples.add(g.names, g.vec)
        if resident:
            s = _copy_of(self._static._replace(tc=tc0 + len(sampled)))
        return s

    def _graph_for(self, sampled: bool) -> Optional[_Graph]:
        if not sampled:
            return self._step_graph
        g = self._diag_graph
        if g is not None and g.names != self._active_names():
            # set_active_diagnostics changed the set: capture again
            self._diag_graph = g = None
        return g

    def _capture(self, sampled: bool, template):
        """Capture graph A (or B where ``sampled``) on the static buffers,
        shaped after ``template``, a state just made by the same step."""
        m, K = self.model, self.model.kernel
        if self._static is None:
            self._static = _rebuild(
                template, iter([_buffer_like(t) for t in _leaves(template)]))
        X = self._static
        graph = torch.cuda.CUDAGraph()
        names = vec = None
        t0 = time.perf_counter()
        # no garbage collection inside the capture: one could destroy
        # another graph, which a capturing process may not do
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                t_prev = X.t
                out = K.step(X)
                if sampled:
                    values = m._diag_fn(out, t_prev)
                    names, vec = tuple(values), _diag_vector(values)
                    if m._stale_grads:
                        out = K.refresh_phi_gradients(out)
                _copy_into(X, out)
        finally:
            if collecting:
                gc.enable()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        g = _Graph(graph, names, vec, capture_ms)
        if sampled:
            self._diag_graph = g
        else:
            self._step_graph = g

    def capture_ms(self) -> float:
        """Host ms spent capturing the graphs that are live."""
        return sum(g.capture_ms for g in (self._step_graph, self._diag_graph)
                   if g is not None)


def _copy_into(X, out):
    """Inside a capture: the step's output into the static buffers. An
    output leaf that is a buffer of another leaf is cloned first, so that
    no buffer is read after it was overwritten."""
    xs, outs = _leaves(X), _leaves(out)
    if len(xs) != len(outs):
        raise RuntimeError("the step changed the state's structure")
    ids = {id(x): i for i, x in enumerate(xs)}
    outs = [o.clone() if ids.get(id(o), i) != i else o
            for i, o in enumerate(outs)]
    for x, o in zip(xs, outs):
        if o is not x:
            x.copy_(o)
