"""The step runner of ``run``, ``run_with_snapshots`` and ``run_steps``:
replayed CUDA graphs of a model's step, on one card and on a mesh whose
collectives stay on the card (the counterpart of the JAX package's compiled
``lax.scan`` chunks, ``niwqg_tpu/api.py`` ``_chunk`` and
``_chunk_with_diags``, which hold a mesh's collectives inside).

A :class:`StepRunner` advances its model's state ``n`` steps at a time,
between two host events (a status line, a snapshot, a yield). A step whose
*pre-step* counter is a multiple of ``tdiags`` also evaluates the active
diagnostics into one vector, stored as a row of a buffer on the device,
and, in the stale-gradient mode, refreshes the wave gradients after that
evaluation (the reference's order). The rows are fetched in one transfer
at the end of the chunk (``SeriesAccumulator.append_rows``). The state,
the series and their sample times come out as the per-step loop
(``_ModelBase._step_forward``) makes them.

On CUDA every step is a replay of one of two graphs that read and write
one set of static state buffers, one per tensor leaf of the state:

  A  one step;
  B  one step and a diagnostics sample (the vector ``B.vec``), the
     refresh after it in the stale-gradient mode.

Each is captured after a step of its kind has run eagerly on the runner's
side stream, as PyTorch documents for the warm-up: that step is a real
step of the run, and it creates cuFFT plans, cuBLAS workspaces, K1's
library state, K2's plans and the launch counters before the capture. B
is captured again when the active diagnostics change (it is keyed by their
names). The static buffers keep the memory layout of the state that
first eager step made; a state set later in another layout (a restored
checkpoint, say) is copied into them, so a replay sums in the order of
the buffers' layout, which may round otherwise than an eager step on the
state as set. The graphs share one memory pool; that is safe because the only
tensors that outlive a replay are the static buffers (allocated outside
the pool) and ``B.vec``, which is copied into its row right after each
replay of B. A chunk copies the model's state into the static buffers,
replays, and copies the state out into fresh tensors: a state a caller
holds never aliases the buffers. The step counter ``tc`` is a Python
integer that the runner keeps on the host (inside a graph ``tc + 1`` would
be frozen at capture).

On a mesh the graphs are the same, per rank, wherever the step's
collectives stay on the card (``parallel.mesh.capturable``; the runner
keeps the reason in ``why_not`` where they do not). Every rank makes the
same calls, so every rank captures and replays at the same steps, and a
graph holds its collectives in the same order on every rank. Two routes:

- K2 (``transform_opts={"pallas_a2a": True}``): every exchange inside a
  step is a K2 launch, the transposes and also the domain sums and maxima
  and the Hermitian reflection (``parallel/mesh.py``), and a step makes no
  call of ``torch.distributed``. A K2 launch takes nothing from the host
  that changes from call to call but the buffer parity of its key
  (``parallel/a2a.py``), which is baked into the graph, in the task table
  it reads and the output its readers read. So a capture records a
  :class:`~.parallel.a2a.Tape` of its keys' parities, each graph is kept
  per variant of those parities, a replay first counts its calls with the
  group (``PeerGroup.parity``, which raises on a variant of the wrong
  parity) and a graph whose calls of some key are odd is captured in both
  variants, the second when a replay first needs it (a capture runs
  nothing and asks nothing of the peers).
- The default route on NCCL (a card per rank): the transposes are
  ``all_to_all_single`` (with ``overlap_chunks`` > 1 asynchronous, each
  ``wait`` joining NCCL's stream back into the capturing one), the sums
  and maxima ``all_reduce``, the reflection an uneven
  ``all_to_all_single``; the graph holds NCCL's kernels. They take no host
  value that changes from call to call, so one graph of each kind serves
  every step. The communicator exists before any capture: the eager step
  before it made every collective the graph holds. The gathers of
  snapshots and checkpoints and the barriers stay eager on the same
  communicator, between chunks. The graphs must die before the
  communicator: :func:`release_all`, which ``multihost.shutdown`` calls.

On gloo (ranks that share a card) every payload goes through the host, so
the chunks call the step directly there, as on the host.

The runner's host work is timed by spans (``utils/profiling.py``): in a
chunk ``runner.enqueue`` (copies in, parities, replays, and any first step
and capture), ``runner.copy_out`` and ``runner.fetch`` (the rows' transfer,
which waits for the chunk to have run); at set-up ``runner.first_step`` and
``runner.capture``. No span lies inside a step or a capture's region.

A failed capture or replay raises; nothing retries without the graph.
K1 and K2 count their launches on the card (``ops.csplit_mm.counts``,
``parallel.a2a.counts``), so their counts are the launches that replays
ran.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Optional

import torch

from .parallel.mesh import capturable
from .utils.profiling import span


# the runners that hold captured graphs (release_all)
_LIVE = weakref.WeakSet()


def release_all():
    """Drop the captured graphs of every runner in this process, after the
    work queued on the card has run; a runner's next chunk captures again.
    A graph on an NCCL mesh launches the communicator's kernels, and
    destroying the process group under a live one hangs:
    ``parallel.multihost.shutdown`` calls this first."""
    if not _LIVE:
        return
    torch.cuda.synchronize()
    for runner in list(_LIVE):
        runner._graphs = {False: {}, True: {}}
        runner._static = None
    _LIVE.clear()


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
    graph, for B its vector and the vector's names, and on a mesh the
    tape of its K2 calls (``None`` on one card)."""

    __slots__ = ("graph", "names", "vec", "capture_ms", "tape")

    def __init__(self, graph, names, vec, capture_ms, tape):
        self.graph = graph
        self.names = names
        self.vec = vec
        self.capture_ms = capture_ms
        self.tape = tape

    def variant(self) -> tuple:
        """The K2 parities this graph was captured at."""
        return () if self.tape is None else tuple(self.tape.entry.values())


class StepRunner:
    """Advances one model (``api._ModelBase``) in chunks; see the module
    docstring. ``graphs`` is true on CUDA, on one card or on a mesh whose
    step keeps its collectives on the card (K2, or NCCL), and nowhere
    else; ``why_not`` says why where it is false."""

    def __init__(self, model):
        # no reference cycle: a model that is dropped frees its graphs at
        # once, not in a garbage collection that might fall inside another
        # model's capture (which refuses the graphs' destruction)
        self._model = weakref.ref(model)
        device = model.kernel.device
        kmesh = getattr(model.kernel, "mesh", None)
        # the K2 group of the step's exchanges (parallel/mesh.py)
        self._group = kmesh.k2 if kmesh is not None else None
        self.graphs, self.why_not = capturable(kmesh, device)
        self.device = device
        self._static = None
        self._stream = None
        self._pool = None
        # graph A (False) and B (True), each by the variant of its parities
        self._graphs = {False: {}, True: {}}
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
            with span("runner.enqueue"):
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
                    with span("runner.enqueue"):
                        s, resident = self._replay_chunk(m.state, tc0,
                                                         sampled, samples)
                    if resident:
                        with span("runner.copy_out"):
                            s = _copy_of(self._static._replace(tc=tc0 + n))
            finally:
                # the caller's stream waits for the chunk before the old
                # state can be freed into its pool and reused
                cur.wait_stream(self._stream)
            m.state = s
        if samples.rows is not None:
            # the rows' transfer waits for the chunk to have run
            with span("runner.fetch"):
                m._diag_acc.append_rows(samples.names, samples.rows)

    def _replay_chunk(self, s, tc0, sampled, samples):
        """The chunk on the side stream: replays, and an eager step of a
        kind not captured yet, followed by its capture. Returns the state
        and whether the static buffers hold it (it is then copied out)."""
        resident = False  # the static buffers hold the current state
        for i, smp in enumerate(sampled):
            g = self._graph_for(smp)
            if g is None and not self._graphs[smp]:
                if resident:
                    s = _copy_of(self._static._replace(tc=tc0 + i))
                    resident = False
                # the eager step makes cuFFT's and K2's plans and the
                # kernels' state, which the capture must find made
                with span("runner.first_step"):
                    s, names, vec = self._direct(s, smp)
                if smp:
                    samples.add(names, vec)
                self._capture(smp, s)
                continue
            if g is None:
                # the other parity of K2's buffers: capture that variant
                g = self._capture(smp, None)
            if not resident:
                for buf, t in zip(_leaves(self._static), _leaves(s)):
                    buf.copy_(t)
                resident = True
            if self._group is not None:
                self._group.parity(replay=g.tape)
            g.graph.replay()
            self.replays += 1
            if smp:
                samples.add(g.names, g.vec)
        return s, resident

    def _graph_for(self, sampled: bool) -> Optional[_Graph]:
        """The graph of this kind for K2's parities now, or ``None``."""
        variants = self._graphs[sampled]
        if not variants:
            return None
        g = next(iter(variants.values()))
        if sampled and g.names != self._active_names():
            # set_active_diagnostics changed the set: capture again
            variants.clear()
            return None
        if self._group is None:
            return g
        return variants.get(self._group.signature(g.tape.keys()))

    @span("runner.capture")
    def _capture(self, sampled: bool, template) -> _Graph:
        """Capture graph A (or B where ``sampled``) on the static buffers,
        shaped after ``template``, a state just made by the same step (or
        ``None`` once they exist), at the K2 parities of now."""
        m, K = self.model, self.model.kernel
        if self._static is None:
            self._static = _rebuild(
                template, iter([_buffer_like(t) for t in _leaves(template)]))
        X = self._static
        graph = torch.cuda.CUDAGraph()
        names = vec = tape = None
        t0 = time.perf_counter()
        # no garbage collection inside the capture: one could destroy
        # another graph, which a capturing process may not do
        collecting = gc.isenabled()
        gc.disable()
        if self._group is not None:
            self._group.parity(record=True)
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
            if self._group is not None:
                tape = self._group.parity(record=False)
            if collecting:
                gc.enable()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        g = _Graph(graph, names, vec, capture_ms, tape)
        self._graphs[sampled][g.variant()] = g
        _LIVE.add(self)
        return g

    def capture_ms(self) -> float:
        """Host ms spent capturing the graphs that are live."""
        return sum(g.capture_ms for v in self._graphs.values()
                   for g in v.values())

    def variants(self) -> dict:
        """The graphs that are live: ``{"A": n, "B": n}``, variants of K2's
        parities counted apart."""
        return {"A": len(self._graphs[False]), "B": len(self._graphs[True])}


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
