"""The communication census of one step on a mesh (the census of the JAX
package's ``scripts/traffic_audit.py``).

Two tallies over one eager step of a model on a mesh:

- :class:`Census` wraps the kernel's transform provider and counts the
  fields each of its seven 2-D transforms receives (the product of the
  leading axes of a batched call), as JAX's ``_Census`` does at trace
  time. :func:`step_census` also points the kernel's aliases of those
  methods (``_fwd_real``, ``_inv_real``, QG's ``_fwd``/``_bwd``, bound
  at construction) at the wrapper for the step, as JAX rebinds
  ``_fwd_real``/``_inv_real``. Each field of a pencil transform is one
  ``(nx/P, nx)`` block through the transpose (a packed pair of real
  fields is one), a half spectrum one ``(nx/P, nx//2+1+rfft_pad)``
  block: that gives the model's bytes.
- :func:`transport` tallies what the exchanges themselves were given,
  where they are called: on the K2 route every launch's blocks by kind
  (``a2a._exchange``: ``fwd``, ``inv``, ``gather``, ``reflect``), on the
  default route every ``Mesh.all_to_all_single`` (the transposes, and with
  uneven splits the reflection) and ``Mesh.all_reduce`` (sums, maxima).
  ``Mesh.all_gather`` counts where a step asks for it, not where K2's
  plain version gathers the ranks' blocks on the host. K1's calls count
  by shape beside them.

The step executes (the port has no trace), outside the CUDA graphs, and
the model's state advances by it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import csplit_mm
from ..parallel import a2a
from ..parallel.mesh import Mesh

# the provider methods the census counts (JAX's seven)
METHODS = ("fft2", "ifft2", "fft2_real", "ifft2_real", "rfft2", "irfft2",
           "ifft2_real_pairs")
# the kernels' aliases of those methods, bound when the kernel is built
ALIASES = ("_fwd_real", "_inv_real", "_fwd", "_bwd")
# what the transport tally counts: K2's kinds, then the library's
KINDS = a2a.KINDS + ("all_to_all_single", "reflect_single", "sum", "max",
                     "all_gather")
TRANSPOSES = ("fwd", "inv", "all_to_all_single")


class Census:
    """A transform provider's stand-in that counts the fields of each call
    of ``METHODS`` in ``counts`` and passes every call on."""

    def __init__(self, tr):
        self._tr = tr
        self.counts = {}

    def __getattr__(self, name):
        fn = getattr(self._tr, name)
        if name not in METHODS:
            return fn

        def wrapped(z, *args, **kwargs):
            nf = int(np.prod(z.shape[:-2])) if z.dim() > 2 else 1
            self.counts[name] = self.counts.get(name, 0) + nf
            return fn(z, *args, **kwargs)

        return wrapped


def _name(dtype) -> str:
    """``torch.complex64`` as ``"complex64"`` (``getattr(torch, name)``
    gives it back)."""
    return str(dtype).replace("torch.", "")


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size()


class Tally:
    """What :func:`transport` counted: ``calls[kind]``, ``bytes[kind]``
    (the payload handed to the exchange on this rank), ``log``, the
    transposes in order as ``(kind, shape, dtype name, chunks or
    async_op)``, and ``k1``, K1's calls by ``(M, K, N)``."""

    def __init__(self):
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self.log = []
        self.k1 = {}

    def add(self, kind, payload):
        self.calls[kind] += 1
        self.bytes[kind] += _nbytes(payload)


@contextlib.contextmanager
def transport():
    """Inside, every exchange of this process is tallied in the
    :class:`Tally` it yields (see the module docstring)."""
    tally = Tally()
    inside_k2 = [0]
    exchange, dispatch = a2a._exchange, csplit_mm._dispatch
    a2a_single = Mesh.all_to_all_single
    all_reduce, all_gather = Mesh.all_reduce, Mesh.all_gather

    def k2(ref, kind, z, group, chunks, check):
        tally.add(kind, z)
        if kind in TRANSPOSES:
            tally.log.append((kind, tuple(z.shape), _name(z.dtype), chunks))
        inside_k2[0] += 1
        try:
            return exchange(ref, kind, z, group, chunks, check)
        finally:
            inside_k2[0] -= 1

    def single(self, send, out_splits=None, in_splits=None, async_op=False):
        if self.nP > 1:
            if out_splits is None:
                tally.add("all_to_all_single", send)
                tally.log.append(("all_to_all_single", tuple(send.shape),
                                  _name(send.dtype), bool(async_op)))
            else:
                tally.add("reflect_single", send)
        return a2a_single(self, send, out_splits, in_splits, async_op)

    def reduce(self, t, op=torch.distributed.ReduceOp.SUM):
        if self.nP > 1:
            tally.add("max" if op == torch.distributed.ReduceOp.MAX
                      else "sum", t)
        return all_reduce(self, t, op)

    def gather(self, t):
        if self.nP > 1 and not inside_k2[0]:
            tally.add("all_gather", t)
        return all_gather(self, t)

    def k1(ar, ai, planes, prepared):
        M, K = ar.shape
        key = (M, K, planes[0].shape[-1])
        tally.k1[key] = tally.k1.get(key, 0) + 1
        return dispatch(ar, ai, planes, prepared)

    a2a._exchange = k2
    Mesh.all_to_all_single, Mesh.all_reduce = single, reduce
    Mesh.all_gather = gather
    csplit_mm._dispatch = k1
    try:
        yield tally
    finally:
        a2a._exchange = exchange
        Mesh.all_to_all_single, Mesh.all_reduce = a2a_single, all_reduce
        Mesh.all_gather = all_gather
        csplit_mm._dispatch = dispatch


def step_census(m):
    """One eager step of model ``m`` on its mesh with both tallies on;
    returns the record (the JAX script's keys where the quantity is
    computed the same way; see ``scripts/traffic_audit_torch.py``)."""
    K = m.kernel
    mesh = K.mesh
    P = mesh.nP if mesh is not None else 1
    tr = K.tr
    cen = Census(tr)
    saved = {a: K.__dict__[a] for a in ALIASES if a in K.__dict__}
    c0 = a2a.counts()
    with transport() as tally:
        K.tr = cen
        for a, fn in saved.items():
            # a bound method of the provider; closures read K.tr themselves
            if getattr(fn, "__self__", None) is tr:
                setattr(K, a, getattr(cen, fn.__name__))
        try:
            m.state = K.step(m.state)
        finally:
            K.tr = tr
            for a, fn in saved.items():
                setattr(K, a, fn)
        if K.device.type == "cuda":
            torch.cuda.synchronize(K.device)
    c1 = a2a.counts()
    launched = {k: c1[k] - c0[k] for k in c1}
    counts = cen.counts
    nx = K.params.nx
    # one (nx/P, nx) block per full-spectrum field, a packed pair of real
    # fields riding one complex inverse (ceil for odd tails)
    fields = (counts.get("fft2", 0) + counts.get("ifft2", 0)
              + counts.get("fft2_real", 0) + counts.get("ifft2_real", 0)
              + (counts.get("ifft2_real_pairs", 0) + 1) // 2)
    # one (nx/P, nx//2+1+rfft_pad) block per half-spectrum field
    half = counts.get("rfft2", 0) + counts.get("irfft2", 0)
    width = nx // 2 + 1 + getattr(tr, "rfft_pad", 0)
    itemsize = torch.empty((), dtype=K.cdtype).element_size()
    model = (fields * nx + half * width) * (nx // P) * itemsize * (P - 1) / P
    moved = sum(tally.bytes[k] for k in TRANSPOSES) * (P - 1) / P
    k2_kinds = {k: tally.calls[k] for k in a2a.KINDS}
    on_card = K.device.type == "cuda"
    return {
        "P": P, "nx": nx,
        "pair_inverse": bool(getattr(K, "pair_inverse", False)),
        "census": counts,
        "transposed_fields_per_step": fields + half,
        "half_spectrum_fields_per_step": half,
        "model_ici_bytes_per_dev_per_step": int(model),
        "transport_ici_bytes_per_dev_per_step": int(moved),
        "transport_over_model": moved / model if model else None,
        "all_reduce_count": (tally.calls["gather"] + tally.calls["sum"]
                             + tally.calls["max"]),
        "all_gather_count": tally.calls["all_gather"],
        "route": "k2" if getattr(tr, "_group", None) is not None
                 else "default",
        "backend": "mxu" if hasattr(tr, "mm") else "native",
        "dtype": str(np.dtype(K.dtype)),
        "itemsize": itemsize,
        "transport_calls": {k: v for k, v in tally.calls.items() if v},
        "transport_bytes": {k: v for k, v in tally.bytes.items() if v},
        "transpose_bytes_per_rank": sum(tally.bytes[k] for k in TRANSPOSES),
        "k2_launches": {k: launched[k] for k in a2a.KINDS},
        "k2_cpu_calls": launched["cpu_calls"],
        # every K2 call of the step ran its kernel on the card, each kind
        # as often as the tally says; on the host its plain version
        "launches_match": (launched["cpu_calls"] == 0
                           and all(launched[k] == k2_kinds[k]
                                   for k in a2a.KINDS)) if on_card else (
            launched["cpu_calls"] == sum(k2_kinds.values())),
        "k1_calls": sorted([*k, n] for k, n in tally.k1.items()),
        "transposes": tally.log,
    }
