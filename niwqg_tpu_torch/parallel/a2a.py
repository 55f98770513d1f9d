"""Direct-exchange all-to-all transpose of the pencil FFT (K2 of the port),
and the mesh's other exchanges inside a step on the same kernel.

``all_to_all_fwd(z, group, chunks)`` takes a rank's local row block
``(..., R, P*W)`` to its column pencil ``(..., P*R, W)``;
``all_to_all_inv`` is the reverse. They are the contract of the TPU
kernels ``niwqg_tpu/parallel/pallas_a2a.py:all_to_all_fwd`` and
``all_to_all_inv``, equal to ``lax.all_to_all(tiled=True)``. On CUDA tensors
they launch the hand-written kernel ``csrc/a2a.cu``, which stores through
pointers into the other ranks' memory and counts, per peer, the tasks that
have landed (the source says how); no collective of ``torch.distributed``
and no ``copy_`` moves the data. On CPU tensors they run the plain
version, :func:`all_to_all_fwd_ref` and :func:`all_to_all_inv_ref`, which
take the list of all ``P`` local blocks and slice and concatenate. There is
no fallback between the two: a CUDA call that cannot launch raises.

Two more exchanges run on the same kernel, each with its plain version
beside it, so that a step on a mesh makes no call of ``torch.distributed``
(and can be captured in a CUDA graph): :func:`all_reduce`, the sum or the
maximum of a small vector over the ranks (a gather of the vector, copied
to every peer, then a reduction in rank order, so that every rank holds
the same bits), and :func:`reflect_exchange`, the Hermitian reflection's
uneven exchange of mirror columns (``mesh.reflect_spectrum``).

The kernel copies a table of tasks (:func:`task_table`,
:func:`reflect_table`), built here once per kind, shape, type and chunk
count and kept, with everything else a launch needs, in a plan of the
group: a later call with the same four checks its blocks and makes one C
call (one for all ``P`` ranks of a :meth:`PeerGroup.local` group). The
shape alone picks the kernel's path (:func:`path`): ``"aligned"`` copies
16-byte units, ``"ragged"`` 8-byte ones where a chunk's row segment is not
a multiple of 16 bytes. A plan is built by a call outside a CUDA graph
capture (it swaps IPC handles through ``all_gather_object``); a call under
capture whose plan is missing raises.

Where the pointers come from (:class:`PeerGroup`):

``PeerGroup.local(devices)``
    all ``P`` ranks in this process, rank ``r`` on ``devices[r]`` (cards may
    repeat). Outputs and flags are ordinary tensors, addressed by
    ``data_ptr()``, with peer access enabled between distinct cards. The
    wrappers then take and return the list of all ``P`` blocks and launch
    the ``P`` kernels on ``P`` streams, so that they wait for each other
    on the device.
``PeerGroup(mesh)``
    one rank per process (a :class:`~.mesh.Mesh`). Outputs and flags are
    allocated by the C library with ``cudaMalloc``, once per shape, and
    handed round as CUDA IPC handles (``cudaIpcGetMemHandle`` /
    ``cudaIpcOpenMemHandle``, swapped through ``all_gather_object``). IPC
    was taken rather than PyTorch's symmetric memory because it works the
    same between processes on one card and on several, needs nothing but
    the CUDA runtime the kernel's library already links, and a whole
    ``cudaMalloc`` allocation maps to one handle with no offset
    bookkeeping against the caching allocator.

The result is a view of one of the group's two exchange buffers for that
kind, shape and type, used in turn: it is valid until the next call with
the same three, and the caller consumes it (enqueues its reader) before
that call (``PencilTransform`` transforms it at once). The kernel relies
on this instead of an entry barrier (``csrc/a2a.cu`` has the argument).
Which buffer a call takes is the parity of the calls of its key so far,
replays of CUDA graphs included: :meth:`PeerGroup.parity` keeps that count
on the host, and a captured graph carries a :class:`Tape` of the parities
it was captured with (see ``graphs.py``).

The kernel counts its launches on the card, per kind and path, so a
replayed launch counts as any other (``FAMILY``, a ``cuda_build.Family``):
:func:`counts` reads them (a synchronise) and :func:`reset_counts` sets
them to 0. ``FAMILY.plain_calls(kind)`` counts the calls of each kind that
the plain version served.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda_build import Family
from ..utils.profiling import span

# wall-clock limit of one device-side wait; past it the kernel traps
_TIMEOUT_NS = 30 * 10**9
# the kernel's block (csrc/a2a.cu: NT / 32 warps) and the most units of one
# row segment a task may have (32 lanes x DEPTH loads in flight)
_WARPS = 16
MAX_UNITS = 256
# the kernel's kinds of launch (csrc/a2a.cu), each with its own arrival
# counts and launch counters
KINDS = ("fwd", "inv", "gather", "reflect")
PATHS = ("aligned", "ragged")
# one task of the kernel (csrc/a2a.cu: HostTask); byte offsets of the first
# row in the input and in the destination's output
TASK_DTYPE = np.dtype([("src", "<i8"), ("dst", "<i8"), ("rows", "<i4"),
                       ("units", "<i4"), ("peer", "<i4"), ("pad", "<i4")])


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def all_to_all_fwd_ref(blocks):
    """Plain version, all ranks at once: ``blocks[r]`` is rank ``r``'s
    ``(..., R, P*W)`` row block; returns every rank's ``(..., P*R, W)``,
    each where that rank's block lies."""
    P = len(blocks)
    W = blocks[0].shape[-1] // P
    return [torch.cat([b[..., d * W:(d + 1) * W].to(blocks[d].device)
                       for b in blocks], dim=-2) for d in range(P)]


def all_to_all_inv_ref(blocks):
    """Plain version of the inverse: ``(..., P*R, W)`` blocks in,
    ``(..., R, P*W)`` blocks out."""
    P = len(blocks)
    R = blocks[0].shape[-2] // P
    return [torch.cat([b[..., d * R:(d + 1) * R, :].to(blocks[d].device)
                       for b in blocks], dim=-1) for d in range(P)]


def all_reduce_ref(vectors, op: str = "sum"):
    """Plain version of :func:`all_reduce`: every rank's vector (equal
    shapes), reduced in rank order on the first rank's device; the one
    result every rank holds."""
    acc = vectors[0]
    for v in vectors[1:]:
        v = v.to(acc.device)
        acc = acc + v if op == "sum" else torch.maximum(acc, v)
    return acc


def reflect_partners(P: int, r: int):
    """The ranks rank ``r`` sends its first row to and its other rows to in
    :func:`reflect_exchange` (and receives them from: the exchange is
    symmetric)."""
    return (P - r) % P, P - 1 - r


def reflect_exchange_ref(sends):
    """Plain version of :func:`reflect_exchange`, all ranks at once:
    ``sends[r]`` is rank ``r``'s ``(W, ...)`` rows; rank ``r`` gets the
    first row of rank ``a`` and the other rows of rank ``b``
    (:func:`reflect_partners`)."""
    P = len(sends)
    outs = []
    for r in range(P):
        a, b = reflect_partners(P, r)
        outs.append(torch.cat([sends[a][:1].to(sends[r].device),
                               sends[b][1:].to(sends[r].device)]))
    return outs


def clamp_chunks(width: int, c: int) -> int:
    """Largest divisor of ``width`` that is <= the requested chunk count."""
    c = max(1, min(int(c), width))
    while width % c:
        c -= 1
    return c


# ----------------------------------------------------------------------
# the task table
# ----------------------------------------------------------------------
def path(width: int, chunks: int, itemsize: int) -> str:
    """The kernel's path for blocks of ``width`` columns a peer, cut into
    ``chunks`` column chunks (clamped as the wrappers clamp it), of
    ``itemsize``-byte elements: ``"aligned"`` (16-byte units) where a
    chunk's row segment is a multiple of 16 bytes, ``"ragged"`` (8-byte
    units) otherwise. The shape alone decides."""
    cw = width // clamp_chunks(width, chunks)
    return "aligned" if cw * itemsize % 16 == 0 else "ragged"


def task_table(inverse: int, lead: int, R: int, W: int, P: int, me: int,
               chunks: int, itemsize: int):
    """The tasks of rank ``me``'s launch, and what the launch needs with
    them.

    The forward input is ``(lead, R, P*W)``, the inverse's ``(lead, P*R,
    W)``. A task copies ``rows`` row segments of ``units`` units, one
    (field, destination ``peer``, column chunk, piece of at most
    :data:`MAX_UNITS` units) at a time, from byte offset ``src`` of the
    input to byte offset ``dst`` of the destination's output, row after
    row at the pitches ``in_pitch`` and ``out_pitch``. A task has as many
    rows as the kernel's block takes in one trip. The table runs chunk,
    row group, piece, field, then destination (starting at ``me``):
    neighbouring tasks, which neighbouring blocks take, go to different
    ranks. Returns ``(tasks, meta)``: a :data:`TASK_DTYPE` array and a dict
    with ``path``, ``unit``, ``in_pitch``, ``out_pitch`` and ``per_peer``
    (the tasks that go to each rank)."""
    chunks = clamp_chunks(W, chunks)
    kind = path(W, chunks, itemsize)
    unit = 16 if kind == "aligned" else 8
    cw = W // chunks
    seg = cw * itemsize // unit               # units of a chunk's segment
    npieces = -(-seg // MAX_UNITS)
    piece = -(-seg // npieces)                # balanced pieces
    rows_per = _WARPS * max(1, MAX_UNITS // piece)
    in_pitch = (W if inverse else P * W) * itemsize
    out_pitch = (P * W if inverse else W) * itemsize
    recs = []
    for c in range(chunks):
        for r0 in range(0, R, rows_per):
            rows = min(rows_per, R - r0)
            for k in range(npieces):
                u0 = k * piece
                col = c * cw * itemsize + u0 * unit
                for b in range(lead):
                    for j in range(P):
                        d = (me + j) % P
                        if inverse:
                            src = (b * P * R + d * R + r0) * in_pitch + col
                            dst = ((b * R + r0) * out_pitch + me * W * itemsize
                                   + col)
                        else:
                            src = ((b * R + r0) * in_pitch + d * W * itemsize
                                   + col)
                            dst = (b * P * R + me * R + r0) * out_pitch + col
                        recs.append((src, dst, rows, min(piece, seg - u0), d,
                                     0))
    tasks = np.array(recs, dtype=TASK_DTYPE)
    meta = dict(path=kind, unit=unit, in_pitch=in_pitch, out_pitch=out_pitch,
                per_peer=len(recs) // P)
    return tasks, meta


def _row_tasks(recs, peer, row0, nrows, row_bytes, unit):
    """Tasks that copy rows ``[row0, row0 + nrows)`` of ``row_bytes`` each
    to the same rows of ``peer``'s output (equal pitches)."""
    seg = row_bytes // unit
    npieces = -(-seg // MAX_UNITS)
    piece = -(-seg // npieces)
    rows_per = _WARPS * max(1, MAX_UNITS // piece)
    for r0 in range(row0, row0 + nrows, rows_per):
        rows = min(rows_per, row0 + nrows - r0)
        for k in range(npieces):
            off = r0 * row_bytes + k * piece * unit
            recs.append((off, off, rows, min(piece, seg - k * piece), peer,
                         0))


def reflect_table(W: int, L: int, P: int, me: int, itemsize: int):
    """The tasks of rank ``me``'s :func:`reflect_exchange` of ``(W, L)``
    rows: row 0 to rank ``a``, rows ``1..W-1`` to rank ``b``
    (:func:`reflect_partners`), each into the same rows there. Returns
    ``(tasks, meta)`` as :func:`task_table` does."""
    row_bytes = L * itemsize
    kind = "aligned" if row_bytes % 16 == 0 else "ragged"
    unit = 16 if kind == "aligned" else 8
    a, b = reflect_partners(P, me)
    recs = []
    _row_tasks(recs, a, 0, 1, row_bytes, unit)
    if W > 1:
        _row_tasks(recs, b, 1, W - 1, row_bytes, unit)
    tasks = np.array(recs, dtype=TASK_DTYPE)
    return tasks, dict(path=kind, unit=unit, in_pitch=row_bytes,
                       out_pitch=row_bytes)


def recv_counts(table, P: int, me: int) -> list:
    """The tasks each rank's launch sends rank ``me``: ``table(r)`` is
    rank ``r``'s ``(tasks, meta)``."""
    return [int((table(r)[0]["peer"] == me).sum()) for r in range(P)]


# ----------------------------------------------------------------------
# the kernel's library
# ----------------------------------------------------------------------
_vp, _i = ctypes.c_void_p, ctypes.c_int
FAMILY = Family(
    "a2a",
    {"a2a_launch_many": [_i, _vp, _vp, _i, _vp, _vp],
     "a2a_plan_create": [_vp, _i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                         ctypes.c_longlong, ctypes.c_longlong, _i, _i,
                         ctypes.c_ulonglong, ctypes.POINTER(_vp)],
     "a2a_plan_free": [_vp],
     "a2a_malloc": [ctypes.c_size_t, ctypes.POINTER(_vp)],
     "a2a_free": [_vp],
     "a2a_ipc_get": [_vp, _vp],
     "a2a_ipc_open": [_vp, ctypes.POINTER(_vp)],
     "a2a_ipc_close": [_vp],
     "a2a_enable_peer_access": [_i],
     "a2a_max_ranks": [], "a2a_flag_words": [], "a2a_ipc_handle_bytes": []},
    keys=[f"{k}_{p}" for k in KINDS for p in PATHS], plain=KINDS)
_library, _ok = FAMILY.library, FAMILY.check


class _DeviceBytes:
    """A ``cudaMalloc`` allocation seen by PyTorch as a byte tensor."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


class _Buffers:
    """The two exchange buffers of one (kind, shape, type), used in turn:
    ``outs[parity]`` (this process's ranks' outputs) and ``ptrs[parity]``
    (all ``P`` ranks' addresses)."""

    def __init__(self, outs, ptrs):
        self.outs, self.ptrs = outs, ptrs


def _layout(kind, shape, nP):
    """(lead, R, W, out shape) of a block of ``shape`` in ``kind``'s
    exchange: R rows of W columns a peer (``reflect``: W rows of R)."""
    lead = 1
    for s in shape[:-2]:
        lead *= s
    if kind == "reflect":
        return 1, shape[-1], shape[-2], tuple(shape)
    if kind == "inv":
        R, W = shape[-2] // nP, shape[-1]
        return lead, R, W, tuple(shape[:-2]) + (R, nP * W)
    R, W = shape[-2], shape[-1] // nP
    return lead, R, W, tuple(shape[:-2]) + (nP * R, W)


class _Plan:
    """Everything one (kind, shape, type, chunks) launch needs but the
    blocks: the C plan of each local rank and the argument arrays."""

    def __init__(self, lib, group, kind, shape, dtype, chunks):
        nP = group.nP
        lead, R, W, out_shape = _layout(kind, shape, nP)
        if kind == "reflect":
            table = lambda r: reflect_table(W, R, nP, r, dtype.itemsize)
        else:
            table = lambda r: task_table(int(kind == "inv"), lead, R, W, nP,
                                         r, chunks, dtype.itemsize)
        self.lib, self.shape, self.dtype = lib, shape, dtype
        self.key = (kind, out_shape, dtype)
        self.bufs = group._buffers(lib, self.key)
        self.devices = [group.devices[r] for r in group.ranks]
        self.cards = sorted(set(self.devices), key=str)
        self.n = n = len(group.ranks)
        handles = []
        arr = ctypes.c_void_p * nP
        outs0, outs1 = arr(*self.bufs.ptrs[0]), arr(*self.bufs.ptrs[1])
        flags = arr(*group._flags)
        for r, dev in zip(group.ranks, self.devices):
            tasks, meta = table(r)
            recv = (ctypes.c_int * nP)(*recv_counts(table, nP, r))
            count = FAMILY.counter(dev, f"{kind}_{meta['path']}")
            h = ctypes.c_void_p()
            _ok(lib, lib.a2a_plan_create(
                tasks.ctypes.data, len(tasks), outs0, outs1, flags, recv,
                count, r, nP, KINDS.index(kind),
                int(meta["path"] == "aligned"),
                meta["in_pitch"], meta["out_pitch"], group.blocks, dev.index,
                _TIMEOUT_NS, ctypes.byref(h)), "plan")
            handles.append(h.value)
        group._handles += handles
        self.path = meta["path"]
        self.align = meta["unit"]
        vn = ctypes.c_void_p * n
        self.handles = vn(*handles)
        self.ins = vn()
        self.streams = vn()
        self.waits = None
        if group._streams is not None:  # ranks that share a card
            self.streams = vn(*(s.cuda_stream for s in group._streams))
            self.waits = vn()


class Tape:
    """The K2 calls of one CUDA graph capture, by buffer key: the parity
    each key had at the graph's entry (``entry``) and the calls the graph
    makes (``calls``). A replay is right only where every key has its
    entry parity."""

    def __init__(self):
        self.entry, self.calls = {}, {}

    def keys(self) -> tuple:
        return tuple(self.calls)


# ----------------------------------------------------------------------
# who the peers are and where their memory is
# ----------------------------------------------------------------------
class PeerGroup:
    """The ranks of one exchange and the pointers into their memory.

    The kernels wait for each other on the device, also between processes
    that share a card: the card time-slices them and the waits make
    progress, a time slice at a time (PERF.md has the cost)."""

    @span("mesh.k2_group")
    def __init__(self, mesh=None, *, devices=None):
        if (mesh is None) == (devices is None):
            raise ValueError("PeerGroup takes a mesh or a list of devices")
        self.mesh = mesh
        if mesh is not None:
            self.nP, self.ranks = mesh.nP, [mesh.rank]
            self.devices = {mesh.rank: mesh.device}
        else:
            devs = [torch.device(d) for d in devices]
            self.nP, self.ranks = len(devs), list(range(len(devs)))
            self.devices = dict(enumerate(devs))
        self.blocks = None        # grid of one launch
        self._flags = None        # P flag pointers
        self._keep = []           # flag tensors kept alive
        self._bufs = {}           # (kind, out shape, dtype) -> _Buffers
        self._plans = {}          # (kind, shape, dtype, chunks) -> _Plan
        self._calls = {}          # buffer key -> calls run so far
        self._tape = None         # the Tape of a capture in progress
        self._handles = []        # every C plan, to free
        self._streams = None      # a stream per rank where ranks share a card
        self._opened = []
        self._owned = []

    @classmethod
    def local(cls, devices) -> "PeerGroup":
        """All ranks in this process; rank ``r`` on ``devices[r]``."""
        return cls(devices=devices)

    # -- which of a key's two exchange buffers a call takes ----------------
    def parity(self, key=None, *, record=None, replay=None):
        """The bookkeeping of the buffers' parity, in one place.

        ``parity(key)``: the parity of the next call of buffer ``key``
        (the calls of that key so far, mod 2), counted: a call that runs
        advances the run's count; under a capture (``record``) it advances
        the capture's :class:`Tape` only, since a capture runs nothing.
        ``parity(record=True)`` starts a capture's tape and
        ``parity(record=False)`` ends it and returns it. ``parity(replay=
        tape)`` checks that every key of ``tape`` has its entry parity now
        (raises otherwise: the graph would write the buffer a peer may
        still read, and its readers read the other) and then counts the
        replay's calls. Eager calls, captures and replays of graphs in any
        order thus keep every key's calls alternating over the whole run.
        """
        if record is not None:
            if record == (self._tape is not None):
                raise RuntimeError("K2: a capture's tape is "
                                   + ("already open" if record else
                                      "not open"))
            tape, self._tape = self._tape, (Tape() if record else None)
            return tape
        if replay is not None:
            wrong = [k for k, p in replay.entry.items()
                     if self._calls.get(k, 0) & 1 != p]
            if wrong:
                raise RuntimeError(f"K2: a graph captured at parity "
                                   f"{replay.entry} replayed at {wrong} "
                                   "of the other parity")
            for k, n in replay.calls.items():
                self._calls[k] = self._calls.get(k, 0) + n
            return None
        tape = self._tape
        if tape is None:
            n = self._calls.get(key, 0)
            self._calls[key] = n + 1
            return n & 1
        if key not in tape.calls:
            tape.entry[key] = self._calls.get(key, 0) & 1
            tape.calls[key] = 0
        p = (tape.entry[key] + tape.calls[key]) & 1
        tape.calls[key] += 1
        return p

    def signature(self, keys) -> tuple:
        """The parities of buffer ``keys`` now: which variant of a graph
        whose tape holds these keys a replay needs."""
        return tuple(self._calls.get(k, 0) & 1 for k in keys)

    # -- set-up, at the first CUDA launch -------------------------------------
    def _ranks_per_card(self) -> int:
        """Ranks that share one card: their grids run together."""
        if self.mesh is None:
            devs = list(self.devices.values())
            return max(devs.count(d) for d in devs)
        return -(-self.nP // torch.cuda.device_count())

    def _setup(self, lib):
        if self.nP > lib.a2a_max_ranks():
            raise ValueError(f"the kernel takes at most "
                             f"{lib.a2a_max_ranks()} ranks, got {self.nP}")
        dev0 = self.devices[self.ranks[0]]
        sms = torch.cuda.get_device_properties(dev0).multi_processor_count
        # a persistent grid: the card's SMs, shared by the ranks on it
        self.blocks = max(1, sms // self._ranks_per_card())
        words = lib.a2a_flag_words()
        if self.mesh is None:
            cards = sorted({d.index for d in self.devices.values()})
            for a in cards:
                for b in cards:
                    if a == b:
                        continue
                    if not torch.cuda.can_device_access_peer(a, b):
                        raise RuntimeError(
                            f"all_to_all kernel: card {a} cannot access "
                            f"card {b}'s memory")
                    with torch.cuda.device(a):
                        _ok(lib, lib.a2a_enable_peer_access(b),
                            f"cudaDeviceEnablePeerAccess({a}->{b})")
            flags = [torch.zeros(words, dtype=torch.int64, device=d)
                     for d in self.devices.values()]
            self._keep += flags
            self._flags = [f.data_ptr() for f in flags]
            if self._ranks_per_card() > 1:
                # one stream per rank, so that the ranks of a card run
                # together
                self._streams = [torch.cuda.Stream(d)
                                 for d in self.devices.values()]
            for d in set(self.devices.values()):
                torch.cuda.synchronize(d)
        else:
            self._flags = self._shared_alloc(lib, words * 8)[1]

    def _shared_alloc(self, lib, nbytes: int):
        """``cudaMalloc`` on this rank, IPC-mapped by every other rank;
        returns (own pointer, all P pointers)."""
        dev = self.mesh.device
        with torch.cuda.device(dev):
            torch.cuda.current_stream(dev)  # the context exists
            ptr = ctypes.c_void_p()
            _ok(lib, lib.a2a_malloc(nbytes, ctypes.byref(ptr)), "cudaMalloc")
            self._owned.append(ptr.value)
            handle = ctypes.create_string_buffer(lib.a2a_ipc_handle_bytes())
            _ok(lib, lib.a2a_ipc_get(ptr, handle), "cudaIpcGetMemHandle")
            handles = self.mesh.all_gather_object(handle.raw)
            ptrs = []
            for r, h in enumerate(handles):
                if r == self.mesh.rank:
                    ptrs.append(ptr.value)
                    continue
                p = ctypes.c_void_p()
                _ok(lib, lib.a2a_ipc_open(h, ctypes.byref(p)),
                    f"cudaIpcOpenMemHandle(rank {r})")
                self._opened.append(p.value)
                ptrs.append(p.value)
        return ptr.value, ptrs

    def _buffers(self, lib, key) -> _Buffers:
        _, shape, dtype = key
        hit = self._bufs.get(key)
        if hit is not None:
            return hit
        if self.mesh is None:
            outs = [[torch.empty(shape, dtype=dtype, device=d)
                     for d in self.devices.values()] for _ in range(2)]
            ptrs = [[o.data_ptr() for o in pair] for pair in outs]
        else:
            n = 1
            for s in shape:
                n *= s
            nbytes = n * dtype.itemsize
            half = -(-nbytes // 256) * 256  # the second buffer, aligned
            own, base = self._shared_alloc(lib, 2 * half)
            dev = self.mesh.device
            with torch.cuda.device(dev):
                raw = torch.as_tensor(_DeviceBytes(own, 2 * half), device=dev)
            outs = [[raw[k * half:k * half + nbytes].view(dtype).view(shape)]
                    for k in range(2)]
            ptrs = [base, [p + half for p in base]]
        self._bufs[key] = buf = _Buffers(outs, ptrs)
        return buf

    def _plan(self, kind, shape, dtype, chunks) -> _Plan:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"K2: no plan for a {kind} call of {tuple(shape)} {dtype} "
                "at a CUDA graph capture: plans are built by an eager call "
                "(they swap IPC handles between the ranks)")
        # set-up reached from a key's first eager call (a step's or a
        # field's), never from a capture: the span's one exception to
        # "no span inside a step"
        with span("mesh.k2_group"):
            lib = _library()
            if self._flags is None:
                self._setup(lib)
            plan = _Plan(lib, self, kind, shape, dtype, chunks)
        self._plans[(kind, shape, dtype, chunks)] = plan
        return plan

    def close(self):
        """Free the plans; on a mesh, unmap the peers' memory and free this
        rank's (after a barrier: no peer may still be storing into it)."""
        if self._flags is None:
            return
        lib = _library()
        for d in set(self.devices.values()):
            torch.cuda.synchronize(d)
        for h in self._handles:
            lib.a2a_plan_free(h)
        self._handles, self._plans = [], {}
        if self.mesh is None:
            return
        self.mesh.barrier()
        self._bufs.clear()
        with torch.cuda.device(self.mesh.device):
            for p in self._opened:
                lib.a2a_ipc_close(p)
            self.mesh.barrier()
            for p in self._owned:
                lib.a2a_free(p)
        self._opened, self._owned, self._flags = [], [], None


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------
def _check(z, nP, inverse):
    if not z.is_complex():
        raise TypeError(f"all_to_all takes complex tensors, got {z.dtype}")
    if z.dim() < 2:
        raise ValueError("all_to_all takes (..., rows, columns) blocks")
    split = z.shape[-2] if inverse else z.shape[-1]
    if split % nP or min(z.shape) == 0:
        raise ValueError(f"block {tuple(z.shape)} does not split over "
                         f"{nP} ranks")


def _refuse(plan, z, dev):
    """Raise for a block that ``plan`` does not take."""
    if z.shape != plan.shape or z.dtype != plan.dtype:
        raise ValueError("K2 blocks differ in shape or type")
    if z.device != dev:
        raise ValueError(f"a block lies on {z.device}, its rank on {dev}")
    if not z.is_contiguous():
        raise ValueError("K2's kernel takes contiguous blocks")
    raise ValueError(f"K2's kernel takes {plan.align}-byte aligned "
                     f"blocks on its {plan.path} path")


def _launch(plan, blocks, group):
    """One C call for this process's ranks; returns their outputs."""
    for z, dev in zip(blocks, plan.devices):
        if (z.device != dev or z.shape != plan.shape or z.dtype != plan.dtype
                or not z.is_contiguous() or z.data_ptr() % plan.align):
            _refuse(plan, z, dev)
    cur = {d: torch.cuda.current_stream(d).cuda_stream for d in plan.cards}
    # the caller's streams: where the ranks run, or what their own wait for
    callers = plan.streams if plan.waits is None else plan.waits
    for i, (z, dev) in enumerate(zip(blocks, plan.devices)):
        plan.ins[i] = z.data_ptr()
        callers[i] = cur[dev]
    parity = group.parity(plan.key)
    lib = plan.lib
    _ok(lib, lib.a2a_launch_many(plan.n, plan.handles, plan.ins, parity,
                                 plan.streams, plan.waits), "launch")
    return plan.bufs.outs[parity]


def _exchange(ref, kind, z, group: PeerGroup, chunks: int, check):
    """``z`` (this rank's block, or the list of a local group's) through
    ``kind``'s kernel on CUDA, or ``ref`` (every rank's blocks in, every
    rank's out) on the CPU."""
    many = isinstance(z, (list, tuple))
    blocks = list(z) if many else [z]
    if len(blocks) != len(group.ranks):
        raise ValueError(f"this process holds {len(group.ranks)} rank(s) of "
                         f"the group, got {len(blocks)} block(s)")
    z0 = blocks[0]
    plan = group._plans.get((kind, z0.shape, z0.dtype, chunks))
    if plan is None:  # CPU blocks, or the first call of this key
        for b in blocks:
            check(b)
        kinds = {b.device.type for b in blocks}
        if kinds == {"cpu"}:
            FAMILY.plain_call(kind)
            if many:
                return ref(blocks)
            # one rank per process: the plain version wants every rank's
            # block
            return ref(group.mesh.all_gather(blocks[0]))[group.mesh.rank]
        if kinds != {"cuda"}:
            raise ValueError(f"K2: unsupported devices {sorted(kinds)}")
        plan = group._plan(kind, z0.shape, z0.dtype, chunks)
    outs = _launch(plan, blocks, group)
    return outs if many else outs[0]


def all_to_all_fwd(z, group: PeerGroup, chunks: int = 1):
    """``(..., R, P*W)`` row block -> ``(..., P*R, W)`` column pencil over
    the ranks of ``group``. ``z`` is this rank's block, or the list of all
    ``P`` blocks for a :meth:`PeerGroup.local` group (a list comes back).
    ``chunks`` column chunks per peer; the result does not depend on it."""
    return _exchange(all_to_all_fwd_ref, "fwd", z, group, chunks,
                     lambda b: _check(b, group.nP, 0))


def all_to_all_inv(z, group: PeerGroup, chunks: int = 1):
    """``(..., P*R, W)`` column pencil -> ``(..., R, P*W)`` row block: the
    inverse of :func:`all_to_all_fwd`."""
    return _exchange(all_to_all_inv_ref, "inv", z, group, chunks,
                     lambda b: _check(b, group.nP, 1))


# the reals of a vector that :func:`all_reduce` sends a peer, padded to this
# many: one plan (and one pair of buffers) for every vector up to its size
_GATHER_REALS = 8
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _gather_block(t, nP):
    """``t`` as one rank's forward block of the gather: the vector, padded
    and viewed as complex, copied into each peer's column block of one
    row."""
    if t.dtype not in _COMPLEX:
        raise TypeError(f"K2's all_reduce takes float32 or float64 vectors, "
                        f"got {t.dtype}")
    v = t.reshape(-1)
    width = -(-max(v.numel(), 1) // _GATHER_REALS) * _GATHER_REALS
    v = torch.nn.functional.pad(v, (0, width - v.numel()))
    return v.view(_COMPLEX[t.dtype]).repeat(nP).reshape(1, -1)


def all_reduce(t, group: PeerGroup, op: str = "sum"):
    """The sum (``op="sum"``) or maximum (``"max"``) of a small real tensor
    (any shape, the same on every rank) over the ranks of ``group``, on
    every rank: the same bits on all, each rank reducing every rank's
    tensor in rank order (:func:`all_reduce_ref`). ``t`` is this rank's
    tensor, or the list of a :meth:`PeerGroup.local` group's (a list comes
    back). On CUDA tensors one launch of K2's gather kind moves the
    vectors, each rank's copied to every peer; on CPU tensors the plain
    version reduces the mesh's ``all_gather``."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op is 'sum' or 'max', got {op!r}")
    many = isinstance(t, (list, tuple))
    ts = list(t) if many else [t]
    unchecked = lambda x: None
    if {x.device.type for x in ts} != {"cuda"}:
        ref = lambda vs: [all_reduce_ref(vs, op) for _ in vs]
        return _exchange(ref, "gather", t, group, 1, unchecked)
    rows = _exchange(None, "gather", [_gather_block(x, group.nP) for x in ts],
                     group, 1, unchecked)
    outs = [all_reduce_ref(list(r.view(x.dtype)[:, :x.numel()]), op)
            .reshape(x.shape) for r, x in zip(rows, ts)]
    return outs if many else outs[0]


def _check_reflect(z):
    if not z.is_complex() or z.dim() != 2 or min(z.shape) == 0:
        raise ValueError(f"reflect_exchange takes (W, L) complex rows, got "
                         f"{tuple(z.shape)} {z.dtype}")


def reflect_exchange(z, group: PeerGroup):
    """The Hermitian reflection's uneven exchange (``mesh.reflect_spectrum``)
    on ``(W, L)`` rows: rank ``r`` gets row 0 of rank ``(P - r) % P`` and
    rows ``1..W-1`` of rank ``P - 1 - r``, in place. ``z`` is this rank's
    rows, or the list of a :meth:`PeerGroup.local` group's. One launch of
    K2's reflect kind on CUDA tensors, :func:`reflect_exchange_ref` on CPU
    tensors."""
    return _exchange(reflect_exchange_ref, "reflect", z, group, 1,
                     _check_reflect)


def counts() -> dict:
    """K2's launches on every card, counted there (read after a
    synchronise of each card, so that every launch queued has run): per
    kind and path (``"fwd_aligned"``, ..., ``"reflect_ragged"``), per kind
    (``"fwd"``, ``"inv"``, ``"gather"``, ``"reflect"``), and ``cpu_calls``,
    the calls of every wrapper its plain version served."""
    out = FAMILY.counts()
    for k in KINDS:
        out[k] = sum(out[f"{k}_{p}"] for p in PATHS)
    return out


reset_counts = FAMILY.reset
