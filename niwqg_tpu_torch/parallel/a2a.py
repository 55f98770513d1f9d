"""Direct-exchange all-to-all transpose of the pencil FFT (K2 of the port).

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

The kernel copies a table of tasks (:func:`task_table`), built here once
per direction, shape, type and chunk count and kept, with everything else
a launch needs, in a plan of the group: a later call with the same four
checks its blocks and makes one C call (one for all ``P`` ranks of a
:meth:`PeerGroup.local` group). The shape alone picks the kernel's path
(:func:`path`): ``"aligned"`` copies 16-byte units, ``"ragged"`` 8-byte
ones where a chunk's row segment is not a multiple of 16 bytes.

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
direction, shape and type, used in turn: it is valid until the next call
with the same three, and the caller consumes it (enqueues its reader)
before that call (``PencilTransform`` transforms it at once). The kernel
relies on this instead of an entry barrier (``csrc/a2a.cu`` has the
argument).

``all_to_all_fwd.launches`` / ``all_to_all_inv.launches`` count kernel
launches and nothing else, the sum of ``.launches_aligned`` and
``.launches_ragged`` (one count per path); ``.cpu_calls`` count calls
served by the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda_build import load

# wall-clock limit of one device-side wait; past it the kernel traps
_TIMEOUT_NS = 30 * 10**9
# the kernel's block (csrc/a2a.cu: NT / 32 warps) and the most units of one
# row segment a task may have (32 lanes x DEPTH loads in flight)
_WARPS = 16
MAX_UNITS = 256
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


# ----------------------------------------------------------------------
# the kernel's library
# ----------------------------------------------------------------------
def _library():
    lib = load("a2a")
    fn = lib.a2a_launch_many
    if fn.argtypes is None:
        vp, ll, i, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
        fn.argtypes = [i, vp, vp, i, u64, u64, vp, vp]
        fn.restype = i
        lib.a2a_plan_create.argtypes = [vp, i, vp, vp, vp, i, i, i, i, ll,
                                        ll, i, i, u64, ctypes.POINTER(vp)]
        lib.a2a_plan_free.argtypes = [vp]
        lib.a2a_malloc.argtypes = [ctypes.c_size_t, ctypes.POINTER(vp)]
        lib.a2a_free.argtypes = [vp]
        lib.a2a_ipc_get.argtypes = [vp, vp]
        lib.a2a_ipc_open.argtypes = [vp, ctypes.POINTER(vp)]
        lib.a2a_ipc_close.argtypes = [vp]
        lib.a2a_enable_peer_access.argtypes = [i]
        lib.a2a_error_string.argtypes = [i]
        lib.a2a_error_string.restype = ctypes.c_char_p
    return lib


def _ok(lib, err, what):
    if err != 0:
        raise RuntimeError(f"all_to_all kernel: {what} failed: "
                           + lib.a2a_error_string(err).decode())


class _DeviceBytes:
    """A ``cudaMalloc`` allocation seen by PyTorch as a byte tensor."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


class _Buffers:
    """The two exchange buffers of one (direction, shape, type), used in
    turn: ``outs[parity]`` (this process's ranks' outputs) and
    ``ptrs[parity]`` (all ``P`` ranks' addresses)."""

    def __init__(self, outs, ptrs):
        self.outs, self.ptrs = outs, ptrs
        self.calls = 0


class _Plan:
    """Everything one (direction, shape, type, chunks) launch needs but
    the blocks: the C plan of each local rank and the argument arrays."""

    def __init__(self, lib, group, inverse, shape, dtype, chunks):
        nP = group.nP
        lead = 1
        for s in shape[:-2]:
            lead *= s
        if inverse:
            R, W = shape[-2] // nP, shape[-1]
            out_shape = tuple(shape[:-2]) + (R, nP * W)
        else:
            R, W = shape[-2], shape[-1] // nP
            out_shape = tuple(shape[:-2]) + (nP * R, W)
        self.lib, self.shape, self.dtype = lib, shape, dtype
        self.bufs = group._buffers(lib, inverse, out_shape, dtype)
        self.devices = [group.devices[r] for r in group.ranks]
        self.cards = sorted(set(self.devices), key=str)
        self.n = n = len(group.ranks)
        handles = []
        arr = ctypes.c_void_p * nP
        outs0, outs1 = arr(*self.bufs.ptrs[0]), arr(*self.bufs.ptrs[1])
        flags = arr(*group._flags)
        for r, dev in zip(group.ranks, self.devices):
            tasks, meta = task_table(inverse, lead, R, W, nP, r, chunks,
                                     dtype.itemsize)
            h = ctypes.c_void_p()
            _ok(lib, lib.a2a_plan_create(
                tasks.ctypes.data, len(tasks), outs0, outs1, flags, r, nP,
                inverse, int(meta["path"] == "aligned"), meta["in_pitch"],
                meta["out_pitch"], group.blocks, dev.index, _TIMEOUT_NS,
                ctypes.byref(h)), "plan")
            handles.append(h.value)
        group._handles += handles
        self.path = meta["path"]
        self.align = meta["unit"]
        self.per_peer = meta["per_peer"]
        self.counter = "launches_" + self.path
        vn = ctypes.c_void_p * n
        self.handles = vn(*handles)
        self.ins = vn()
        self.streams = vn()
        self.waits = None
        if group._streams is not None:  # ranks that share a card
            self.streams = vn(*(s.cuda_stream for s in group._streams))
            self.waits = vn()


# ----------------------------------------------------------------------
# who the peers are and where their memory is
# ----------------------------------------------------------------------
class PeerGroup:
    """The ranks of one exchange and the pointers into their memory.

    The kernels wait for each other on the device, also between processes
    that share a card: the card time-slices them and the waits make
    progress, a time slice at a time (PERF.md has the cost)."""

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
        self._epoch = [0, 0]      # launches so far, forward and inverse
        self._arrived = [0, 0]    # tasks each peer has sent, cumulative
        self._flags = None        # P flag pointers
        self._keep = []           # flag tensors kept alive
        self._bufs = {}           # (inverse, out shape, dtype) -> _Buffers
        self._plans = {}          # (inverse, shape, dtype, chunks) -> _Plan
        self._handles = []        # every C plan, to free
        self._streams = None      # a stream per rank where ranks share a card
        self._opened = []
        self._owned = []

    @classmethod
    def local(cls, devices) -> "PeerGroup":
        """All ranks in this process; rank ``r`` on ``devices[r]``."""
        return cls(devices=devices)

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

    def _buffers(self, lib, inverse, shape, dtype) -> _Buffers:
        key = (inverse, tuple(shape), dtype)
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

    def _plan(self, inverse, shape, dtype, chunks) -> _Plan:
        lib = _library()
        if self._flags is None:
            self._setup(lib)
        plan = _Plan(lib, self, inverse, shape, dtype, chunks)
        self._plans[(inverse, shape, dtype, chunks)] = plan
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
        raise ValueError("all_to_all blocks differ in shape or type")
    if z.device != dev:
        raise ValueError(f"a block lies on {z.device}, its rank on {dev}")
    if not z.is_contiguous():
        raise ValueError("all_to_all's kernel takes contiguous blocks")
    raise ValueError(f"all_to_all's kernel takes {plan.align}-byte aligned "
                     f"blocks on its {plan.path} path")


def _launch(fn, plan, blocks, group, inverse):
    """One C call for this process's ranks; returns their outputs."""
    for z, dev in zip(blocks, plan.devices):
        if (z.device != dev or z.shape != plan.shape or z.dtype != plan.dtype
                or not z.is_contiguous() or z.data_ptr() % plan.align):
            _refuse(plan, z, dev)
    bufs = plan.bufs
    parity = bufs.calls & 1
    epoch = group._epoch[inverse] + 1
    target = group._arrived[inverse] + plan.per_peer
    cur = {d: torch.cuda.current_stream(d).cuda_stream for d in plan.cards}
    # the caller's streams: where the ranks run, or what their own wait for
    callers = plan.streams if plan.waits is None else plan.waits
    for i, (z, dev) in enumerate(zip(blocks, plan.devices)):
        plan.ins[i] = z.data_ptr()
        callers[i] = cur[dev]
    lib = plan.lib
    _ok(lib, lib.a2a_launch_many(plan.n, plan.handles, plan.ins, parity,
                                 target, epoch, plan.streams, plan.waits),
        "launch")
    bufs.calls += 1
    group._epoch[inverse] = epoch
    group._arrived[inverse] = target
    fn.launches += plan.n
    setattr(fn, plan.counter, getattr(fn, plan.counter) + plan.n)
    return bufs.outs[parity]


def _all_to_all(fn, ref, z, group: PeerGroup, chunks: int, inverse: int):
    many = isinstance(z, (list, tuple))
    blocks = list(z) if many else [z]
    if len(blocks) != len(group.ranks):
        raise ValueError(f"this process holds {len(group.ranks)} rank(s) of "
                         f"the group, got {len(blocks)} block(s)")
    z0 = blocks[0]
    plan = group._plans.get((inverse, z0.shape, z0.dtype, chunks))
    if plan is None:  # CPU blocks, or the first call of this key
        for b in blocks:
            _check(b, group.nP, inverse)
        kinds = {b.device.type for b in blocks}
        if kinds == {"cpu"}:
            fn.cpu_calls += 1
            if many:
                return ref(blocks)
            # one rank per process: the plain version wants every rank's
            # block
            return ref(group.mesh.all_gather(blocks[0]))[group.mesh.rank]
        if kinds != {"cuda"}:
            raise ValueError(f"all_to_all: unsupported devices "
                             f"{sorted(kinds)}")
        plan = group._plan(inverse, z0.shape, z0.dtype, chunks)
    outs = _launch(fn, plan, blocks, group, inverse)
    return outs if many else outs[0]


def all_to_all_fwd(z, group: PeerGroup, chunks: int = 1):
    """``(..., R, P*W)`` row block -> ``(..., P*R, W)`` column pencil over
    the ranks of ``group``. ``z`` is this rank's block, or the list of all
    ``P`` blocks for a :meth:`PeerGroup.local` group (a list comes back).
    ``chunks`` column chunks per peer; the result does not depend on it."""
    return _all_to_all(all_to_all_fwd, all_to_all_fwd_ref, z, group, chunks, 0)


def all_to_all_inv(z, group: PeerGroup, chunks: int = 1):
    """``(..., P*R, W)`` column pencil -> ``(..., R, P*W)`` row block: the
    inverse of :func:`all_to_all_fwd`."""
    return _all_to_all(all_to_all_inv, all_to_all_inv_ref, z, group, chunks, 1)


for _fn in (all_to_all_fwd, all_to_all_inv):
    _fn.launches = 0
    _fn.launches_aligned = 0
    _fn.launches_ragged = 0
    _fn.cpu_calls = 0
