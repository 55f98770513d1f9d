"""Launcher of the fast wave kernel's fused stage epilogue
(``csrc/stage.cu``).

``FastWaveKernel._epilogue`` (``models/fast_kernel.py``) fills the gap
between a stage's forward transforms and its ETDRK4 update with one launch
of ``stage_epilogue``: from the transforms' outputs it writes the stage's
right-hand sides ``Fn`` (q side) and ``Fnw`` (wave side) and this rank's 11
budget partials (``FastWaveKernel._sources_plain`` names them), or either
part alone (:func:`epilogue`'s ``rhs`` and ``sources``).

It takes CUDA tensors and a :class:`Plan`: plain numbers, the weight tables
and 1-D wavenumber tables, which the kernel object makes once from its
layout and physics. A field is read in its own strides (the pencil mesh's
transform outputs lead with their columns); tables are row-major. It
launches on the tensors' current stream and raises if the launch is
refused; it has no host path (the plain chain is the kernel object's, and
runs on host tensors).

The kernel counts its own launches, on the card: thread 0 of block 0 adds
one to a counter in device memory, so a launch replayed from a CUDA graph
counts as one from the host does, and a capture, which runs nothing,
counts none. There are two counters, by use (``USES``): ``stage``, a
stage's right-hand sides (with or without its partials), and ``sources``,
the partials alone (the diagnostics' sources). :func:`counts` reads them
with ``cpu_calls``, the epilogues the plain chain served on host tensors
(:func:`count_host_call`); :func:`reset_counts` sets all to 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..cuda_build import load

KERNELS = ("stage_epilogue",)
# the launch counters, by use
USES = ("stage", "sources")
# the budget partials: seven weighted sums, then four mean-mode entries
N_PARTS = 11
N_SUMS = 7
# blocks of the workspace a card, per SM (the kernel takes as many blocks
# as fit on the card at once, at most these)
BLOCKS_PER_SM = 16


class Plan(NamedTuple):
    """What the kernel reads of a kernel object's layout and physics."""

    w_d: torch.Tensor      # (ny, w) wave side: -(nu4w wv4 + nuw wv2 + muw)
    w_chi: torch.Tensor    # (ny, w) chi_phi's weight
    wv2: torch.Tensor      # (ny, w) the wave side's wv2
    w_eppsi: torch.Tensor  # (ny, wq) ep_psi's weight (half: degeneracy in)
    kq: torch.Tensor       # (wq,) k of the q side's columns
    lq: torch.Tensor       # (ny,) l by row
    col0: int              # the q side's first global column on this rank
    nx: int
    nreal: int             # global q-side columns that hold data
    nyq: int               # l_dy on the Nyquist row (derive_fused.NYQ_*)
    zero_jac: bool         # zero Fnw's Jacobian at the mean mode
    owner: bool            # this rank holds the (0,0) mode
    inv_m: float           # 1/M, rounded as the working type rounds it
    inv_m2: float          # 1/M²
    partials: object       # the kernel object's workspace (:func:`workspace`)
    arrivals: object
    blocks: int


_cpu_calls = 0
# each card's launch counters (by index), int64 in USES' order
_LAUNCHES = {}


def _outside_capture(what):
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"the fused stage epilogue's {what} on a card "
                           "cannot be made inside a CUDA graph capture")


def launch_counter(device):
    """The card's launch counters, made at its first call, which must be
    outside a capture (a tensor made there would live in the graph's pool):
    the kernel object calls it when it is built."""
    c = _LAUNCHES.get(device.index)
    if c is None:
        _outside_capture("launch counters")
        c = _LAUNCHES[device.index] = torch.zeros(
            len(USES), dtype=torch.int64, device=device)
    return c


def workspace(device):
    """A kernel object's ``(partials, arrivals, blocks)`` on ``device``:
    room for ``blocks`` blocks' partial sums (float64) and the count of
    blocks done (int32, 0 between launches: the last block resets it).
    Made with the kernel object, outside any capture; its launches, one
    after another on a stream, share it."""
    _outside_capture("workspace")
    blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count
    return (torch.zeros(blocks * N_SUMS, dtype=torch.float64, device=device),
            torch.zeros(1, dtype=torch.int32, device=device), blocks)


def count_host_call():
    """One epilogue served by the plain chain on host tensors."""
    global _cpu_calls
    _cpu_calls += 1


def counts() -> dict:
    """The kernel's launches on every card (read after a synchronise of
    the card, so that every launch queued has run) and ``cpu_calls``."""
    out = dict.fromkeys(USES, 0)
    for index, c in _LAUNCHES.items():
        torch.cuda.synchronize(index)
        for name, n in zip(USES, c.tolist()):
            out[name] += n
    out["cpu_calls"] = _cpu_calls
    return out


def reset_counts():
    """Set every count of :func:`counts` to 0."""
    global _cpu_calls
    for index, c in _LAUNCHES.items():
        torch.cuda.synchronize(index)
        c.zero_()
        torch.cuda.synchronize(index)
    _cpu_calls = 0


def _library():
    lib = load("stage")
    if lib.stage_epilogue.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.stage_epilogue.argtypes = ([ptr] * 12 + [i32] * 10
                                       + [ctypes.c_double] * 2 + [i32] * 3
                                       + [ptr] * 2)
        lib.stage_epilogue.restype = i32
        lib.stage_error_string.argtypes = [i32]
        lib.stage_error_string.restype = ctypes.c_char_p
    return lib


def _field(z):
    """(address, row stride, column stride) of a 2-D field, or zeros."""
    if z is None:
        return (0, 0, 0)
    if z.dim() != 2:
        raise ValueError(f"a field of the epilogue is 2-D, not {z.dim()}-D")
    return (z.data_ptr(),) + tuple(z.stride())


def epilogue(plan: Plan, rh, jadv=None, jh=None, phih=None, uvqh=None,
             qh=None, ph=None, rhs=True, sources=True):
    """``(Fn, Fnw, parts)`` of one stage, each ``None`` where not asked for.

    ``rh`` is the refraction's transform; with ``rhs``: ``jadv`` (the
    Jacobian that enters ``Fnw``) and ``uvqh`` (the q side's products'
    transforms, ``(2, ny, wq)``); with ``sources``: ``jh`` (the Jacobian by
    the full flow), ``phih``, ``qh`` and the projected ``ph``."""
    if not (rhs or sources):
        raise ValueError("the epilogue has nothing to write")
    if (rhs and (jadv is None or uvqh is None)) or (sources and any(
            z is None for z in (jh, phih, qh, ph))):
        raise ValueError("a field the epilogue's uses read is missing")
    dev = rh.device
    ny, w = rh.shape
    wq = plan.kq.shape[0]
    cd, rd = rh.dtype, plan.w_d.dtype
    uq = vq = fn = fnw = parts = None
    if rhs:
        uq, vq = uvqh[0], uvqh[1]
        fn = torch.empty((ny, wq), dtype=cd, device=dev)
        fnw = torch.empty((ny, w), dtype=cd, device=dev)
    if sources:
        parts = torch.empty(N_PARTS, dtype=rd, device=dev)
    for z, shape in ((jadv, (ny, w)), (jh, (ny, w)), (phih, (ny, w)),
                     (uq, (ny, wq)), (vq, (ny, wq)), (qh, (ny, wq)),
                     (ph, (ny, wq))):
        if z is not None and (tuple(z.shape) != shape or z.dtype != cd
                              or z.device != dev):
            raise ValueError(f"a field of shape {tuple(z.shape)}, {z.dtype} "
                             f"on {z.device}; the epilogue takes {shape}, "
                             f"{cd} on {dev}")
    fields = (ctypes.c_longlong * 24)(*[
        v for z in (phih, jadv if rhs else None, jh, rh, uq, vq, qh, ph)
        for v in _field(z)])
    lib = _library()
    c = launch_counter(dev)
    counter = c.data_ptr() + c.element_size() * (0 if rhs else 1)

    def addr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.stage_epilogue(
            fields, plan.w_d.data_ptr(), plan.w_chi.data_ptr(),
            plan.wv2.data_ptr(), plan.w_eppsi.data_ptr(),
            plan.kq.data_ptr(), plan.lq.data_ptr(), addr(fnw), addr(fn),
            addr(parts), plan.partials.data_ptr(),
            plan.arrivals.data_ptr(), plan.blocks,
            ny, w, wq, plan.col0, plan.nx, plan.nreal, plan.nyq,
            int(plan.zero_jac), int(plan.owner), plan.inv_m, plan.inv_m2,
            int(rhs), int(sources), int(rd == torch.float64),
            counter, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("stage_epilogue launch failed: "
                           + lib.stage_error_string(err).decode())
    return fn, fnw, parts
