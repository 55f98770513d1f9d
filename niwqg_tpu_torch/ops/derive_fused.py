"""Launchers of the fast wave kernel's fused derive (``csrc/derive.cu``).

``FastWaveKernel.derive`` (``models/fast_kernel.py``) is three transforms
with one of these kernels in each gap between them, each writing straight
into the batch the next transform takes:

:func:`grad_pack` (``derive_grad_pack``)
    ``phih -> [phih, ik phih, il phih]``, the batch of ``tr.ifft2``;
:func:`wave_pv` (``derive_wave_pv``, physics with a wave PV)
    ``phi, phix, phiy -> [|phi|^2, Re(i z)]``, ``z = phix* phiy - phiy*
    phix``, the batch of the forward real transform;
:func:`invert` (``derive_invert``)
    ``fj, qh -> qwh``, ``ph = -(qh - qwh)/wv2`` with its Hermitian
    projection, and the batch ``[ph?, -il_dy ph, ik ph, qh, qh - qwh?]`` of
    the inverse real transform, its self-mirror columns ``k = 0, nx/2``
    projected where the layout's inverse takes them so;
:func:`project_pack` (``derive_project_pack``, the pencil mesh, where the
    mirror columns lie on another rank)
    after ``parallel.mesh.reflect_spectrum`` of the unprojected ``ph``: the
    projected ``ph`` and the batch's ``ph``-dependent entries.

Each takes CUDA tensors and a :class:`Plan`: plain numbers and 1-D
wavenumber tables, which the kernel object makes once from its layout and
physics. Each launches on the tensors' current stream and raises if the
launch is refused; none has a host path (the plain chain is the kernel
object's, and runs on host tensors).

The kernels count their own launches, on the card: thread 0 of block 0
adds one to the kernel's counter in device memory, so a launch replayed
from a CUDA graph counts as one from the host does, and a capture, which
runs nothing, counts none. :func:`counts` reads them with ``cpu_calls``,
the inversions the plain chain served on host tensors
(:func:`count_host_call`); :func:`reset_counts` sets all to 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..cuda_build import load

KERNELS = ("derive_grad_pack", "derive_wave_pv", "derive_invert",
           "derive_project_pack")

# derive_invert's flags and projection modes (csrc/derive.cu)
WAVE_PV, IMAG_JAC, OWNS_MEAN = 1, 2, 4
PROJ_NONE, PROJ_MIRROR, PROJ_REFLECT, PROJ_RAW = 0, 1, 2, 3
# l_dy on the Nyquist row: l; zero on global columns 1..nx/2-1 (the half
# layout); zero but on columns 0 and nx/2 (pair_inverse)
NYQ_L, NYQ_HALF, NYQ_PAIR = 0, 1, 2
# the batch's entries, in the order of Plan.slots
SLOTS = ("ph", "u", "v", "q", "qpsi")


class Plan(NamedTuple):
    """What the kernels read of a kernel object's layout and physics."""

    k: torch.Tensor   # (w,) k of the phi side's columns
    l: torch.Tensor   # (ny,) l by row
    kq: torch.Tensor  # (wq,) k of the q side's columns
    col0: int         # the q side's first global column on this rank
    nx: int
    nreal: int        # global q-side columns that hold data (beyond: pad)
    nyq: int          # NYQ_*
    flags: int        # WAVE_PV | IMAG_JAC | OWNS_MEAN
    proj: int         # PROJ_*
    slots: tuple      # the batch index of each of SLOTS, -1 where absent
    inv_f: float      # 1/f as PyTorch's CUDA division by a scalar rounds it


_cpu_calls = 0
# each card's launch counters (by index), int64 in KERNELS' order
_LAUNCHES = {}


def launch_counter(device):
    """The card's launch counters, made at its first call, which must be
    outside a capture (a tensor made there would live in the graph's pool):
    the kernel object calls it when it is built."""
    c = _LAUNCHES.get(device.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the fused derive's first launch on a card "
                               "cannot be inside a CUDA graph capture")
        c = _LAUNCHES[device.index] = torch.zeros(
            len(KERNELS), dtype=torch.int64, device=device)
    return c


def count_host_call():
    """One inversion served by the plain chain on host tensors."""
    global _cpu_calls
    _cpu_calls += 1


def counts() -> dict:
    """Each kernel's launches on every card (read after a synchronise of
    the card, so that every launch queued has run) and ``cpu_calls``."""
    out = dict.fromkeys(KERNELS, 0)
    for index, c in _LAUNCHES.items():
        torch.cuda.synchronize(index)
        for name, n in zip(KERNELS, c.tolist()):
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
    lib = load("derive")
    if lib.derive_invert.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.derive_grad_pack.argtypes = [ptr] * 4 + [i32] * 3 + [ptr] * 2
        lib.derive_wave_pv.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32,
                                                   ptr, ptr]
        lib.derive_invert.argtypes = ([ptr] * 10 + [ctypes.c_double]
                                      + [i32] * 14 + [ptr] * 2)
        lib.derive_project_pack.argtypes = ([ptr] * 5 + [i32] * 10
                                            + [ptr] * 2)
        for name in KERNELS:
            getattr(lib, name).restype = i32
        lib.derive_error_string.argtypes = [i32]
        lib.derive_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, device, *args):
    """Launch ``name`` on ``device``'s current stream with its launch
    counter; raises if the launch is refused."""
    lib = _library()
    c = launch_counter(device)
    counter = c.data_ptr() + c.element_size() * KERNELS.index(name)
    with torch.cuda.device(device):
        err = getattr(lib, name)(
            *args, counter, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.derive_error_string(err).decode())


def _f64(z) -> int:
    return int(z.dtype in (torch.complex128, torch.float64))


def grad_pack(phih, plan: Plan):
    """``[phih, ik phih, il phih]``, ``(3, ny, w)``."""
    phih = phih.contiguous()
    out = torch.empty((3,) + tuple(phih.shape), dtype=phih.dtype,
                      device=phih.device)
    ny, w = phih.shape
    _launch("derive_grad_pack", phih.device, phih.data_ptr(), out.data_ptr(),
            plan.k.data_ptr(), plan.l.data_ptr(), ny, w, _f64(phih))
    return out


def wave_pv(phi, phix, phiy):
    """``[|phi|^2, Re(i z)]``, real, ``(2, ny, w)``."""
    phi, phix, phiy = (t.contiguous() for t in (phi, phix, phiy))
    out = torch.empty((2,) + tuple(phi.shape), dtype=phi.real.dtype,
                      device=phi.device)
    _launch("derive_wave_pv", phi.device, phi.data_ptr(), phix.data_ptr(),
            phiy.data_ptr(), out.data_ptr(), phi.numel(), _f64(phi))
    return out


def invert(qh, fj, wv2, wv2i, filtr, plan: Plan):
    """``(qwh, ph, batch)`` from the forward transform ``fj`` of the wave-PV
    batch (``None`` without a wave PV) and the q side's tables. Under
    ``PROJ_RAW`` ``ph`` is unprojected and the batch's ``ph``-dependent
    entries wait for :func:`project_pack`."""
    # the kernels index flat fields: a transform's output in another layout
    # (a y-FFT's on the pencil mesh, set_q's 2-D rfft2) is copied once
    qh = qh.contiguous()
    if fj is not None:
        fj = fj.contiguous()
    ny, w = qh.shape
    if plan.proj == PROJ_REFLECT and w != plan.nx:
        raise ValueError("the one-rank reflection needs the full width")
    qwh = torch.empty_like(qh) if fj is not None else torch.zeros_like(qh)
    ph = torch.empty_like(qh)
    batch = torch.empty((sum(s >= 0 for s in plan.slots), ny, w),
                        dtype=qh.dtype, device=qh.device)
    _launch("derive_invert", qh.device,
            None if fj is None else fj.data_ptr(), qh.data_ptr(),
            qwh.data_ptr(), ph.data_ptr(), batch.data_ptr(), wv2.data_ptr(),
            wv2i.data_ptr(), filtr.data_ptr(), plan.kq.data_ptr(),
            plan.l.data_ptr(), plan.inv_f, ny, w, plan.col0, plan.nx,
            plan.nreal, plan.flags, plan.nyq, plan.proj, *plan.slots,
            _f64(qh))
    return qwh, ph, batch


def project_pack(ph, refl, batch, plan: Plan):
    """In place: ``ph`` projected against its reflection ``refl``
    (``Z(-k, -l)``), and the batch's ``ph``-dependent entries from it."""
    refl = refl.contiguous()
    ny, w = ph.shape
    s_ph, s_u, s_v = plan.slots[:3]
    _launch("derive_project_pack", ph.device, ph.data_ptr(), refl.data_ptr(),
            batch.data_ptr(), plan.kq.data_ptr(), plan.l.data_ptr(), ny, w,
            plan.col0, plan.nx, plan.nreal, plan.nyq, s_ph, s_u, s_v,
            _f64(ph))
