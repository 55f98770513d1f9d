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

The kernels count their own launches on the card, one counter each
(``FAMILY``, a ``cuda_build.Family``): :func:`counts` reads them with
``cpu_calls``, the inversions the plain chain served on host tensors
(``FAMILY.plain_call("invert")``); :func:`reset_counts` sets all to 0.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..cuda_build import Family

KERNELS = ("derive_grad_pack", "derive_wave_pv", "derive_invert",
           "derive_project_pack")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
FAMILY = Family(
    "derive",
    {"derive_grad_pack": [_ptr] * 4 + [_i32] * 3 + [_ptr] * 2,
     "derive_wave_pv": [_ptr] * 4 + [ctypes.c_longlong, _i32, _ptr, _ptr],
     "derive_invert": ([_ptr] * 10 + [ctypes.c_double] + [_i32] * 14
                       + [_ptr] * 2),
     "derive_project_pack": [_ptr] * 5 + [_i32] * 10 + [_ptr] * 2},
    keys=KERNELS, plain=["invert"])
counts, reset_counts = FAMILY.counts, FAMILY.reset

# derive_invert's flags and projection modes (csrc/derive.cu)
WAVE_PV, IMAG_JAC, OWNS_MEAN = 1, 2, 4
PROJ_NONE, PROJ_MIRROR, PROJ_REFLECT, PROJ_RAW = 0, 1, 2, 3
# l_dy on the Nyquist row: l; zero on global columns 1..nx/2-1 (the half
# layout); zero but on columns 0 and nx/2 (pair_inverse)
NYQ_L, NYQ_HALF, NYQ_PAIR = 0, 1, 2
# the batch's entries, in the order of Plan.slots
SLOTS = ("ph", "u", "v", "q", "qpsi")


class QLayout(NamedTuple):
    """A wave kernel's q-side layout, resolved once (:func:`q_layout`):
    what the plain chain's q-side tables are cut by and the kernels read."""

    cut: object       # a global full-layout host table -> this rank's block
    kq: torch.Tensor  # (wq,) k of this rank's q-side columns
    l: torch.Tensor   # (ny,) l by row
    col0: int         # this rank's first global q-side column
    nx: int
    nreal: int        # global q-side columns that hold data (beyond: pad)
    pad: int          # zero columns after the half spectrum's nx//2+1
    nyq: int          # NYQ_*
    proj: int         # PROJ_*: ph's Hermitian projection
    mirror: tuple     # local indices of the self-mirror columns k = 0, nx/2

    def l_dy(self) -> torch.Tensor:
        """The ``(ny, wq)`` l table of the q side's y-derivatives, as the
        kernels make it: zero on padded columns and, by ``nyq``, on part of
        the Nyquist row, where the l-derivative of a Hermitian spectrum is
        purely anti-Hermitian: the half layout's representative there is
        0, and ``pair_inverse``'s packed read must never create it."""
        ny, wq = self.l.shape[0], self.kq.shape[0]
        cg = torch.arange(self.col0, self.col0 + wq, device=self.l.device)
        out = self.l[:, None].repeat(1, wq)
        out[:, cg >= self.nreal] = 0.0
        if self.nyq == NYQ_HALF:
            out[ny // 2, (cg >= 1) & (cg < self.nx // 2)] = 0.0
        elif self.nyq == NYQ_PAIR:
            out[ny // 2, (cg != 0) & (cg != self.nx // 2)] = 0.0
        return out


def q_layout(grid, hermitian: bool, half=False, pad=0, pair=False):
    """The q side's :class:`QLayout` on ``grid`` (this rank's block): the
    half spectrum padded with ``pad`` zero columns (``Grid.half_np``), or
    the full one, read through pair-packed inverses where ``pair``;
    ``hermitian``: whether the physics projects ``ph``."""
    nx = grid.nx
    cut = partial(grid.half_np, pad=pad) if half else grid.spec_np
    nreal = nx // 2 + 1 if half else nx
    width = nreal + pad
    one_rank = grid.mesh is None or grid.mesh.nP == 1
    col0 = 0 if grid.mesh is None else grid.mesh.block(width).start
    kq = np.ascontiguousarray(cut(grid.k_np)[0]).astype(grid.dtype)
    if not hermitian:
        proj = PROJ_NONE
    elif half or pair:
        proj = PROJ_MIRROR
    else:
        proj = PROJ_REFLECT if one_rank else PROJ_RAW
    return QLayout(
        cut=cut, kq=torch.as_tensor(kq, device=grid.device),
        l=grid.l[:, 0].contiguous(), col0=col0, nx=nx, nreal=nreal, pad=pad,
        nyq=NYQ_HALF if half else NYQ_PAIR if pair else NYQ_L, proj=proj,
        mirror=tuple(grid.local_cols([0, nx // 2], width)))


class Plan(NamedTuple):
    """What the kernels read of a kernel object's layout and physics."""

    k: torch.Tensor   # (w,) k of the phi side's columns
    q: QLayout        # the q side's
    flags: int        # WAVE_PV | IMAG_JAC | OWNS_MEAN
    slots: tuple      # the batch index of each of SLOTS, -1 where absent
    inv_f: float      # 1/f as PyTorch's CUDA division by a scalar rounds it


def _f64(z) -> int:
    return int(z.dtype in (torch.complex128, torch.float64))


def grad_pack(phih, plan: Plan):
    """``[phih, ik phih, il phih]``, ``(3, ny, w)``."""
    phih = phih.contiguous()
    out = torch.empty((3,) + tuple(phih.shape), dtype=phih.dtype,
                      device=phih.device)
    ny, w = phih.shape
    FAMILY.launch("derive_grad_pack", phih.device, phih, out, plan.k,
                  plan.q.l, ny, w, _f64(phih))
    return out


def wave_pv(phi, phix, phiy):
    """``[|phi|^2, Re(i z)]``, real, ``(2, ny, w)``."""
    phi, phix, phiy = (t.contiguous() for t in (phi, phix, phiy))
    out = torch.empty((2,) + tuple(phi.shape), dtype=phi.real.dtype,
                      device=phi.device)
    FAMILY.launch("derive_wave_pv", phi.device, phi, phix, phiy, out,
                  phi.numel(), _f64(phi))
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
    q = plan.q
    if q.proj == PROJ_REFLECT and w != q.nx:
        raise ValueError("the one-rank reflection needs the full width")
    qwh = torch.empty_like(qh) if fj is not None else torch.zeros_like(qh)
    ph = torch.empty_like(qh)
    batch = torch.empty((sum(s >= 0 for s in plan.slots), ny, w),
                        dtype=qh.dtype, device=qh.device)
    FAMILY.launch("derive_invert", qh.device, fj, qh, qwh, ph, batch, wv2,
                  wv2i, filtr, q.kq, q.l, plan.inv_f, ny, w, q.col0, q.nx,
                  q.nreal, plan.flags, q.nyq, q.proj, *plan.slots, _f64(qh))
    return qwh, ph, batch


def project_pack(ph, refl, batch, plan: Plan):
    """In place: ``ph`` projected against its reflection ``refl``
    (``Z(-k, -l)``), and the batch's ``ph``-dependent entries from it."""
    refl = refl.contiguous()
    ny, w = ph.shape
    s_ph, s_u, s_v = plan.slots[:3]
    q = plan.q
    FAMILY.launch("derive_project_pack", ph.device, ph, refl, batch, q.kq,
                  q.l, ny, w, q.col0, q.nx, q.nreal, q.nyq, s_ph, s_u, s_v,
                  _f64(ph))
