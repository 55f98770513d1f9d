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

The kernel counts its own launches on the card (``FAMILY``, a
``cuda_build.Family``), by use (``USES``): ``stage``, a stage's right-hand
sides (with or without its partials), and ``sources``, the partials alone
(the diagnostics' sources). :func:`counts` reads them with ``cpu_calls``,
the epilogues the plain chain served on host tensors
(``FAMILY.plain_call("epilogue")``); :func:`reset_counts` sets all to 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..cuda_build import Family, field
from .derive_fused import QLayout

KERNELS = ("stage_epilogue",)
# the launch counters, by use
USES = ("stage", "sources")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
FAMILY = Family(
    "stage",
    {"stage_epilogue": ([_ptr] * 12 + [_i32] * 10 + [ctypes.c_double] * 2
                        + [_i32] * 3 + [_ptr] * 2)},
    keys=USES, plain=["epilogue"])
counts, reset_counts = FAMILY.counts, FAMILY.reset
# the budget partials: seven weighted sums, then four mean-mode entries
N_PARTS = 11
N_SUMS = 7


class Plan(NamedTuple):
    """What the kernel reads of a kernel object's layout and physics."""

    w_d: torch.Tensor      # (ny, w) wave side: -(nu4w wv4 + nuw wv2 + muw)
    w_chi: torch.Tensor    # (ny, w) chi_phi's weight
    wv2: torch.Tensor      # (ny, w) the wave side's wv2
    w_eppsi: torch.Tensor  # (ny, wq) ep_psi's weight (half: degeneracy in)
    q: QLayout             # the q side's layout
    zero_jac: bool         # zero Fnw's Jacobian at the mean mode
    owner: bool            # this rank holds the (0,0) mode
    inv_m: float           # 1/M, rounded as the working type rounds it
    inv_m2: float          # 1/M²
    partials: object       # the workspace (``FAMILY.workspace``)
    arrivals: object
    blocks: int


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
    q = plan.q
    wq = q.kq.shape[0]
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
        for v in field(z)])
    FAMILY.launch(
        "stage_epilogue", dev, fields, plan.w_d, plan.w_chi, plan.wv2,
        plan.w_eppsi, q.kq, q.l, fnw, fn, parts, plan.partials,
        plan.arrivals, plan.blocks, ny, w, wq, q.col0, q.nx, q.nreal, q.nyq,
        int(plan.zero_jac), int(plan.owner), plan.inv_m, plan.inv_m2,
        int(rhs), int(sources), int(rd == torch.float64),
        key="stage" if rhs else "sources")
    return fn, fnw, parts
