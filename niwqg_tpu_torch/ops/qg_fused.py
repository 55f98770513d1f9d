"""Launchers of the QG model's fused stage gaps (``csrc/qg_stage.cu``).

``QGKernel._step_fused`` (``models/qg.py``) is a step of four ETDRK4 stages,
each a batched inverse and a batched forward real transform with one of
these kernels in each gap between them:

:func:`products` (``qg_products``)
    after a stage's inverse ``[u, v, q (, c)]``: the forward's batch
    ``[u q, v q (, u c, v c)]``;
:func:`stage` (``qg_stage``)
    after a stage's forward ``fj``: ``Fn = -(ik fj0 + il fj1)`` (and the
    scalar's from ``fj2, fj3``), the stage's ETDRK4 update with the
    filter, the inversion ``ph = -qh wv2i``, this rank's budget partials
    (:data:`PARTS`) and the next inverse's batch ``[-il ph, ik ph, qh
    (, ch)]`` (stage 4: ``[ph, qh (, ch)]``, the final inverse's); stages
    1-3 also write the right-hand sides later stages read;
:func:`pack` (``qg_stage``, its stage 0)
    stage 1's batch from the state's ``ph``, ``qh`` and ``ch``.

Each takes CUDA tensors and a :class:`Plan`, which the kernel object
makes once from its grid, tables and physics; a field is read in its own
strides, tables are row-major. Each launches on the tensors' current
stream and raises if the launch is refused. The ``*_plain`` functions are
the same gaps as PyTorch operations, in the order and rounding of the
plain step's chain: the oracle the kernels are held to on the card (the
host runs the plain step itself).

The kernels count their launches on the card (``FAMILY``, a
``cuda_build.Family``), by use (``USES``): ``pack``, ``products`` and
``stage``. :func:`counts` reads them with ``cpu_calls``, the stages the
plain step served on host tensors (``FAMILY.plain_call("stage")``);
:func:`reset_counts` sets all to 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..cuda_build import Family, field
from .spectral import abs2, mul_i

KERNELS = ("qg_products", "qg_stage")
# the launch counters, by use
USES = ("pack", "products", "stage")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
FAMILY = Family(
    "qg_stage",
    {"qg_products": [_ptr] * 2 + [_i32] * 4 + [_ptr] * 2,
     "qg_stage": ([_ptr] * 5 + [_i32] * 10 + [ctypes.c_double] * 3
                  + [_i32] + [_ptr] * 2)},
    keys=USES, plain=["stage"])
counts, reset_counts = FAMILY.counts, FAMILY.reset
# this rank's budget partials a stage, each over M²: the scalar's spec_var
# of ch, ch wv and ch wv2 (ep_c's C2, gradC2 and mean(lapc²)), ep_psi's
# spec_cross of the pairing qh and ph (nu4 wv4 + mu), and of the fresh qh
# and ph wv2 (its nu term)
PARTS = ("C2", "gradC2", "lapc2", "psi", "psi_nu")
# qg_stage's table and output slots (``ptrs``), in csrc/qg_stage.cu's order
_PTRS = ("tq0", "tq1", "tq2", "tq3", "tc0", "tc1", "tc2", "tc3", "fn0q",
         "fn0c", "fn1q", "fn1c", "fn_outq", "fn_outc", "mly", "kx", "ph",
         "outq", "outc", "filt", "wv2i", "k", "l", "kd", "ld")


class Plan(NamedTuple):
    """What the kernels read of a QG kernel object's grid and physics."""

    k: torch.Tensor          # (wq,) k of this rank's columns
    l: torch.Tensor          # (ny,) l by row
    kd: torch.Tensor         # (wq,) and (ny,) the same in float64 (the
    ld: torch.Tensor         # budgets' weights)
    wv2i: torch.Tensor       # (ny, wq)
    filtr: Optional[torch.Tensor]  # (ny, wq); None where folded in the tables
    cq: tuple                # etdrk4.ETDRK4Coefs of q, row-major
    cc: Optional[tuple]      # the scalar's, or None
    col0: int                # this rank's first global column
    nx: int
    nreal: int               # global columns that hold data (beyond: pad)
    owner: bool              # this rank holds the (0,0) mode
    sums: bool               # the budget partials (spectral budgets)
    nu4: float
    mu: float
    nu: float
    inv_m2: float            # 1/M², float64
    partials: object         # the workspace (``FAMILY.workspace``)
    arrivals: object
    blocks: int


def _check(zs, shape, dtype, device):
    for z in zs:
        if z is not None and (tuple(z.shape) != shape or z.dtype != dtype
                              or z.device != device):
            raise ValueError(f"a field of shape {tuple(z.shape)}, {z.dtype} "
                             f"on {z.device}; the kernel takes {shape}, "
                             f"{dtype} on {device}")


def _sides(plan):
    return (0, 1) if plan.cc is not None else (0,)


# -- the card -----------------------------------------------------------------

def products(plan, gb):
    """The forward's batch ``[u q, v q (, u c, v c)]`` from the inverse's
    ``gb = [u, v, q (, c)]`` (each read in its own strides)."""
    nout = 2 * len(_sides(plan))
    u = gb[0]
    rows, nx = u.shape
    fac = [gb[j] for j in range(nout // 2 + 2)]
    _check(fac, (rows, nx), u.dtype, u.device)
    out = torch.empty((nout, rows, nx), dtype=u.dtype, device=u.device)
    fields = (ctypes.c_longlong * 12)(*[
        v for j in range(4) for v in field(fac[j] if j < len(fac) else None)])
    FAMILY.launch("qg_products", u.device, fields, out, nout, rows, nx,
                  int(u.dtype == torch.float64), key="products")
    return out


def pack(plan, ph, qh, ch=None):
    """Stage 1's batch ``[-il ph, ik ph, qh (, ch)]`` from the state."""
    return _launch(plan, 0, base=(qh, ch), ph=ph)[0]


def stage(plan, n, fj, base, qh_q=None, fns=(None, None), ph=False):
    """Stage ``n``'s gap from its forward ``fj`` (``(2 or 4, ny, wq)``):
    ``(batch, fn, parts, ph)``. ``base`` is the update's start ``(qh,
    ch)`` (``ch`` None without the scalar): the step's at stages 1, 2 and
    4, stage 1's at stage 3; ``qh_q`` the step's ``qh`` at stage 3 (the
    budget's pairing); ``fns`` the right-hand sides stages 1-3 wrote:
    stage 3 reads stage 1's and 2's, stage 4 stage 1's and 3's. ``batch``
    is the next inverse's, ``fn`` the stage's kept right-hand sides
    (``(sides, ny, wq)``; stage 3: ``Fna + Fnb``; stage 4: None), ``parts``
    the budget partials (None without spectral budgets), ``ph`` stage 4's
    (the batch's first) or, where ``ph``, stages 1-3's."""
    if not 1 <= n <= 4:
        raise ValueError(f"QG's stages are 1-4, not {n}")
    return _launch(plan, n, fj=fj, base=base, qh_q=qh_q, fns=fns,
                   want_ph=ph)


def _launch(plan, n, fj=None, base=(None, None), qh_q=None, fns=(None, None),
            ph=None, want_ph=False):
    qh = base[0]
    dev, cd = qh.device, qh.dtype
    ny, wq = qh.shape
    sides = _sides(plan)
    ns = len(sides)
    if n > 0:
        fj = [fj[j] for j in range(2 * ns)]
    _check((fj or []) + [base[s] for s in sides] + [qh_q, ph], (ny, wq), cd,
           dev)
    if (n >= 3) != (fns[0] is not None) or (n == 3 and plan.sums
                                             and qh_q is None):
        raise ValueError(f"stage {n} takes the right-hand sides of stages "
                         "before it, and at stage 3 the step's qh")
    width = (4 if n < 4 else 3) - (1 if ns == 1 else 0)
    batch = torch.empty((width, ny, wq), dtype=cd, device=dev)
    fn = (torch.empty((ns, ny, wq), dtype=cd, device=dev)
          if 1 <= n <= 3 else None)
    parts = (torch.empty(len(PARTS), dtype=plan.wv2i.dtype, device=dev)
             if n > 0 and plan.sums else None)
    ph_out = (batch[0] if n == 4 else
              torch.empty((ny, wq), dtype=cd, device=dev) if want_ph
              else None)
    p = dict.fromkeys(_PTRS, None)
    if n > 0:
        for s, c in zip(sides, (plan.cq, plan.cc)):
            tabs = (c.expch, c.f0, c.fab, c.fc) if n == 4 else (c.expch_h,
                                                                c.Qh)
            for j, t in enumerate(tabs):
                p[f"t{'qc'[s]}{j}"] = t
            if n >= 3:
                p[f"fn0{'qc'[s]}"] = fns[0][s]
                p[f"fn1{'qc'[s]}"] = fns[1][s]
            if fn is not None:
                p[f"fn_out{'qc'[s]}"] = fn[s]
        p.update(filt=plan.filtr, wv2i=plan.wv2i)
    if n < 4:
        p.update(mly=batch[0], kx=batch[1], outq=batch[2],
                 outc=batch[3] if ns == 2 else None, ph=ph_out)
    else:
        p.update(ph=batch[0], outq=batch[1],
                 outc=batch[2] if ns == 2 else None)
    p.update(k=plan.k, l=plan.l, kd=plan.kd, ld=plan.ld)
    ptrs = (ctypes.c_longlong * len(_PTRS))(*[
        0 if p[k] is None else p[k].data_ptr() for k in _PTRS])
    fj = fj or []
    fields = (ctypes.c_longlong * 24)(*[
        v for z in (*(fj + [None] * (4 - len(fj))), base[0],
                    base[1] if ns == 2 else None, qh_q, ph)
        for v in field(z)])
    flags = int(plan.sums) | (int(bool(plan.nu)) << 1)
    FAMILY.launch(
        "qg_stage", dev, fields, ptrs, parts, plan.partials, plan.arrivals,
        plan.blocks, n, ny, wq, plan.col0, plan.nx, plan.nreal,
        int(plan.owner), int(ns == 2), flags, plan.nu4, plan.mu,
        plan.inv_m2, int(cd == torch.complex128),
        key="pack" if n == 0 else "stage")
    return batch, fn, parts, ph_out


# -- the plain chain ----------------------------------------------------------

def products_plain(plan, gb):
    """:func:`products` as the plain step forms it."""
    u, v, q = gb[0], gb[1], gb[2]
    prods = [u * q, v * q]
    if plan.cc is not None:
        prods += [u * gb[3], v * gb[3]]
    return torch.stack(prods)


def pack_plain(plan, ph, qh, ch=None):
    """:func:`pack` as the plain step forms it."""
    k, l = plan.k[None, :], plan.l[:, None]
    return torch.stack([mul_i(ph, -l), mul_i(ph, k), qh]
                       + ([ch] if ch is not None else []))


def stage_plain(plan, n, fj, base, qh_q=None, fns=(None, None), ph=False):
    """:func:`stage` as the plain step forms it; ``parts`` the float64
    totals of :func:`part_terms`, rounded once."""
    k, l = plan.k[None, :], plan.l[:, None]
    flt = plan.filtr
    new, kept = [], []
    for s, c in zip(_sides(plan), (plan.cq, plan.cc)):
        fn = -(mul_i(fj[2 * s], k) + mul_i(fj[2 * s + 1], l))
        if n <= 2:
            x = c.expch_h * base[s] + fn * c.Qh
            kept.append(fn)
        elif n == 3:
            x = c.expch_h * base[s] + (2.0 * fn - fns[0][s]) * c.Qh
            kept.append(fns[1][s] + fn)
        else:
            x = (c.expch * base[s] + fns[0][s] * c.f0
                 + 2.0 * fns[1][s] * c.fab + fn * c.fc)
        new.append(x if flt is None else x * flt)
    qh = new[0]
    ch = new[1] if len(new) == 2 else None
    phn = -(qh * plan.wv2i)
    rest = [qh] + ([ch] if ch is not None else [])
    if n < 4:
        batch = torch.stack([mul_i(phn, -l), mul_i(phn, k)] + rest)
    else:
        batch = torch.stack([phn] + rest)
    parts = None
    if plan.sums:
        pair = qh_q if n == 3 else qh if n == 4 else base[0]
        parts = parts_plain(plan, pair, qh, phn, ch)
    return (batch, torch.stack(kept) if kept else None, parts,
            phn if n == 4 or ph else None)


def part_terms(plan, qh_q, qh, ph, ch=None) -> list:
    """The terms of the budget partials in float64, in :data:`PARTS`' order
    (None where the partial is not made: the scalar's without it, psi_nu
    without ``nu``); each partial is its terms' sum over M². ``qh_q`` is
    ep_psi's pairing, ``qh``, ``ph`` and ``ch`` the stage's fresh fields."""
    ny, wq = plan.l.shape[0], plan.k.shape[0]
    kd, ld = plan.kd[None, :], plan.ld[:, None]
    wv2 = kd * kd + ld * ld
    wv4 = wv2 * wv2
    # the half spectrum's weights (Grid.spec_var, Grid.spec_cross): the
    # self-mirror columns k = 0, nx/2 once, the others twice, padding not
    cg = torch.arange(plan.col0, plan.col0 + wq, device=plan.kd.device)
    deg = torch.full((wq,), 2.0, dtype=torch.float64, device=cg.device)
    deg[(cg == 0) | (cg == plan.nx // 2)] = 1.0
    deg[cg >= plan.nreal] = 0.0
    deg = deg[None, :].expand(ny, wq)
    p = ph.to(torch.complex128)
    out = [None] * len(PARTS)
    if ch is not None:
        a2 = abs2(ch.to(torch.complex128))
        deg0 = deg.clone()
        if plan.owner:
            deg0[0, 0] = 0.0  # spec_var leaves out the mean mode
        out[0], out[1], out[2] = deg0 * a2, deg * wv2 * a2, deg * wv4 * a2
    q = qh_q.to(torch.complex128)
    out[3] = deg * (plan.nu4 * wv4 + plan.mu) * (q.real * p.real
                                                 + q.imag * p.imag)
    if plan.nu:
        h = qh.to(torch.complex128)
        out[4] = deg * wv2 * (h.real * p.real + h.imag * p.imag)
    return out


def parts_plain(plan, qh_q, qh, ph, ch=None) -> torch.Tensor:
    """The budget partials: each the float64 total of :func:`part_terms`
    over M², rounded once to the working type (0 where not made)."""
    sums = [0.0 if t is None else float(t.sum()) * plan.inv_m2
            for t in part_terms(plan, qh_q, qh, ph, ch)]
    return torch.tensor(sums, dtype=plan.wv2i.dtype, device=qh.device)
