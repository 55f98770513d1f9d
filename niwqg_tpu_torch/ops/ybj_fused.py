"""Launchers of the YBJ model's fused stage gaps (``csrc/ybj_stage.cu``).

``YBJKernel._step_fused`` (``models/ybj.py``) is a step of four ETDRK4
stages, each a batched inverse and a batched forward C2C transform with one
of these kernels in each gap between them:

:func:`products` (``ybj_products``)
    after a stage's inverse: from ``phix``, ``phiy``, ``phi`` and the frozen
    real ``u``, ``v``, ``q_psi``, the forward's batch ``[phix u + phiy v,
    phi q_psi]``;
:func:`stage` (``ybj_stage``)
    after a stage's forward ``nl``: ``Fn = -nl0 - (i/2) nl1`` (no mean-mode
    zeroing), the stage's ETDRK4 update with the filter, the right-hand
    side later stages read and the next inverse's batch ``[ik phih, il
    phih]`` (with ``faithful=False``, and at stage 4 for the step's end,
    ``[phih, ik phih, il phih]``);
:func:`pack` (``ybj_stage``, its stage 0)
    stage 1's batch from the state's ``phih``.

Each takes CUDA tensors of one card and a :class:`Plan`, which the kernel
object makes once from its grid and tables; fields are row-major (one that
is not is copied first). Each launches on the tensors' current stream and
raises if the launch is refused. The ``*_plain`` functions are the same
gaps as PyTorch operations, in the order and rounding of the plain step's
chain (``YBJKernel.step``): the oracle the kernels are held to on the card
(the host runs the plain step itself).

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

from ..cuda_build import Family
from .spectral import jmul, mul_i

KERNELS = ("ybj_products", "ybj_stage")
# the launch counters, by use
USES = ("pack", "products", "stage")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
FAMILY = Family(
    "ybj_stage",
    {"ybj_products": [_ptr] + [_i32] * 3 + [_ptr] * 2,
     "ybj_stage": [_ptr] + [_i32] * 4 + [_ptr] * 2},
    keys=USES, plain=["stage"])
counts, reset_counts = FAMILY.counts, FAMILY.reset
# the kernels' address slots, in csrc/ybj_stage.cu's order
_PRODUCT_PTRS = ("phix", "phiy", "phi", "u", "v", "q_psi", "out0", "out1")
_STAGE_PTRS = ("nl0", "nl1", "base", "t0", "t1", "t2", "t3", "fn0", "fn1",
               "fn_out", "phih", "kx", "ly", "filt", "k", "l")


class Plan(NamedTuple):
    """What the kernels read of a YBJ kernel object's grid and tables."""

    k: torch.Tensor                 # (nx,) k by column
    l: torch.Tensor                 # (ny,) l by row
    filtr: Optional[torch.Tensor]   # (ny, nx); None where folded in the tables
    cw: tuple                       # etdrk4.ETDRK4Coefs of phi, row-major
    faithful: bool                  # the refraction reads the step-start phi


def engages(device, mesh) -> bool:
    """Whether a YBJ step on ``device`` takes these kernels: CUDA tensors
    of one card (host tensors and a pencil mesh's blocks take the plain
    chain)."""
    return device.type == "cuda" and mesh is None


def _fields(zs, shape, dtype, device):
    """``zs`` row-major (a copy of one that is not), each checked."""
    out = []
    for z in zs:
        if tuple(z.shape) != shape or z.dtype != dtype or z.device != device:
            raise ValueError(f"a field of shape {tuple(z.shape)}, {z.dtype} "
                             f"on {z.device}; the kernel takes {shape}, "
                             f"{dtype} on {device}")
        out.append(z.contiguous())
    return out


def _addresses(p: dict, slots):
    return (ctypes.c_longlong * len(slots))(*[
        0 if p.get(k) is None else p[k].data_ptr() for k in slots])


# -- the card -----------------------------------------------------------------

def products(plan, phix, phiy, phi, u, v, q_psi):
    """The forward's batch ``[phix u + phiy v, phi q_psi]``, ``(2, ny,
    nx)``."""
    ny, nx = phix.shape
    dev = phix.device
    cs = _fields((phix, phiy, phi), (ny, nx), phix.dtype, dev)
    rs = _fields((u, v, q_psi), (ny, nx), phix.real.dtype, dev)
    out = torch.empty((2, ny, nx), dtype=phix.dtype, device=dev)
    ptrs = _addresses(dict(zip(_PRODUCT_PTRS, cs + rs + [out[0], out[1]])),
                      _PRODUCT_PTRS)
    FAMILY.launch("ybj_products", dev, ptrs, ny, nx,
                  int(phix.dtype == torch.complex128), key="products")
    return out


def pack(plan, phih):
    """Stage 1's batch from the state's ``phih``: ``[ik phih, il phih]``, or
    (not ``plan.faithful``) ``[phih, ik phih, il phih]``."""
    return _launch(plan, 0, None, phih)[0]


def stage(plan, n, nl, base, fns=(None, None)):
    """Stage ``n``'s gap from its forward ``nl`` (``(2, ny, nx)``):
    ``(batch, fn, phih)``. ``base`` is the update's start: the step's
    ``phih`` at stages 1, 2 and 4, stage 1's at stage 3; ``fns`` the
    right-hand sides earlier stages kept: stage 3 reads stage 1's and 2's,
    stage 4 stage 1's and 3's. ``batch`` is the next inverse's, ``fn`` the
    stage's kept right-hand side (stages 1-2 ``Fn``, stage 3 ``Fna + Fnb``,
    stage 4 None), ``phih`` the fresh spectrum where it is written: the
    batch's first field where the batch holds it (not ``plan.faithful``,
    and stage 4), a field of its own at stage 1 (stage 3's start), else
    None."""
    if not 1 <= n <= 4:
        raise ValueError(f"YBJ's stages are 1-4, not {n}")
    return _launch(plan, n, nl, base, fns)


def _launch(plan, n, nl, base, fns=(None, None)):
    ny, nx = base.shape
    dev, cd = base.device, base.dtype
    if (n >= 3) != (fns[0] is not None and fns[1] is not None):
        raise ValueError(f"stage {n} takes the right-hand sides of the "
                         "stages before it at 3 and 4 only")
    full = n == 4 or not plan.faithful
    batch = torch.empty((3 if full else 2, ny, nx), dtype=cd, device=dev)
    phih = (batch[0] if full else
            torch.empty((ny, nx), dtype=cd, device=dev) if n == 1 else None)
    fn = (torch.empty((ny, nx), dtype=cd, device=dev) if 1 <= n <= 3
          else None)
    (base,) = _fields((base,), (ny, nx), cd, dev)
    p = dict(base=base, phih=phih, kx=batch[-2], ly=batch[-1], k=plan.k,
             l=plan.l)
    if n > 0:
        c = plan.cw
        tabs = (c.expch, c.f0, c.fab, c.fc) if n == 4 else (c.expch_h, c.Qh)
        ins = _fields([nl[0], nl[1]] + [f for f in fns if f is not None],
                      (ny, nx), cd, dev)
        p.update(zip(("nl0", "nl1", "fn0", "fn1"), ins))
        p.update(zip(("t0", "t1", "t2", "t3"), tabs))
        p.update(fn_out=fn, filt=plan.filtr)
    FAMILY.launch("ybj_stage", dev, _addresses(p, _STAGE_PTRS), n, ny, nx,
                  int(cd == torch.complex128),
                  key="pack" if n == 0 else "stage")
    return batch, fn, phih


# -- the plain chain ----------------------------------------------------------

def products_plain(plan, phix, phiy, phi, u, v, q_psi):
    """:func:`products` as the plain step forms it."""
    return torch.stack([phix * u + phiy * v, phi * q_psi])


def _batch_plain(plan, phih, full):
    k, l = plan.k[None, :], plan.l[:, None]
    grads = [mul_i(phih, k), mul_i(phih, l)]
    return torch.stack([phih] + grads if full else grads)


def pack_plain(plan, phih):
    """:func:`pack` as the plain step forms it."""
    return _batch_plain(plan, phih, not plan.faithful)


def stage_plain(plan, n, nl, base, fns=(None, None)):
    """:func:`stage` as the plain step forms it."""
    c = plan.cw
    fn = -nl[0] - jmul(nl[1], 0.5)
    if n <= 2:
        x = c.expch_h * base + fn * c.Qh
        kept = fn
    elif n == 3:
        x = c.expch_h * base + (2.0 * fn - fns[0]) * c.Qh
        kept = fns[1] + fn
    else:
        x = (c.expch * base + fns[0] * c.f0 + 2.0 * fns[1] * c.fab
             + fn * c.fc)
        kept = None
    phih = x if plan.filtr is None else x * plan.filtr
    full = n == 4 or not plan.faithful
    return (_batch_plain(plan, phih, full), kept,
            phih if full or n == 1 else None)
