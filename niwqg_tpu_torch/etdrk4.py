"""ETDRK4 coefficient tables (port of ``niwqg_tpu/etdrk4.py``).

Cox & Matthews (2002) exponential time differencing RK4 with coefficients
from the Kassam & Trefethen (2005) circular contour mean (M=32 points,
radius 1). Everything is computed on the host in numpy complex128 — the
same code path, chunking and row mirror as the JAX package, so the tables
are bitwise equal to ``niwqg_tpu.etdrk4.build_coefs`` — and only cast to
the model's complex dtype on its device at the end.

The per-equation linear operator ``c`` bundles mean-flow advection, the
three dissipation operators and, for the wave equation, the NIW dispersion
term ``-i/2 * f * wv2/kappa^2``.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .device import complex_dtype
from .grid import Grid


class ETDRK4Coefs(NamedTuple):
    """Coefficient tables for one prognostic equation (complex tensors).

      stage1: uh = (expch_h*uh0 + F0*Qh) * filtr
      stage2: uh = (expch_h*uh0 + Fa*Qh) * filtr
      stage3: uh = (expch_h*uh1 + (2Fb - F0)*Qh) * filtr
      final : uh = (expch*uh0 + F0*f0 + 2(Fa+Fb)*fab + Fc*fc) * filtr
    """

    expch: torch.Tensor
    expch_h: torch.Tensor
    Qh: torch.Tensor
    f0: torch.Tensor
    fab: torch.Tensor
    fc: torch.Tensor


def _contour_phis(ch: np.ndarray, dt: float, M: int = 32, rho: float = 1.0):
    """Kassam–Trefethen contour means of the four phi-functions.

    Row chunks bound the peak host memory (the naive ``(nl, nk, M)``
    broadcast needs ~13 GB at 2048²); chunks run on a thread pool, since
    numpy's transcendental ufuncs release the GIL. Per-element arithmetic
    is the same as a serial loop, so the result does not depend on the
    worker count (``NIWQG_ETDRK4_WORKERS``, default the CPU count, at most
    16).
    """
    r = rho * np.exp(2j * np.pi * ((np.arange(1.0, M + 1)) / M))
    Qh = np.empty_like(ch)
    f0 = np.empty_like(ch)
    fab = np.empty_like(ch)
    fc = np.empty_like(ch)
    nl = ch.shape[0]
    try:
        nworkers_env = int(os.environ.get("NIWQG_ETDRK4_WORKERS", "0"))
    except ValueError:
        nworkers_env = 0
    nworkers = min(nworkers_env or (os.cpu_count() or 1), 16)
    rows = max(1, min(nl, (8 << 20) // max(1, ch.shape[1] * M)
                      // max(1, nworkers)))

    # row symmetry: every operator depends on l only through wv2, so rows
    # l and nl-l carry identical ch; evaluate the lower half and mirror
    nl_eval = nl
    if nl % 2 == 0 and nl > 2 and np.array_equal(ch[1:nl // 2],
                                                 ch[:nl // 2:-1]):
        nl_eval = nl // 2 + 1

    def do_chunk(j0):
        sl = slice(j0, min(j0 + rows, nl_eval))
        LR = ch[sl, :, np.newaxis] + r[np.newaxis, np.newaxis, :]
        LR2 = LR * LR
        LR3 = LR2 * LR
        eLR = np.exp(LR)
        Qh[sl] = dt * (((np.exp(LR / 2.0) - 1.0) / LR).mean(axis=-1))
        f0[sl] = dt * (
            (((-4.0 - LR + (eLR * (4.0 - 3.0 * LR + LR2))) / LR3).mean(axis=-1))
        )
        fab[sl] = dt * (((2.0 + LR + eLR * (-2.0 + LR)) / LR3).mean(axis=-1))
        fc[sl] = dt * (((-4.0 - 3.0 * LR - LR2 + eLR * (4.0 - LR)) / LR3).mean(axis=-1))

    starts = list(range(0, nl_eval, rows))
    if nworkers > 1 and len(starts) > 1:
        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            list(ex.map(do_chunk, starts))
    else:
        for j0 in starts:
            do_chunk(j0)
    if nl_eval != nl:
        for out in (Qh, f0, fab, fc):
            out[nl // 2 + 1:] = out[1:nl // 2][::-1]
    return Qh, f0, fab, fc


def fold_filter_into(coefs: ETDRK4Coefs, filtr) -> ETDRK4Coefs:
    """Pre-multiply the stage filter into every table so the stepper skips
    its explicit ``* filtr`` pass (pure reassociation)."""
    return ETDRK4Coefs(*[t * filtr for t in coefs])


def _table_cache_dir() -> str:
    """Directory of the persistent contour-table cache.

    The contour means dominate a cold build at production sizes and depend
    only on ``(ch, dt)``, so they are cached on disk under a content hash.
    ``NIWQG_TORCH_TABLE_CACHE=0`` disables the cache; any other value
    replaces the default ``~/.cache/niwqg_tpu_torch/etdrk4``. Only tables
    of at least 2^20 elements are cached."""
    d = os.environ.get("NIWQG_TORCH_TABLE_CACHE", "")
    if d == "0":
        return ""
    return d or os.path.join(os.path.expanduser("~"), ".cache",
                             "niwqg_tpu_torch", "etdrk4")


_TABLE_CACHE_MIN_ELEMS = 1 << 20


def _contour_phis_cached(ch: np.ndarray, dt: float):
    cache_dir = _table_cache_dir()
    if not cache_dir or ch.size < _TABLE_CACHE_MIN_ELEMS:
        return _contour_phis(ch, dt)
    h = hashlib.sha256()
    h.update(np.float64(dt).tobytes())
    h.update(str(ch.shape).encode())
    h.update(b"M=32,rho=1,v1")
    h.update(np.ascontiguousarray(ch).tobytes())
    fno = os.path.join(cache_dir, h.hexdigest() + ".npz")
    if os.path.exists(fno):
        try:
            with np.load(fno) as z:
                return z["Qh"], z["f0"], z["fab"], z["fc"]
        except (OSError, ValueError, KeyError):
            pass  # corrupt or partial file: rebuild and overwrite
    Qh, f0, fab, fc = _contour_phis(ch, dt)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = fno + f".tmp{os.getpid()}.npz"  # np.savez appends .npz itself
        np.savez(tmp[:-4], Qh=Qh, f0=f0, fab=fab, fc=fc)
        os.replace(tmp, fno)
    except OSError:
        pass  # the cache is best-effort (read-only file system, disk full)
    return Qh, f0, fab, fc


def build_tables_np(c: np.ndarray, dt: float):
    """Host complex128 tables ``(expch, expch_h, Qh, f0, fab, fc)``."""
    ch = c * dt
    Qh, f0, fab, fc = _contour_phis_cached(ch, dt)
    return np.exp(ch), np.exp(ch / 2.0), Qh, f0, fab, fc


def build_coefs(grid: Grid, c: np.ndarray, dt: float) -> ETDRK4Coefs:
    """ETDRK4 tables for a linear operator ``c`` (complex128, host), cast
    to the grid's complex dtype on its device."""
    cd = complex_dtype(grid.dtype)
    return ETDRK4Coefs(*[torch.as_tensor(t).to(device=grid.device, dtype=cd)
                         for t in build_tables_np(c, dt)])


def linear_operator_q(grid: Grid, U: float, nu4: float, nu: float, mu: float,
                      beta: float = 0.0) -> np.ndarray:
    """Linear operator of the vorticity equation."""
    c = np.zeros((grid.nl, grid.nk), np.complex128) - 1j * grid.k_np * U
    c += -nu4 * grid.wv4_np - nu * grid.wv2_np - mu
    if beta:
        c += beta * (1j * grid.k_np) * grid.wv2i_np
    return c


def linear_operator_phi(grid: Grid, U: float, f: float, kappa2: float,
                        nu4w: float, nuw: float, muw: float) -> np.ndarray:
    """Linear operator of the wave equation."""
    c = np.zeros((grid.nl, grid.nk), np.complex128) - 1j * grid.k_np * U
    c += (
        -nu4w * grid.wv4_np
        - 0.5j * f * (grid.wv2_np / kappa2)
        - nuw * grid.wv2_np
        - muw
    )
    return c
