"""Grid, wavenumber arrays, and spectral filter (port of ``niwqg_tpu/grid.py``).

A frozen, host-precomputed description of the doubly periodic domain. All
tables are built in numpy float64 and cast to the model dtype once, on the
model's device, so grid setup is exact regardless of the working precision.

Reference semantics (cesar-rocha/niwqg):
  - cell-centred physical grid ``x = (arange(0.5, nx))/nx * L``
  - full-spectrum wavenumber ordering ``[0..nx/2-1, -nx/2..-1]`` (the
    negative-Nyquist convention); half spectrum ``k = dk*arange(nx//2+1)``
  - ``ny`` is ignored: ``ny = nx``
  - ``wv2i`` is zero at the mean mode
  - exponential filter ``exp(-23.6 (wvx-0.65*pi)^4)`` above the cutoff, 1
    below; 2/3-rule mask alternative

On a mesh (``mesh=``, see ``parallel/mesh.py``) the host tables stay
global and bitwise those of the one-rank grid; the device tables are cut
from them to this rank's block: spectral tables to its columns, physical
tables to its rows.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .parallel.mesh import RowBlock, all_sum


@dataclasses.dataclass(frozen=True)
class Grid:
    """Doubly periodic square grid with full- or half-spectrum layout."""

    nx: int
    L: float
    dtype: np.dtype = np.dtype("float64")
    spectrum: str = "full"  # 'full' | 'half'
    use_filter: bool = True
    dealias: bool = False
    device: Optional[torch.device] = None  # the card unless "cpu"
    # extra zero-wavenumber spectral columns (half layout only): the pencil
    # rfft pads nk = nx//2+1 up to a mesh-divisible column count
    # (``parallel/pfft.py``); padded columns carry k = 0 and zero data
    pad: int = 0
    mesh: Optional[object] = None  # parallel.mesh.Mesh; None: one rank

    def __post_init__(self):
        dev = self.mesh.device if self.mesh is not None else self.device
        object.__setattr__(self, "device", resolve_device(dev))
        if self.mesh is not None and (self.nx % self.mesh.nP
                                      or self.nk % self.mesh.nP):
            raise ValueError(
                f"nx={self.nx} (spectral width {self.nk}) is not divisible "
                f"by the mesh size {self.mesh.nP}")

    # ---- host-side (numpy, float64) -------------------------------------
    @property
    def ny(self) -> int:
        return self.nx

    @property
    def W(self) -> float:
        return self.L

    @property
    def dx(self) -> float:
        return self.L / self.nx

    @property
    def dy(self) -> float:
        return self.W / self.ny

    @property
    def M(self) -> int:
        """Spectral normalisation constant nx*ny."""
        return self.nx * self.ny

    @property
    def nl(self) -> int:
        return self.ny

    @property
    def nk(self) -> int:
        if self.spectrum == "full":
            return self.nx
        return self.nx // 2 + 1 + self.pad

    # ---- this rank's blocks ------------------------------------------------
    @property
    def spec_shape(self) -> tuple:
        """Local shape of a spectral field: all rows, this rank's columns."""
        nP = 1 if self.mesh is None else self.mesh.nP
        return (self.nl, self.nk // nP)

    @property
    def phys_shape(self) -> tuple:
        """Local shape of a physical field: this rank's rows, all columns."""
        nP = 1 if self.mesh is None else self.mesh.nP
        return (self.ny // nP, self.nx)

    def local_cols(self, cols) -> list:
        """Local indices of those global spectral columns this rank owns.
        Masks of single columns (the mean mode, the self-mirror columns)
        come from the global index, never from a local ``[:, 0]``."""
        if self.mesh is None:
            return list(cols)
        blk = self.mesh.block(self.nk)
        return [c - blk.start for c in cols if blk.start <= c < blk.stop]

    @property
    def owns_mean_mode(self) -> bool:
        """Whether this rank holds the (0,0) spectral coefficient."""
        return bool(self.local_cols([0]))

    def spec_np(self, a: np.ndarray) -> np.ndarray:
        """This rank's column block of a global host spectral table."""
        return a if self.mesh is None else self.mesh.cols(a)

    def phys_np(self, a: np.ndarray) -> np.ndarray:
        """This rank's row block of a global host physical array, or the
        block a ``multihost.make_global_field`` result holds (checked to be
        this rank's)."""
        if isinstance(a, RowBlock):
            return a.block_for(self.mesh)
        return a if self.mesh is None else self.mesh.rows(a)

    @cached_property
    def x_np(self) -> np.ndarray:
        x, _ = np.meshgrid(
            np.arange(0.5, self.nx, 1.0) / self.nx * self.L,
            np.arange(0.5, self.ny, 1.0) / self.ny * self.W,
        )
        return x

    @cached_property
    def y_np(self) -> np.ndarray:
        _, y = np.meshgrid(
            np.arange(0.5, self.nx, 1.0) / self.nx * self.L,
            np.arange(0.5, self.ny, 1.0) / self.ny * self.W,
        )
        return y

    @property
    def dk(self) -> float:
        return 2.0 * np.pi / self.L

    @property
    def dl(self) -> float:
        return 2.0 * np.pi / self.L

    @cached_property
    def ll_np(self) -> np.ndarray:
        """1-D meridional wavenumbers, full-spectrum ordering."""
        return self.dl * np.append(
            np.arange(0.0, self.nx / 2), np.arange(-self.nx / 2, 0.0)
        )

    @cached_property
    def kk_np(self) -> np.ndarray:
        """1-D zonal wavenumbers (layout-dependent)."""
        if self.spectrum == "full":
            return self.ll_np.copy()
        kk = self.dk * np.arange(0.0, self.nx // 2 + 1)
        if self.pad:
            kk = np.append(kk, np.zeros(self.pad))
        return kk

    @cached_property
    def k_np(self) -> np.ndarray:
        k, _ = np.meshgrid(self.kk_np, self.ll_np)
        return k

    @cached_property
    def l_np(self) -> np.ndarray:
        _, l = np.meshgrid(self.kk_np, self.ll_np)
        return l

    @cached_property
    def wv2_np(self) -> np.ndarray:
        return self.k_np**2 + self.l_np**2

    @cached_property
    def wv_np(self) -> np.ndarray:
        return np.sqrt(self.wv2_np)

    @cached_property
    def wv4_np(self) -> np.ndarray:
        return self.wv2_np**2

    @cached_property
    def wv2i_np(self) -> np.ndarray:
        iwv2 = self.wv2_np != 0.0
        out = np.zeros_like(self.wv2_np)
        out[iwv2] = self.wv2_np[iwv2] ** -1
        return out

    @cached_property
    def filtr_np(self) -> np.ndarray:
        if self.use_filter:
            cphi = 0.65 * np.pi
            wvx = np.sqrt((self.k_np * self.dx) ** 2 + (self.l_np * self.dy) ** 2)
            filtr = np.exp(-23.6 * (wvx - cphi) ** 4)
            filtr[wvx <= cphi] = 1.0
            return filtr
        if self.dealias:
            filtr = np.ones_like(self.wv2_np)
            filtr[self.nx // 3 : 2 * self.nx // 3, :] = 0.0
            if self.spectrum == "full":
                filtr[:, self.ny // 3 : 2 * self.ny // 3] = 0.0
            else:
                filtr[:, self.nx // 3 :] = 0.0
            return filtr
        return np.ones_like(self.wv2_np)

    # ---- device-side (torch, model dtype) --------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A spectral table on the device, cut to this rank's columns."""
        return torch.as_tensor(
            np.ascontiguousarray(self.spec_np(a)).astype(self.dtype),
            device=self.device)

    def _dev_phys(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(self.phys_np(a)).astype(self.dtype),
            device=self.device)

    @cached_property
    def x(self):
        return self._dev_phys(self.x_np)

    @cached_property
    def y(self):
        return self._dev_phys(self.y_np)

    @cached_property
    def k(self):
        return self._dev(self.k_np)

    @cached_property
    def l(self):
        return self._dev(self.l_np)

    @cached_property
    def wv(self):
        return self._dev(self.wv_np)

    @cached_property
    def wv2(self):
        return self._dev(self.wv2_np)

    @cached_property
    def wv4(self):
        return self._dev(self.wv4_np)

    @cached_property
    def wv2i(self):
        return self._dev(self.wv2i_np)

    @cached_property
    def filtr(self):
        return self._dev(self.filtr_np)

    # ---- spec_var --------------------------------------------------------
    def spec_var(self, zh: torch.Tensor) -> torch.Tensor:
        """Variance of a field from its transform: ``|zh|^2/M^2`` summed with
        the mean mode removed; the half-spectrum variant doubles the
        columns whose conjugate mirrors it drops."""
        var_dens = (zh.real * zh.real + zh.imag * zh.imag) / float(self.M) ** 2
        if self.spectrum == "half":
            var_dens = 2.0 * var_dens
            # the Nyquist column by its global index: it is not the last
            # column when the layout carries pencil padding
            for c in self.local_cols([0, self.nx // 2]):
                var_dens[:, c] *= 0.5
        if self.owns_mean_mode:
            var_dens[0, 0].fill_(0.0)  # no scalar copied from the host
        return all_sum(var_dens.sum(), self.mesh)

    # ---- spec_cross ------------------------------------------------------
    def spec_cross(self, fh: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
        """Physical-grid mean of ``f * g`` from their transforms (Parseval),
        with the same Hermitian-degeneracy weights as :meth:`spec_var`; the
        (0,0) mode is kept."""
        d = (fh.real * gh.real + fh.imag * gh.imag) / float(self.M) ** 2
        if self.spectrum == "half":
            d = 2.0 * d
            for c in self.local_cols([0, self.nx // 2]):
                d[:, c] *= 0.5
        return all_sum(d.sum(), self.mesh)
