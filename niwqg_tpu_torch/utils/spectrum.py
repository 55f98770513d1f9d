"""Isotropic spectral analysis of 2-D doubly periodic fields.

Host-side numpy, a copy of ``niwqg_tpu/utils/spectrum.py`` (the port
imports nothing of the JAX package), covering what the reference examples
pull from the external ``pyspec`` package (``examples/LambDipole.py:159-171``):
the 2-D power spectral density of a field and its azimuthal
(isotropic-ring) integral.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TwoDimensionalSpec(NamedTuple):
    """2-D spectrum and its isotropic integral."""

    spec: np.ndarray   # 2-D power spectral density (kj, ki)
    ispec: np.ndarray  # isotropic (ring-integrated) spectrum
    ki: np.ndarray     # isotropic wavenumber bins
    kx: np.ndarray     # 1-D wavenumbers, x
    ky: np.ndarray     # 1-D wavenumbers, y


def spectrum_2d(field, d1: float, d2: float) -> TwoDimensionalSpec:
    """Power spectral density of a real or complex 2-D field.

    Parameters mirror pyspec's ``TWODimensional_spec(phi, d1, d2)``:
    ``d1``/``d2`` are the grid spacings. Normalised so that
    ``sum(spec) * dk1 * dk2 ~ variance`` (density convention).
    """
    field = np.asarray(field)
    n2, n1 = field.shape
    L1, L2 = d1 * n1, d2 * n2
    dk1, dk2 = 2 * np.pi / L1, 2 * np.pi / L2

    fh = np.fft.fftshift(np.fft.fft2(field)) * (d1 * d2) / (2 * np.pi)
    spec = np.abs(fh) ** 2 / (L1 * L2)

    kx = np.fft.fftshift(np.fft.fftfreq(n1, d1)) * 2 * np.pi
    ky = np.fft.fftshift(np.fft.fftfreq(n2, d2)) * 2 * np.pi
    kkx, kky = np.meshgrid(kx, ky)
    kmag = np.sqrt(kkx**2 + kky**2)

    dkr = max(dk1, dk2)
    ki = dkr * np.arange(1, int(kmag.max() / dkr) + 1)
    # exact binned ring sums: sum(ispec)*dkr == sum(spec)*dk1*dk2
    idx = np.round(kmag / dkr).astype(int) - 1
    valid = (idx >= 0) & (idx < len(ki))
    ispec = np.bincount(idx[valid].ravel(), weights=spec[valid].ravel(),
                        minlength=len(ki)).astype(spec.dtype)
    ispec *= dk1 * dk2 / dkr
    return TwoDimensionalSpec(spec=spec, ispec=ispec, ki=ki, kx=kx, ky=ky)
