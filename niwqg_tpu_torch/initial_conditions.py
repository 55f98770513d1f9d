"""Initial-condition generators (port of ``niwqg_tpu/initial_conditions.py``).

Host-side numpy float64, with the same explicitly seeded
``numpy.random.default_rng`` as the JAX package, so the same seed gives the
same field. Every generator accepts a model of this package (which exposes
``grid``) or a reference-style object with ``wv``, ``wv2``, ``x``, ``y``
and ``nx`` attributes.
"""

from __future__ import annotations

import numpy as np
import scipy.special as special


def _wv(model):
    g = getattr(model, "grid", None)
    if g is not None:
        return g.wv_np, g.wv2_np, g.x_np, g.y_np, g.nx
    return model.wv, model.wv2, model.x, model.y, model.nx


def _spec_var(model, ph):
    """Host-side spec_var; ``M = nx*ny`` of the physical grid."""
    _, _, _, _, nx = _wv(model)
    M = nx * nx
    var_dens = np.abs(ph) ** 2 / float(M) ** 2
    if ph.shape[-1] != ph.shape[-2]:  # half spectrum
        var_dens = 2.0 * var_dens
        var_dens[:, 0] *= 0.5
        var_dens[:, nx // 2] *= 0.5
    var_dens[0, 0] = 0.0
    return var_dens.sum()


def _fft(model, x):
    g = getattr(model, "grid", None)
    if g is not None and g.spectrum == "half":
        return np.fft.rfft2(x)
    return np.fft.fft2(x)


def _ifft(model, xh):
    g = getattr(model, "grid", None)
    if g is not None and g.spectrum == "half":
        return np.fft.irfft2(xh, s=(g.nx, g.nx))
    return np.fft.ifft2(xh)


def McWilliams1984(model, k0=6, E=0.5, seed=None):
    """Random vorticity with the McWilliams (1984) red spectrum."""
    wv, wv2, _, _, _ = _wv(model)
    ckappa = np.zeros_like(wv2)
    nhx, nhy = wv2.shape
    kc2 = k0**2
    fk = wv != 0
    ckappa[fk] = np.sqrt(wv2[fk] * (1.0 + (wv2[fk] / kc2) ** 2)) ** -1

    rng = np.random.default_rng(seed)
    phase = rng.random((nhx, nhy)) * 2 * np.pi
    ph = ckappa * np.cos(phase) + 1j * ckappa * np.sin(phase)
    ph = _fft(model, np.real(_ifft(model, ph)))
    Eaux = 0.5 * _spec_var(model, wv * ph)
    pih = np.sqrt(E / Eaux) * ph
    qih = -wv2 * pih
    return np.real(_ifft(model, qih))


def LambDipole(model, U=0.01, R=1.0):
    """Lamb's dipole vorticity field."""
    _, _, x, y, N = _wv(model)
    x0, y0 = x[N // 2, N // 2], y[N // 2, N // 2]

    r = np.sqrt((x - x0) ** 2 + (y - y0) ** 2)
    s = np.zeros_like(r)
    nz = r != 0.0
    s[nz] = (y[nz] - y0) / r[nz]

    lam = 3.8317 / R
    Cc = -(2.0 * U * lam) / (special.j0(lam * R))
    q = np.zeros_like(r)
    inside = r <= R
    q[inside] = Cc * special.j1(lam * r[inside]) * s[inside]
    return q


def WavePacket(model, k=10, l=0, R=1, x0=0.0, y0=0.0):
    """Gaussian NIW wave packet."""
    _, _, x, y, _ = _wv(model)
    r = np.sqrt((x - x0) ** 2 + (y - y0) ** 2)
    phi = np.exp(1j * (k * (x - x0) + l * (y - y0)))
    return phi * np.exp(-((r / R) ** 2))


def PlaneWave(model, k=10, l=0, phase=0.0):
    """Plane-wave NIW field. As in the reference, ``phase`` is added
    outside the imaginary unit (an amplitude factor ``e^phase``)."""
    _, _, x, y, _ = _wv(model)
    return np.exp(1j * (k * x + l * y) + phase)
