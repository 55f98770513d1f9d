"""Initial fields ``q`` and ``c`` made from ``--seed`` and a traffic mix's
``initial`` parameters: the seeded Lamb dipole of ``lamb_dipole_waves``,
and the upstream QG example's passive tracer (``niwqg``
``examples/LambDipole_qg.py``: ``Re(PlaneWave(k0, k0)) max|q|`` with
``k0 = 10 (2 pi / L)``) plus a seeded real perturbation of its lowest
Fourier modes, of rms ``c_perturbation`` times the tracer's scale
``max|q|``. Every seed draws the same number of values and gives fields
of the same sizes, so the work of a run does not depend on it; the fields
are built on the device in float64."""

from __future__ import annotations

import math

import torch

from portbench.initial import lamb_dipole_waves

# the upstream example's tracer wavenumber, in units of 2 pi / L, along x
# and along y
TRACER_WAVENUMBER = 10


def make(nx: int, L: float, seed: int, initial: dict, device) -> dict:
    """``{"q": ..., "c": ...}``: float64 tensors of shape (nx, nx) on
    ``device`` (rows y, columns x, as the upstream's grids)."""
    nmax = int(initial["c_modes"])
    modes = lamb_dipole_waves.low_modes(nmax)
    # the same draws as the dipole's own: its centre, then the amplitudes
    _, amp = lamb_dipole_waves.draws(seed, len(modes))
    dipole = {"dipole_U": initial["dipole_U"],
              "dipole_radius_over_L": initial["dipole_radius_over_L"],
              "phi_modes": nmax, "phi_amplitude_over_U": 0.0,
              "phi_perturbation": 0.0}
    q = lamb_dipole_waves.make(nx, L, seed, dipole, device)["q"]

    f64 = dict(dtype=torch.float64, device=device)
    x1 = (torch.arange(nx, **f64) + 0.5) / nx * L
    y, x = torch.meshgrid(x1, x1, indexing="ij")
    k0 = TRACER_WAVENUMBER * 2.0 * math.pi / L
    # the perturbation: the real part of the seeded amplitudes on the
    # lowest modes, scaled to unit rms
    spec = torch.zeros((nx, nx), dtype=torch.complex128, device=device)
    idx = torch.tensor([[b % nx, a % nx] for a, b in modes], device=device)
    spec[idx[:, 0], idx[:, 1]] = torch.as_tensor(amp, device=device)
    eta = (torch.fft.ifft2(spec) * (nx * nx)).real
    eta = eta / torch.sqrt((eta * eta).mean())
    eps = float(initial["c_perturbation"])
    c = q.abs().max() * (torch.cos(k0 * (x + y)) + eps * eta)
    return {"q": q, "c": c}
