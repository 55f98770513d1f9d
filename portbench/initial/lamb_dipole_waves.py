"""Initial fields ``q`` and ``phi`` made from ``--seed`` and a traffic mix's
``initial`` parameters: the upstream example's Lamb dipole (Lamb 1932;
``niwqg`` ``InitialConditions.LambDipole``) centred at a seeded position of
the periodic domain, and its uniform near-inertial wave field
``phi0 (1 + i)/sqrt(2)`` with a seeded perturbation of its lowest Fourier
modes. Every seed draws the same number of values and gives fields of the
same sizes, so the work of a run does not depend on it. The few random
values come from numpy's generator on the host; the fields are built on
the device in float64."""

from __future__ import annotations

import math

import numpy as np
import torch

LAMB_ZERO = 3.8317  # first zero of J1, as the upstream writes it


def low_modes(nmax: int):
    """The integer wavevectors ``(mx, my)`` with ``0 < |m| <= nmax``."""
    return [(a, b) for a in range(-nmax, nmax + 1)
            for b in range(-nmax, nmax + 1) if 0 < a * a + b * b <= nmax ** 2]


def draws(seed: int, nmodes: int):
    """The seed's random values: the dipole's centre as fractions of the
    domain, and a complex amplitude for each perturbed mode."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    centre = rng.random(2)
    amp = rng.standard_normal(nmodes) + 1j * rng.standard_normal(nmodes)
    return centre, amp


def make(nx: int, L: float, seed: int, initial: dict, device) -> dict:
    """``{"q": ..., "phi": ...}``: float64 and complex128 tensors of shape
    (nx, nx) on ``device`` (rows y, columns x, as the upstream's grids)."""
    f64 = dict(dtype=torch.float64, device=device)
    modes = low_modes(int(initial["phi_modes"]))
    centre, amp = draws(seed, len(modes))

    x1 = (torch.arange(nx, **f64) + 0.5) / nx * L
    y, x = torch.meshgrid(x1, x1, indexing="ij")
    # the dipole at the seeded centre, by the nearest periodic image
    dx = torch.remainder(x - centre[0] * L + L / 2, L) - L / 2
    dy = torch.remainder(y - centre[1] * L + L / 2, L) - L / 2
    U = float(initial["dipole_U"])
    R = float(initial["dipole_radius_over_L"]) * L
    r = torch.sqrt(dx * dx + dy * dy)
    s = torch.where(r > 0, dy / torch.where(r > 0, r, 1.0), 0.0)
    lam = LAMB_ZERO / R
    j0 = torch.special.bessel_j0(torch.tensor(lam * R, **f64))
    Cc = -2.0 * U * lam / j0
    q = torch.where(r <= R, Cc * torch.special.bessel_j1(lam * r) * s, 0.0)

    # the perturbation: the seeded amplitudes on the lowest modes, scaled
    # to unit rms
    spec = torch.zeros((nx, nx), dtype=torch.complex128, device=device)
    idx = torch.tensor([[b % nx, a % nx] for a, b in modes], device=device)
    spec[idx[:, 0], idx[:, 1]] = torch.as_tensor(amp, device=device)
    eta = torch.fft.ifft2(spec) * (nx * nx)
    eta = eta / torch.sqrt((eta.real ** 2 + eta.imag ** 2).mean())
    phi0 = float(initial["phi_amplitude_over_U"]) * U
    eps = float(initial["phi_perturbation"])
    phi = phi0 * (1 + 1j) / math.sqrt(2) * (1 + eps * eta)
    return {"q": q, "phi": phi}
