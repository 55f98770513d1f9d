"""Spectral-space operator helpers (port of ``niwqg_tpu/ops/spectral.py``).

Plain functions on complex tensors with arbitrary leading batch axes
``(..., ny, nx)``. Complex-by-real products are written out on the real
and imaginary planes, as the JAX package's re/im pairs compute them.
"""

from __future__ import annotations

import torch


def abs2(z: torch.Tensor) -> torch.Tensor:
    """|z|^2 as a real tensor."""
    return z.real * z.real + z.imag * z.imag


def mul_i(z: torch.Tensor, k) -> torch.Tensor:
    """(i*k) * z for a real tensor or scalar k (spectral derivative)."""
    return torch.complex(-k * z.imag, k * z.real)


def jmul(z: torch.Tensor, s: float = 1.0) -> torch.Tensor:
    """(i*s) * z for a scalar s."""
    return torch.complex(-s * z.imag, s * z.real)


def _refl(a: torch.Tensor) -> torch.Tensor:
    """Z(-k,-l) on the full spectral grid."""
    return torch.roll(torch.flip(a, dims=(-2, -1)), shifts=(1, 1),
                      dims=(-2, -1))


def hermitian_project(zh: torch.Tensor) -> torch.Tensor:
    """Project a full-spectrum transform onto the Hermitian subspace,
    ``(Z + Z*(-k,-l))/2`` — what the reference's ``fft(real(ifft(Z)))``
    sandwich computes, without the two transforms."""
    r = _refl(zh)
    return torch.complex(0.5 * (zh.real + r.real), 0.5 * (zh.imag - r.imag))


def hermitian_project_half(zh: torch.Tensor, nx: int) -> torch.Tensor:
    """:func:`hermitian_project` on the half-spectrum layout: only the
    self-mirror columns ``k = 0`` and ``k = nx/2`` pair rows ``l <-> -l``
    within the column, so only those two are projected."""
    out = zh.clone()
    for c in (0, nx // 2):
        col = zh[..., :, c]
        r = torch.roll(torch.flip(col, dims=(-1,)), shifts=1, dims=-1)
        out[..., :, c] = torch.complex(0.5 * (col.real + r.real),
                                       0.5 * (col.imag - r.imag))
    return out


def expand_half_to_full(zh: torch.Tensor) -> torch.Tensor:
    """Hermitian-expand a half-spectrum transform ``(..., ny, nx//2+1)`` of
    a real field to the full spectrum ``(..., ny, nx)`` via
    ``Z(l, k) = conj(Z(-l, -k))`` (a gather; even ``nx`` only)."""
    nh = zh.shape[-1] - 1
    src = zh[..., 1:nh]
    tail = torch.roll(torch.flip(src, dims=(-2, -1)), shifts=1, dims=-2)
    tail = torch.complex(tail.real, -tail.imag)
    return torch.cat([zh, tail], dim=-1)


def project_full_to_half(zh: torch.Tensor) -> torch.Tensor:
    """First ``nx//2+1`` columns of the Hermitian projection of a
    full-spectrum transform: the half spectrum whose ``irfft2`` is exactly
    ``real(ifft2(zh))``."""
    nk = zh.shape[-1] // 2 + 1
    return hermitian_project(zh)[..., :nk]


def zero_mean_mode(zh: torch.Tensor) -> torch.Tensor:
    """Zero the (0,0) spectral coefficient."""
    out = zh.clone()
    out[..., 0, 0] = 0.0
    return out


def velocities(tr, grid, ph: torch.Tensor):
    """u = ifft(-il*ph).real, v = ifft(ik*ph).real."""
    u = tr.ifft2_real(mul_i(ph, -grid.l))
    v = tr.ifft2_real(mul_i(ph, grid.k))
    return u, v


def jacobian_psi_q_hat(tr, grid, u, v, q, zero_mean: bool = True):
    """fft of J(psi, q) = ik*fft(u q) + il*fft(v q)."""
    jach = mul_i(tr.fft2_real(u * q), grid.k) + mul_i(tr.fft2_real(v * q),
                                                      grid.l)
    return zero_mean_mode(jach) if zero_mean else jach


def jacobian_psi_phi_hat(tr, u, v, phix, phiy, zero_mean: bool = True):
    """fft of u*phix + v*phiy for complex phi gradients."""
    jach = tr.fft2(phix * u + phiy * v)
    return zero_mean_mode(jach) if zero_mean else jach


def gradients(tr, grid, zh: torch.Tensor):
    """(d/dx, d/dy) of a complex field from its transform."""
    return tr.ifft2(mul_i(zh, grid.k)), tr.ifft2(mul_i(zh, grid.l))


def wave_pv_hat(tr, grid, f: float, phi, phix, phiy):
    """Wave potential vorticity ``qwh = 0.5*(0.5*gphi2h + J(phi*,phi)hat)/f``
    with ``gphi2h = -wv2*fft(|phi|^2)`` and the Jacobian term
    ``fft((1j*(conj(phix)*phiy - conj(phiy)*phix)).real)``, mean mode
    zeroed. The caller applies the filter."""
    gphi2h = tr.fft2_real(abs2(phi)) * (-grid.wv2)
    z = phix.conj() * phiy - phiy.conj() * phix
    jach = zero_mean_mode(tr.fft2_real(-z.imag))  # (1j*z).real
    return (0.5 * gphi2h + jach) * 0.5 / f


def cfl_number(u, v, phi_abs_max, dt: float, dx: float):
    """CFL from max(|u|,|v|,|phi|)."""
    m = torch.maximum(u.abs().max(), v.abs().max())
    m = torch.maximum(m, phi_abs_max)
    return m * dt / dx
