"""Coupled (Xie & Vanneste 2015) physics: wave PV feeds back on psi
(port of ``niwqg_tpu/models/coupled.py``).

The inversion includes the wave potential vorticity
``qwh = 0.5*(0.5*gphi2h + J(phi*,phi)hat)/f``; the streamfunction splits
into vortex and wave parts, and relative vorticity is ``q_psi = q - qw``.
"""

from __future__ import annotations

from ..ops import spectral
from ..ops.spectral import mul_i
from .kernel import Derived, WaveKernel, WavePhysics


class CoupledPhysics(WavePhysics):
    name = "Coupled Model"
    has_wave_pv = True
    subtracts_wave_pv = True

    def invert(self, K: WaveKernel, qh, phih, phi) -> Derived:
        g, tr, p = K.grid, K.tr, K.params
        phix, phiy = spectral.gradients(tr, g, phih)
        qwh = spectral.wave_pv_hat(tr, g, p.f, phi, phix, phiy) * g.filtr

        pw = tr.ifft2_real(qwh * g.wv2i)
        pv = tr.ifft2_real(-(qh * g.wv2i))
        psi = pv + pw
        ph = tr.fft2_real(psi)

        q = tr.ifft2_real(qh)
        qw = tr.ifft2_real(qwh)
        return Derived(ph=ph, p=psi, q=q, q_psi=q - qw, qwh=qwh, phi=phi,
                       phix=phix, phiy=phiy, u=q, v=q)  # caller fills u, v

    # -- CoupledModel-only diagnostics ------------------------------------
    def ke_qg_decomp(self, K: WaveKernel, qh, qwh):
        # q-side spectra go through K.qtab/K._inv_real so the fast
        # kernel's half-spectrum layout works unchanged
        g = K.qtab
        phq = -(qh * g.wv2i)
        ke_qg_q = 0.5 * K.spec_var(phq * g.wv)
        phw = qwh * g.wv2i
        ke_qg_w = 0.5 * K.spec_var(phw * g.wv)
        uq = K._inv_real(mul_i(phq, -K._l_dy))
        vq = K._inv_real(mul_i(phq, g.k))
        uw = K._inv_real(mul_i(phw, -K._l_dy))
        vw = K._inv_real(mul_i(phw, g.k))
        ke_qg_qw = (uq * uw).mean() + (vq * vw).mean()
        return ke_qg_q, ke_qg_w, ke_qg_qw
