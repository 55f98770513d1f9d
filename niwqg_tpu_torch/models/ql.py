"""Quasilinear coupled physics (port of ``niwqg_tpu/models/ql.py``).

The reference ``QLModel`` cannot run as shipped. The default here is the
intended quasilinear physics:

  - inversion with wave PV, ``ph = -(qh - qwh)/wv2``, with the Coupled
    wave-PV definition and ``ph`` left unprojected;
  - quasilinear advection: phi is advected by the vortex part of the flow
    alone (``ph_q = -qh/wv2``), with no mean-mode zeroing;
  - relative vorticity ``q_psi = q`` every stage.

``faithful_quirks=True`` reproduces the repaired reference bug for bug:
the wave-PV Jacobian term enters as ``1j*jach``; ``q_psi`` stays the
vorticity ``set_q`` gave for the whole run (refraction, sources and the
``ens``/``skew``/``conc_niw`` diagnostics read it, the advection Jacobian
the evolving ``q``); and each stage's wave advection reads the ``qh`` that
stage has just updated (``WavePhysics.jac_reads_updated_qh``).
"""

from __future__ import annotations

from ..ops import spectral
from .kernel import Derived, WaveKernel, WavePhysics


class QLPhysics(WavePhysics):
    name = "Quasilinear Model"
    zero_mean_jac_psi_phi = False
    has_wave_pv = True
    subtracts_wave_pv = False
    hermitian_ph = False          # the reference QL keeps ph unprojected
    advect_by_vortex_flow = True

    def __init__(self, faithful_quirks: bool = False):
        self.wave_pv_imag_jac = bool(faithful_quirks)
        self.stale_q_psi = bool(faithful_quirks)
        self.jac_reads_updated_qh = bool(faithful_quirks)

    def invert(self, K: WaveKernel, qh, phih, phi) -> Derived:
        g, tr, p = K.grid, K.tr, K.params
        phix, phiy = spectral.gradients(tr, g, phih)
        qwh = spectral.wave_pv_hat(tr, g, p.f, phi, phix, phiy,
                                   imag_jac=self.wave_pv_imag_jac) * g.filtr
        ph = -((qh - qwh) * g.wv2i)
        psi = tr.ifft2_real(ph)
        q = tr.ifft2_real(qh)
        return Derived(ph=ph, p=psi, q=q, q_psi=q, qwh=qwh, phi=phi,
                       phix=phix, phiy=phiy, u=q, v=q)  # caller fills u, v

    def jac_psi_phi(self, K: WaveKernel, D: Derived, qh):
        """Advection by the vortex streamfunction alone."""
        g, tr = K.grid, K.tr
        uq, vq = spectral.velocities(tr, g, -(qh * g.wv2i))
        return spectral.jacobian_psi_phi_hat(tr, g, uq, vq, D.phix, D.phiy,
                                             zero_mean=False)
