"""Uncoupled physics: YBJ waves on an evolving QG flow (port of
``niwqg_tpu/models/uncoupled.py``).

Plain inversion ``p = ifft(-qh/wv2)``; the waves are refracted and advected
by the flow but exert no feedback (``q_psi = q``).

Reference quirk: the reference refreshes the wave gradients ``phix/phiy``
only when a diagnostic happens to run (every ``tdiags``/``twrite`` steps),
so its advection term uses stale gradients. ``faithful_quirks=True`` (the
model shell's default) carries the gradients through all four stages and
refreshes them on that cadence; ``faithful_quirks=False`` recomputes them
from the current ``phih`` every stage.
"""

from __future__ import annotations

import torch

from ..ops import spectral
from .kernel import Derived, WaveKernel, WavePhysics


class UnCoupledPhysics(WavePhysics):
    name = "Uncoupled Model"

    def __init__(self, faithful_quirks: bool = False):
        self.stale_phi_gradients = bool(faithful_quirks)

    def invert(self, K: WaveKernel, qh, phih, phi) -> Derived:
        g, tr = K.grid, K.tr
        phix, phiy = spectral.gradients(tr, g, phih)
        psi = tr.ifft2_real(-(qh * g.wv2i))
        ph = tr.fft2_real(psi)
        q = tr.ifft2_real(qh)
        return Derived(ph=ph, p=psi, q=q, q_psi=q, qwh=torch.zeros_like(qh),
                       phi=phi, phix=phix, phiy=phiy, u=q, v=q)  # caller fills u, v
