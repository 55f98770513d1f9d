"""YBJ model: NIW phi on a prescribed, frozen QG flow (port of
``niwqg_tpu/models/ybj.py``).

Only the phi equation is stepped. ``q``, ``psi``, ``u``, ``v`` and
``q_psi`` stay at their ``set_q`` values; the inversion sets
``ph = -qh/wv2`` alone; the wave Jacobian does not zero the mean mode; no
energy budgets are integrated (Ke/Pw/Kw keep their ``set_q``/``set_phi``
values). On a mesh (``mesh=``, the pencil transform as ``transform=``) the
frozen ``u``, ``v`` and ``q_psi`` are this rank's row blocks and
``ph = -qh*wv2i`` its column block.

Reference quirk, reproduced when ``faithful_quirks=True`` (default): the
physical ``phi`` of the refraction term is refreshed only at the end of a
step, so all four stages use the step-start ``phi`` while the gradients
are recomputed per stage. With ``faithful_quirks=False`` the refraction
reads the stage's own ``phi = ifft(phih)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..etdrk4 import fold_filter_into
from ..ops import spectral
from ..ops.spectral import jmul, mul_i
from ..utils.profiling import count
from .kernel import Derived, KernelParams, WaveKernel, WavePhysics, WaveState


class YBJPhysics(WavePhysics):
    name = "YBJ Model (Steady QG flow)"
    zero_mean_jac_psi_phi = False

    def invert(self, K: WaveKernel, qh, phih, phi) -> Derived:
        g, tr = K.grid, K.tr
        phix, phiy = spectral.gradients(tr, g, phih)
        q = tr.ifft2_real(qh)
        return Derived(ph=-(qh * g.wv2i), p=torch.zeros_like(q), q=q,
                       q_psi=q, qwh=torch.zeros_like(qh), phi=phi,
                       phix=phix, phiy=phiy, u=q, v=q)


class YBJKernel(WaveKernel):
    """Wave-only ETDRK4 stepper on a frozen flow."""

    def __init__(self, params: KernelParams, faithful_quirks: bool = True,
                 dtype=np.float64, backend: str = "auto",
                 precision: str = "auto", transform=None,
                 transform_opts=None, fold_filter: bool = False,
                 device=None, mesh=None):
        super().__init__(params, YBJPhysics(), dtype=dtype, backend=backend,
                         precision=precision, transform=transform,
                         transform_opts=transform_opts, device=device,
                         mesh=mesh)
        self.faithful_quirks = bool(faithful_quirks)
        # pre-multiply the stage filter into the phi-equation tables
        self.fold_filter = bool(fold_filter)
        if self.fold_filter:
            self.coefs_w = fold_filter_into(self.coefs_w, self.grid.filtr)

    def _ybj_nonlinear(self, phih, s: WaveState):
        """``-J(psi,phi)hat - 0.5j*fft(phi*q_psi)`` with the frozen u, v
        and q_psi: one batched inverse and one batched forward call."""
        g, tr = self.grid, self.tr
        if self.faithful_quirks:
            # the refraction reads the step-start phi
            grads = tr.ifft2(torch.stack([mul_i(phih, g.k),
                                          mul_i(phih, g.l)]))
            phi, phix, phiy = s.d.phi, grads[0], grads[1]
        else:
            b = tr.ifft2(torch.stack([phih, mul_i(phih, g.k),
                                      mul_i(phih, g.l)]))
            phi, phix, phiy = b[0], b[1], b[2]
        nl = tr.fft2(torch.stack([phix * s.d.u + phiy * s.d.v,
                                  phi * s.d.q_psi]))
        # no mean-mode zeroing
        return -nl[0] - jmul(nl[1], 0.5)

    def step(self, s: WaveState) -> WaveState:
        """One ETDRK4 step of ``phih``; counted ``step.ybj`` from the
        host (eager steps and captures: a replay runs no host code)."""
        count("step.ybj")
        cw = self.coefs_w
        flt = None if self.fold_filter else self.grid.filtr
        mulf = self._mulf
        dt = self._dt

        phih0 = s.phih
        Fn0w = self._ybj_nonlinear(phih0, s)
        phih = mulf(cw.expch_h * phih0 + Fn0w * cw.Qh, flt)
        phih1 = phih

        Fnaw = self._ybj_nonlinear(phih, s)
        phih = mulf(cw.expch_h * phih0 + Fnaw * cw.Qh, flt)

        Fnbw = self._ybj_nonlinear(phih, s)
        phih = mulf(cw.expch_h * phih1 + (2.0 * Fnbw - Fn0w) * cw.Qh, flt)

        Fncw = self._ybj_nonlinear(phih, s)
        phih = mulf(cw.expch * phih0 + Fn0w * cw.f0
                    + 2.0 * (Fnaw + Fnbw) * cw.fab + Fncw * cw.fc, flt)

        phi = self.tr.ifft2(phih)
        phix, phiy = spectral.gradients(self.tr, self.grid, phih)
        D = s.d._replace(phi=phi, phix=phix, phiy=phiy)
        return s._replace(t=s.t + dt, tc=s.tc + 1, phih=phih, d=D)

    def apply_set_q(self, s: WaveState, q) -> WaveState:
        """Frozen-flow setup: ``q`` is kept as given."""
        q = self._cast_field(q)
        qh = self.tr.fft2_real(q)
        ph = -(qh * self.grid.wv2i)
        u, v = spectral.velocities(self.tr, self.grid, ph)
        D = s.d._replace(ph=ph, q=q, q_psi=q, u=u, v=v)
        return s._replace(qh=qh, d=D, Ke=self.ke_qg(ph))
