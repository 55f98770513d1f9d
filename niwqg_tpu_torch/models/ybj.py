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

On one card's CUDA tensors each gap between a stage's transforms is one
hand-written kernel (``ops/ybj_fused.py``, :meth:`YBJKernel._step_fused`);
host tensors and a mesh's blocks take the plain chain of
:meth:`YBJKernel.step`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..etdrk4 import fold_filter_into
from ..ops import spectral, ybj_fused
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
        # what the fused stage gaps read; the card's launch counters are
        # made here, outside any capture
        self._ybj_plan = self._fused_plan()

    def _fused_plan(self) -> ybj_fused.Plan:
        """The grid and tables as the fused stage gaps read them
        (``ops/ybj_fused.py``)."""
        g = self.grid
        if self.device.type == "cuda":
            ybj_fused.FAMILY.counters(self.device)
        return ybj_fused.Plan(
            k=g.k[0].contiguous(), l=g.l[:, 0].contiguous(),
            filtr=None if self.fold_filter else g.filtr.contiguous(),
            cw=type(self.coefs_w)(*[t.contiguous() for t in self.coefs_w]),
            faithful=self.faithful_quirks)

    def _ybj_nonlinear(self, phih, s: WaveState):
        """``-J(psi,phi)hat - 0.5j*fft(phi*q_psi)`` with the frozen u, v
        and q_psi: one batched inverse and one batched forward call (on
        host tensors counted as a stage the fused kernels' plain version
        served)."""
        g, tr = self.grid, self.tr
        if phih.device.type == "cpu":
            ybj_fused.FAMILY.plain_call("stage")
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

    def step(self, s: WaveState, plain=None) -> WaveState:
        """One ETDRK4 step of ``phih``; counted ``step.ybj`` from the
        host (eager steps and captures: a replay runs no host code). On one
        card's CUDA tensors each gap between the stages' transforms is one
        kernel of ``ops/ybj_fused.py`` (:meth:`_step_fused`); on host
        tensors and a mesh the plain chain below (``plain``, by default,
        is whether ``ybj_fused.engages`` does not; ``plain=True`` on the
        card is the oracle the kernels are held to)."""
        count("step.ybj")
        if plain is None:
            plain = not ybj_fused.engages(s.phih.device, self.mesh)
        if not plain:
            return self._step_fused(s)
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

    def _step_fused(self, s: WaveState) -> WaveState:
        """:meth:`step` on the card: stage 1's batch packed from the state,
        then a stage is its batched inverse, ``ybj_fused.products``, its
        batched forward and ``ybj_fused.stage`` (the right-hand side, the
        update and the next inverse's batch); stage 4's batch ``[phih, ik
        phih, il phih]`` goes through one inverse for the step's ``phi``,
        ``phix`` and ``phiy``, and the state's ``phih`` is a view of it. Bit
        for bit the plain chain's fields."""
        count("step.ybj_fused")
        P, d, tr = self._ybj_plan, s.d, self.tr
        batch = ybj_fused.pack(P, s.phih)
        fns, phih1 = [], None
        for n in (1, 2, 3, 4):
            gb = tr.ifft2(batch)
            # faithful: [phix, phiy], the refraction reading the step-start
            # phi; else [phi, phix, phiy]
            phi = d.phi if P.faithful else gb[0]
            nl = tr.fft2(ybj_fused.products(P, gb[-2], gb[-1], phi, d.u,
                                            d.v, d.q_psi))
            batch, fn, phih = ybj_fused.stage(
                P, n, nl, phih1 if n == 3 else s.phih,
                fns=((fns[0], fns[1]) if n == 3 else (fns[0], fns[2])
                     if n == 4 else (None, None)))
            fns.append(fn)
            if n == 1:  # stage 3's start
                phih1 = phih
        fb = tr.ifft2(batch)
        D = d._replace(phi=fb[0], phix=fb[1], phiy=fb[2])
        return s._replace(t=s.t + self._dt, tc=s.tc + 1, phih=batch[0], d=D)

    def apply_set_q(self, s: WaveState, q) -> WaveState:
        """Frozen-flow setup: ``q`` is kept as given."""
        q = self._cast_field(q)
        qh = self.tr.fft2_real(q)
        ph = -(qh * self.grid.wv2i)
        # row-major, as the fused products read them every stage (the
        # real part of an inverse is a strided view)
        u, v = (x.contiguous() for x in spectral.velocities(self.tr,
                                                             self.grid, ph))
        D = s.d._replace(ph=ph, q=q, q_psi=q, u=u, v=v)
        return s._replace(qh=qh, d=D, Ke=self.ke_qg(ph))
