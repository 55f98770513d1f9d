"""Plain reference of the upstream's YBJ model (``niwqg`` ``YBJModel``):
Young & Ben Jelloul (1997) near-inertial waves on a prescribed, frozen QG
flow.

Written from the upstream's equations. ``set_q`` fixes the flow for good:
``ph = -qh/wv2``, the velocities ``u = -psi_y``, ``v = psi_x`` and the
relative vorticity ``q_psi = q``. Only ``phi`` is stepped:

    phi_t = -(phix u + phiy v)^ - (i/2) (phi q_psi)^ + L phi,
    L = -(i/2) f wv2/kappa2 - nu4w wv2^2 - nuw wv2 - muw - i k U,

with ETDRK4 (Cox & Matthews 2002) on the contour-mean coefficients of
``coupled.py``, the upstream's exponential filter after every stage, no
mean-mode zeroing of the advection, and ``phi`` and its gradients
refreshed at the step's end. The diagnostics are the upstream's wave
series and its energy conversions, whose domain means are taken in
physical space (``coupled.Reference.source_means``). Every spectral field
is the full complex spectrum of ``torch.fft.fft2``. Nothing here imports
the program under test.

The upstream's own step is kept where it departs from the textbook scheme:
with ``faithful_quirks`` (the upstream's step as it runs, and the
configuration's) the refraction ``phi q_psi`` of all four stages reads the
step-start ``phi`` while the gradients are those of each stage's ``phih``
(the upstream refreshes its physical ``phi`` only at the step's end);
without it every stage reads its own ``phi = ifft(phih)``. Departures from
the upstream: only the series that move on a frozen flow are computed
(the QG energy, enstrophy and their dissipation stay at their ``set_q``
values, and no budget is integrated); the streamfunction ``p``, which the
upstream's YBJ inversion never sets, is zero in the conversions' means,
where only ``ep_psi`` (not computed here) reads it.

Two precisions, as ``coupled.py``'s (:class:`coupled.Arith`): ``"f64"``,
the reference itself, and ``"bf16"``, the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import coupled
# the harness's interface: the same segment loop and physical fields
from .coupled import _abs2, physical, run_segment  # noqa: F401

# the prognostic fields, in the upstream's set_q/set_phi order; the step
# integrates no budget
FIELDS = ("q", "phi")
BUDGETS = ()


class Params(NamedTuple):
    phys: coupled.Params   # the wave model's physics
    faithful_quirks: bool  # the refraction reads the step-start phi


def params_from(model_kwargs: dict) -> Params:
    """The physics of a configuration's model keywords (the upstream
    model's defaults for those it leaves out; ``faithful_quirks`` on, as
    the port's YBJ model defaults)."""
    return Params(coupled.params_from(model_kwargs),
                  bool(model_kwargs.get("faithful_quirks", True)))


class Reference(coupled.Reference):
    """The YBJ model's step and diagnostics in one precision."""

    def __init__(self, params: Params, device, mode: str = "f64"):
        # a float32 product on the card must not run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(params.phys, device, mode)
        self.faithful = params.faithful_quirks

    # -- states ----------------------------------------------------------------
    def _state(self, q, phi) -> coupled.State:
        """The frozen flow of ``q`` (the upstream's ``set_q``) and the wave
        field ``phi`` with its gradients (``set_phi``); the budget
        integrals are not carried."""
        A, T = self.A, self.T
        q = A.r(q.to(A.rdtype))
        qh = A.fft2(q)
        ph = A.r(-(qh * T.wv2i))
        u, v = A.rifft2(A.r(-T.il * ph)), A.rifft2(A.r(T.ik * ph))
        phi = A.r(phi.to(A.cdtype))
        phih = A.fft2(phi)
        d = coupled.Fields(ph=ph, p=torch.zeros_like(q), q=q, q_psi=q,
                           qwh=torch.zeros_like(qh), phi=phi,
                           phix=A.ifft2(T.ik * phih),
                           phiy=A.ifft2(T.il * phih), u=u, v=v)
        zero = q.new_zeros(())
        return coupled.State(qh, phih, d, zero, zero, zero)

    def start(self, q, phi) -> coupled.State:
        """The state after the upstream's ``set_q(q)`` then
        ``set_phi(phi)``."""
        return self._state(q, phi)

    def resume(self, q, phi) -> coupled.State:
        """A state mid-run, from its frozen ``q`` and its ``phi``."""
        return self._state(q, phi)

    # -- one ETDRK4 step -------------------------------------------------------
    def nonlinear_phi(self, phih, d: coupled.Fields):
        """``-(phix u + phiy v)^ - (i/2) (phi q_psi)^`` of a stage's
        ``phih`` on the frozen flow; ``d.phi`` is the step-start ``phi``
        (read under ``faithful_quirks``)."""
        A, T = self.A, self.T
        phix, phiy = A.ifft2(T.ik * phih), A.ifft2(T.il * phih)
        phi = d.phi if self.faithful else A.ifft2(phih)
        jac = A.fft2(A.r(phix * d.u + phiy * d.v))
        refr = A.fft2(A.r(phi * d.q_psi))
        return A.r(-jac - 0.5j * refr)

    def step(self, s: coupled.State) -> coupled.State:
        A, T = self.A, self.T
        cw, flt = T.ew, T.filtr

        def upd(c, base, F, into):
            return A.r((c * base + F * into) * flt)

        phih0, d = s.phih, s.d
        Fn0 = self.nonlinear_phi(phih0, d)
        phih1 = upd(cw.expch_h, phih0, Fn0, cw.Qh)
        Fna = self.nonlinear_phi(phih1, d)
        phih2 = upd(cw.expch_h, phih0, Fna, cw.Qh)
        Fnb = self.nonlinear_phi(phih2, d)
        phih3 = upd(cw.expch_h, phih1, A.r(2.0 * Fnb - Fn0), cw.Qh)
        Fnc = self.nonlinear_phi(phih3, d)
        phih = A.r((cw.expch * phih0 + Fn0 * cw.f0
                    + 2.0 * (Fna + Fnb) * cw.fab + Fnc * cw.fc) * flt)
        # phi and its gradients refreshed at the step's end (upstream)
        d = d._replace(phi=A.ifft2(phih), phix=A.ifft2(T.ik * phih),
                       phiy=A.ifft2(T.il * phih))
        return s._replace(phih=phih, d=d)

    # -- diagnostics -----------------------------------------------------------
    def diagnostics(self, s: coupled.State) -> dict:
        """The upstream ``YBJModel``'s scalar diagnostics of a state after
        a step that move on a frozen flow: the wave energies, the
        correlation of wave energy and vorticity, and the energy
        conversions and wave dissipations."""
        A, T, p = self.A, self.T, self.p
        d = s.d
        src = self.sources(self.source_means(s.qh, s.phih, d))
        phix, phiy = A.ifft2(T.ik * s.phih), A.ifft2(T.il * s.phih)
        ke = 0.5 * _abs2(d.phi).mean()
        cke = 0.5 * _abs2(d.phi.mean())
        # the correlation of |phi|^2 and q_psi, the means removed first
        ups = _abs2(d.phi)
        ups = ups - ups.mean()
        dq = d.q_psi - d.q_psi.mean()
        conc = ((ups * d.q_psi).mean() / torch.sqrt((ups * ups).mean())
                / torch.sqrt((dq * dq).mean()))
        out = dict(
            ke_niw=ke, cke_niw=cke, ike_niw=ke - cke,
            pe_niw=0.25 * (_abs2(phix) + _abs2(phiy)).mean() / p.kappa2,
            conc_niw=conc,
        )
        out.update({k: src[k] for k in ("gamma_r", "gamma_a", "xi_r", "xi_a",
                                         "pi", "chi_phi", "ep_phi")})
        return {k: A.r(torch.as_tensor(v)).to(torch.float64)
                for k, v in out.items()}

