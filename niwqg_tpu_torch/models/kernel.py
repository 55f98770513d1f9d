"""Shared NIW–QG wave kernel (port of ``niwqg_tpu/models/kernel.py``).

ETDRK4 co-evolution of ``(qh, phih)``: a :class:`WaveKernel` holding every
precomputed table, an immutable :class:`WaveState` of tensors, and
``step(state) -> state``. The four stage updates and their filter passes,
the stage-interleaved RK4 energy budgets (Ke/Pw/Kw) and the
initial-condition ordering (``set_q`` inverts with the phi it currently
holds) follow the JAX kernel operation for operation.

Spectral fields and the complex wave fields are complex tensors; physical
real fields are real tensors; ``t``, ``Ke``, ``Pw`` and ``Kw`` are 0-d
tensors of the model dtype and ``tc`` is a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import complex_dtype, real_dtype, resolve_device
from ..etdrk4 import build_coefs, linear_operator_phi, linear_operator_q
from ..grid import Grid
from ..ops import spectral
from ..ops.fft import make_transform
from ..ops.spectral import abs2, jmul


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Physical and numerical parameters (reference defaults)."""

    nx: int = 128
    L: float = 5e5
    dt: float = 10000.0
    tmax: float = 250000.0
    twrite: int = 1000
    cflmax: float = 0.8
    U: float = 0.0
    f: float = 1.0e-4
    N: float = 0.01
    m: float = 0.025
    g: float = 9.81
    nu4: float = 0.0
    nu4w: float = 0.0
    nu: float = 20.0
    nuw: float = 50.0
    mu: float = 0.0
    muw: float = 0.0
    use_filter: bool = True
    dealias: bool = False
    tdiags: int = 10
    tsave_snapshots: int = 10
    # stage-interleaved RK4 energy-budget integration; off freezes the
    # accumulators and skips the per-stage sources
    compute_budgets: bool = True
    # the fast kernel evaluates the budget sources by Parseval (zero extra
    # transforms); the faithful kernel ignores this flag
    spectral_budgets: bool = True

    @property
    def kappa(self) -> float:
        return self.m * self.f / self.N

    @property
    def kappa2(self) -> float:
        return self.kappa**2

    @property
    def hslash(self) -> float:
        return self.f / self.kappa2


class Derived(NamedTuple):
    """Derived fields recomputed after every stage update."""

    ph: torch.Tensor
    p: Optional[torch.Tensor]
    q: torch.Tensor
    q_psi: torch.Tensor
    qwh: torch.Tensor
    phi: torch.Tensor
    phix: torch.Tensor
    phiy: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class WaveState(NamedTuple):
    """Full model state (prognostic + carried derived + budgets + clock)."""

    t: torch.Tensor
    tc: int
    qh: torch.Tensor
    phih: torch.Tensor
    d: Derived
    Ke: torch.Tensor
    Pw: torch.Tensor
    Kw: torch.Tensor


class StageSources(NamedTuple):
    k: torch.Tensor   # dKe/dt source
    p: torch.Tensor   # dPw/dt source
    a: torch.Tensor   # dKw/dt source
    gamma1: torch.Tensor
    gamma2: torch.Tensor
    xi1: torch.Tensor
    xi2: torch.Tensor
    pi: torch.Tensor
    ep_psi: torch.Tensor
    chi_phi: torch.Tensor
    ep_phi: torch.Tensor


class WavePhysics:
    """Model-variant strategy: inversion + wave advection term.

    Capability flags read by the batched fast kernel:
      has_wave_pv       — the inversion carries a wave PV qwh
      subtracts_wave_pv — relative vorticity is q - qw
      hermitian_ph      — the inversion Hermitian-projects ph (the
                          reference's ``fft(real(ifft(.)))`` sandwich)
    """

    name = "wave"
    zero_mean_jac_psi_phi = True
    has_wave_pv = False
    subtracts_wave_pv = False
    hermitian_ph = True

    def invert(self, K: "WaveKernel", qh, phih, phi) -> Derived:
        raise NotImplementedError

    def jac_psi_phi(self, K: "WaveKernel", D: Derived, qh):
        """J(psi, phi) advection by the full geostrophic flow."""
        return spectral.jacobian_psi_phi_hat(
            K.tr, D.u, D.v, D.phix, D.phiy, zero_mean=self.zero_mean_jac_psi_phi
        )


class WaveKernel:
    """Static configuration + step/diagnostic functions."""

    def __init__(self, params: KernelParams, physics: WavePhysics,
                 dtype=np.float64, backend: str = "auto",
                 precision: str = "auto", transform=None,
                 transform_opts=None, device=None):
        self.params = params
        self.physics = physics
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self.rdtype = real_dtype(self.dtype)
        self.cdtype = complex_dtype(self.dtype)
        self.grid = Grid(nx=params.nx, L=params.L, dtype=self.dtype,
                         spectrum="full", use_filter=params.use_filter,
                         dealias=params.dealias, device=self.device)
        if transform is not None:
            self.tr = transform
        else:
            self.tr = make_transform(params.nx, self.dtype, backend,
                                     precision=precision, device=self.device,
                                     **(transform_opts or {}))
        p = params
        self.coefs_q = build_coefs(
            self.grid, linear_operator_q(self.grid, p.U, p.nu4, p.nu, p.mu),
            p.dt)
        self.coefs_w = build_coefs(
            self.grid,
            linear_operator_phi(self.grid, p.U, p.f, p.kappa2, p.nu4w, p.nuw,
                                p.muw),
            p.dt)
        # q-side layout indirection: identities here; the fast kernel's
        # q_half mode rebinds them to the rfft half spectrum
        self.qtab = self.grid
        self._flt_q = self.grid.filtr
        self._flt_w = self.grid.filtr
        self._fwd_real = self.tr.fft2_real
        self._inv_real = self.tr.ifft2_real
        self._qdeg = None
        # l table for q-side y-derivatives (the fast kernel zeroes its
        # Nyquist row's interior columns in half mode)
        self._l_dy = self.grid.l

    # ------------------------------------------------------------------
    def _s(self, x) -> torch.Tensor:
        return torch.tensor(x, dtype=self.rdtype, device=self.device)

    @property
    def _drop_p(self) -> bool:
        """Whether the carried state omits the physical streamfunction."""
        return False

    # ------------------------------------------------------------------
    # derived state (invert + relative vorticity + velocities)
    # ------------------------------------------------------------------
    def derive(self, qh, phih, prev: Optional[Derived] = None) -> Derived:
        phi = self.tr.ifft2(phih)
        D = self.physics.invert(self, qh, phih, phi)
        u, v = spectral.velocities(self.tr, self.grid, D.ph)
        return D._replace(u=u, v=v)

    # ------------------------------------------------------------------
    # per-stage computation: budget sources + nonlinear terms
    # ------------------------------------------------------------------
    def stage_sources(self, qh, phih, D: Derived) -> StageSources:
        """Energy conversion and dissipation sources, evaluated on the
        carried state in physical space."""
        g, tr = self.grid, self.tr
        lapphi = tr.ifft2(phih * (-g.wv2))
        lap2phi = tr.ifft2(phih * g.wv4)
        lap2psi = tr.ifft2_real(D.ph * g.wv4)
        lapq = tr.ifft2_real(qh * (-g.wv2))
        lphix = tr.ifft2(spectral.mul_i(phih, -g.k * g.wv2))
        lphiy = tr.ifft2(spectral.mul_i(phih, -g.l * g.wv2))
        return self.sources_from_fields(D, lapphi, lap2phi, lphix, lphiy,
                                        lap2psi, lapq)

    def sources_from_fields(self, D: Derived, lapphi, lap2phi, lphix, lphiy,
                            lap2psi, lapq) -> StageSources:
        """Budget-source formulas on precomputed derived fields."""
        p = self.params
        phi, phix, phiy, q_psi = D.phi, D.phix, D.phiy, D.q_psi

        J_psi_phi = phix * D.u + phiy * D.v
        diss_phi = -p.nu4w * lap2phi + p.nuw * lapphi - p.muw * phi
        J_diss_phi = -(diss_phi * J_psi_phi.conj()).imag
        L_diss_phi = 0.5 * (diss_phi * phi.conj()).real * q_psi
        divFw = 0.5 * p.hslash * (phi.conj() * lapphi).imag

        gamma1 = (0.5 * q_psi * divFw).mean() / p.f
        gamma2 = 0.5 * p.hslash * ((lapphi.conj() * J_psi_phi).real).mean() / p.f
        xi1 = J_diss_phi.mean() / p.f
        xi2 = L_diss_phi.mean() / p.f
        pi = (0.5 * phi.mean() * (phi.conj() * q_psi).mean()).imag

        ep_psi = (
            p.nu4 * (D.q * lap2psi).mean()
            - p.nu * (D.p * lapq).mean()
            + p.mu * (D.p * D.q).mean()
        )
        k2 = p.kappa2
        chi_phi = (
            -0.5 * p.nu4w * (abs2(lphix) + abs2(lphiy)).mean() / k2
            - 0.5 * p.nuw * abs2(lapphi).mean() / k2
            - 0.5 * p.muw * (abs2(phix) + abs2(phiy)).mean() / k2
        )
        ep_phi = (
            -p.nu4w * abs2(lapphi).mean()
            - p.nuw * (abs2(phix) + abs2(phiy)).mean()
            - p.muw * abs2(phi).mean()
        )

        k_src = -(gamma1 + gamma2) + (xi1 + xi2) + ep_psi
        p_src = gamma1 + gamma2 + chi_phi
        a_src = ep_phi
        return StageSources(k_src, p_src, a_src, gamma1, gamma2, xi1, xi2, pi,
                            ep_psi, chi_phi, ep_phi)

    def nonlinear(self, qh, D: Derived):
        """RHS nonlinear terms Fn (q equation) and Fnw (phi equation)."""
        jacq = spectral.jacobian_psi_q_hat(self.tr, self.grid, D.u, D.v, D.q)
        jacw = self.physics.jac_psi_phi(self, D, qh)
        refr = jmul(self.tr.fft2(D.phi * D.q_psi), 0.5)  # 0.5j*fft(phi*q_psi)
        return -jacq, -jacw - refr

    def zero_sources(self) -> StageSources:
        z = self._s(0.0)
        return StageSources(*([z] * len(StageSources._fields)))

    def stage_terms(self, qh, phih, D: Derived, want_sources: bool):
        """One stage's RHS nonlinear terms plus (optionally) its budget
        sources; the fast kernel overrides this to share transforms."""
        src = (self.stage_sources(qh, phih, D) if want_sources
               else self.zero_sources())
        Fn, Fnw = self.nonlinear(qh, D)
        return Fn, Fnw, src

    # ------------------------------------------------------------------
    # one ETDRK4 step
    # ------------------------------------------------------------------
    @staticmethod
    def _mulf(x, f):
        """Stage filter multiply; ``f=None`` means the filter is folded
        into the ETDRK4 tables."""
        return x if f is None else x * f

    def step(self, s: WaveState) -> WaveState:
        cq, cw = self.coefs_q, self.coefs_w
        fq, fw = self._flt_q, self._flt_w
        mulf = self._mulf
        dt = self._s(self.params.dt)
        want = self.params.compute_budgets

        # stage 1 (sources from the carried state)
        Fn0, Fn0w, src1 = self.stage_terms(s.qh, s.phih, s.d, want)
        qh0, phih0 = s.qh, s.phih
        qh = mulf(cq.expch_h * qh0 + Fn0 * cq.Qh, fq)
        phih = mulf(cw.expch_h * phih0 + Fn0w * cw.Qh, fw)
        qh1, phih1 = qh, phih
        D = self.derive(qh, phih, s.d)

        # stage 2
        Fna, Fnaw, src2 = self.stage_terms(qh, phih, D, want)
        qh = mulf(cq.expch_h * qh0 + Fna * cq.Qh, fq)
        phih = mulf(cw.expch_h * phih0 + Fnaw * cw.Qh, fw)
        D = self.derive(qh, phih, D)

        # stage 3
        Fnb, Fnbw, src3 = self.stage_terms(qh, phih, D, want)
        qh = mulf(cq.expch_h * qh1 + (2.0 * Fnb - Fn0) * cq.Qh, fq)
        phih = mulf(cw.expch_h * phih1 + (2.0 * Fnbw - Fn0w) * cw.Qh, fw)
        D = self.derive(qh, phih, D)

        # stage 4 + final combination
        Fnc, Fncw, src4 = self.stage_terms(qh, phih, D, want)
        qh = mulf(cq.expch * qh0 + Fn0 * cq.f0 + 2.0 * (Fna + Fnb) * cq.fab
                  + Fnc * cq.fc, fq)
        phih = mulf(cw.expch * phih0 + Fn0w * cw.f0
                    + 2.0 * (Fnaw + Fnbw) * cw.fab + Fncw * cw.fc, fw)

        if want:
            Ke = s.Ke + dt * (src1.k + 2.0 * (src2.k + src3.k) + src4.k) / 6.0
            Pw = s.Pw + dt * (src1.p + 2.0 * (src2.p + src3.p) + src4.p) / 6.0
            Kw = s.Kw + dt * (src1.a + 2.0 * (src2.a + src3.a) + src4.a) / 6.0
        else:
            Ke, Pw, Kw = s.Ke, s.Pw, s.Kw

        D = self.derive(qh, phih, D)
        return WaveState(t=s.t + dt, tc=s.tc + 1, qh=qh, phih=phih, d=D,
                         Ke=Ke, Pw=Pw, Kw=Kw)

    # ------------------------------------------------------------------
    # initialization (the reference's set_q/set_phi ordering)
    # ------------------------------------------------------------------
    def zero_state(self) -> WaveState:
        shape = (self.grid.nl, self.grid.nk)
        z = torch.zeros(shape, dtype=self.cdtype, device=self.device)
        r = torch.zeros(shape, dtype=self.rdtype, device=self.device)
        D = Derived(ph=z, p=None if self._drop_p else r, q=r, q_psi=r,
                    qwh=z, phi=z, phix=z, phiy=z, u=r, v=r)
        zero = self._s(0.0)
        return WaveState(t=zero, tc=0, qh=z, phih=z, d=D, Ke=zero, Pw=zero,
                         Kw=zero)

    def _cast_field(self, q) -> torch.Tensor:
        return torch.as_tensor(np.asarray(q, dtype=self.dtype),
                               device=self.device)

    def apply_set_q(self, s: WaveState, q) -> WaveState:
        """``set_q``: transform, invert with the *current* phi (zero right
        after construction — the reference quirk), compute Ke."""
        qh = self.tr.fft2_real(self._cast_field(q))
        D = self.physics.invert(self, qh, s.phih, s.d.phi)
        u, v = spectral.velocities(self.tr, self.grid, D.ph)
        # keep the carried phi and its gradients (set_phi provides them)
        D = D._replace(u=u, v=v, phix=s.d.phix, phiy=s.d.phiy, phi=s.d.phi)
        if self._drop_p:
            D = D._replace(p=None)
        return s._replace(qh=qh, d=D, Ke=self.ke_qg(D.ph))

    def apply_set_phi(self, s: WaveState, phi) -> WaveState:
        """``set_phi``: transform, compute Pw (which refreshes phix/phiy, as
        the reference stores them) and Kw."""
        phi_c = torch.as_tensor(np.asarray(phi, dtype=np.complex128)).to(
            device=self.device, dtype=self.cdtype)
        phih = self.tr.fft2(phi_c)
        phix, phiy = spectral.gradients(self.tr, self.grid, phih)
        Pw = 0.25 * (abs2(phix) + abs2(phiy)).mean() / self.params.kappa2
        Kw = 0.5 * abs2(phi_c).mean()
        D = s.d._replace(phi=phi_c, phix=phix, phiy=phiy)
        return s._replace(phih=phih, d=D, Pw=Pw, Kw=Kw)

    # ------------------------------------------------------------------
    # energy / diagnostic scalars
    # ------------------------------------------------------------------
    def spec_var(self, zh):
        """Variance of a q-side spectrum (the fast kernel's ``q_half`` mode
        sums with Hermitian-degeneracy weights)."""
        if self._qdeg is None:
            return self.grid.spec_var(zh)
        dens = abs2(zh) * self._qdeg
        dens[0, 0] = 0.0
        return dens.sum() / self._s(float(self.grid.M) ** 2)

    def ke_qg(self, ph):
        return 0.5 * self.spec_var(ph * self.qtab.wv)

    def ke_niw(self, phi):
        return 0.5 * abs2(phi).mean()

    def pe_niw(self, phih):
        phix, phiy = spectral.gradients(self.tr, self.grid, phih)
        return 0.25 * (abs2(phix) + abs2(phiy)).mean() / self.params.kappa2

    def cke_niw(self, phi):
        return 0.5 * abs2(phi.mean())

    def ens(self, q):
        return 0.5 * (q * q).mean()

    def conc_niw(self, phi, q_psi):
        ups = abs2(phi)
        ups = ups - ups.mean()
        return ((ups * q_psi).mean() / torch.std(ups, correction=0)
                / torch.std(q_psi, correction=0))

    def skewness(self, q_psi):
        return (q_psi**3).mean() / ((q_psi**2).mean()) ** 1.5

    def chi_q(self, qh):
        return -self.params.nu4 * self.spec_var(qh * self.qtab.wv2)

    def cfl(self, s: WaveState):
        phimax = torch.sqrt(abs2(s.d.phi).max())
        return spectral.cfl_number(s.d.u, s.d.v, phimax, self.params.dt,
                                   self.grid.dx)
