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

On a mesh (``mesh=``, a ``parallel.mesh.Mesh``) every field is this
rank's block: physical fields its rows, spectral fields its columns. The
transform provider does the transposes; every domain mean and sum goes
through :meth:`WaveKernel._gsum`, one ``all_reduce`` of a vector of local
partial sums. A stage's budget sources travel as such a vector
(:meth:`WaveKernel.stage_terms`) and a step reduces their RK4 combination
once, at its end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import complex_dtype, real_dtype, resolve_device
from ..etdrk4 import (build_coefs, coefs_cut, linear_operator_phi,
                      linear_operator_q)
from ..grid import Grid
from ..ops import spectral
from ..ops.derive_fused import QLayout, q_layout
from ..ops.fft import make_transform
from ..ops.spectral import abs2, jmul
from ..parallel.mesh import all_sum
from ..utils.profiling import count


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
                          reference's ``fft(real(ifft(.)))`` sandwich); QL
                          keeps ph raw
      advect_by_vortex_flow — waves advected by the vortex-part velocities
                          only (quasilinear)

    Reference quirks, reproduced bug for bug where a model asks for them:
      stale_phi_gradients — UnCoupled: the wave gradients are refreshed
                          only on the diagnostics and status cadence
                          (:meth:`WaveKernel.refresh_phi_gradients`), never
                          per stage
      wave_pv_imag_jac  — QL: the wave-PV Jacobian term enters as
                          ``1j*jach``
      stale_q_psi       — QL: ``q_psi`` stays the vorticity ``set_q`` gave
                          (the advection Jacobian still reads the evolving
                          ``q``)
      jac_reads_updated_qh — QL: the wave advection of a stage reads the
                          ``qh`` that stage has just updated, not its input
    """

    name = "wave"
    zero_mean_jac_psi_phi = True
    has_wave_pv = False
    subtracts_wave_pv = False
    hermitian_ph = True
    advect_by_vortex_flow = False
    stale_phi_gradients = False
    wave_pv_imag_jac = False
    stale_q_psi = False
    jac_reads_updated_qh = False

    def invert(self, K: "WaveKernel", qh, phih, phi) -> Derived:
        raise NotImplementedError

    def jac_psi_phi(self, K: "WaveKernel", D: Derived, qh):
        """J(psi, phi) advection by the full geostrophic flow."""
        return spectral.jacobian_psi_phi_hat(
            K.tr, K.grid, D.u, D.v, D.phix, D.phiy,
            zero_mean=self.zero_mean_jac_psi_phi)


class WaveKernel:
    """Static configuration + step/diagnostic functions."""

    def __init__(self, params: KernelParams, physics: WavePhysics,
                 dtype=np.float64, backend: str = "auto",
                 precision: str = "auto", transform=None,
                 transform_opts=None, device=None, mesh=None):
        self.params = params
        self.physics = physics
        self.dtype = np.dtype(dtype)
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.rdtype = real_dtype(self.dtype)
        self.cdtype = complex_dtype(self.dtype)
        self.grid = Grid(nx=params.nx, L=params.L, dtype=self.dtype,
                         spectrum="full", use_filter=params.use_filter,
                         dealias=params.dealias, device=self.device,
                         mesh=mesh)
        if transform is not None:
            self.tr = transform
        elif mesh is not None:
            raise ValueError("a mesh kernel takes its distributed transform "
                             "provider as transform=")
        else:
            self.tr = make_transform(params.nx, self.dtype, backend,
                                     precision=precision, device=self.device,
                                     **(transform_opts or {}))
        p = params
        self.layout = self._q_layout()
        self.coefs_q = coefs_cut(
            linear_operator_q(self.grid, p.U, p.nu4, p.nu, p.mu), p.dt,
            self.grid, self.layout.cut)
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
        # l table for q-side y-derivatives (the fast kernel's half and
        # pair_inverse layouts zero part of its Nyquist row)
        self._l_dy = self.layout.l_dy()
        # scalar constants on the device, made once: a tensor made from a
        # Python number inside a step is a blocking copy from the host, and
        # one that a CUDA graph capture refuses
        self._dt = self._s(params.dt)
        self._M2 = self._s(float(self.grid.M) ** 2)
        self._zero = torch.zeros((), dtype=self.rdtype, device=self.device)

    # ------------------------------------------------------------------
    def _q_layout(self) -> QLayout:
        """The q side's layout: the full spectrum (the fast kernel's
        ``q_half`` cuts it to the half spectrum)."""
        return q_layout(self.grid, self.physics.hermitian_ph)

    def _s(self, x) -> torch.Tensor:
        """A 0-d tensor of a Python number (a copy from the host: for
        construction only, never inside a step or a diagnostic)."""
        return torch.tensor(x, dtype=self.rdtype, device=self.device)

    @property
    def _drop_p(self) -> bool:
        """Whether the carried state omits the physical streamfunction."""
        return False

    # ------------------------------------------------------------------
    # domain sums and means: local partial sums, one all_reduce
    # ------------------------------------------------------------------
    def _gsum(self, parts) -> torch.Tensor:
        """Global sums of a vector (or list of 0-d tensors) of local
        partial sums."""
        if not torch.is_tensor(parts):
            parts = torch.stack(list(parts))
        return all_sum(parts, self.mesh)

    def _lmean(self, x) -> torch.Tensor:
        """This rank's share of the domain mean of a physical field."""
        return x.sum() / float(self.grid.M)

    def _lmeans(self, *fields) -> torch.Tensor:
        """Local shares of several domain means, real parts then (for
        complex fields) imaginary parts in place: one entry per real
        number."""
        parts = []
        for x in fields:
            if x.is_complex():
                parts += [self._lmean(x.real), self._lmean(x.imag)]
            else:
                parts.append(self._lmean(x))
        return torch.stack(parts)

    def _gmeans(self, *fields) -> torch.Tensor:
        """Domain means of several physical fields in one all_reduce."""
        return self._gsum(self._lmeans(*fields))

    # ------------------------------------------------------------------
    # derived state (invert + relative vorticity + velocities)
    # ------------------------------------------------------------------
    def derive(self, qh, phih, prev: Optional[Derived] = None) -> Derived:
        phi = self.tr.ifft2(phih)
        D = self.physics.invert(self, qh, phih, phi)
        if self.physics.stale_phi_gradients and prev is not None:
            # keep the carried gradients: refreshes come only from
            # refresh_phi_gradients on the reference's cadence
            D = D._replace(phix=prev.phix, phiy=prev.phiy)
        if self.physics.stale_q_psi and prev is not None:
            D = D._replace(q_psi=prev.q_psi)  # frozen at the set_q value
        u, v = spectral.velocities(self.tr, self.grid, D.ph)
        return D._replace(u=u, v=v)

    def refresh_phi_gradients(self, s: WaveState) -> WaveState:
        """The state change hidden in the reference's ``_calc_pe_niw``:
        the wave gradients recomputed from the current ``phih``."""
        phix, phiy = spectral.gradients(self.tr, self.grid, s.phih)
        return s._replace(d=s.d._replace(phix=phix, phiy=phiy))

    # ------------------------------------------------------------------
    # per-stage computation: budget sources + nonlinear terms
    # ------------------------------------------------------------------
    def stage_sources(self, qh, phih, D: Derived) -> StageSources:
        """Energy conversion and dissipation sources of the carried state
        (global values on every rank)."""
        return self.sources_from_parts(
            self._gsum(self.stage_source_parts(qh, phih, D)))

    def stage_source_parts(self, qh, phih, D: Derived) -> torch.Tensor:
        """This rank's partial sums of :meth:`stage_sources`, evaluated in
        physical space (six more transforms); counted
        ``diag.field_sources`` from the host: a YBJ diagnostics sample, and
        on the host's faithful kernel also each stage's sources (the fast
        kernel has its own)."""
        count("diag.field_sources")
        g, tr = self.grid, self.tr
        lapphi = tr.ifft2(phih * (-g.wv2))
        lap2phi = tr.ifft2(phih * g.wv4)
        lap2psi = tr.ifft2_real(D.ph * g.wv4)
        lapq = tr.ifft2_real(qh * (-g.wv2))
        lphix = tr.ifft2(spectral.mul_i(phih, -g.k * g.wv2))
        lphiy = tr.ifft2(spectral.mul_i(phih, -g.l * g.wv2))
        return self.field_source_parts(D, lapphi, lap2phi, lphix, lphiy,
                                       lap2psi, lapq)

    def field_source_parts(self, D: Derived, lapphi, lap2phi, lphix, lphiy,
                           lap2psi, lapq) -> torch.Tensor:
        """Local shares of the 15 domain means the physical-space budget
        sources are made of (:meth:`sources_from_parts` names them)."""
        p = self.params
        phi, phix, phiy, q_psi = D.phi, D.phix, D.phiy, D.q_psi

        J_psi_phi = phix * D.u + phiy * D.v
        diss_phi = -p.nu4w * lap2phi + p.nuw * lapphi - p.muw * phi
        J_diss_phi = -(diss_phi * J_psi_phi.conj()).imag
        L_diss_phi = 0.5 * (diss_phi * phi.conj()).real * q_psi
        divFw = 0.5 * p.hslash * (phi.conj() * lapphi).imag
        # ep_psi reads the reference's ``self.q``, which QL never
        # refreshes (stale_q_psi): there the frozen field is q_psi
        q_eps = q_psi if self.physics.stale_q_psi else D.q
        return self._lmeans(
            0.5 * q_psi * divFw, (lapphi.conj() * J_psi_phi).real,
            J_diss_phi, L_diss_phi, phi, phi.conj() * q_psi,
            q_eps * lap2psi, D.p * lapq, D.p * q_eps,
            abs2(lphix) + abs2(lphiy), abs2(lapphi),
            abs2(phix) + abs2(phiy), abs2(phi))

    def sources_from_parts(self, m: torch.Tensor) -> StageSources:
        """Budget sources from the global means of
        :meth:`field_source_parts`. Everything but ``pi`` (a product of
        two means) is linear in ``m``, so a weighted sum of several
        stages' vectors gives the weighted sum of their sources."""
        p = self.params
        gamma1 = m[0] / p.f
        gamma2 = 0.5 * p.hslash * m[1] / p.f
        xi1 = m[2] / p.f
        xi2 = m[3] / p.f
        # Im(0.5 * mean(phi) * mean(conj(phi) q_psi))
        pi = 0.5 * (m[4] * m[7] + m[5] * m[6])

        ep_psi = p.nu4 * m[8] - p.nu * m[9] + p.mu * m[10]
        k2 = p.kappa2
        chi_phi = (-0.5 * p.nu4w * m[11] / k2 - 0.5 * p.nuw * m[12] / k2
                   - 0.5 * p.muw * m[13] / k2)
        ep_phi = -p.nu4w * m[12] - p.nuw * m[13] - p.muw * m[14]

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

    def stage_terms(self, qh, phih, D: Derived, want_sources: bool):
        """One stage's RHS nonlinear terms plus (optionally) this rank's
        partial sums of its budget sources, else ``None``; the fast kernel
        overrides this to share transforms."""
        parts = (self.stage_source_parts(qh, phih, D) if want_sources
                 else None)
        Fn, Fnw = self.nonlinear(qh, D)
        return Fn, Fnw, parts

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
        dt = self._dt
        want = self.params.compute_budgets
        # QL stage-ordering quirk (jac_reads_updated_qh): the wave RHS is
        # re-evaluated on the just-updated qh, and that Fnw replaces the
        # stage-input one everywhere it is reused
        skew = self.physics.jac_reads_updated_qh

        def reFnw(qh_new, D_):
            return self.nonlinear(qh_new, D_)[1]

        # stage 1 (sources from the carried state)
        Fn0, Fn0w, src1 = self.stage_terms(s.qh, s.phih, s.d, want)
        qh0, phih0 = s.qh, s.phih
        qh = mulf(cq.expch_h * qh0 + Fn0 * cq.Qh, fq)
        if skew:
            Fn0w = reFnw(qh, s.d)
        phih = mulf(cw.expch_h * phih0 + Fn0w * cw.Qh, fw)
        qh1, phih1 = qh, phih
        D = self.derive(qh, phih, s.d)

        # stage 2
        Fna, Fnaw, src2 = self.stage_terms(qh, phih, D, want)
        qh = mulf(cq.expch_h * qh0 + Fna * cq.Qh, fq)
        if skew:
            Fnaw = reFnw(qh, D)
        phih = mulf(cw.expch_h * phih0 + Fnaw * cw.Qh, fw)
        D = self.derive(qh, phih, D)

        # stage 3
        Fnb, Fnbw, src3 = self.stage_terms(qh, phih, D, want)
        qh = mulf(cq.expch_h * qh1 + (2.0 * Fnb - Fn0) * cq.Qh, fq)
        if skew:
            Fnbw = reFnw(qh, D)
        phih = mulf(cw.expch_h * phih1 + (2.0 * Fnbw - Fn0w) * cw.Qh, fw)
        D = self.derive(qh, phih, D)

        # stage 4 + final combination
        Fnc, Fncw, src4 = self.stage_terms(qh, phih, D, want)
        qh = mulf(cq.expch * qh0 + Fn0 * cq.f0 + 2.0 * (Fna + Fnb) * cq.fab
                  + Fnc * cq.fc, fq)
        if skew:
            Fncw = reFnw(qh, D)
        phih = mulf(cw.expch * phih0 + Fn0w * cw.f0
                    + 2.0 * (Fnaw + Fnbw) * cw.fab + Fncw * cw.fc, fw)

        if want:
            # the RK4 combination of the four stages' partial sums, reduced
            # over the mesh once; k, p and a are linear in them
            src = self.sources_from_parts(self._gsum(
                src1 + 2.0 * (src2 + src3) + src4))
            Ke = s.Ke + dt * src.k / 6.0
            Pw = s.Pw + dt * src.p / 6.0
            Kw = s.Kw + dt * src.a / 6.0
        else:
            Ke, Pw, Kw = s.Ke, s.Pw, s.Kw

        D = self.derive(qh, phih, D)
        return WaveState(t=s.t + dt, tc=s.tc + 1, qh=qh, phih=phih, d=D,
                         Ke=Ke, Pw=Pw, Kw=Kw)

    # ------------------------------------------------------------------
    # initialization (the reference's set_q/set_phi ordering)
    # ------------------------------------------------------------------
    def zero_state(self) -> WaveState:
        g = self.grid
        z = torch.zeros(g.spec_shape, dtype=self.cdtype, device=self.device)
        zp = torch.zeros(g.phys_shape, dtype=self.cdtype, device=self.device)
        r = torch.zeros(g.phys_shape, dtype=self.rdtype, device=self.device)
        D = Derived(ph=z, p=None if self._drop_p else r, q=r, q_psi=r,
                    qwh=z, phi=zp, phix=zp, phiy=zp, u=r, v=r)
        zero = torch.zeros((), dtype=self.rdtype, device=self.device)
        return WaveState(t=zero, tc=0, qh=z, phih=z, d=D, Ke=zero, Pw=zero,
                         Kw=zero)

    def _cast_field(self, q, dtype=None) -> torch.Tensor:
        """A global host field (or a ``multihost.make_global_field``
        block) on the device, cut to this rank's rows."""
        q = np.asarray(self.grid.phys_np(q), dtype=dtype or self.dtype)
        return torch.as_tensor(np.ascontiguousarray(q), device=self.device)

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
        phi_c = self._cast_field(phi, np.complex128).to(self.cdtype)
        phih = self.tr.fft2(phi_c)
        phix, phiy = spectral.gradients(self.tr, self.grid, phih)
        m = self._gmeans(abs2(phix) + abs2(phiy), abs2(phi_c))
        Pw = 0.25 * m[0] / self.params.kappa2
        Kw = 0.5 * m[1]
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
        if self.grid.owns_mean_mode:
            dens[0, 0].fill_(0.0)  # no scalar copied from the host
        return self._gsum([dens.sum()])[0] / self._M2

    def ke_qg(self, ph):
        return 0.5 * self.spec_var(ph * self.qtab.wv)

    def ke_niw(self, phi):
        return 0.5 * self._gmeans(abs2(phi))[0]

    def pe_niw(self, phih):
        phix, phiy = spectral.gradients(self.tr, self.grid, phih)
        return (0.25 * self._gmeans(abs2(phix) + abs2(phiy))[0]
                / self.params.kappa2)

    def cke_niw(self, phi):
        m = self._gmeans(phi)  # the global mean first, then its |.|^2
        return 0.5 * (m[0] * m[0] + m[1] * m[1])

    def ens(self, q):
        return 0.5 * self._gmeans(q * q)[0]

    def conc_niw(self, phi, q_psi):
        # two rounds: the global means, then the centred moments
        ups = abs2(phi)
        m = self._gmeans(ups, q_psi)
        ups = ups - m[0]
        dq = q_psi - m[1]
        c = self._gmeans(ups * q_psi, ups * ups, dq * dq)
        return c[0] / torch.sqrt(c[1]) / torch.sqrt(c[2])

    def skewness(self, q_psi):
        m = self._gmeans(q_psi**3, q_psi**2)
        return m[0] / m[1] ** 1.5

    def chi_q(self, qh):
        return -self.params.nu4 * self.spec_var(qh * self.qtab.wv2)

    def cfl(self, s: WaveState):
        phimax = torch.sqrt(abs2(s.d.phi).max())
        return spectral.cfl_number(s.d.u, s.d.v, phimax, self.params.dt,
                                   self.grid.dx, self.mesh)

    def strain(self, ph):
        """Geostrophic rate of strain squared."""
        g = self.qtab
        pxx = self._inv_real(ph * (-g.k * g.k))
        pyy = self._inv_real(ph * (-g.l * g.l))
        # k*l is odd in l: the y-derivative table (its half-layout
        # Hermitian representative at the Nyquist row)
        pxy = self._inv_real(ph * (-g.k * self._l_dy))
        return 4.0 * pxy**2 + (pxx - pyy) ** 2

    def okubo_weiss(self, s: WaveState):
        """Okubo–Weiss parameter: squared strain minus squared relative
        vorticity (the reference's never-called ``_calc_OW`` squares the
        already squared strain; corrected here, as in the JAX package)."""
        return self.strain(s.d.ph) - s.d.q_psi**2
