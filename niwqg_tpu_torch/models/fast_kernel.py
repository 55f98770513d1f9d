"""Batched fast wave kernel (port of ``niwqg_tpu/models/fast_kernel.py``).

Same ETDRK4 stage structure, budget integration and physics as
:class:`~niwqg_tpu_torch.models.kernel.WaveKernel`, re-associated:

  - each stage's transforms are grouped into a few batched calls
    (leading-axis stacking);
  - the elliptic inversion stays in spectral space,
    ``ph = -(qh - qwh)/wv2``, with the reference's ``fft(real(ifft(.)))``
    sandwich reduced to its Hermitian projection;
  - every transform of a real field goes through the provider's
    half-spectrum path;
  - with ``spectral_budgets=True`` (default) the per-stage budget sources
    are evaluated by Parseval and cost no transforms;
  - ``q_half`` carries every q/psi-side spectrum on the rfft half
    spectrum ``(ny, nx//2+1)``, tables sliced from the full grid so the
    retained columns are bitwise those of the full layout;
  - ``fold_filter`` pre-multiplies the stage filter into the ETDRK4
    tables.

The JAX kernel's ``pair_inverse`` mode is not ported (ROADMAP.md, queue 1,
item 11).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..etdrk4 import ETDRK4Coefs, fold_filter_into
from ..ops import spectral
from ..ops.spectral import abs2, jmul, mul_i
from .kernel import Derived, KernelParams, StageSources, WaveKernel, \
    WavePhysics, WaveState


class _QTables(NamedTuple):
    """q-side wavenumber/filter tables (full grid, or its first
    ``nx//2+1`` columns in ``q_half`` mode)."""

    k: torch.Tensor
    l: torch.Tensor
    wv: torch.Tensor
    wv2: torch.Tensor
    wv2i: torch.Tensor
    wv4: torch.Tensor
    filtr: torch.Tensor


class FastWaveKernel(WaveKernel):
    """Batched-transform wave kernel."""

    def __init__(self, params: KernelParams, physics: WavePhysics,
                 q_half=None, pair_inverse: bool = False,
                 fold_filter: bool = True, **kw):
        if pair_inverse:
            raise NotImplementedError(
                "pair_inverse is not ported yet (ROADMAP.md, queue 1, item 11)")
        super().__init__(params, physics, **kw)
        if q_half is None:
            q_half = (params.nx % 2 == 0 and hasattr(self.tr, "rfft2")
                      and physics.hermitian_ph)
        elif q_half and not physics.hermitian_ph:
            raise ValueError(
                "q_half requires Hermitian-projecting physics "
                f"({type(physics).__name__} keeps ph unprojected)")
        self.q_half = bool(q_half)
        g = self.grid
        if self.q_half:
            nk = params.nx // 2 + 1
            cut = lambda t: t[:, :nk].contiguous()
            self.qtab = _QTables(
                k=cut(g.k), l=cut(g.l), wv=cut(g.wv), wv2=cut(g.wv2),
                wv2i=cut(g.wv2i), wv4=cut(g.wv4), filtr=cut(g.filtr),
            )
            self._flt_q = self.qtab.filtr
            self.coefs_q = ETDRK4Coefs(*[cut(t) for t in self.coefs_q])
            self._fwd_real = self.tr.rfft2
            nx = params.nx

            def _inv_real(z):
                # irfft2 projects only the k-direction residue; fold in the
                # within-column (l <-> -l) projection of the self-mirror
                # columns that real(ifft(.)) performs
                return self.tr.irfft2(spectral.hermitian_project_half(z, nx))

            self._inv_real = _inv_real
            # Hermitian-degeneracy weights: interior columns stand for
            # their dropped conjugate mirrors
            deg = np.full((1, nk), 2.0)
            deg[0, 0] = deg[0, params.nx // 2] = 1.0
            self._qdeg = self._dev(deg)
            # y-derivative l table: an l-derivative of a Hermitian spectrum
            # is purely anti-Hermitian on the Nyquist row's interior
            # columns, so its half-layout representative there is 0
            l_dy = g.l_np[:, :nk].copy()
            l_dy[g.ny // 2, 1:params.nx // 2] = 0.0
            self._l_dy = self._dev(l_dy)
        # spectral-budget weights (f64 numpy, cast once): each budget
        # scalar is one weighted reduction
        p = params
        wv2 = g.wv2_np
        wv4 = g.wv4_np
        k2 = p.kappa2
        w_d = -(p.nu4w * wv4 + p.nuw * wv2 + p.muw)
        w_chi = -0.5 * (p.nu4w * wv2 * wv4 + p.nuw * wv4 + p.muw * wv2) / k2
        w_eppsi = p.nu4 * wv4 + p.nu * wv2 + p.mu
        self._w_d = self._dev(w_d)
        self._w_chi = self._dev(w_chi)
        if self.q_half:
            # fold the Hermitian degeneracy into the q-side weight
            w_eppsi = w_eppsi[:, :params.nx // 2 + 1] * deg
        self._w_eppsi = self._dev(w_eppsi)

        self.fold_filter = bool(fold_filter)
        if self.fold_filter:
            self.coefs_q = fold_filter_into(self.coefs_q, self._flt_q)
            self.coefs_w = fold_filter_into(self.coefs_w, self._flt_w)
            self._flt_q = None
            self._flt_w = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64).astype(self.dtype),
                               device=self.device)

    @property
    def _drop_p(self) -> bool:
        # the physical streamfunction feeds only the physical-space sources
        return self._spectral_src

    @property
    def _spectral_src(self) -> bool:
        return self.params.spectral_budgets

    # ------------------------------------------------------------------
    def derive(self, qh, phih, prev=None) -> Derived:
        g = self.grid
        pg = self.tr.ifft2(torch.stack([phih, mul_i(phih, g.k),
                                        mul_i(phih, g.l)]))
        return self._invert_core(qh, pg[0], pg[1], pg[2])

    def _project_ph(self, ph):
        """The reference inversion's ``fft(real(ifft(.)))`` sandwich."""
        if self.q_half:
            return spectral.hermitian_project_half(ph, self.params.nx)
        return spectral.hermitian_project(ph)

    def _invert_core(self, qh, phi, phix, phiy) -> Derived:
        """Inversion + derived physical fields from given wave fields
        (shared by ``derive`` and ``apply_set_q``, which inverts with the
        carried phi)."""
        qt, p = self.qtab, self.params
        if self.physics.has_wave_pv:
            z = phix.conj() * phiy - phiy.conj() * phix
            fj = self._fwd_real(torch.stack([abs2(phi), jmul(z).real]))
            gphi2h = fj[0] * (-qt.wv2)
            jach = spectral.zero_mean_mode(fj[1])
            qwh = ((0.5 * gphi2h + jach) * 0.5 / p.f) * qt.filtr
        else:
            qwh = torch.zeros_like(qh)

        ph = -((qh - qwh) * qt.wv2i)
        if self.physics.hermitian_ph:
            ph = self._project_ph(ph)
        # batch only the fields a stage consumes
        specs = [mul_i(ph, -self._l_dy), mul_i(ph, qt.k), qh]
        if not self._drop_p:
            specs.insert(0, ph)
        if self.physics.subtracts_wave_pv:
            specs.append(qh - qwh)
        gb = self._inv_real(torch.stack(specs))
        i = 0 if self._drop_p else 1
        p_ = None if self._drop_p else gb[0]
        u, v, q = gb[i], gb[i + 1], gb[i + 2]
        q_psi = gb[i + 3] if self.physics.subtracts_wave_pv else q
        return Derived(ph=ph, p=p_, q=q, q_psi=q_psi, qwh=qwh, phi=phi,
                       phix=phix, phiy=phiy, u=u, v=v)

    # ------------------------------------------------------------------
    # shared RHS products (also feed the spectral budget sources)
    # ------------------------------------------------------------------
    def _wave_products(self, D: Derived):
        """``fft(J(psi, phi))`` and ``fft(phi*q_psi)`` in one batch."""
        j_full = D.phix * D.u + D.phiy * D.v
        nlc = self.tr.fft2(torch.stack([j_full, D.phi * D.q_psi]))
        return nlc[0], nlc[1]

    def _rhs_from_products(self, D: Derived, jacwh_raw, refrh_raw):
        qt = self.qtab
        uvqh = self._fwd_real(torch.stack([D.u * D.q, D.v * D.q]))
        jacq = spectral.zero_mean_mode(mul_i(uvqh[0], qt.k)
                                       + mul_i(uvqh[1], self._l_dy))
        jacwh = jacwh_raw
        if self.physics.zero_mean_jac_psi_phi:
            jacwh = spectral.zero_mean_mode(jacwh)
        return -jacq, -jacwh - jmul(refrh_raw, 0.5)

    def stage_terms(self, qh, phih, D: Derived, want_sources: bool):
        jh, refrh = self._wave_products(D)
        Fn, Fnw = self._rhs_from_products(D, jh, refrh)
        if not want_sources:
            src = self.zero_sources()
        elif self._spectral_src:
            src = self._sources_spectral(qh, phih, D, refrh, jh)
        else:
            src = self._stage_sources_batched(qh, phih, D)
        return Fn, Fnw, src

    def nonlinear(self, qh, D: Derived):
        return self._rhs_from_products(D, *self._wave_products(D))

    # ------------------------------------------------------------------
    # budget sources
    # ------------------------------------------------------------------
    def stage_sources(self, qh, phih, D: Derived) -> StageSources:
        """Standalone source evaluation (diagnostics cadence)."""
        if self._spectral_src:
            jh, refrh = self._wave_products(D)
            return self._sources_spectral(qh, phih, D, refrh, jh)
        return self._stage_sources_batched(qh, phih, D)

    def _sources_spectral(self, qh, phih, D: Derived, refrh_raw,
                          jh_full) -> StageSources:
        """Parseval evaluation of the physical-space budget means. With
        ``Rh = fft(phi*q_psi)``, ``Jh = fft(phix*u + phiy*v)``,
        ``lapphi_h = -wv2*phih`` and ``diss_phi_h = w_d*phih``:

          ep_phi  = Σ w_d|phih|²/M²;  chi_phi = Σ w_chi|phih|²/M²
          ep_psi  = Σ w_eppsi Re(conj(qh) ph)/M²
          gamma1  = ¼ hslash/f Im(Σ conj(Rh)(−wv2 phih))/M²
          gamma2  = ½ hslash/f Re(Σ conj(−wv2 phih) Jh)/M²
          xi1     = −Im(Σ w_d phih conj(Jh))/M²/f
          xi2     = ½ Re(Σ w_d phih conj(Rh))/M²/f
          pi      = ½ Im(phih[0,0] conj(Rh[0,0]))/M²

        ``Jh``/``Rh`` are the raw products, before the Jacobian's mean-mode
        zeroing and the refraction's ``0.5j``."""
        g, p = self.grid, self.params
        M2 = self._s(1.0 / float(g.M) ** 2)
        hs, f = p.hslash, p.f

        aphi2 = abs2(phih)
        ep_phi = (self._w_d * aphi2).sum() * M2
        chi_phi = (self._w_chi * aphi2).sum() * M2

        ph = D.ph
        if not self.physics.hermitian_ph:
            ph = self._project_ph(ph)
        rqp = qh.real * ph.real + qh.imag * ph.imag  # Re(conj(qh)*ph)
        ep_psi = (self._w_eppsi * rqp).sum() * M2

        pr, pim = phih.real, phih.imag
        rr, ri = refrh_raw.real, refrh_raw.imag
        jr, ji = jh_full.real, jh_full.imag
        gamma1 = (0.25 * hs / f) * M2 * ((-g.wv2) * (rr * pim - ri * pr)).sum()
        gamma2 = (0.5 * hs / f) * M2 * ((-g.wv2) * (pr * jr + pim * ji)).sum()
        xi1 = (-1.0 / f) * M2 * (self._w_d * (pim * jr - pr * ji)).sum()
        xi2 = (0.5 / f) * M2 * (self._w_d * (pr * rr + pim * ri)).sum()
        pi = 0.5 * M2 * (pim[0, 0] * rr[0, 0] - pr[0, 0] * ri[0, 0])

        k_src = -(gamma1 + gamma2) + (xi1 + xi2) + ep_psi
        p_src = gamma1 + gamma2 + chi_phi
        a_src = ep_phi
        return StageSources(k_src, p_src, a_src, gamma1, gamma2, xi1, xi2, pi,
                            ep_psi, chi_phi, ep_phi)

    def _stage_sources_batched(self, qh, phih, D: Derived) -> StageSources:
        """Physical-space sources with batched transforms
        (``spectral_budgets=False``)."""
        g, qt, tr = self.grid, self.qtab, self.tr
        batch = tr.ifft2(torch.stack([
            phih * (-g.wv2),                 # lapphi
            phih * g.wv4,                    # lap2phi
            mul_i(phih, -g.k * g.wv2),       # lphix
            mul_i(phih, -g.l * g.wv2),       # lphiy
        ]))
        rb = self._inv_real(torch.stack([D.ph * qt.wv4, qh * (-qt.wv2)]))
        return self.sources_from_fields(D, batch[0], batch[1], batch[2],
                                        batch[3], rb[0], rb[1])

    # ------------------------------------------------------------------
    # state construction / initialization (q_half-aware layouts)
    # ------------------------------------------------------------------
    def zero_state(self) -> WaveState:
        if not self.q_half:
            return super().zero_state()
        shape = (self.grid.nl, self.grid.nk)
        hshape = (self.grid.nl, self.params.nx // 2 + 1)
        zf = torch.zeros(shape, dtype=self.cdtype, device=self.device)
        zh = torch.zeros(hshape, dtype=self.cdtype, device=self.device)
        r = torch.zeros(shape, dtype=self.rdtype, device=self.device)
        D = Derived(ph=zh, p=None if self._drop_p else r, q=r, q_psi=r,
                    qwh=zh, phi=zf, phix=zf, phiy=zf, u=r, v=r)
        zero = self._s(0.0)
        return WaveState(t=zero, tc=0, qh=zh, phih=zf, d=D, Ke=zero,
                         Pw=zero, Kw=zero)

    def apply_set_q(self, s: WaveState, q) -> WaveState:
        if not self.q_half:
            return super().apply_set_q(s, q)
        # invert with the carried phi and gradients, keep the carried wave
        # fields, refresh Ke
        qh = self._fwd_real(self._cast_field(q))
        D = self._invert_core(qh, s.d.phi, s.d.phix, s.d.phiy)
        return s._replace(qh=qh, d=D, Ke=self.ke_qg(D.ph))
