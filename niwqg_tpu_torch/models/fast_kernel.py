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
    tables;
  - ``pair_inverse`` keeps the q side on the full spectrum and reads
    every stacked real-inverse batch through pair-packed complex inverses
    (``ifft2(A + iB) = a + ib``): on a pencil mesh that halves the
    transpose volume of the real-inverse group;
  - ``derive`` is three transforms with one hand-written CUDA kernel in
    each gap between them on the card (``ops/derive_fused.py``,
    ``csrc/derive.cu``), each writing the batch the next transform takes;
    the plain chain on host tensors;
  - a stage's epilogue, from its forward transforms to its ETDRK4 update
    (the right-hand sides and the Parseval budget sums), is one
    hand-written CUDA kernel on the card (``ops/stage_fused.py``,
    ``csrc/stage.cu``), the plain chain on host tensors.

On a mesh tables are this rank's columns, and the masks of the mean mode
and of the self-mirror columns ``k = 0, nx/2`` come from the global column
index (``Grid.local_cols``). On the pencil FFT's mesh the q side stays
full-spectrum, as in JAX (``q_half`` raises there); on the matmul-DFT's
(``parallel/mfft.py``, JAX's GSPMD branch) it keeps ``q_half``, in the
half layout padded with ``rfft_pad`` zero columns to a mesh-divisible
width: the padded columns carry k = 0, zero data and zero weight in every
budget sum (``Grid.half_np``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..etdrk4 import fold_filter_into
from ..ops import derive_fused, spectral, stage_fused
from ..ops.derive_fused import Plan, QLayout, q_layout
from ..ops.spectral import abs2, jmul, mul_i
from ..parallel.mesh import reflect_spectrum
from ..utils.profiling import count
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
        self.pair_inverse = bool(pair_inverse)
        if self.pair_inverse:
            # pair packing rides full complex inverses, so the q side must
            # carry full-width spectra
            if q_half:
                raise ValueError(
                    "pair_inverse requires the full-spectrum q side "
                    "(q_half=False)")
            if params.nx % 2:
                raise ValueError("pair_inverse needs even nx")
            if not physics.hermitian_ph:
                # an unprojected ph carries anti-Hermitian content that the
                # packed inverse would deposit on the partner field
                raise ValueError(
                    "pair_inverse requires Hermitian-projecting physics "
                    f"({type(physics).__name__} keeps ph unprojected)")
            q_half = False
        self._q_half_arg = q_half
        # resolves the q side's layout (_q_layout) and builds coefs_q in it
        super().__init__(params, physics, **kw)
        if self.pair_inverse and not hasattr(self.tr, "ifft2_real_pairs"):
            raise ValueError("pair_inverse needs a transform provider with "
                             "ifft2_real_pairs")
        g = self.grid
        nk = params.nx // 2 + 1
        self._qshape = (g.nl, self.layout.kq.shape[0])
        if self.q_half:
            half = self._dev
            self.qtab = _QTables(
                k=half(g.k_np), l=half(g.l_np), wv=half(g.wv_np),
                wv2=half(g.wv2_np), wv2i=half(g.wv2i_np), wv4=half(g.wv4_np),
                filtr=half(g.filtr_np),
            )
            self._flt_q = self.qtab.filtr
            self._fwd_real = self.tr.rfft2
            # Hermitian-degeneracy weights: interior columns stand for
            # their dropped conjugate mirrors (padded columns weigh 0)
            deg = np.full((1, nk), 2.0)
            deg[0, 0] = deg[0, params.nx // 2] = 1.0
            self._qdeg = self._dev(deg)

        def _inv_real(z):
            return self._inv_packed(self._inv_prepare(z))

        self._inv_real = _inv_real
        # spectral-budget weights (f64 numpy, cast once): each budget
        # scalar is one weighted reduction
        p = params
        wv2 = g.wv2_np
        wv4 = g.wv4_np
        k2 = p.kappa2
        w_d = -(p.nu4w * wv4 + p.nuw * wv2 + p.muw)
        w_chi = -0.5 * (p.nu4w * wv2 * wv4 + p.nuw * wv4 + p.muw * wv2) / k2
        w_eppsi = p.nu4 * wv4 + p.nu * wv2 + p.mu
        self._w_d = g._dev(w_d)
        self._w_chi = g._dev(w_chi)
        if self.q_half:
            # fold the Hermitian degeneracy into the q-side weight
            w_eppsi = w_eppsi[:, :nk] * deg
        self._w_eppsi = self._dev(w_eppsi)

        # the Parseval sums' scales, made once (see WaveKernel._dt)
        self._inv_M = self._s(1.0 / float(g.M))
        self._inv_M2 = self._s(1.0 / float(g.M) ** 2)

        self.fold_filter = bool(fold_filter)
        if self.fold_filter:
            self.coefs_q = fold_filter_into(self.coefs_q, self._flt_q)
            self.coefs_w = fold_filter_into(self.coefs_w, self._flt_w)
            self._flt_q = None
            self._flt_w = None
        # what the fused kernels read; the card's launch counters are made
        # here, outside any capture (the stage's with its workspace)
        self._plan = self._derive_plan()
        self._stage_plan = self._epilogue_plan()
        if self.device.type == "cuda":
            derive_fused.FAMILY.counters(self.device)

    def _q_layout(self) -> QLayout:
        """Resolve ``q_half`` now that the transform is known; the q side's
        layout is then the half spectrum, padded with the transform's
        ``rfft_pad`` zero columns (``Grid.half_np``), or the full one, read
        through pair-packed inverses under ``pair_inverse``."""
        q_half, physics = self._q_half_arg, self.physics
        if self.mesh is not None and not getattr(self.tr, "internal_pad",
                                                 False):
            if q_half:
                raise ValueError(
                    "q_half is not available on the pencil FFT's mesh: the "
                    "q side stays full-spectrum there, as in JAX "
                    "(backend='mxu' keeps it)")
            q_half = False
        if q_half is None:
            q_half = (self.params.nx % 2 == 0 and hasattr(self.tr, "rfft2")
                      and physics.hermitian_ph)
        elif q_half and not physics.hermitian_ph:
            raise ValueError(
                "q_half requires Hermitian-projecting physics "
                f"({type(physics).__name__} keeps ph unprojected)")
        self.q_half = bool(q_half)
        return q_layout(
            self.grid, physics.hermitian_ph, half=self.q_half,
            pad=getattr(self.tr, "rfft_pad", 0) if self.q_half else 0,
            pair=self.pair_inverse)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A q-side table on the device: a full-layout host table cut to
        this rank's block of the q side's layout."""
        a = self.layout.cut(np.asarray(a, np.float64))
        return torch.as_tensor(np.ascontiguousarray(a).astype(self.dtype),
                               device=self.device)

    @property
    def _drop_p(self) -> bool:
        # the physical streamfunction feeds only the physical-space sources
        return self._spectral_src

    @property
    def _spectral_src(self) -> bool:
        # The stale-gradient mode keeps the physical-space sources: by
        # Parseval the gradient quadratics would see the fresh phih, where
        # the reference integrates the stale phix/phiy. So does the frozen
        # q_psi: ep_psi then mixes the frozen q with the current ph, which
        # one Re(conj(qh) ph) reduction cannot express.
        return (self.params.spectral_budgets
                and not self.physics.stale_phi_gradients
                and not self.physics.stale_q_psi)

    # ------------------------------------------------------------------
    def derive(self, qh, phih, prev=None, plain=None) -> Derived:
        """The derived fields of ``(qh, phih)``: on the card three
        transforms with one kernel of ``ops/derive_fused.py`` in each gap,
        on host tensors the plain chain (``plain``, by default, is whether
        the tensors are the host's; ``plain=True`` on the card is the
        oracle the kernels are held to)."""
        if plain is None:
            plain = qh.device.type == "cpu"
        pg = self.tr.ifft2(self._grad_pack(phih, plain))
        phix, phiy = pg[1], pg[2]
        if self.physics.stale_phi_gradients and prev is not None:
            phix, phiy = prev.phix, prev.phiy
        D = self._invert_core(qh, pg[0], phix, phiy, plain)
        if self.physics.stale_q_psi and prev is not None:
            D = D._replace(q_psi=prev.q_psi)  # frozen at the set_q value
        return D

    def _invert_core(self, qh, phi, phix, phiy, plain=None) -> Derived:
        """Inversion + derived physical fields from given wave fields
        (shared by ``derive`` and ``apply_set_q``, which inverts with the
        carried phi)."""
        if plain is None:
            plain = qh.device.type == "cpu"
        if qh.device.type == "cpu":
            derive_fused.FAMILY.plain_call("invert")
        elif not plain:
            count("step.derive_fused")
        fj = None
        if self.physics.has_wave_pv:
            fj = self._fwd_real(self._wave_pv(phi, phix, phiy, plain))
        qwh, ph, batch = self._invert_pack(qh, fj, plain)
        # the kernels project the batch's self-mirror columns themselves
        gb = self._inv_real(batch) if plain else self._inv_packed(batch)
        i = 0 if self._drop_p else 1
        p_ = None if self._drop_p else gb[0]
        u, v, q = gb[i], gb[i + 1], gb[i + 2]
        q_psi = gb[i + 3] if self.physics.subtracts_wave_pv else q
        return Derived(ph=ph, p=p_, q=q, q_psi=q_psi, qwh=qwh, phi=phi,
                       phix=phix, phiy=phiy, u=u, v=v)

    def _grad_pack(self, phih, plain):
        """``[phih, ik phih, il phih]``, the batch of ``tr.ifft2``."""
        if not plain:
            return derive_fused.grad_pack(phih, self._plan)
        g = self.grid
        return torch.stack([phih, mul_i(phih, g.k), mul_i(phih, g.l)])

    def _wave_pv(self, phi, phix, phiy, plain):
        """``[|phi|^2, Re(i z)]``, ``z = phix* phiy - phiy* phix``: the
        batch of the forward real transform."""
        if not plain:
            return derive_fused.wave_pv(phi, phix, phiy)
        z = phix.conj() * phiy - phiy.conj() * phix
        return torch.stack([abs2(phi), jmul(z).real])

    def _invert_pack(self, qh, fj, plain):
        """``(qwh, ph, batch)`` from the forward transform ``fj`` of the
        wave-PV batch (``None`` without a wave PV): the spectra ``Derived``
        keeps, and the stack of the fields a stage consumes, which the
        kernels hand over as ``_inv_prepare`` would (plain: before it)."""
        qt = self.qtab
        if not plain:
            a = self._plan
            qwh, ph, batch = derive_fused.invert(qh, fj, qt.wv2, qt.wv2i,
                                                 qt.filtr, a)
            if self.layout.proj == derive_fused.PROJ_RAW:
                # the mirror columns live on other ranks: exchange, project
                derive_fused.project_pack(
                    ph, reflect_spectrum(ph, self.mesh), batch, a)
            return qwh, ph, batch
        if fj is not None:
            gphi2h = fj[0] * (-qt.wv2)
            jach = spectral.zero_mean_mode(fj[1], self.grid.owns_mean_mode)
            if self.physics.wave_pv_imag_jac:
                jach = jmul(jach)  # the reference QL transcription bug
            qwh = ((0.5 * gphi2h + jach) * 0.5 / self.params.f) * qt.filtr
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
        return qwh, ph, torch.stack(specs)

    def _derive_plan(self) -> Plan:
        """The layout and physics as the derive's kernels read them: the
        choices ``_invert_pack``'s plain chain makes, as numbers."""
        g, ph, p = self.grid, self.physics, self.params
        slots = ["u", "v", "q"]
        if not self._drop_p:
            slots.insert(0, "ph")
        if ph.subtracts_wave_pv:
            slots.append("qpsi")
        # PyTorch's CUDA division by a scalar multiplies by its reciprocal,
        # rounded on the host in the working type
        inv_f = (1.0 / p.f if self.rdtype == torch.float64
                 else float(np.float32(1.0) / np.float32(p.f)))
        return Plan(
            k=g.k[0].contiguous(), q=self.layout,
            flags=((derive_fused.WAVE_PV if ph.has_wave_pv else 0)
                   | (derive_fused.IMAG_JAC if ph.wave_pv_imag_jac else 0)
                   | (derive_fused.OWNS_MEAN if g.owns_mean_mode else 0)),
            slots=tuple(slots.index(s) if s in slots else -1
                        for s in derive_fused.SLOTS),
            inv_f=inv_f)

    def _epilogue_plan(self) -> stage_fused.Plan:
        """The layout and physics as the stage epilogue's kernel reads
        them: the weight tables and the q side's layout."""
        g = self.grid
        ws = (stage_fused.FAMILY.workspace(self.device, stage_fused.N_SUMS)
              if self.device.type == "cuda" else (None, None, 0))
        return stage_fused.Plan(
            w_d=self._w_d.contiguous(), w_chi=self._w_chi.contiguous(),
            wv2=g.wv2.contiguous(), w_eppsi=self._w_eppsi.contiguous(),
            q=self.layout, zero_jac=bool(self.physics.zero_mean_jac_psi_phi),
            owner=g.owns_mean_mode, inv_m=self._inv_M.item(),
            inv_m2=self._inv_M2.item(), partials=ws[0], arrivals=ws[1],
            blocks=ws[2])

    def _inv_prepare(self, z):
        """What a stack of q-side spectra needs before ``_inv_packed``.
        irfft2 projects only the k-direction residue; the half layout folds
        in the within-column (l <-> -l) projection of the self-mirror
        columns that real(ifft(.)) performs. Under ``pair_inverse`` that
        O(ny) 2-column projection replaces the full fft(real(ifft(.)))
        sandwich: interior mirror columns stay Hermitian up to rounding, so
        only the self-mirror columns carry systematic anti-Hermitian content
        (mean-flow advection phase); residual rounding-grade asymmetry lands
        on the partner field as eps*||q||-scale noise (the mode is
        opt-in)."""
        if self.q_half or (self.pair_inverse and z.dim() > 2):
            return self._project_mirror_cols(z)
        return z

    def _inv_packed(self, z):
        """Each layout's inverse real transform of q-side spectra made
        ready by ``_inv_prepare`` (``_inv_real`` is the two)."""
        if self.q_half:
            return self.tr.irfft2(z)
        if self.pair_inverse and z.dim() > 2:
            return self.tr.ifft2_real_pairs(z)
        return self.tr.ifft2_real(z)

    def _project_mirror_cols(self, z):
        return spectral.hermitian_project_half(z, self.params.nx,
                                               self.layout.mirror)

    def _project_ph(self, ph):
        """The reference inversion's ``fft(real(ifft(.)))`` sandwich."""
        if self.q_half or self.pair_inverse:
            # the 2-column projection suffices (see ``pair_inverse``)
            return self._project_mirror_cols(ph)
        return spectral.hermitian_project(ph, self.mesh)

    # ------------------------------------------------------------------
    # shared RHS products (also feed the spectral budget sources)
    # ------------------------------------------------------------------
    def _wave_products(self, qh, D: Derived):
        """Forward transforms of the stage's nonlinear products, in one
        batch: ``fft(J_adv)`` (the advection entering the phi RHS),
        ``fft(phi*q_psi)`` (refraction, before ``0.5j``) and ``fft(J_full)``,
        the Jacobian by the full geostrophic flow that the budget sources
        read. They are one field unless the waves are advected by the
        vortex flow alone (QL), whose velocities come from ``qh``."""
        refr = D.phi * D.q_psi
        j_full = D.phix * D.u + D.phiy * D.v
        if not self.physics.advect_by_vortex_flow:
            nlc = self.tr.fft2(torch.stack([j_full, refr]))
            return nlc[0], nlc[1], nlc[0]
        qt = self.qtab
        ph_q = -(qh * qt.wv2i)
        uv = self._inv_real(torch.stack([mul_i(ph_q, -self._l_dy),
                                         mul_i(ph_q, qt.k)]))
        j_adv = D.phix * uv[0] + D.phiy * uv[1]
        nlc = self.tr.fft2(torch.stack([j_adv, refr, j_full]))
        return nlc[0], nlc[1], nlc[2]

    def _q_products(self, D: Derived):
        """Forward real transforms of the q side's products
        ``[u q, v q]``."""
        return self._fwd_real(torch.stack([D.u * D.q, D.v * D.q]))

    def _epilogue(self, qh, phih, D: Derived, refrh, jadv=None, uvqh=None,
                  jh=None, sources=True, plain=None):
        """A stage's gap from its forward transforms to its update:
        ``(Fn, Fnw, parts)``, the right-hand sides where ``uvqh`` (and
        ``jadv``) are given, this rank's budget partials where ``sources``.
        On the card one kernel of ``ops/stage_fused.py``; on host tensors
        the plain chain (``plain``, by default, is whether the tensors are
        the host's; ``plain=True`` on the card is the oracle the kernel is
        held to)."""
        rhs = uvqh is not None
        if plain is None:
            plain = refrh.device.type == "cpu"
        ph = D.ph if sources else None
        if sources and not self.physics.hermitian_ph:
            ph = self._project_ph(ph)  # the kernel reads the projected ph
        if refrh.device.type == "cpu":
            stage_fused.FAMILY.plain_call("epilogue")
        elif not plain:
            count("step.stage_fused")
            return stage_fused.epilogue(
                self._stage_plan, refrh, jadv=jadv, jh=jh, phih=phih,
                uvqh=uvqh, qh=qh, ph=ph, rhs=rhs, sources=sources)
        Fn, Fnw = self._rhs_plain(uvqh, jadv, refrh) if rhs else (None, None)
        parts = (self._sources_plain(qh, phih, ph, refrh, jh) if sources
                 else None)
        return Fn, Fnw, parts

    def _rhs_plain(self, uvqh, jacwh_raw, refrh_raw):
        """``(Fn, Fnw)`` from the products' transforms: the plain chain."""
        qt = self.qtab
        own = self.grid.owns_mean_mode
        jacq = spectral.zero_mean_mode(mul_i(uvqh[0], qt.k)
                                       + mul_i(uvqh[1], self._l_dy), own)
        jacwh = jacwh_raw
        if self.physics.zero_mean_jac_psi_phi:
            jacwh = spectral.zero_mean_mode(jacwh, own)
        return -jacq, -jacwh - jmul(refrh_raw, 0.5)

    def stage_terms(self, qh, phih, D: Derived, want_sources: bool,
                    plain=None):
        jadv, refrh, jh = self._wave_products(qh, D)
        spectral_src = want_sources and self._spectral_src
        Fn, Fnw, parts = self._epilogue(qh, phih, D, refrh, jadv,
                                        self._q_products(D), jh,
                                        spectral_src, plain)
        if want_sources and not spectral_src:
            parts = self._batched_source_parts(qh, phih, D)
        return Fn, Fnw, parts

    def nonlinear(self, qh, D: Derived):
        jadv, refrh, _ = self._wave_products(qh, D)
        Fn, Fnw, _ = self._epilogue(qh, None, D, refrh, jadv,
                                    self._q_products(D), sources=False)
        return Fn, Fnw

    # ------------------------------------------------------------------
    # budget sources
    # ------------------------------------------------------------------
    def stage_source_parts(self, qh, phih, D: Derived) -> torch.Tensor:
        """Standalone source evaluation (diagnostics cadence)."""
        if self._spectral_src:
            _, refrh, jh = self._wave_products(qh, D)
            return self._epilogue(qh, phih, D, refrh, jh=jh)[2]
        return self._batched_source_parts(qh, phih, D)

    def sources_from_parts(self, m: torch.Tensor) -> StageSources:
        if not self._spectral_src:
            return super().sources_from_parts(m)
        p = self.params
        hs, f = p.hslash, p.f
        ep_phi, chi_phi, ep_psi = m[0], m[1], m[2]
        gamma1 = (0.25 * hs / f) * m[3]
        gamma2 = (0.5 * hs / f) * m[4]
        xi1 = (-1.0 / f) * m[5]
        xi2 = (0.5 / f) * m[6]
        # the mean modes of phih (m[7], m[8]) and Rh (m[9], m[10]), each
        # already over M: the one source that is not linear in ``m``
        pi = 0.5 * (m[8] * m[9] - m[7] * m[10])
        k_src = -(gamma1 + gamma2) + (xi1 + xi2) + ep_psi
        p_src = gamma1 + gamma2 + chi_phi
        a_src = ep_phi
        return StageSources(k_src, p_src, a_src, gamma1, gamma2, xi1, xi2, pi,
                            ep_psi, chi_phi, ep_phi)

    def _sources_plain(self, qh, phih, ph, refrh_raw,
                       jh_full) -> torch.Tensor:
        """This rank's partial sums of the Parseval evaluation of the
        physical-space budget means (:meth:`sources_from_parts` finishes
        them), ``ph`` projected: the plain chain. With
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
        zeroing and the refraction's ``0.5j``. ``pi`` needs the (0,0)
        coefficients, which only the owner of column 0 holds: it
        contributes them (over M) and the others contribute zeros."""
        M2 = self._inv_M2
        sums = [t.sum() * M2
                for t in self._source_terms(qh, phih, ph, refrh_raw, jh_full)]
        if self.grid.owns_mean_mode:
            M1 = self._inv_M
            mean_modes = [phih.real[0, 0] * M1, phih.imag[0, 0] * M1,
                          refrh_raw.real[0, 0] * M1, refrh_raw.imag[0, 0] * M1]
        else:
            mean_modes = [self._zero] * 4
        return torch.stack(sums + mean_modes)

    def _source_terms(self, qh, phih, ph, refrh_raw, jh_full):
        """The terms of :meth:`_sources_plain`'s seven sums, one field a
        sum in turn, as the plain chain forms them (its kernel adds the
        same terms)."""
        aphi2 = abs2(phih)
        yield self._w_d * aphi2
        yield self._w_chi * aphi2
        yield self._w_eppsi * (qh.real * ph.real + qh.imag * ph.imag)
        pr, pim = phih.real, phih.imag
        rr, ri = refrh_raw.real, refrh_raw.imag
        jr, ji = jh_full.real, jh_full.imag
        mw2 = -self.grid.wv2
        yield mw2 * (rr * pim - ri * pr)
        yield mw2 * (pr * jr + pim * ji)
        yield self._w_d * (pim * jr - pr * ji)
        yield self._w_d * (pr * rr + pim * ri)

    def _batched_source_parts(self, qh, phih, D: Derived) -> torch.Tensor:
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
        return self.field_source_parts(D, batch[0], batch[1], batch[2],
                                       batch[3], rb[0], rb[1])

    # ------------------------------------------------------------------
    # state construction / initialization (q_half-aware layouts)
    # ------------------------------------------------------------------
    def zero_state(self) -> WaveState:
        s = super().zero_state()
        if not self.q_half:
            return s
        # the q side's spectra in the half layout (this rank's block)
        zh = torch.zeros(self._qshape, dtype=self.cdtype, device=self.device)
        return s._replace(qh=zh, d=s.d._replace(ph=zh, qwh=zh))

    def apply_set_q(self, s: WaveState, q) -> WaveState:
        if not self.q_half:
            return super().apply_set_q(s, q)
        # invert with the carried phi and gradients, keep the carried wave
        # fields, refresh Ke
        qh = self._fwd_real(self._cast_field(q))
        D = self._invert_core(qh, s.d.phi, s.d.phix, s.d.phiy)
        return s._replace(qh=qh, d=D, Ke=self.ke_qg(D.ph))
