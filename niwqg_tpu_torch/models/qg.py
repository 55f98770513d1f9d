"""Standalone barotropic QG model with beta and an optional passive scalar
(port of ``niwqg_tpu/models/qg.py``).

The shared grid, transform and ETDRK4 machinery in the reference's
half-spectrum (real-FFT) layout, ``nk = nx//2+1``. On a mesh (``mesh=``
with the pencil transform as ``transform=``) the layout stays half but
carries ``rfft_pad`` zero columns (``Grid.pad``): spectral fields are this
rank's column block of ``nk + pad`` columns, physical fields its row block,
and every domain mean and maximum is one ``all_reduce``. The padded columns
hold k = 0 in every table and zero data, which the step keeps zero.

Faithfulness notes:
  - budget sources ``k1..k4`` are evaluated *after* each stage's inversion
    (the wave kernel samples before the update), and ``k1..k3`` pair the
    stale physical ``q`` of the step start (``qh_q`` under Parseval) while
    ``k4`` uses the fresh one;
  - the passive-scalar variance ``cvar`` integrates stage sources
    ``c1..c4`` with RK4 weights;
  - ``ep_c`` and ``chi_c`` use the *vorticity* diffusivity ``nu`` in their
    middle term, as the reference does;
  - the QG Jacobian does not zero the spectral mean mode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import complex_dtype, real_dtype, resolve_device
from ..etdrk4 import (build_coefs, fold_filter_into, linear_operator_c,
                      linear_operator_q)
from ..grid import Grid
from ..ops import qg_fused
from ..ops.fft import make_transform
from ..ops.spectral import mul_i
from ..parallel.mesh import all_max, all_sum
from ..utils.profiling import count


@dataclasses.dataclass(frozen=True)
class QGParams:
    """Reference defaults."""

    nx: int = 128
    L: float = 5e5
    dt: float = 10000.0
    tmax: float = 250000.0
    twrite: int = 1000
    cflmax: float = 0.5
    U: float = 0.0
    beta: float = 0.0
    nu4: float = 5.0e9
    nu: float = 0.0
    mu: float = 0.0
    passive_scalar: bool = False
    nu4c: float = 5.0e9
    nuc: float = 0.0
    muc: float = 0.0
    use_filter: bool = True
    dealias: bool = False
    tdiags: int = 10
    tsave_snapshots: int = 10
    # the quadratic budget means (ep_psi, ep_c, chi_c, Gamma_c) by Parseval
    # (Grid.spec_cross/spec_var): exact re-associations of the
    # physical-space means that need no transforms
    spectral_budgets: bool = True


class QGState(NamedTuple):
    t: torch.Tensor
    tc: int
    qh: torch.Tensor
    ch: torch.Tensor
    ph: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    c: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    Ke: torch.Tensor
    cvar: torch.Tensor


class QGKernel:
    """Static configuration + step of the standalone QG model."""

    def __init__(self, params: QGParams, dtype=np.float64,
                 backend: str = "auto", precision: str = "auto",
                 transform=None, transform_opts=None,
                 fold_filter: bool = False, device=None, mesh=None):
        self.params = params
        self.dtype = np.dtype(dtype)
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.rdtype = real_dtype(self.dtype)
        self.cdtype = complex_dtype(self.dtype)
        if transform is not None:
            self.tr = transform
        elif mesh is not None:
            raise ValueError("a mesh kernel takes its distributed transform "
                             "provider as transform=")
        else:
            self.tr = make_transform(params.nx, self.dtype, backend,
                                     precision=precision, device=self.device,
                                     **(transform_opts or {}))
        # the pencil rfft pads the spectral columns to a mesh-divisible
        # count; the grid mirrors that layout
        self.grid = Grid(nx=params.nx, L=params.L, dtype=self.dtype,
                         spectrum="half", use_filter=params.use_filter,
                         dealias=params.dealias, device=self.device,
                         pad=getattr(self.tr, "rfft_pad", 0), mesh=mesh)
        self._fwd, self._bwd = self.tr.rfft2, self.tr.irfft2
        p = params
        self.coefs_q = build_coefs(
            self.grid,
            linear_operator_q(self.grid, p.U, p.nu4, p.nu, p.mu, beta=p.beta),
            p.dt)
        self.coefs_c = build_coefs(
            self.grid, linear_operator_c(self.grid, p.nu4c, p.nuc, p.muc),
            p.dt) if p.passive_scalar else None
        # the stage filter pre-multiplied into the tables: off by default,
        # as in the JAX package
        self.fold_filter = bool(fold_filter)
        if self.fold_filter:
            f = self.grid.filtr
            self.coefs_q = fold_filter_into(self.coefs_q, f)
            if self.coefs_c is not None:
                self.coefs_c = fold_filter_into(self.coefs_c, f)
        # dt on the device, made once: a tensor made from a Python number
        # inside a step is a blocking copy from the host, and one that a
        # CUDA graph capture refuses
        self._dt = self._s(p.dt)
        # what the fused stage gaps read; the card's launch counters and
        # the kernels' workspace are made here, outside any capture
        self._qg_plan = self._fused_plan()

    def _fused_plan(self) -> qg_fused.Plan:
        """The grid, tables and physics as the fused stage gaps read them
        (``ops/qg_fused.py``)."""
        g, p = self.grid, self.params
        ws = (qg_fused.FAMILY.workspace(self.device, len(qg_fused.PARTS))
              if self.device.type == "cuda" else (None, None, 0))

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                   device=self.device)

        def rows(c):
            return None if c is None else type(c)(*[t.contiguous()
                                                    for t in c])

        return qg_fused.Plan(
            k=g.k[0].contiguous(), l=g.l[:, 0].contiguous(),
            kd=f64(g.spec_np(g.k_np)[0]), ld=f64(g.l_np[:, 0]),
            wv2i=g.wv2i.contiguous(),
            filtr=None if self.fold_filter else g.filtr.contiguous(),
            cq=rows(self.coefs_q), cc=rows(self.coefs_c),
            col0=0 if g.mesh is None else g.mesh.block(g.nk).start,
            nx=g.nx, nreal=g.nx // 2 + 1, owner=g.owns_mean_mode,
            sums=bool(p.spectral_budgets), nu4=float(p.nu4), mu=float(p.mu),
            nu=float(p.nu), inv_m2=1.0 / float(g.M) ** 2, partials=ws[0],
            arrivals=ws[1], blocks=ws[2])

    def _s(self, x) -> torch.Tensor:
        """A 0-d tensor of a Python number (construction only)."""
        return torch.tensor(x, dtype=self.rdtype, device=self.device)

    # -- domain means (one all_reduce on a mesh) ----------------------------
    def _mean(self, x) -> torch.Tensor:
        """The domain mean of a physical field (this rank's rows summed,
        then over the mesh)."""
        return all_sum(x.sum(), self.mesh) / float(self.grid.M)

    def ens(self, q):
        return 0.5 * self._mean(q * q)

    # -- spectral helpers (half-spectrum layout) ---------------------------
    def spec_var(self, zh):
        return self.grid.spec_var(zh)

    def _velocities(self, ph):
        return (self._bwd(mul_i(ph, -self.grid.l)),
                self._bwd(mul_i(ph, self.grid.k)))

    def _jacobian_hat(self, u, v, field):
        """ik*rfft(u*f) + il*rfft(v*f), no mean-mode zeroing."""
        g = self.grid
        return mul_i(self._fwd(u * field), g.k) + mul_i(self._fwd(v * field),
                                                        g.l)

    def _invert(self, qh):
        ph = -(qh * self.grid.wv2i)
        return ph, self._bwd(ph)

    def _invert_stage(self, qh):
        """Stage inversion; under ``spectral_budgets`` nothing between
        stages consumes the physical ``p``, so it is not transformed."""
        if self.params.spectral_budgets:
            return -(qh * self.grid.wv2i), None
        return self._invert(qh)

    def ep_psi(self, q, p, qh, ph, qh_q=None):
        """Stages 1-3 pair the step start's stale physical ``q`` (under
        ``spectral_budgets`` its transform ``qh_q``) with a fresh ``p``;
        the dissipation terms pair the fresh ``qh``/``ph``."""
        g, pr = self.grid, self.params
        if pr.spectral_budgets:
            if qh_q is None:
                qh_q = qh
            # nu4 mean(q lap²ψ) + mu mean(p q): (qh_q, ph) pairings;
            # −nu mean(p lap q) = +nu Σ w wv2 Re(conj(qh) ph)/M²
            s = g.spec_cross(qh_q, ph * (pr.nu4 * g.wv4 + pr.mu))
            if pr.nu:
                s = s + pr.nu * g.spec_cross(qh, ph * g.wv2)
            return s
        lap2psi = self._bwd(ph * g.wv4)
        lapq = self._bwd(-(qh * g.wv2))
        return (pr.nu4 * self._mean(q * lap2psi)
                - pr.nu * self._mean(p * lapq) + pr.mu * self._mean(p * q))

    def ep_c_stage(self, ch):
        """Per-stage tracer-variance source; transform-free under
        ``spectral_budgets``."""
        if not self.params.spectral_budgets:
            C2, gradC2, lapc, _ = self._scalar_derived(ch, None, None)
            return self.ep_c(C2, gradC2, lapc)
        g, pr = self.grid, self.params
        C2 = self.spec_var(ch)
        gradC2 = self.spec_var(ch * g.wv)
        lapc2 = self.spec_var(ch * g.wv2)   # mean(lapc²): lapc is zero-mean
        return (-2.0 * pr.nu4c * lapc2 - 2.0 * pr.nu * gradC2
                - 2.0 * pr.muc * C2)

    def _scalar_derived(self, ch, u, v, c=None):
        """C2, gradC2, lapc (or, under ``spectral_budgets``, ``mean(lapc²)``,
        what every consumer reduces it to) and Gamma_c; ``c`` is the carried
        physical field."""
        g = self.grid
        C2 = self.spec_var(ch)
        gradC2 = self.spec_var(ch * g.wv)
        if self.params.spectral_budgets:
            lapc2 = self.spec_var(ch * g.wv2)
            if u is None:
                return C2, gradC2, lapc2, None
            jac_c = self._jacobian_hat(u, v, c)
            Gamma_c = 2.0 * g.spec_cross(-(ch * g.wv2), jac_c)
            return C2, gradC2, lapc2, Gamma_c
        lapc = self._bwd(-(ch * g.wv2))
        if u is None:
            return C2, gradC2, lapc, None
        c = self._bwd(ch) if c is None else c
        jac_c = self._jacobian_hat(u, v, c)
        Gamma_c = 2.0 * self._mean(lapc * self._bwd(jac_c))
        return C2, gradC2, lapc, Gamma_c

    def ep_c(self, C2, gradC2, lapc):
        """Middle term on ``nu``, not ``nuc``, as in the reference.
        ``lapc`` is the physical field or ``mean(lapc²)``."""
        pr = self.params
        lapc2 = lapc if lapc.dim() == 0 else self._mean(lapc**2)
        return (-2.0 * pr.nu4c * lapc2 - 2.0 * pr.nu * gradC2
                - 2.0 * pr.muc * C2)

    def chi_c(self, ch, gradC2, lapc):
        g, pr = self.grid, self.params
        if pr.spectral_budgets:
            # mean(lap²c lapc) = −Σ w wv2 wv4 |ch|²/M²
            lapc2 = lapc if lapc.dim() == 0 else self.spec_var(ch * g.wv2)
            cross = -g.spec_cross(ch * g.wv4, ch * g.wv2)
            return (2.0 * pr.nu4c * cross - 2.0 * pr.nu * lapc2
                    - 2.0 * pr.muc * gradC2)
        lap2c = self._bwd(ch * g.wv4)
        return (2.0 * pr.nu4c * self._mean(lap2c * lapc)
                - 2.0 * pr.nu * self._mean(lapc**2) - 2.0 * pr.muc * gradC2)

    def chi_q(self, qh):
        return -self.params.nu4 * self.spec_var(qh * self.grid.wv2)

    def ke_qg(self, ph):
        return 0.5 * self.spec_var(ph * self.grid.wv)

    # -- one ETDRK4 step -----------------------------------------------------
    def _stage_rhs(self, ph, qh, ch: Optional[torch.Tensor]):
        """One stage's nonlinear terms: ``u``, ``v``, ``q`` (and ``c``) in
        one batched inverse, the Jacobian products in one batched
        forward (the plain step's; on host tensors counted as a stage the
        fused kernels' plain version served)."""
        g = self.grid
        if ph.device.type == "cpu":
            qg_fused.FAMILY.plain_call("stage")
        specs = [mul_i(ph, -g.l), mul_i(ph, g.k), qh]
        if ch is not None:
            specs.append(ch)
        gb = self._bwd(torch.stack(specs))
        u, v, q = gb[0], gb[1], gb[2]
        prods = [u * q, v * q]
        if ch is not None:
            prods += [u * gb[3], v * gb[3]]
        fj = self._fwd(torch.stack(prods))
        jac_q = mul_i(fj[0], g.k) + mul_i(fj[1], g.l)
        jac_c = (mul_i(fj[2], g.k) + mul_i(fj[3], g.l)
                 if ch is not None else None)
        return jac_q, jac_c, u, v

    @staticmethod
    def _mulf(x, f):
        return x if f is None else x * f

    def step(self, s: QGState, plain=None) -> QGState:
        """One ETDRK4 step. On the card each gap between the stages'
        transforms is one kernel of ``ops/qg_fused.py``
        (:meth:`_step_fused`); on host tensors the plain chain below
        (``plain``, by default, is whether the tensors are the host's;
        ``plain=True`` on the card is the oracle the kernels are held
        to)."""
        if plain is None:
            plain = s.qh.device.type == "cpu"
        if not plain:
            return self._step_fused(s)
        pr = self.params
        cq, cc = self.coefs_q, self.coefs_c
        flt = None if self.fold_filter else self.grid.filtr
        mulf = self._mulf
        dt = self._dt
        scalar = pr.passive_scalar

        # stage 1
        qh0, ch0 = s.qh, s.ch
        jac, jacc, u, v = self._stage_rhs(s.ph, s.qh, ch0 if scalar else None)
        Fn0 = -jac
        qh = mulf(cq.expch_h * qh0 + Fn0 * cq.Qh, flt)
        qh1 = qh
        ch = ch0
        if scalar:
            Fn0c = -jacc
            ch = mulf(cc.expch_h * ch0 + Fn0c * cc.Qh, flt)
            ch1 = ch
            c1 = self.ep_c_stage(ch)
        ph, p = self._invert_stage(qh)
        k1 = self.ep_psi(s.q, p, qh, ph, qh_q=s.qh)

        # stage 2
        jac, jacc, u, v = self._stage_rhs(ph, qh, ch if scalar else None)
        Fna = -jac
        qh = mulf(cq.expch_h * qh0 + Fna * cq.Qh, flt)
        if scalar:
            Fnac = -jacc
            ch = mulf(cc.expch_h * ch0 + Fnac * cc.Qh, flt)
            c2 = self.ep_c_stage(ch)
        ph, p = self._invert_stage(qh)
        k2 = self.ep_psi(s.q, p, qh, ph, qh_q=s.qh)

        # stage 3
        jac, jacc, u, v = self._stage_rhs(ph, qh, ch if scalar else None)
        Fnb = -jac
        qh = mulf(cq.expch_h * qh1 + (2.0 * Fnb - Fn0) * cq.Qh, flt)
        if scalar:
            Fnbc = -jacc
            ch = mulf(cc.expch_h * ch1 + (2.0 * Fnbc - Fn0c) * cc.Qh, flt)
            c3 = self.ep_c_stage(ch)
        ph, p = self._invert_stage(qh)
        k3 = self.ep_psi(s.q, p, qh, ph, qh_q=s.qh)

        # stage 4 + final combination
        jac, jacc, u, v = self._stage_rhs(ph, qh, ch if scalar else None)
        Fnc = -jac
        qh = mulf(cq.expch * qh0 + Fn0 * cq.f0 + 2.0 * (Fna + Fnb) * cq.fab
                  + Fnc * cq.fc, flt)
        cvar = s.cvar
        if scalar:
            Fncc = -jacc
            ch = mulf(cc.expch * ch0 + Fn0c * cc.f0
                      + 2.0 * (Fnac + Fnbc) * cc.fab + Fncc * cc.fc, flt)
            c4 = self.ep_c_stage(ch)
            cvar = s.cvar + dt * (c1 + 2.0 * (c2 + c3) + c4) / 6.0

        # final inversion + physical fields (one batched inverse)
        ph = -(qh * self.grid.wv2i)
        fb = self._bwd(torch.stack([ph, qh] + ([ch] if scalar else [])))
        p, q = fb[0], fb[1]
        cphys = fb[2] if scalar else s.c
        k4 = self.ep_psi(q, p, qh, ph)
        Ke = s.Ke + dt * (k1 + 2.0 * (k2 + k3) + k4) / 6.0
        return QGState(t=s.t + dt, tc=s.tc + 1, qh=qh, ch=ch, ph=ph, p=p,
                       q=q, c=cphys, u=u, v=v, Ke=Ke, cvar=cvar)

    def _step_fused(self, s: QGState) -> QGState:
        """:meth:`step` on the card: stage 1's batch packed from the
        state, then a stage is its batched inverse, ``qg_fused.products``,
        its batched forward and ``qg_fused.stage`` (the Jacobian, the
        update, the inversion, the budget partials and the next inverse's
        batch). Bit for bit the plain chain's fields; the budgets sum the
        same terms in another order."""
        count("step.qg_fused")
        pr, P, dt = self.params, self._qg_plan, self._dt
        scalar, spectral = pr.passive_scalar, pr.spectral_budgets
        ch0 = s.ch if scalar else None
        batch = qg_fused.pack(P, s.ph, s.qh, ch0)
        ks, cs, fns, base1 = [], [], [], None
        for n in (1, 2, 3, 4):
            gb = self._bwd(batch)
            fj = self._fwd(qg_fused.products(P, gb))
            batch, fn, parts, ph = qg_fused.stage(
                P, n, fj, base1 if n == 3 else (s.qh, ch0),
                qh_q=s.qh if n == 3 else None,
                fns=((fns[0], fns[1]) if n == 3 else (fns[0], fns[2])
                     if n == 4 else (None, None)),
                ph=not spectral)
            fns.append(fn)
            # the batch: [-il ph, ik ph, qh (, ch)], stage 4 [ph, qh (, ch)]
            qh = batch[1] if n == 4 else batch[2]
            ch = batch[-1] if scalar else s.ch
            if n == 1:  # stage 3's start
                base1 = (qh, ch if scalar else None)
            if scalar:
                cs.append(self._c_source(parts) if spectral
                          else self.ep_c_stage(ch))
            if n < 4:
                ks.append(self._psi_source(parts) if spectral else
                          self.ep_psi(s.q, self._bwd(ph), qh, ph,
                                      qh_q=s.qh))
        u, v = gb[0], gb[1]
        # the final inverse: stage 4's batch [ph, qh (, ch)]
        fb = self._bwd(batch)
        p, q = fb[0], fb[1]
        cphys = fb[2] if scalar else s.c
        ks.append(self._psi_source(parts) if spectral
                  else self.ep_psi(q, p, qh, ph))
        k1, k2, k3, k4 = ks
        Ke = s.Ke + dt * (k1 + 2.0 * (k2 + k3) + k4) / 6.0
        cvar = s.cvar
        if scalar:
            c1, c2, c3, c4 = cs
            cvar = s.cvar + dt * (c1 + 2.0 * (c2 + c3) + c4) / 6.0
        return QGState(t=s.t + dt, tc=s.tc + 1, qh=qh, ch=ch, ph=ph, p=p,
                       q=q, c=cphys, u=u, v=v, Ke=Ke, cvar=cvar)

    def _c_source(self, parts):
        """:meth:`ep_c_stage` from a stage's budget partials."""
        return self.ep_c(*(all_sum(parts[i], self.mesh) for i in range(3)))

    def _psi_source(self, parts):
        """:meth:`ep_psi` from a stage's budget partials."""
        s = all_sum(parts[3], self.mesh)
        if self.params.nu:
            s = s + self.params.nu * all_sum(parts[4], self.mesh)
        return s

    # -- initialization ------------------------------------------------------
    def zero_state(self) -> QGState:
        """A zero state of this rank's blocks."""
        g = self.grid
        z = torch.zeros(g.spec_shape, dtype=self.cdtype, device=self.device)
        r = torch.zeros(g.phys_shape, dtype=self.rdtype, device=self.device)
        zero = torch.zeros((), dtype=self.rdtype, device=self.device)
        return QGState(t=zero, tc=0, qh=z, ch=z, ph=z, p=r, q=r, c=r, u=r,
                       v=r, Ke=zero, cvar=zero)

    def _cast_field(self, q, real=False) -> torch.Tensor:
        """A global host field (or a ``multihost.make_global_field``
        block) on the device, cut to this rank's rows; ``real`` keeps the
        real part of a complex one."""
        q = np.asarray(self.grid.phys_np(q))
        if real:
            q = np.real(q)
        return torch.as_tensor(
            np.ascontiguousarray(q.astype(self.dtype, copy=False)),
            device=self.device)

    def apply_set_q(self, s: QGState, q) -> QGState:
        q = self._cast_field(q)
        qh = self._fwd(q)
        ph, p = self._invert(qh)
        return s._replace(qh=qh, ph=ph, p=p, q=q, Ke=self.ke_qg(ph))

    def apply_set_c(self, s: QGState, c) -> QGState:
        """``set_c`` keeps the real part of its argument (the reference
        relied on numpy discarding it silently)."""
        c = self._cast_field(c, real=True)
        ch = self._fwd(c)
        return s._replace(ch=ch, c=c, cvar=self.spec_var(ch))

    def cfl(self, s: QGState):
        u, v = self._velocities(s.ph)
        m = all_max(torch.maximum(u.abs().max(), v.abs().max()), self.mesh)
        return m * self.params.dt / self.grid.dx
