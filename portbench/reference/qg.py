"""Plain reference of the upstream's standalone barotropic QG model with
beta, a mean flow and a passive scalar (``niwqg`` ``QGModel``).

Written from the upstream's equations: the inversion ``ph = -qh/wv2``;
``q_t + J(psi, q) + beta psi_x = -U q_x`` with hyperviscosity, viscosity
and drag (``nu4``, ``nu``, ``mu``); ``c_t + J(psi, c)`` with the scalar's
own hyperdiffusion, diffusion and drag (``nu4c``, ``nuc``, ``muc``; its
linear operator has no mean flow, as the upstream's). Both are stepped
with ETDRK4 (Cox & Matthews 2002) on the contour-mean coefficients of
``coupled.py``, with the upstream's exponential filter after every stage,
and the energy and tracer-variance budgets ``Ke`` and ``cvar`` are
integrated from stage sources as the upstream does. Spectral fields are
the half spectrum of ``torch.fft.rfft2`` (the upstream's layout), real
fields ``irfft2``; the domain means of the budgets are taken in physical
space, as the upstream takes them. Nothing here imports the program under
test: the grid, the tables, the filter and the inversion are worked out
again from the configuration.

The upstream's departures from the textbook scheme are kept, each noted
where it is written: the budget sources after each stage's inversion,
with the step's stale physical ``q`` in ``k1..k3``; ``cvar`` from the
stage sources ``c1..c4`` with RK4 weights; ``nu`` (not ``nuc``) in the
middle terms of ``ep_c`` and ``chi_c``; no mean-mode zeroing in the
Jacobian; ``Gamma_c`` with the velocities of the step's last stage.

Two precisions, as ``coupled.py``'s (:class:`coupled.Arith`): ``"f64"``,
the reference itself, and ``"bf16"``, the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .coupled import FILTER_COEF, FILTER_CUT, FILTER_ORDER, Arith, _etdrk4

# the prognostic fields, in the upstream's set_q/set_c order, and the
# budget integrals a state carries
FIELDS = ("q", "c")
BUDGETS = ("Ke", "cvar")


class Params(NamedTuple):
    nx: int
    L: float
    dt: float
    U: float
    beta: float
    nu4: float
    nu: float
    mu: float
    nu4c: float
    nuc: float
    muc: float
    use_filter: bool


# the upstream QGModel's defaults
PARAM_DEFAULTS = dict(U=0.0, beta=0.0, nu4=5.0e9, nu=0.0, mu=0.0,
                      nu4c=5.0e9, nuc=0.0, muc=0.0, use_filter=True)


def params_from(model_kwargs: dict) -> Params:
    """The physics of a configuration's model keywords (the upstream
    model's defaults for those it leaves out). The reference always
    carries the scalar, and has only the exponential filter."""
    if not model_kwargs.get("passive_scalar", False):
        raise ValueError("the QG reference needs passive_scalar=True")
    if model_kwargs.get("dealias", False) and not model_kwargs.get(
            "use_filter", True):
        raise ValueError("the QG reference has no 2/3-rule dealiasing")
    kw = dict(PARAM_DEFAULTS)
    kw.update({k: model_kwargs[k] for k in Params._fields
               if k in model_kwargs})
    return Params(**{k: kw[k] for k in Params._fields})


class Tables:
    """Half-spectrum wavenumbers, weights, filter and ETDRK4
    coefficients on one device."""

    def __init__(self, p: Params, device, A: Arith):
        nx = p.nx
        f64 = dict(dtype=torch.float64, device=device)
        dk = 2.0 * math.pi / p.L
        ll = dk * torch.cat([torch.arange(0, nx // 2, **f64),
                             torch.arange(-(nx // 2), 0, **f64)])
        kk = dk * torch.arange(0, nx // 2 + 1, **f64)
        l, k = torch.meshgrid(ll, kk, indexing="ij")  # rows l, columns k
        wv2 = k * k + l * l
        wv2i = torch.where(wv2 > 0, 1.0 / torch.where(wv2 > 0, wv2, 1.0),
                           0.0)
        dx = p.L / nx
        if p.use_filter:
            wvx = torch.sqrt((k * dx) ** 2 + (l * dx) ** 2)
            filtr = torch.where(
                wvx > FILTER_CUT,
                torch.exp(-FILTER_COEF * (wvx - FILTER_CUT) ** FILTER_ORDER),
                1.0)
        else:
            filtr = torch.ones_like(wv2)
        # q_t = -U q_x - beta psi_x + ..., psi_x = -i k qh / wv2
        c_q = (-1j * k * p.U + 1j * p.beta * k * wv2i - p.nu4 * wv2 * wv2
               - p.nu * wv2 - p.mu)
        c_c = (-p.nu4c * wv2 * wv2 - p.nuc * wv2 - p.muc).to(
            torch.complex128)
        # a half spectrum's weights in a sum over the whole spectrum: the
        # columns k = 0 and k = nx/2 are their own mirrors, the others
        # stand for two
        w = torch.full_like(wv2, 2.0)
        w[:, 0] = 1.0
        w[:, nx // 2] = 1.0
        self.M = nx * nx
        self.nx = nx
        self.ik = A.r((1j * k).to(A.cdtype))
        self.il = A.r((1j * l).to(A.cdtype))
        rd = A.rdtype
        self.w = w.to(rd)
        self.wv = A.r(torch.sqrt(wv2).to(rd))
        self.wv2 = A.r(wv2.to(rd))
        self.wv4 = A.r((wv2 * wv2).to(rd))
        self.wv2i = A.r(wv2i.to(rd))
        self.filtr = A.r(filtr.to(rd))
        self.eq = _etdrk4(c_q, p.dt, A)
        self.ec = _etdrk4(c_c, p.dt, A)


class State(NamedTuple):
    qh: torch.Tensor
    ch: torch.Tensor
    q: torch.Tensor       # physical q (set_q's field, or irfft2(qh))
    c: torch.Tensor
    ph: torch.Tensor
    p: torch.Tensor
    u: Optional[torch.Tensor]  # the last stage's velocities (None before
    v: Optional[torch.Tensor]  # a step)
    Ke: torch.Tensor
    cvar: torch.Tensor


class Reference:
    """The QG model's step and diagnostics in one precision."""

    def __init__(self, params: Params, device, mode: str = "f64"):
        # a float32 product on the card must not run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.A = Arith(mode)
        self.p = params
        self.T = Tables(params, device, self.A)

    # -- transforms and means ------------------------------------------------
    def rfft2(self, x):
        return self.A.r(torch.fft.rfft2(x.to(self.A.rdtype)))

    def irfft2(self, zh):
        return self.A.r(torch.fft.irfft2(zh, s=(self.T.nx, self.T.nx)))

    def mean(self, x):
        return self.A.r(x.mean())

    def spec_var(self, zh):
        """The variance of a real field from its half spectrum, the mean
        mode left out (the upstream's rfft ``spec_var``)."""
        v = self.T.w * (zh.real * zh.real + zh.imag * zh.imag)
        v[0, 0] = 0
        return self.A.r(v.sum() / float(self.T.M) ** 2)

    # -- the step's pieces -----------------------------------------------------
    def invert(self, qh):
        """``ph = -qh / wv2`` (zero at the mean mode) and ``psi``."""
        ph = self.A.r(-(qh * self.T.wv2i))
        return ph, self.irfft2(ph)

    def velocities(self, ph):
        T = self.T
        return (self.irfft2(self.A.r(-T.il * ph)),
                self.irfft2(self.A.r(T.ik * ph)))

    def jacobian(self, u, v, f):
        """The transform of ``J(psi, f) = u f_x + v f_y`` in flux form,
        ``ik rfft(u f) + il rfft(v f)``; the upstream zeroes no mean
        mode here (its ``ik``, ``il`` vanish there anyway)."""
        A, T = self.A, self.T
        return A.r(T.ik * self.rfft2(A.r(u * f))
                   + T.il * self.rfft2(A.r(v * f)))

    def ep_psi(self, q, p, qh, ph):
        """``nu4 <q lap^2 psi> - nu <psi lap q> + mu <psi q>``; the step's
        stages 1-3 pass the stale ``q`` of the step's start (upstream)."""
        A, T, pr = self.A, self.T, self.p
        lap2psi = self.irfft2(A.r(ph * T.wv4))
        lapq = self.irfft2(A.r(-(qh * T.wv2)))
        return A.r(pr.nu4 * self.mean(A.r(q * lap2psi))
                   - pr.nu * self.mean(A.r(p * lapq))
                   + pr.mu * self.mean(A.r(p * q)))

    def lapc(self, ch):
        return self.irfft2(self.A.r(-(ch * self.T.wv2)))

    def ep_c(self, ch):
        """``-2 nu4c <lapc^2> - 2 nu <|grad c|^2> - 2 muc <c^2>``: the
        middle term on ``nu``, the vorticity's, as the upstream writes it."""
        A, T, pr = self.A, self.T, self.p
        lapc = self.lapc(ch)
        C2, gradC2 = self.spec_var(ch), self.spec_var(A.r(ch * T.wv))
        return A.r(-2.0 * pr.nu4c * self.mean(A.r(lapc * lapc))
                   - 2.0 * pr.nu * gradC2 - 2.0 * pr.muc * C2)

    def chi_c(self, ch):
        """``2 nu4c <lap^2 c lapc> - 2 nu <lapc^2> - 2 muc <|grad c|^2>``,
        ``nu`` again the vorticity's (upstream)."""
        A, T, pr = self.A, self.T, self.p
        lapc = self.lapc(ch)
        lap2c = self.irfft2(A.r(ch * T.wv4))
        gradC2 = self.spec_var(A.r(ch * T.wv))
        return A.r(2.0 * pr.nu4c * self.mean(A.r(lap2c * lapc))
                   - 2.0 * pr.nu * self.mean(A.r(lapc * lapc))
                   - 2.0 * pr.muc * gradC2)

    def ke_qg(self, ph):
        return self.A.r(0.5 * self.spec_var(self.A.r(ph * self.T.wv)))

    # -- one ETDRK4 step -------------------------------------------------------
    def step(self, s: State) -> State:
        A, T, p = self.A, self.T, self.p
        eq, ec, flt = T.eq, T.ec, T.filtr

        def rhs(ph, qh, ch):
            """A stage's nonlinear terms ``-J(psi, q)``, ``-J(psi, c)``
            and the velocities they used."""
            u, v = self.velocities(ph)
            return (A.r(-self.jacobian(u, v, self.irfft2(qh))),
                    A.r(-self.jacobian(u, v, self.irfft2(ch))), u, v)

        def upd(c, base, F, into):
            return A.r((c * base + F * into) * flt)

        def stage_sources(qh, ch):
            """The budgets' sources after a stage's inversion (the
            upstream samples them there, not before the update), ``k``
            with the step's stale ``q``."""
            ph, p_ = self.invert(qh)
            return ph, self.ep_psi(s.q, p_, qh, ph), self.ep_c(ch)

        qh0, ch0 = s.qh, s.ch
        Fn0, Fn0c, _, _ = rhs(s.ph, qh0, ch0)
        qh1 = upd(eq.expch_h, qh0, Fn0, eq.Qh)
        ch1 = upd(ec.expch_h, ch0, Fn0c, ec.Qh)
        ph1, k1, c1 = stage_sources(qh1, ch1)

        Fna, Fnac, _, _ = rhs(ph1, qh1, ch1)
        qh2 = upd(eq.expch_h, qh0, Fna, eq.Qh)
        ch2 = upd(ec.expch_h, ch0, Fnac, ec.Qh)
        ph2, k2, c2 = stage_sources(qh2, ch2)

        Fnb, Fnbc, _, _ = rhs(ph2, qh2, ch2)
        qh3 = upd(eq.expch_h, qh1, A.r(2.0 * Fnb - Fn0), eq.Qh)
        ch3 = upd(ec.expch_h, ch1, A.r(2.0 * Fnbc - Fn0c), ec.Qh)
        ph3, k3, c3 = stage_sources(qh3, ch3)

        Fnc, Fncc, u, v = rhs(ph3, qh3, ch3)
        qh = A.r((eq.expch * qh0 + Fn0 * eq.f0 + 2.0 * (Fna + Fnb) * eq.fab
                  + Fnc * eq.fc) * flt)
        ch = A.r((ec.expch * ch0 + Fn0c * ec.f0
                  + 2.0 * (Fnac + Fnbc) * ec.fab + Fncc * ec.fc) * flt)
        # cvar: the stage sources c1..c4 with RK4 weights (upstream)
        cvar = A.r(s.cvar + p.dt * (c1 + 2.0 * (c2 + c3) + self.ep_c(ch))
                   / 6.0)

        ph, psi = self.invert(qh)
        q, c = self.irfft2(qh), self.irfft2(ch)
        # k4 with the fresh q
        k4 = self.ep_psi(q, psi, qh, ph)
        Ke = A.r(s.Ke + p.dt * (k1 + 2.0 * (k2 + k3) + k4) / 6.0)
        return State(qh, ch, q, c, ph, psi, u, v, Ke, cvar)

    # -- states ----------------------------------------------------------------
    def _state(self, q, c, Ke, cvar) -> State:
        A = self.A
        q, c = A.r(q.to(A.rdtype)), A.r(c.to(A.rdtype))
        qh, ch = self.rfft2(q), self.rfft2(c)
        ph, p = self.invert(qh)
        as_r = lambda x: A.r(torch.as_tensor(x, dtype=A.rdtype,  # noqa
                                             device=qh.device))
        return State(qh, ch, q, c, ph, p, None, None,
                     as_r(self.ke_qg(ph) if Ke is None else Ke),
                     as_r(self.spec_var(ch) if cvar is None else cvar))

    def start(self, q, c) -> State:
        """The state after the upstream's ``set_q(q)`` (``Ke`` the kinetic
        energy of its inversion) then ``set_c(c)`` (``cvar`` its
        variance)."""
        return self._state(q, c, None, None)

    def resume(self, q, c, Ke, cvar) -> State:
        """A state mid-run, from its physical fields and budget
        integrals."""
        return self._state(q, c, Ke, cvar)

    # -- diagnostics -----------------------------------------------------------
    def diagnostics(self, s: State) -> dict:
        """The upstream ``QGModel``'s scalar diagnostics of a state after a
        step. ``Gamma_c`` pairs the fresh ``c`` with the velocities of the
        step's last stage, which the upstream keeps as the model's ``u``,
        ``v`` (its final inversion makes none)."""
        A, T, p = self.A, self.T, self.p
        lapc = self.lapc(s.ch)
        J = self.irfft2(self.jacobian(s.u, s.v, s.c))
        out = dict(
            Ke=s.Ke, cvar=s.cvar,
            ke_qg=self.ke_qg(s.ph),
            ens=0.5 * self.mean(A.r(s.q * s.q)),
            ep_psi=self.ep_psi(s.q, s.p, s.qh, s.ph),
            chi_q=-p.nu4 * self.spec_var(A.r(s.qh * T.wv2)),
            C2=self.spec_var(s.ch),
            gradC2=self.spec_var(A.r(s.ch * T.wv)),
            Gamma_c=2.0 * self.mean(A.r(lapc * J)),
            ep_c=self.ep_c(s.ch),
            chi_c=self.chi_c(s.ch),
        )
        return {k: A.r(torch.as_tensor(v)).to(torch.float64)
                for k, v in out.items()}


def run_segment(ref: Reference, s: State, nsteps: int, tdiags: int,
                tc0: int):
    """``nsteps`` steps from ``s``, whose step counter is ``tc0``; after
    every step whose pre-step counter is a multiple of ``tdiags`` the
    diagnostics of the new state, as the upstream's run loop samples them.
    Returns the last state and ``{name: [samples]}``."""
    series: dict = {}
    for i in range(nsteps):
        s = ref.step(s)
        if (tc0 + i) % tdiags == 0:
            for k, v in ref.diagnostics(s).items():
                series.setdefault(k, []).append(v)
    return s, {k: torch.stack(v).cpu() for k, v in series.items()}


def physical(s: State) -> dict:
    """``q`` and ``c`` of a state, in float64 on the host."""
    return {"q": s.q.to(torch.float64).cpu().numpy(),
            "c": s.c.to(torch.float64).cpu().numpy()}
