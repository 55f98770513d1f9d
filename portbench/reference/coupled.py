"""Plain reference of the Xie & Vanneste (2015) coupled NIW-QG model.

Written from the equations of the upstream ``niwqg`` package
(``CoupledModel``: the wave equation, the QG vorticity equation and the
coupled inversion with the wave potential vorticity), stepped with ETDRK4
(Cox & Matthews 2002) whose coefficients are the Kassam & Trefethen (2005)
contour means, with the upstream's exponential filter after every stage and
its stage-interleaved RK4 integration of the energy budgets (Ke, Pw, Kw).
Every spectral field is the full complex spectrum of ``torch.fft.fft2``;
real fields are the real parts of ``ifft2``. Nothing here imports the
program under test: the grid, the tables, the filter and the inversion are
worked out again from the configuration.

Two precisions (:class:`Arith`): ``"f64"``, the reference itself, and
``"bf16"``, the control: every field is stored in bfloat16 (each computed
field is rounded to it; the transforms run in float32 on the rounded
values), the nearest precision below the float32 that the configurations
state that changes the arithmetic of FFTs and elementwise work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# the upstream filter: exp(-23.6 (|k dx| - 0.65 pi)^4) above the cutoff
FILTER_ORDER, FILTER_COEF, FILTER_CUT = 4, 23.6, 0.65 * math.pi
CONTOUR_POINTS = 32  # Kassam & Trefethen's M, radius 1
# the prognostic fields, in the upstream's set_q/set_phi order, and the
# budget integrals a state carries
FIELDS = ("q", "phi")
BUDGETS = ("Ke", "Pw", "Kw")


class Arith:
    """Precision policy: dtypes and the rounding of every stored field."""

    def __init__(self, mode: str = "f64"):
        if mode not in ("f64", "bf16"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        wide = mode == "f64"
        self.rdtype = torch.float64 if wide else torch.float32
        self.cdtype = torch.complex128 if wide else torch.complex64

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as this precision stores it."""
        if self.mode == "f64":
            return x
        if x.is_complex():
            return torch.complex(x.real.bfloat16().float(),
                                 x.imag.bfloat16().float())
        return x.bfloat16().float()

    def fft2(self, x):
        return self.r(torch.fft.fft2(x.to(self.cdtype)))

    def ifft2(self, x):
        return self.r(torch.fft.ifft2(x))

    def rifft2(self, x):
        """The real part of the inverse transform."""
        return self.r(torch.fft.ifft2(x).real)


class Params(NamedTuple):
    nx: int
    L: float
    dt: float
    f: float
    N: float
    m: float
    nu4: float
    nu4w: float
    nu: float
    nuw: float
    mu: float
    muw: float
    U: float
    use_filter: bool

    @property
    def kappa2(self) -> float:
        return (self.m * self.f / self.N) ** 2

    @property
    def hslash(self) -> float:
        return self.f / self.kappa2


PARAM_DEFAULTS = dict(nu=20.0, nuw=50.0, mu=0.0, muw=0.0, U=0.0,
                      use_filter=True)


def params_from(model_kwargs: dict) -> Params:
    """The physics of a configuration's model keywords (the upstream
    model's defaults for those it leaves out)."""
    kw = dict(PARAM_DEFAULTS)
    kw.update({k: model_kwargs[k] for k in Params._fields
               if k in model_kwargs})
    return Params(**{k: kw[k] for k in Params._fields})


class Tables:
    """Wavenumbers, filter and ETDRK4 coefficients on one device."""

    def __init__(self, p: Params, device, A: Arith):
        nx = p.nx
        f64 = dict(dtype=torch.float64, device=device)
        dk = 2.0 * math.pi / p.L
        kk = dk * torch.cat([torch.arange(0, nx // 2, **f64),
                             torch.arange(-(nx // 2), 0, **f64)])
        l, k = torch.meshgrid(kk, kk, indexing="ij")  # rows l, columns k
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
        c_q = (-1j * k * p.U - p.nu4 * wv2 * wv2 - p.nu * wv2 - p.mu)
        c_w = (-1j * k * p.U - p.nu4w * wv2 * wv2
               - 0.5j * p.f * wv2 / p.kappa2 - p.nuw * wv2 - p.muw)
        self.M = nx * nx
        self.ik = A.r((1j * k).to(A.cdtype))
        self.il = A.r((1j * l).to(A.cdtype))
        rd = A.rdtype
        self.wv = A.r(torch.sqrt(wv2).to(rd))
        self.wv2 = A.r(wv2.to(rd))
        self.wv4 = A.r((wv2 * wv2).to(rd))
        self.wv2i = A.r(wv2i.to(rd))
        self.filtr = A.r(filtr.to(rd))
        self.eq = _etdrk4(c_q, p.dt, A)
        self.ew = _etdrk4(c_w, p.dt, A)


class Coefs(NamedTuple):
    expch: torch.Tensor
    expch_h: torch.Tensor
    Qh: torch.Tensor
    f0: torch.Tensor
    fab: torch.Tensor
    fc: torch.Tensor


def _etdrk4(c: torch.Tensor, dt: float, A: Arith, rows: int = 64) -> Coefs:
    """ETDRK4 coefficients of the linear operator ``c`` (complex128): the
    phi-functions as means over ``CONTOUR_POINTS`` points of the unit
    circle around each ``c*dt`` (Kassam & Trefethen 2005), in blocks of
    rows."""
    ch = (c * dt).to(torch.complex128)
    M = CONTOUR_POINTS
    r = torch.exp(2j * math.pi * torch.arange(1, M + 1, dtype=torch.float64,
                                              device=c.device) / M)
    outs = [torch.empty_like(ch) for _ in range(4)]
    for j in range(0, ch.shape[0], rows):
        LR = ch[j:j + rows, :, None] + r
        LR2, eLR = LR * LR, torch.exp(LR)
        LR3 = LR2 * LR
        outs[0][j:j + rows] = dt * ((torch.exp(LR / 2) - 1) / LR).mean(-1)
        outs[1][j:j + rows] = dt * ((-4 - LR + eLR * (4 - 3 * LR + LR2))
                                    / LR3).mean(-1)
        outs[2][j:j + rows] = dt * ((2 + LR + eLR * (-2 + LR))
                                    / LR3).mean(-1)
        outs[3][j:j + rows] = dt * ((-4 - 3 * LR - LR2 + eLR * (4 - LR))
                                    / LR3).mean(-1)
        del LR, LR2, LR3, eLR
    cast = lambda t: A.r(t.to(A.cdtype))  # noqa: E731
    return Coefs(cast(torch.exp(ch)), cast(torch.exp(ch / 2)),
                 *[cast(t) for t in outs])


class Fields(NamedTuple):
    """Fields derived from ``(qh, phih)`` after every stage."""

    ph: torch.Tensor     # streamfunction spectrum
    p: torch.Tensor      # streamfunction
    q: torch.Tensor      # potential vorticity
    q_psi: torch.Tensor  # relative vorticity q - qw
    qwh: torch.Tensor    # wave potential vorticity spectrum
    phi: torch.Tensor
    phix: torch.Tensor
    phiy: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class State(NamedTuple):
    qh: torch.Tensor
    phih: torch.Tensor
    d: Fields
    Ke: torch.Tensor
    Pw: torch.Tensor
    Kw: torch.Tensor


def _zero_mean(zh):
    out = zh.clone()
    out[0, 0] = 0
    return out


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


class Reference:
    """The coupled model's step and diagnostics in one precision."""

    def __init__(self, params: Params, device, mode: str = "f64"):
        self.A = Arith(mode)
        self.p = params
        self.T = Tables(params, device, self.A)

    # -- inversion ---------------------------------------------------------
    def derive(self, qh, phih) -> Fields:
        A, T, p = self.A, self.T, self.p
        phi = A.ifft2(phih)
        phix = A.ifft2(T.ik * phih)
        phiy = A.ifft2(T.il * phih)
        qwh = self.wave_pv(phi, phix, phiy)
        return self._invert(qh, qwh, phi, phix, phiy)

    def wave_pv(self, phi, phix, phiy):
        """``qw = (lap(|phi|^2)/2 + i J(phi*, phi)) / (2 f)``, filtered,
        with the mean of the Jacobian's transform removed."""
        A, T, p = self.A, self.T, self.p
        gphi2h = A.r(A.fft2(_abs2(phi)) * (-T.wv2))
        jach = _zero_mean(A.fft2(-2.0 * (phix.conj() * phiy).imag))
        return A.r((0.5 * gphi2h + jach) * (0.5 / p.f) * T.filtr)

    def _invert(self, qh, qwh, phi, phix, phiy) -> Fields:
        A, T = self.A, self.T
        # psi = real(ifft(-qh/wv2)) + real(ifft(qwh/wv2)), ph = fft(psi)
        p_ = A.rifft2(A.r((qwh - qh) * T.wv2i))
        ph = A.fft2(p_)
        q = A.rifft2(qh)
        q_psi = A.rifft2(A.r(qh - qwh))
        u = A.rifft2(A.r(-T.il * ph))
        v = A.rifft2(A.r(T.ik * ph))
        return Fields(ph, p_, q, q_psi, qwh, phi, phix, phiy, u, v)

    # -- right-hand sides and budget sources --------------------------------
    def nonlinear(self, d: Fields):
        A, T = self.A, self.T
        jacq = _zero_mean(A.r(T.ik * A.fft2(d.u * d.q)
                              + T.il * A.fft2(d.v * d.q)))
        jacw = _zero_mean(A.fft2(d.phix * d.u + d.phiy * d.v))
        refr = A.r(0.5j * A.fft2(d.phi * d.q_psi))
        return A.r(-jacq), A.r(-jacw - refr)

    def source_means(self, qh, phih, d: Fields) -> torch.Tensor:
        """The 15 domain means the budget sources are made of."""
        A, T, p = self.A, self.T, self.p
        lapphi = A.ifft2(A.r(-T.wv2 * phih))
        lap2phi = A.ifft2(A.r(T.wv4 * phih))
        lphix = A.ifft2(A.r(T.ik * (-T.wv2) * phih))
        lphiy = A.ifft2(A.r(T.il * (-T.wv2) * phih))
        lap2psi = A.rifft2(A.r(T.wv4 * d.ph))
        lapq = A.rifft2(A.r(-T.wv2 * qh))
        phi, q_psi = d.phi, d.q_psi
        J = A.r(d.phix * d.u + d.phiy * d.v)
        diss = A.r(-p.nu4w * lap2phi + p.nuw * lapphi - p.muw * phi)
        divFw = A.r(0.5 * p.hslash * (phi.conj() * lapphi).imag)
        parts = [
            0.5 * q_psi * divFw,
            (lapphi.conj() * J).real,
            -(diss * J.conj()).imag,
            0.5 * (diss * phi.conj()).real * q_psi,
            phi.real, phi.imag,
            (phi.conj() * q_psi).real, (phi.conj() * q_psi).imag,
            d.q * lap2psi,
            d.p * lapq,
            d.p * d.q,
            _abs2(lphix) + _abs2(lphiy),
            _abs2(lapphi),
            _abs2(d.phix) + _abs2(d.phiy),
            _abs2(phi),
        ]
        return A.r(torch.stack([A.r(x).mean() for x in parts]))

    def sources(self, m: torch.Tensor) -> dict:
        """Energy conversions and dissipations from :meth:`source_means`:
        all but ``pi`` are linear in ``m``."""
        p = self.p
        k2 = p.kappa2
        s = dict(
            gamma_r=m[0] / p.f,
            gamma_a=0.5 * p.hslash * m[1] / p.f,
            xi_r=m[2] / p.f,
            xi_a=m[3] / p.f,
            pi=0.5 * (m[4] * m[7] + m[5] * m[6]),
            ep_psi=p.nu4 * m[8] - p.nu * m[9] + p.mu * m[10],
            chi_phi=(-0.5 * p.nu4w * m[11] - 0.5 * p.nuw * m[12]
                     - 0.5 * p.muw * m[13]) / k2,
            ep_phi=-p.nu4w * m[12] - p.nuw * m[13] - p.muw * m[14],
        )
        s["k"] = (-(s["gamma_r"] + s["gamma_a"]) + s["xi_r"] + s["xi_a"]
                  + s["ep_psi"])
        s["p"] = s["gamma_r"] + s["gamma_a"] + s["chi_phi"]
        s["a"] = s["ep_phi"]
        return s

    # -- one ETDRK4 step -------------------------------------------------------
    def step(self, s: State) -> State:
        A, T, p = self.A, self.T, self.p
        cq, cw, flt = T.eq, T.ew, T.filtr

        def upd(c, base, F, into):
            return A.r((c * base + F * into) * flt)

        qh0, phih0 = s.qh, s.phih
        m1 = self.source_means(qh0, phih0, s.d)
        Fn0, Fn0w = self.nonlinear(s.d)
        qh1 = upd(cq.expch_h, qh0, Fn0, cq.Qh)
        phih1 = upd(cw.expch_h, phih0, Fn0w, cw.Qh)
        d = self.derive(qh1, phih1)

        m2 = self.source_means(qh1, phih1, d)
        Fna, Fnaw = self.nonlinear(d)
        qh2 = upd(cq.expch_h, qh0, Fna, cq.Qh)
        phih2 = upd(cw.expch_h, phih0, Fnaw, cw.Qh)
        d = self.derive(qh2, phih2)

        m3 = self.source_means(qh2, phih2, d)
        Fnb, Fnbw = self.nonlinear(d)
        qh3 = upd(cq.expch_h, qh1, A.r(2.0 * Fnb - Fn0), cq.Qh)
        phih3 = upd(cw.expch_h, phih1, A.r(2.0 * Fnbw - Fn0w), cw.Qh)
        d = self.derive(qh3, phih3)

        m4 = self.source_means(qh3, phih3, d)
        Fnc, Fncw = self.nonlinear(d)
        qh = A.r((cq.expch * qh0 + Fn0 * cq.f0 + 2.0 * (Fna + Fnb) * cq.fab
                  + Fnc * cq.fc) * flt)
        phih = A.r((cw.expch * phih0 + Fn0w * cw.f0
                    + 2.0 * (Fnaw + Fnbw) * cw.fab + Fncw * cw.fc) * flt)

        src = self.sources(m1 + 2.0 * (m2 + m3) + m4)
        Ke = A.r(s.Ke + p.dt * src["k"] / 6.0)
        Pw = A.r(s.Pw + p.dt * src["p"] / 6.0)
        Kw = A.r(s.Kw + p.dt * src["a"] / 6.0)
        return State(qh, phih, self.derive(qh, phih), Ke, Pw, Kw)

    # -- states ----------------------------------------------------------------
    def spec_var(self, zh):
        v = _abs2(zh)
        v[0, 0] = 0
        return v.sum() / float(self.T.M) ** 2

    def ke_qg(self, ph):
        return 0.5 * self.spec_var(self.T.wv * ph)

    def start(self, q, phi) -> State:
        """The state after the upstream's ``set_q(q)`` then
        ``set_phi(phi)``: ``set_q`` inverts with the wave field it holds
        then, zero, so the carried streamfunction and vorticity hold no
        wave PV until the first stage's inversion; ``set_phi`` replaces the
        wave field and its gradients and sets Pw and Kw."""
        A, T, p = self.A, self.T, self.p
        qh = A.fft2(A.r(q.to(A.rdtype)))
        z = torch.zeros_like(qh)
        d0 = self._invert(qh, z, z, z, z)
        Ke = self.ke_qg(d0.ph)
        phih = A.fft2(A.r(phi.to(A.cdtype)))
        phi_ = A.r(phi.to(A.cdtype))
        phix, phiy = A.ifft2(T.ik * phih), A.ifft2(T.il * phih)
        Pw = 0.25 * (_abs2(phix) + _abs2(phiy)).mean() / p.kappa2
        Kw = 0.5 * _abs2(phi_).mean()
        d = d0._replace(phi=phi_, phix=phix, phiy=phiy)
        return State(qh, phih, d, A.r(Ke), A.r(Pw), A.r(Kw))

    def resume(self, q, phi, Ke, Pw, Kw) -> State:
        """A state mid-run, from its physical fields and budget integrals
        (the derived fields worked out again)."""
        A = self.A
        qh = A.fft2(A.r(q.to(A.rdtype)))
        phih = A.fft2(A.r(phi.to(A.cdtype)))
        as_r = lambda x: A.r(torch.as_tensor(x, dtype=A.rdtype,  # noqa
                                             device=qh.device))
        return State(qh, phih, self.derive(qh, phih), as_r(Ke), as_r(Pw),
                     as_r(Kw))

    # -- diagnostics -----------------------------------------------------------
    def diagnostics(self, s: State) -> dict:
        """The upstream ``CoupledModel``'s scalar diagnostics of a state
        (the energy conversions evaluated on the state itself)."""
        A, T, p = self.A, self.T, self.p
        d = s.d
        src = self.sources(self.source_means(s.qh, s.phih, d))
        phix, phiy = A.ifft2(T.ik * s.phih), A.ifft2(T.il * s.phih)
        phq = A.r(-(s.qh * T.wv2i))
        phw = A.r(d.qwh * T.wv2i)
        uq, vq = A.rifft2(A.r(-T.il * phq)), A.rifft2(A.r(T.ik * phq))
        uw, vw = A.rifft2(A.r(-T.il * phw)), A.rifft2(A.r(T.ik * phw))
        mphi = d.phi.mean()
        out = dict(
            Ke=s.Ke, Pw=s.Pw, Kw=s.Kw,
            ke_qg=self.ke_qg(d.ph),
            ens=0.5 * (d.q * d.q).mean(),
            ke_niw=0.5 * _abs2(d.phi).mean(),
            cke_niw=0.5 * _abs2(mphi),
            pe_niw=0.25 * (_abs2(phix) + _abs2(phiy)).mean() / p.kappa2,
            chi_q=-p.nu4 * self.spec_var(T.wv2 * s.qh),
            ke_qg_q=0.5 * self.spec_var(T.wv * phq),
            ke_qg_w=0.5 * self.spec_var(T.wv * phw),
            ke_qg_qw=(uq * uw + vq * vw).mean(),
        )
        out.update({k: src[k] for k in ("gamma_r", "gamma_a", "xi_r", "xi_a",
                                         "pi", "ep_psi", "chi_phi",
                                         "ep_phi")})
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
    """``q`` and ``phi`` of a state, in float64 on the host."""
    return {"q": s.d.q.to(torch.float64).cpu().numpy(),
            "phi": s.d.phi.to(torch.complex128).cpu().numpy()}
