"""User-facing model classes (port of ``niwqg_tpu/api.py``).

Stateful shells over the kernels with the reference's API surface:
``Model(**kwargs)``, ``set_q``/``set_phi``, ``run``, ``run_steps`` and
``model.diagnostics[...]['value']``. Constructor keywords and defaults are
the JAX package's; the extra ``device`` picks where the model runs: the
first CUDA card by default (the constructor raises without one), or
``device="cpu"``. ``dtype`` defaults to float32 on the card and float64 on
the host.

Not ported yet (ROADMAP.md, queue 1): output to disk (``save_to_disk``),
``run_with_snapshots``, checkpoints, meshes, and the UnCoupled, QL, YBJ and
QG models.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import diagnostics as diag_mod
from .device import default_dtype, resolve_device
from .diagnostics import SeriesAccumulator
from .models.coupled import CoupledPhysics
from .models.kernel import KernelParams, WaveKernel


def _make_logger(name: str, loglevel: int = 10) -> logging.Logger:
    """Reference-style logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(loglevel)
    logger.propagate = False
    return logger


class _ModelBase:
    """Shared run loop and diagnostics machinery."""

    model = "model"

    def _init_services(self, registry):
        self.logger = _make_logger(type(self).__module__)
        self.logger.info(" %s", self.model)
        self.logger.info(
            " Using filter" if self.kernel.grid.use_filter else
            (" Dealiasing with 2/3 rule" if self.kernel.grid.dealias
             else " No dealiasing; no filter")
        )
        self.registry = registry
        self._diag_acc = SeriesAccumulator(registry)

    def _count_steps(self, tmax: float) -> int:
        """Steps the reference's ``while t < tmax`` loop takes from the
        current state, with the model dtype's ``t += dt`` rounding."""
        dtype = self.kernel.dtype
        t = np.asarray(self.state.t.item(), dtype=dtype)
        dt = np.asarray(self.params.dt, dtype=dtype)
        n = 0
        while float(t) < tmax:
            t = (t + dt).astype(dtype)
            n += 1
        return n

    # -- grid passthroughs (reference attribute surface) -------------------
    @property
    def grid(self):
        return self.kernel.grid

    @property
    def nx(self):
        return self.kernel.grid.nx

    @property
    def ny(self):
        return self.kernel.grid.ny

    @property
    def L(self):
        return self.kernel.grid.L

    @property
    def x(self):
        return self.kernel.grid.x_np

    @property
    def y(self):
        return self.kernel.grid.y_np

    @property
    def wv(self):
        return self.kernel.grid.wv_np

    @property
    def wv2(self):
        return self.kernel.grid.wv2_np

    @property
    def kk(self):
        return self.kernel.grid.kk_np

    @property
    def ll(self):
        return self.kernel.grid.ll_np

    @property
    def filtr(self):
        return self.kernel.grid.filtr_np

    @property
    def dt(self):
        return self.kernel.params.dt

    @property
    def t(self):
        return float(self.state.t.item())

    @property
    def tc(self):
        return int(self.state.tc)

    @property
    def wv4(self):
        return self.kernel.grid.wv4_np

    @property
    def wv2i(self):
        return self.kernel.grid.wv2i_np

    @property
    def dx(self):
        return self.kernel.grid.dx

    def __getattr__(self, name):
        # physics-parameter passthrough (m.nu4, m.f, ...)
        params = self.__dict__.get("params")
        if params is not None and hasattr(params, name):
            return getattr(params, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    @property
    def diagnostics(self):
        return self._diag_acc.as_reference_dict()

    def describe_diagnostics(self):
        print(self.registry.describe())

    def get_diagnostic(self, dname: str):
        """Accumulated series for one diagnostic."""
        return np.hstack([np.asarray(v) for v in
                          self._diag_acc.series[dname]])

    def set_active_diagnostics(self, names):
        """Restrict which diagnostics are evaluated and accumulated."""
        self.registry.set_active(names)

    # -- run loop ----------------------------------------------------------
    def _step_forward(self):
        """One step + the diagnostics and status cadence: diagnostics are
        sampled when the *pre-step* counter hits ``tdiags`` and record the
        pre-step time; the status line prints every ``twrite`` steps."""
        p = self.params
        tc_before = self.state.tc
        t_prev = self.state.t
        self.state = self.kernel.step(self.state)
        if tc_before % p.tdiags == 0:
            self._diag_acc.append(self._diag_fn(self.state, t_prev))
        if (tc_before + 1) % p.twrite == 0:
            self._print_status()

    def run(self):
        """Run to ``tmax`` with the reference's per-step cadence."""
        for _ in range(self._count_steps(self.params.tmax)):
            self._step_forward()

    def run_steps(self, n: int):
        """``n`` steps with no diagnostics or status output."""
        step = self.kernel.step
        s = self.state
        for _ in range(n):
            s = step(s)
        self.state = s
        return s

    def _diag_fn(self, state, t_prev):
        raise NotImplementedError

    def _print_status(self):
        raise NotImplementedError


class _WaveModel(_ModelBase):
    """Common shell for the wave-kernel models."""

    _physics_factory = None
    _registry_factory = staticmethod(diag_mod.wave_kernel_registry)

    def __init__(self, nx=128, ny=None, L=5e5, dt=10000.0, twrite=1000,
                 tmax=250000.0, use_filter=True, cflmax=0.8, U=0.0, f=1.0e-4,
                 N=0.01, m=0.025, g=9.81, nu4=0, nu4w=0, nu=20, nuw=50.0,
                 mu=0, muw=0, dealias=False, save_to_disk=False,
                 overwrite=True, tsave_snapshots=10, tdiags=10,
                 path="output/", dtype=None, backend="auto",
                 precision="auto", mesh=None, fast=None,
                 snapshot_format="h5", compute_budgets=True,
                 spectral_budgets=True, device=None, **kernel_kwargs):
        del ny, overwrite, path, snapshot_format  # ny is ignored as in the reference
        if save_to_disk:
            raise NotImplementedError(
                "save_to_disk is not ported yet (ROADMAP.md, queue 1, item 6)")
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md, queue 1, item 11)")
        self.device = resolve_device(device)
        if fast is None:
            # the batched fast kernel for the matmul-DFT and on the card;
            # the faithful kernel on the host, as in JAX
            fast = backend == "mxu" or self.device.type == "cuda"
        self._fast = bool(fast)
        self.params = KernelParams(
            nx=nx, L=L, dt=dt, tmax=tmax, twrite=int(twrite), cflmax=cflmax,
            U=U, f=f, N=N, m=m, g=g, nu4=nu4, nu4w=nu4w, nu=nu, nuw=nuw,
            mu=mu, muw=muw, use_filter=use_filter, dealias=dealias,
            tdiags=tdiags, tsave_snapshots=tsave_snapshots,
            compute_budgets=compute_budgets,
            spectral_budgets=spectral_budgets,
        )
        dtype = dtype or default_dtype(self.device)
        self.kernel = self._make_kernel(dtype, backend, precision,
                                        **kernel_kwargs)
        self.state = self.kernel.zero_state()
        self._init_services(self._registry_factory())

    def _make_kernel(self, dtype, backend, precision, **kw):
        cls = WaveKernel
        if self._fast:
            from .models.fast_kernel import FastWaveKernel

            cls = FastWaveKernel
        return cls(self.params, self._physics_factory(), dtype=dtype,
                   backend=backend, precision=precision, device=self.device,
                   **kw)

    # -- state access (host numpy copies) ----------------------------------
    @staticmethod
    def _np(t):
        return t.detach().cpu().numpy()

    @property
    def q(self):
        return self._np(self.state.d.q)

    @property
    def phi(self):
        return self._np(self.state.d.phi)

    @property
    def p(self):
        if self.state.d.p is None:
            # spectral-budget states do not carry the physical
            # streamfunction; reconstruct it from ph
            return self._np(self.kernel._inv_real(self.state.d.ph))
        return self._np(self.state.d.p)

    def _q_side_full(self, zh):
        """q-side spectra in the reference's full-spectrum layout."""
        if getattr(self.kernel, "q_half", False):
            from .ops.spectral import expand_half_to_full

            zh = expand_half_to_full(zh)
        return self._np(zh)

    @property
    def qh(self):
        return self._q_side_full(self.state.qh)

    @property
    def phih(self):
        return self._np(self.state.phih)

    @property
    def ph(self):
        return self._q_side_full(self.state.d.ph)

    @property
    def u(self):
        return self._np(self.state.d.u)

    @property
    def v(self):
        return self._np(self.state.d.v)

    @property
    def q_psi(self):
        return self._np(self.state.d.q_psi)

    @property
    def qwh(self):
        return self._q_side_full(self.state.d.qwh)

    @property
    def Ke(self):
        return float(self.state.Ke.item())

    @property
    def Pw(self):
        return float(self.state.Pw.item())

    @property
    def Kw(self):
        return float(self.state.Kw.item())

    def _check_field(self, a, name):
        shape = (self.nx, self.nx)
        if a.shape != shape:
            raise ValueError(f"set_{name}: expected shape {shape}, "
                             f"got {a.shape}")
        return a

    def set_q(self, q):
        # a copy: the state holds the value at call time
        q = self._check_field(np.array(q, dtype=self.kernel.dtype), "q")
        self.state = self.kernel.apply_set_q(self.state, q)

    def set_phi(self, phi):
        phi = self._check_field(np.array(phi, dtype=np.complex128), "phi")
        self.state = self.kernel.apply_set_phi(self.state, phi)

    def _diag_fn(self, state, t_prev):
        K = self.kernel
        src = K.stage_sources(state.qh, state.phih, state.d)
        aux = {"time": t_prev, "src": src}
        return self.registry.evaluate(K, state, aux)

    def _print_status(self):
        """Status line + CFL guard."""
        K, s = self.kernel, self.state
        ke, kew, pew, cfl = torch.stack(
            [K.ke_qg(s.d.ph), K.ke_niw(s.d.phi), K.pe_niw(s.phih),
             K.cfl(s)]).tolist()
        self.logger.info(
            "Step: %4i, Time: %2.1e, P: %2.1e, Ke: %4.3e, Kw: %4.3e, "
            "Pw: %4.3e, CFL: %3.2f",
            self.tc, self.t, self.t / self.params.tmax, ke, kew, pew, cfl,
        )
        # an explicit raise survives python -O (reference: AssertionError)
        if not (cfl < self.params.cflmax):
            self.logger.error("CFL condition violated")
            raise AssertionError(f"CFL condition violated: {cfl:.3f} >= "
                                 f"{self.params.cflmax}")


class CoupledModel(_WaveModel):
    """Xie & Vanneste (2015) coupled model."""

    model = " Coupled Model"
    _physics_factory = staticmethod(CoupledPhysics)
    _registry_factory = staticmethod(diag_mod.coupled_registry)

    def _diag_fn(self, state, t_prev):
        K = self.kernel
        src = K.stage_sources(state.qh, state.phih, state.d)
        q_, w_, qw_ = K.physics.ke_qg_decomp(K, state.qh, state.d.qwh)
        aux = {"time": t_prev, "src": src, "ke_qg_q": q_, "ke_qg_w": w_,
               "ke_qg_qw": qw_}
        return self.registry.evaluate(K, state, aux)
