"""User-facing model classes (port of ``niwqg_tpu/api.py``).

Stateful shells over the kernels with the reference's API surface:
``Model(**kwargs)``, ``set_q``/``set_phi``/``set_c``, ``run``,
``run_with_snapshots``, ``run_steps``, ``model.diagnostics[...]['value']``,
output to disk (``save_to_disk``, ``path``, ``overwrite``,
``snapshot_format``: ``io.Saver``) and checkpoints
(``save_checkpoint``/``load_checkpoint``), for the five models: Coupled,
UnCoupled, QL, YBJ and QG (with its passive scalar).
Constructor keywords and defaults are the JAX package's, ``faithful_quirks``
included; the extra ``device`` picks where the model runs: the
first CUDA card by default (the constructor raises without one), or
``device="cpu"``. ``dtype`` defaults to float32 on the card and float64 on
the host.

``mesh=`` (a ``parallel.mesh.Mesh``: one process per rank over
``torch.distributed``) runs any of the five pencil-distributed: the state
holds this rank's blocks, ``set_q``/``set_phi``/``set_c`` take the global
array on every rank (or ``multihost.make_global_field`` of this rank's
rows) and keep the local block, and ``m.q``, ``m.phi`` and the diagnostics
return global values on every rank (the field properties gather, so every
rank calls them together, as they do ``run``, snapshots and checkpoints;
only rank 0 writes files). The distributed transform is the pencil FFT,
or with ``backend='mxu'`` the matmul-DFT on the same decomposition (the
JAX package's GSPMD branch; ``parallel/mfft.py``). Half spectra (QG's, and
on the matmul-DFT's mesh the wave models' ``q_half`` q side) carry the
transform's padded columns on a mesh; ``m.qh``, ``m.ch`` and ``m.ph`` cut
them, so that a user reads the one-rank layout.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import diagnostics as diag_mod
from .device import default_dtype, resolve_device
from .diagnostics import SeriesAccumulator
from .graphs import StepRunner
from .io import Saver, load_checkpoint, require_h5py, save_checkpoint
from .models.coupled import CoupledPhysics
from .models.kernel import KernelParams, WaveKernel
from .models.qg import QGKernel, QGParams
from .models.ql import QLPhysics
from .models.uncoupled import UnCoupledPhysics
from .models.ybj import YBJKernel
from .parallel.mesh import RowBlock
from .utils.profiling import span


@span("model.transform")
def _make_sharded_transform(nx, dtype, mesh, backend, precision="auto",
                            opts=None):
    """Distributed transform for a mesh. ``opts`` is the model's
    ``transform_opts``. ``backend='mxu'``: the matmul-DFT on the pencil
    decomposition (``parallel/mfft.py``; JAX's GSPMD branch), which takes
    every option of the one-card matmul-DFT and raises on one it does
    not know. Otherwise the pencil FFT (``parallel/pfft.py``), as JAX picks
    it on a GPU: ``overlap_chunks`` (pipelined transpose), ``pallas_a2a``
    (the hand-written all-to-all kernel) and ``pallas_interpret``
    (accepted, ignored); both providers take the first two."""
    opts = dict(opts or {})
    if backend == "mxu":
        from .parallel.mfft import MatmulPencilTransform

        return MatmulPencilTransform(nx, dtype, mesh, precision=precision,
                                     **opts)
    from .parallel.pfft import PencilTransform

    tr = PencilTransform(nx, dtype, mesh,
                         overlap_chunks=opts.pop("overlap_chunks", 1),
                         pallas_a2a=opts.pop("pallas_a2a", False),
                         pallas_interpret=opts.pop("pallas_interpret",
                                                   False))
    if opts:
        # matmul-DFT-only (or misspelled) keys: warn, do not drop silently
        logging.getLogger(__name__).warning(
            "transform_opts ignored by the pencil provider: %s",
            sorted(opts))
    return tr


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

    def _init_services(self, registry, path, save_to_disk, overwrite,
                       snapshot_format="h5"):
        self.logger = _make_logger(type(self).__module__)
        mesh = getattr(self, "_mesh", None)
        if mesh is not None and mesh.rank != 0:
            # every rank holds the same status line: rank 0 prints it
            self.logger = logging.getLogger(type(self).__module__ + ".quiet")
            self.logger.setLevel(logging.ERROR)
        self.logger.info(" %s", self.model)
        self.logger.info(
            " Using filter" if self.kernel.grid.use_filter else
            (" Dealiasing with 2/3 rule" if self.kernel.grid.dealias
             else " No dealiasing; no filter")
        )
        self.registry = registry
        self._diag_acc = SeriesAccumulator(registry)
        if save_to_disk:
            # setup.h5 and diagnostics.h5 are HDF5 in either snapshot
            # format: raise before any directory is made
            require_h5py()
        self.saver = Saver(path, save_to_disk, overwrite,
                           snapshot_format=snapshot_format, mesh=mesh)
        self.saver.save_setup(self)
        # run(), run_with_snapshots() and run_steps() advance through it:
        # replayed CUDA graphs on one card and on a mesh whose collectives
        # stay on the card (K2 or NCCL), direct calls on the host and on
        # gloo (graphs.py)
        self._runner = StepRunner(self)

    def _take_mesh(self, mesh, device):
        """Set ``self.device`` and ``self._mesh``; a mesh must be the
        port's own and lie where the model is asked to run."""
        self.device = resolve_device(device)
        self._mesh = mesh
        if mesh is None:
            return
        from .parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError("mesh= takes a niwqg_tpu_torch.parallel.mesh"
                            f".Mesh (make_mesh), got {type(mesh).__name__}")
        if mesh.device.type != self.device.type:
            raise ValueError(
                f"the mesh lies on {mesh.device}, the model on "
                f"{self.device}: pass the same device= to both")
        self.device = mesh.device

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

    # -- host helpers (numpy, for reference-style scripts) -------------------
    def fft(self, x):
        """Host transform in the layout ``m.qh`` gives: the half spectrum
        for QG (without a mesh's padded columns), else the full one."""
        if self.kernel.grid.spectrum == "half":
            return np.fft.rfft2(x)
        return np.fft.fft2(x)

    def ifft(self, xh):
        g = self.kernel.grid
        if g.spectrum == "half":
            return np.fft.irfft2(xh[..., : self.nx // 2 + 1],
                                 s=(self.ny, self.nx))
        return np.fft.ifft2(xh)

    def spec_var(self, ph):
        """The variance of the field whose transform is ``ph`` (a host
        array in the model's spectral layout), mean mode excluded."""
        g = self.kernel.grid
        var_dens = np.abs(np.asarray(ph)) ** 2 / float(g.M) ** 2
        if g.spectrum == "half":
            var_dens = 2.0 * var_dens
            var_dens[:, 0] *= 0.5
            var_dens[:, g.nx // 2] *= 0.5  # Nyquist (the layout may be padded)
        var_dens[0, 0] = 0.0
        return var_dens.sum()

    def isotropic_spectrum(self, field):
        """pyspec-style power spectrum of a field: the 2-D density and its
        ring integral (``utils.spectrum.spectrum_2d``). ``field`` is a
        physical-space array or the name of a model attribute (``'q'``,
        ``'phi'``, ``'p'``, ...)."""
        from .utils.spectrum import spectrum_2d

        if isinstance(field, str):
            field = getattr(self, field)
        dx = self.kernel.grid.dx
        return spectrum_2d(np.asarray(field), dx, dx)

    def get_field(self, name: str):
        """A snapshot field: ``'t'`` or a model attribute (gathered over a
        mesh, so every rank calls it)."""
        if name == "t":
            return self.t
        return getattr(self, name)

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

    def _np(self, t):
        """A physical field on the host, gathered over the mesh."""
        if self._mesh is not None:
            t = self._mesh.gather_rows(t)
        return t.detach().cpu().numpy()

    def _np_spec(self, t):
        """A spectral field on the host, gathered over the mesh."""
        if self._mesh is not None:
            t = self._mesh.gather_cols(t)
        return t.detach().cpu().numpy()

    def _field(self, a, dtype, name, real=False):
        """A copy of a ``set_*`` argument in ``dtype`` (the state holds the
        value at call time): a global host array, or the row block of a
        ``multihost.make_global_field`` result; ``real`` keeps the real
        part."""
        if isinstance(a, RowBlock):
            local = np.real(a.local) if real else a.local
            a = a.with_local(np.array(local, dtype=dtype))
        else:
            a = np.array(np.real(np.asarray(a)) if real else a, dtype=dtype)
        shape = (self.nx, self.nx)
        if a.shape != shape:
            raise ValueError(f"set_{name}: expected shape {shape}, "
                             f"got {a.shape}")
        return a

    # -- run loop ----------------------------------------------------------
    @property
    def _stale_grads(self) -> bool:
        """True in the UnCoupled ``faithful_quirks`` mode: the wave
        gradients are refreshed on the reference's diagnostics and status
        cadence, never inside a step."""
        physics = getattr(self.kernel, "physics", None)
        return bool(getattr(physics, "stale_phi_gradients", False))

    def _snapshot_fields(self):
        raise NotImplementedError

    def _step_forward(self):
        """One step + the diagnostics, status and snapshot cadence:
        diagnostics are sampled when the *pre-step* counter hits ``tdiags``
        and record the pre-step time; the status line prints every
        ``twrite`` steps and a snapshot is saved every ``tsave_snapshots``
        steps (with ``save_to_disk``). In
        the stale-gradient mode each of the two refreshes the wave
        gradients after it has read them, as the reference's
        ``_calc_pe_niw`` does (``run_steps`` refreshes nothing). The
        cadence reads the step counter alone, so on a mesh every rank
        takes the same branches, and the collectives inside them
        (transforms, sums, gathers) line up.

        This is the per-step reference loop: :meth:`run` advances in
        chunks (:meth:`_advance_chunked`) and must match it exactly."""
        p = self.params
        tc_before = self.state.tc
        t_prev = self.state.t
        self.state = self.kernel.step(self.state)
        if tc_before % p.tdiags == 0:
            self._diag_acc.append(self._diag_fn(self.state, t_prev))
            if self._stale_grads:
                self.state = self.kernel.refresh_phi_gradients(self.state)
        tc_now = tc_before + 1
        if tc_now % p.twrite == 0:
            self._print_status()
            if self._stale_grads:
                self.state = self.kernel.refresh_phi_gradients(self.state)
        if self.saver.save_to_disk and tc_now % p.tsave_snapshots == 0:
            self.saver.save_snapshot(self, self._snapshot_fields())

    def _host_event_strides(self, extra_stride=None):
        """The cadences that need the host between chunks: the status line
        every ``twrite`` steps, a snapshot every ``tsave_snapshots`` (when
        saving) and the caller's stride. Diagnostics are not among them:
        the chunks sample them on the device."""
        p = self.params
        strides = [int(p.twrite)]
        if self.saver.save_to_disk:
            strides.append(int(p.tsave_snapshots))
        if extra_stride:
            strides.append(int(extra_stride))
        return strides

    def _advance_chunked(self, nsteps: int, extra_stride=None):
        """Advance ``nsteps`` steps in chunks (``graphs.StepRunner``) that
        end exactly at the host events, then take the events as
        :meth:`_step_forward` does: the status line, the refresh after it
        in the stale-gradient mode, the snapshot. Yields the post-step
        counter at every chunk's end, so that a caller can add its own
        event. A state set between chunks (``set_q``, ``load_checkpoint``)
        is what the next chunk starts from."""
        p = self.params
        strides = self._host_event_strides(extra_stride)
        done = 0
        while done < nsteps:
            # the chunk and its host events; the yield lies outside
            with span("shell.chunk"):
                tc0 = self.tc
                n = nsteps - done
                for m in strides:
                    # the next post-step multiple of m after tc0
                    n = min(n, (tc0 // m + 1) * m - tc0)
                self._runner.advance(n)
                done += n
                tc_now = tc0 + n
                if tc_now % p.twrite == 0:
                    with span("shell.status"):
                        self._print_status()
                    if self._stale_grads:
                        self.state = self.kernel.refresh_phi_gradients(
                            self.state)
                if (self.saver.save_to_disk
                        and tc_now % p.tsave_snapshots == 0):
                    self.saver.save_snapshot(self, self._snapshot_fields())
            yield tc_now

    def run(self):
        """Run to ``tmax`` with the reference's per-step cadence, in chunks
        between host events; with ``save_to_disk`` a snapshot before the
        first step and ``diagnostics.h5`` at the end. The steps, the state,
        the diagnostic series and the print and snapshot cadence are those
        of the per-step loop (:meth:`_step_forward`)."""
        if self.saver.save_to_disk:
            self.saver.save_snapshot(self, self._snapshot_fields())
        for _ in self._advance_chunked(self._count_steps(self.params.tmax)):
            pass
        if self.saver.save_to_disk:
            self.saver.save_diagnostics(self.diagnostics)

    def run_with_snapshots(self, tsnapstart=0.0, tsnapint=432000.0):
        """Generator run loop: steps to ``tmax`` as :meth:`run` does (no
        first snapshot, no ``diagnostics.h5``) and yields the time after
        every step whose counter is a multiple of ``ceil(tsnapint / dt)``
        once ``t >= tsnapstart``, so that the caller can inspect the live
        model; the chunks end at those steps too. Queued snapshot writes
        are drained at the end (on a mesh a collective: a failed write
        raises on every rank); when an exception is already propagating
        their errors are logged, not raised over it."""
        tsnapints = int(np.ceil(tsnapint / self.params.dt))
        try:
            for tc_now in self._advance_chunked(
                    self._count_steps(self.params.tmax),
                    extra_stride=tsnapints):
                if self.t >= tsnapstart and tc_now % tsnapints == 0:
                    yield self.t
        except GeneratorExit:  # the caller stopped early: a normal end
            self.saver.drain()
            raise
        except BaseException:
            self.saver.drain(raise_errors=False)
            raise
        self.saver.drain()

    def run_steps(self, n: int):
        """``n`` steps with no diagnostics or status output (on one card,
        ``n`` replays of the step's graph). The state returned is the
        model's own, fresh tensors that no later step overwrites."""
        self._runner.advance(n, diags=False)
        return self.state

    def _diag_fn(self, state, t_prev):
        raise NotImplementedError

    def _print_status(self):
        raise NotImplementedError

    # -- checkpoints (see io.py; collective on a mesh) ------------------------
    def save_checkpoint(self, path: str):
        """Write the full state and the diagnostic series to ``path``."""
        save_checkpoint(path, self)

    def load_checkpoint(self, path: str):
        """Restore a checkpoint written by this package or the JAX one."""
        load_checkpoint(path, self)
        return self


class _WaveModel(_ModelBase):
    """Common shell for the wave-kernel models."""

    _physics_factory = None
    _registry_factory = staticmethod(diag_mod.wave_kernel_registry)

    @span("model.init")
    def __init__(self, nx=128, ny=None, L=5e5, dt=10000.0, twrite=1000,
                 tmax=250000.0, use_filter=True, cflmax=0.8, U=0.0, f=1.0e-4,
                 N=0.01, m=0.025, g=9.81, nu4=0, nu4w=0, nu=20, nuw=50.0,
                 mu=0, muw=0, dealias=False, save_to_disk=False,
                 overwrite=True, tsave_snapshots=10, tdiags=10,
                 path="output/", dtype=None, backend="auto",
                 precision="auto", mesh=None, fast=None,
                 snapshot_format="h5", compute_budgets=True,
                 spectral_budgets=True, device=None, **kernel_kwargs):
        del ny  # ignored, as in the reference
        self._take_mesh(mesh, device)
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
        if mesh is not None:
            tr = _make_sharded_transform(
                nx, dtype, mesh, backend, precision,
                opts=kernel_kwargs.pop("transform_opts", None))
            kernel_kwargs["transform"] = tr
            # on K2's route the step's sums and reflections take K2 too
            kernel_kwargs["mesh"] = mesh.with_group(tr._group)
        with span("model.kernel"):
            self.kernel = self._make_kernel(dtype, backend, precision,
                                            **kernel_kwargs)
        self.state = self.kernel.zero_state()  # this rank's blocks
        self._init_services(self._registry_factory(), path, save_to_disk,
                            overwrite, snapshot_format=snapshot_format)

    def _make_kernel(self, dtype, backend, precision, **kw):
        cls = WaveKernel
        if kw.get("pair_inverse") and not self._fast:
            raise ValueError(
                "pair_inverse requires the batched fast kernel: pass "
                "fast=True")
        if self._fast:
            from .models.fast_kernel import FastWaveKernel

            cls = FastWaveKernel
        return cls(self.params, self._physics_factory(), dtype=dtype,
                   backend=backend, precision=precision, device=self.device,
                   **kw)

    # -- state access (host numpy copies, global on every rank) ------------
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
        if not getattr(self.kernel, "q_half", False):
            return self._np_spec(zh)
        from .ops.spectral import expand_half_to_full

        if self._mesh is not None:
            # the global half spectrum, its mesh padding cut
            zh = self._mesh.gather_cols(zh)[..., :self.nx // 2 + 1]
        return expand_half_to_full(zh).detach().cpu().numpy()

    @property
    def qh(self):
        return self._q_side_full(self.state.qh)

    @property
    def phih(self):
        return self._np_spec(self.state.phih)

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

    def _snapshot_fields(self):
        return ["t", "q", "phi"]

    @span("model.set_fields")
    def set_q(self, q):
        q = self._field(q, self.kernel.dtype, "q")
        self.state = self.kernel.apply_set_q(self.state, q)

    @span("model.set_fields")
    def set_phi(self, phi):
        phi = self._field(phi, np.complex128, "phi")
        self.state = self.kernel.apply_set_phi(self.state, phi)

    def _diag_fn(self, state, t_prev):
        K = self.kernel
        src = K.stage_sources(state.qh, state.phih, state.d)
        if self._stale_grads:
            # the reference's diagnostics refresh phix/phiy part way
            # through (pe_niw), so ep_phi and chi_phi, evaluated after it,
            # see fresh gradients while gamma/xi read the stale ones
            d2 = K.refresh_phi_gradients(state).d
            fresh = K.stage_sources(state.qh, state.phih, d2)
            src = src._replace(ep_phi=fresh.ep_phi, chi_phi=fresh.chi_phi)
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


class UnCoupledModel(_WaveModel):
    """YBJ waves on an evolving flow.

    ``faithful_quirks=True`` (default: defaults reproduce the reference as
    it runs) keeps the reference's stale-gradient cadence;
    ``faithful_quirks=False`` recomputes the wave gradients every stage
    (see ``models/uncoupled.py``)."""

    model = " Uncoupled Model"
    _physics_factory = staticmethod(UnCoupledPhysics)

    def __init__(self, *args, faithful_quirks=None, **kwargs):
        defaulted = faithful_quirks is None
        if defaulted:
            faithful_quirks = True
        if faithful_quirks:
            self._physics_factory = (
                lambda: UnCoupledPhysics(faithful_quirks=True))
        super().__init__(*args, **kwargs)
        if defaulted:
            self.logger.info(
                " faithful_quirks defaulting to True (reference-parity "
                "stale-gradient cadence); pass faithful_quirks=False for "
                "the corrected per-stage gradients")


class QLModel(_WaveModel):
    """Quasilinear coupled model.

    The reference QLModel crashes at construction, so there is no
    as-shipped trajectory to follow: the default is the intended
    quasilinear physics. ``faithful_quirks=True`` reproduces the repaired
    reference bug for bug (see ``models/ql.py``); its never-updated
    ``self.q`` shows as a frozen ``m.q`` and a frozen ``ens``
    diagnostic."""

    model = " Quasilinear Model"
    _physics_factory = staticmethod(QLPhysics)

    def __init__(self, *args, faithful_quirks: bool = False, **kwargs):
        self._faithful = bool(faithful_quirks)
        if faithful_quirks:
            self._physics_factory = lambda: QLPhysics(faithful_quirks=True)
            # the reference's ens reads the frozen self.q, here q_psi
            reg = diag_mod.wave_kernel_registry()
            reg.add("ens", "Quasigeostrophic Potential Enstrophy", r"s^{-2}",
                    function=lambda K, s, aux: K.ens(s.d.q_psi))
            self._registry_factory = lambda: reg
        super().__init__(*args, **kwargs)

    @property
    def q(self):
        if self._faithful:
            # the reference's self.q is never updated after set_q
            return self._np(self.state.d.q_psi)
        return self._np(self.state.d.q)


class YBJModel(_WaveModel):
    """Waves on a steady flow (``faithful_quirks=True`` by default)."""

    model = " YBJ Model (Steady QG flow)"

    def _make_kernel(self, dtype, backend, precision, faithful_quirks=True,
                     transform=None, transform_opts=None, fold_filter=False,
                     mesh=None):
        return YBJKernel(self.params, faithful_quirks=faithful_quirks,
                         dtype=dtype, backend=backend, precision=precision,
                         transform=transform, transform_opts=transform_opts,
                         fold_filter=fold_filter, device=self.device,
                         mesh=mesh)


class QGModel(_ModelBase):
    """Standalone barotropic QG model, with an optional passive scalar.

    On a mesh the pencil transform's half-spectrum path pads the spectral
    columns from ``nx//2+1`` to a multiple of the mesh size; the padded
    columns stay zero, and the spectral fields a user reads (``qh``,
    ``ch``, ``ph``) are cut back to ``nx//2+1`` columns."""

    model = " QG Model"

    @span("model.init")
    def __init__(self, nx=128, ny=None, L=5e5, dt=10000.0, twrite=1000,
                 tswrite=10, tmax=250000.0, use_filter=True, U=0.0,
                 nu4=5.0e9, nu=0, mu=0, beta=0, passive_scalar=False,
                 nu4c=5.0e9, nuc=0, muc=0, dealias=False, save_to_disk=False,
                 overwrite=True, tsave_snapshots=10, tdiags=10,
                 path="output/", dtype=None, backend="auto",
                 precision="auto", mesh=None, transform_opts=None,
                 spectral_budgets=True, fold_filter=False, device=None):
        del ny, tswrite
        self._take_mesh(mesh, device)
        self.params = QGParams(
            nx=nx, L=L, dt=dt, tmax=tmax, twrite=int(twrite), cflmax=0.5,
            U=U, beta=beta, nu4=nu4, nu=nu, mu=mu,
            passive_scalar=passive_scalar, nu4c=nu4c, nuc=nuc, muc=muc,
            use_filter=use_filter, dealias=dealias, tdiags=tdiags,
            tsave_snapshots=tsave_snapshots,
            spectral_budgets=spectral_budgets,
        )
        dtype = dtype or default_dtype(self.device)
        transform = None
        if mesh is not None:
            transform = _make_sharded_transform(nx, dtype, mesh, backend,
                                                precision, transform_opts)
            transform_opts = None
            # on K2's route the step's sums take K2 too
            mesh = mesh.with_group(transform._group)
        with span("model.kernel"):
            self.kernel = QGKernel(self.params, dtype=dtype, backend=backend,
                                   precision=precision, transform=transform,
                                   transform_opts=transform_opts,
                                   fold_filter=fold_filter,
                                   device=self.device, mesh=mesh)
        self.state = self.kernel.zero_state()  # this rank's blocks
        self._init_services(diag_mod.qg_registry(), path, save_to_disk,
                            overwrite)

    # -- state access (host numpy copies, global on every rank) ------------
    def _np_half(self, t):
        """A half-spectrum field on the host, gathered over the mesh, in
        the one-rank layout (the padded columns cut)."""
        return self._np_spec(t)[..., : self.nx // 2 + 1]

    @property
    def q(self):
        return self._np(self.state.q)

    @property
    def c(self):
        return self._np(self.state.c)

    @property
    def p(self):
        return self._np(self.state.p)

    @property
    def qh(self):
        return self._np_half(self.state.qh)

    @property
    def ch(self):
        return self._np_half(self.state.ch)

    @property
    def ph(self):
        return self._np_half(self.state.ph)

    @property
    def Ke(self):
        return float(self.state.Ke.item())

    @property
    def cvar(self):
        return float(self.state.cvar.item())

    def _snapshot_fields(self):
        # the reference's _step_forward always asks for ['t', 'q', 'c']
        return ["t", "q", "c"] if self.params.passive_scalar else ["t", "q"]

    @span("model.set_fields")
    def set_q(self, q):
        q = self._field(q, self.kernel.dtype, "q")
        self.state = self.kernel.apply_set_q(self.state, q)

    @span("model.set_fields")
    def set_c(self, c):
        """The real part of ``c`` (a complex field's imaginary part is
        dropped, as the reference's ``rfft2`` did)."""
        c = self._field(c, self.kernel.dtype, "c", real=True)
        self.state = self.kernel.apply_set_c(self.state, c)

    def _diag_fn(self, state, t_prev):
        K = self.kernel
        aux = {"time": t_prev}
        if self.params.passive_scalar:
            C2, gradC2, lapc, Gamma_c = K._scalar_derived(state.ch, state.u,
                                                          state.v, state.c)
            aux.update(C2=C2, gradC2=gradC2, Gamma_c=Gamma_c,
                       ep_c=K.ep_c(C2, gradC2, lapc),
                       chi_c=K.chi_c(state.ch, gradC2, lapc))
        else:
            zero = state.Ke * 0.0
            aux.update(C2=zero, gradC2=zero, Gamma_c=zero, ep_c=zero,
                       chi_c=zero)
        return self.registry.evaluate(K, state, aux)

    def _print_status(self):
        """Status line + CFL guard (``cflmax=0.5``)."""
        K, s = self.kernel, self.state
        ke, cfl = torch.stack([K.ke_qg(s.ph), K.cfl(s)]).tolist()
        self.logger.info(
            "Step: %i, Time: %4.3e, P: %4.3e , Ke: %4.3e, CFL: %4.3f",
            self.tc, self.t, self.t / self.params.tmax, ke, cfl,
        )
        if not (cfl < self.params.cflmax):  # survives python -O
            self.logger.error("CFL condition violated")
            raise AssertionError(f"CFL condition violated: {cfl:.3f} >= "
                                 f"{self.params.cflmax}")
