"""The PyTorch port's chunked run loop (``graphs.StepRunner`` under
``run``, ``run_with_snapshots`` and ``run_steps``) against its own per-step
loop (``_step_forward``) and against the JAX package's ``run()``, the
counterpart of ``tests/test_chunked_run.py``.

On the host the runner calls the step and the diagnostics directly, in the
same chunks that replay CUDA graphs on a card, so these tests hold its
chunking, sampling, refresh and event cadence: bit for bit against the
per-step loop, and against JAX in f64 at nx=32 (fields 1e-12 relative,
series 1e-10, sample times equal). The replayed graphs themselves are
held to the per-step loop by ``tests/test_torch_cuda.py`` on the card."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu as jpkg  # noqa: E402
import niwqg_tpu_torch as tpkg  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.graphs import _leaves  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from _torch_common import K1_OPTS  # noqa: E402
from _torch_common import rel as _rel  # noqa: E402

NX, DT, NSTEPS = 32, 10000.0, 17
# (name, keywords): the five models, UnCoupled in both quirk modes and
# the coupled model on both kernels
MODELS = [("CoupledModel", {}), ("CoupledModel", {"fast": True}),
          ("UnCoupledModel", {"faithful_quirks": True}),
          ("UnCoupledModel", {"faithful_quirks": False}),
          ("QLModel", {}), ("YBJModel", {}), ("QGModel", {})]
IDS = ["coupled", "coupled-fast", "uncoupled-faithful", "uncoupled",
       "ql", "ybj", "qg"]
# (tdiags, twrite, tsave_snapshots): the reference defaults' ratio, and
# co-prime cadences that end chunks at every stride
CADENCES = [(10, 1000, 10), (3, 7, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, ic, name, kw, nsteps=NSTEPS, **extra):
    """McWilliams (1984) turbulence with a wave packet in phi, so that the
    wave gradients (stale or fresh) are far from zero; QG: the same flow
    with beta, a mean flow and a plane-wave scalar."""
    if pkg is tpkg:
        extra["device"] = "cpu"
    common = dict(L=2 * np.pi * 200e3, nx=NX, dt=DT, tmax=nsteps * DT,
                  use_filter=True, **kw, **extra)
    if name == "QGModel":
        m = pkg.QGModel.Model(nu4=5e10, beta=1e-11, U=-0.05,
                              passive_scalar=True, **common)
    else:
        m = getattr(pkg, name).Model(m=1.0 / 325, N=0.005, f=1e-4,
                                     nu4=5e10, nu4w=5e10, **common)
    q = ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=11)
    m.set_q(q)
    k0 = 4 * 2 * np.pi / m.L
    if name == "QGModel":
        m.set_c(np.real(np.asarray(ic.PlaneWave(m, k=k0, l=k0))) * 1e-2)
    else:
        m.set_phi(np.asarray(ic.WavePacket(m, k=k0, R=m.L / 6, x0=m.L / 2,
                                           y0=m.L / 2)) * 0.05)
    return m


def _fields(name):
    return (("q", "c", "Ke", "cvar") if name == "QGModel"
            else ("q", "phi", "Ke", "Pw", "Kw"))


def _step_loop(m):
    """The per-step reference loop, as ``run()`` would take it."""
    if m.saver.save_to_disk:
        m.saver.save_snapshot(m, m._snapshot_fields())
    for _ in range(m._count_steps(m.params.tmax)):
        m._step_forward()
    if m.saver.save_to_disk:
        m.saver.save_diagnostics(m.diagnostics)


def _assert_bitwise(a, b):
    """Two port models: the same counter, state and series, bit for bit."""
    assert a.tc == b.tc
    la, lb = _leaves(a.state), _leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    da, db = a.diagnostics, b.diagnostics
    assert sorted(da) == sorted(db)
    for k in db:
        assert da[k]["count"] == db[k]["count"], k
        np.testing.assert_array_equal(da[k]["value"], db[k]["value"],
                                      err_msg=k)


def _assert_close_to_jax(t, j, name):
    assert t.tc == j.tc
    for k in _fields(name):
        a, b = getattr(t, k), np.asarray(getattr(j, k))
        if np.ndim(b):
            assert _rel(a, b) <= 1e-12, k
        else:
            assert abs(a - float(b)) <= 1e-12 * abs(float(b)) + 1e-300, k
    td, jd = t.diagnostics, j.diagnostics
    assert sorted(td) == sorted(jd)
    np.testing.assert_array_equal(td["time"]["value"], jd["time"]["value"])
    for k in jd:
        a, b = td[k]["value"], jd[k]["value"]
        assert a.shape == b.shape, k
        assert np.abs(a - b).max(initial=0.0) \
            <= 1e-10 * np.abs(b).max(initial=0.0) + 1e-20, k


@pytest.mark.parametrize("tdiags,twrite,tsave", CADENCES)
@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_run_matches_step_loop_and_jax(name, kw, tdiags, twrite, tsave):
    """17 steps: ``run()`` equals the port's per-step loop bit for bit
    (state, every series, sample times, ``tc``) and JAX's ``run()`` in f64
    (fields 1e-12 relative, series 1e-10, sample times equal)."""
    cad = dict(tdiags=tdiags, twrite=twrite, tsave_snapshots=tsave)
    a = _build(tpkg, tic, name, kw, **cad)
    a.run()
    b = _build(tpkg, tic, name, kw, **cad)
    _step_loop(b)
    assert a.tc == NSTEPS
    assert not a._runner.graphs  # the host: direct calls
    _assert_bitwise(a, b)
    assert a.diagnostics["time"]["count"] == len(range(0, NSTEPS, tdiags))
    j = _build(jpkg, jic, name, kw, **cad)
    j.run()
    _assert_close_to_jax(a, j, name)


@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_run_with_snapshots_matches_jax(name, kw):
    """``run_with_snapshots(0, 5 dt)``: the port yields JAX's times, with
    the chunks ending at the yields, and its live model there is the
    per-step loop's; the run ends where JAX's does."""
    cad = dict(tdiags=3, twrite=7)
    t = _build(tpkg, tic, name, kw, **cad)
    ref = _build(tpkg, tic, name, kw, **cad)
    ys = []
    for y in t.run_with_snapshots(tsnapstart=0.0, tsnapint=5 * DT):
        while ref.tc < t.tc:
            ref._step_forward()
        _assert_bitwise(t, ref)  # the model a caller inspects
        ys.append(y)
    j = _build(jpkg, jic, name, kw, **cad)
    assert ys == list(j.run_with_snapshots(tsnapstart=0.0,
                                           tsnapint=5 * DT))
    assert ys == [5 * DT, 10 * DT, 15 * DT]
    _assert_close_to_jax(t, j, name)


def test_qg_snapshot_files_match_step_loop(tmp_path):
    """``save_to_disk`` (h5): the chunked run writes the per-step loop's
    snapshot files, the same diagnostics and the same final state."""
    pytest.importorskip("h5py")
    cad = dict(tdiags=4, twrite=6, tsave_snapshots=5, save_to_disk=True,
               overwrite=True)
    a = _build(tpkg, tic, "QGModel", {}, nsteps=12,
               path=str(tmp_path / "a"), **cad)
    a.run()
    b = _build(tpkg, tic, "QGModel", {}, nsteps=12,
               path=str(tmp_path / "b"), **cad)
    _step_loop(b)
    sa = sorted(os.listdir(tmp_path / "a" / "snapshots"))
    sb = sorted(os.listdir(tmp_path / "b" / "snapshots"))
    assert sa == sb == ["000000000000000.h5", "000000000050000.h5",
                        "000000000100000.h5"]
    _assert_bitwise(a, b)


@pytest.mark.parametrize("name", ["CoupledModel", "QGModel"])
def test_one_fetch_per_chunk(name):
    """A sample every step and a status line every 10 over 20 steps: two
    chunks, so two fetches of the diagnostics, not twenty (the per-step
    loop makes twenty); ``run_steps`` fetches none."""
    a = _build(tpkg, tic, name, {}, nsteps=20, tdiags=1, twrite=10)
    a.run()
    assert a._diag_acc.fetches == 2
    assert a.diagnostics["time"]["count"] == 20
    b = _build(tpkg, tic, name, {}, nsteps=20, tdiags=1, twrite=10)
    _step_loop(b)
    assert b._diag_acc.fetches == 20
    _assert_bitwise(a, b)
    a.run_steps(3)
    assert a._diag_acc.fetches == 2 and a.tc == 23


def test_set_active_diagnostics_between_runs():
    """Two runs with another active set between them: the second run's
    samples go to its active series only, as in the per-step loop."""
    series = []
    for chunked in (True, False):
        m = _build(tpkg, tic, "UnCoupledModel", {"faithful_quirks": True},
                   nsteps=6, tdiags=2, twrite=5)
        for tmax, active in ((6 * DT, None), (13 * DT, ["time", "Ke",
                                                        "ep_phi"])):
            if active is not None:
                m.set_active_diagnostics(active)
            m.params = dataclasses.replace(m.params, tmax=tmax)
            if chunked:
                m.run()
            else:
                _step_loop(m)
        series.append(m)
    a, b = series
    _assert_bitwise(a, b)
    d = a.diagnostics
    assert d["time"]["count"] == d["ep_phi"]["count"] == 3 + 4
    assert d["Pw"]["count"] == 3 and not d["Pw"]["active"]


def test_run_steps_state_is_the_callers():
    """``run_steps`` returns the model's state, which later steps replace
    and never modify."""
    m = _build(tpkg, tic, "CoupledModel", {"fast": True})
    s = m.run_steps(2)
    assert s is m.state and m.tc == 2
    kept = [x.clone() for x in _leaves(s)]
    m.run_steps(3)
    assert m.tc == 5
    for x, y in zip(_leaves(s), kept):
        assert torch.equal(x, y)


def test_diagnostic_returning_a_host_number_raises():
    """A run evaluates the diagnostics on the device: one that returns a
    Python number (a constant inside a CUDA graph) is refused."""
    m = _build(tpkg, tic, "QGModel", {}, nsteps=2, tdiags=1)
    m.registry.add("one", "a host number", "-",
                   function=lambda K, s, aux: 1.0)
    m._diag_acc.series["one"] = []
    with pytest.raises(TypeError, match="'one' returned a float"):
        m.run()


class _HostValues(TorchFunctionMode):
    """Records every call that makes a tensor from a host value or reads
    one back: on a card each is a blocking copy, and one that a CUDA graph
    capture refuses."""

    READS = (torch.tensor, torch.as_tensor, torch.Tensor.item,
             torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy)

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            self.hits.append(func.__name__)
        elif (func is torch.Tensor.__setitem__
              and not torch.is_tensor(args[2])):
            self.hits.append(f"__setitem__ of a {type(args[2]).__name__}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,kw", MODELS + [(
    "CoupledModel", dict(backend="mxu", dtype=np.float32, precision="split",
                         transform_opts=K1_OPTS))], ids=IDS + ["coupled-k1"])
def test_step_and_diagnostics_take_no_host_values(name, kw):
    """What a graph captures (a step, a diagnostics sample, the gradient
    refresh) makes no tensor from a Python number and reads nothing back
    to the host, once a first step has made the grid's lazy tables (as the
    step before each capture does)."""
    m = _build(tpkg, tic, name, kw)
    K = m.kernel

    def sample(s0):
        s = K.step(s0)
        m._diag_fn(s, s0.t)
        return K.refresh_phi_gradients(s) if m._stale_grads else s

    s = sample(m.state)
    with _HostValues() as mode:
        sample(s)
    assert mode.hits == []
