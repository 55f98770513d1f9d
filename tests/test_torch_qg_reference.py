"""The QG cell's plain reference (``portbench/reference/qg.py``) against the
port on the host, with the configuration's physics and the harness's
seeded fields (``portbench/initial/lamb_dipole_scalar.py``).

- The port in float64 at 64² follows the reference from the initial
  fields (the upstream's set_q/set_c order) and resumed from the port's
  state mid-run (fields and the budget integrals ``Ke``, ``cvar``): fields
  to 1e-12 of their scale, every diagnostic series to 1e-10, the
  tolerances of the coupled reference's tests.
- The harness's own run of ``qg2048.run`` at 32² in float64 is correct, and
  with a fault planted in the program (``portbench/tests/qg_faults.py``)
  it is not, under the configuration's limits (``check.judge``).
- The generator gives the same fields for the same seed, and the same
  shapes for every seed.
"""

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from niwqg_tpu_torch import QGModel  # noqa: E402
from portbench import cell, check, run, spec  # noqa: E402
from portbench.initial import lamb_dipole_scalar  # noqa: E402
from portbench.reference import qg  # noqa: E402

CONFIG, CELL = "qg_lamb_scalar_2048", "qg2048.run"
NX, STEPS, TDIAGS = 64, 20, 10
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in the harness's worker process: at
    these sizes it is the fastest, and the suite's workers share the
    host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed):
    cfg = spec.config(CONFIG)
    initial = spec.traffic("run_qg_d10")["initial"]
    fields = lamb_dipole_scalar.make(NX, cfg["model"]["L"], seed, initial,
                                     CPU)
    ref = qg.Reference(qg.params_from(dict(cfg["model"], nx=NX)), CPU)
    return cfg, fields, ref


def _port(cfg, fields, steps):
    kw = dict(cfg["model"], nx=NX, dtype=np.float64)
    m = QGModel.Model(tdiags=TDIAGS, tmax=kw["dt"] * (steps - 0.5),
                      device="cpu", **kw)
    m.set_q(fields["q"].numpy())
    m.set_c(fields["c"].numpy())
    m.run()
    return m


def _held(m, s, series, skip=0):
    got = qg.physical(s)
    for k in qg.FIELDS:
        assert check.rel_max(getattr(m, k), got[k]) < 1e-12, k
    assert set(spec.config(CONFIG)["compare"]["diagnostics"]) <= set(series)
    for k, v in series.items():
        prog = np.asarray(m.diagnostics[k]["value"])[skip:]
        assert prog.shape == v.shape, k
        assert check.rel_max(prog, v.numpy()) < 1e-10, k


def test_reference_follows_the_port():
    cfg, fields, ref = _setup(2024)
    m = _port(cfg, fields, 2 * STEPS)
    assert m.kernel.dtype == np.float64 and m.tc == 2 * STEPS
    s, series = qg.run_segment(ref, ref.start(**fields), 2 * STEPS, TDIAGS,
                               0)
    _held(m, s, series)
    assert m.Ke == pytest.approx(float(s.Ke), rel=1e-12)
    assert m.cvar == pytest.approx(float(s.cvar), rel=1e-12)


def test_reference_resumes_from_the_port_state():
    cfg, fields, ref = _setup(7)
    m = _port(cfg, fields, STEPS)
    mid = {k: torch.as_tensor(getattr(m, k)) for k in qg.FIELDS}
    budgets = {k: getattr(m, k) for k in qg.BUDGETS}
    m2 = _port(cfg, fields, 2 * STEPS)
    s, series = qg.run_segment(ref, ref.resume(**mid, **budgets), STEPS,
                               TDIAGS, STEPS)
    _held(m2, s, series, skip=STEPS // TDIAGS)


def _harness(fault):
    """The harness's run of the cell at 32² in float64 (in a process of
    its own, so that a planted fault dies with it), judged by the
    configuration's limits as ``run.report`` judges it: ``(correct,
    checks)``. (``run.report`` itself refuses a process that holds JAX,
    as this suite's does.)"""
    job = cell.Job(workload=CELL, seed=3000000019, seconds=0.5, trace=False,
                   t_start=time.time(), device="cpu",
                   overrides={"model": {"nx": 32, "dtype": "float64"}},
                   prepare=fault and f"portbench.tests.qg_faults:{fault}")
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        res = ex.submit(run.execute, job, 1).result(timeout=600)
    nums = {k: v for r in res["records"] for k, v in r["nums"].items()}
    correct, checks = check.judge(nums, spec.config(CONFIG)["limits"])
    return correct and all(r["finite"] for r in res["records"]), checks


@pytest.mark.parametrize("fault", [None, "beta_dropped",
                                   "scalar_advection_dropped",
                                   "nu4c_for_nu4"])
def test_planted_fault_is_not_correct(fault):
    correct, checks = _harness(fault)
    assert correct is (fault is None), checks


def test_uniform_cvar_weights_are_second_order():
    """The upstream samples the stage sources after each stage, at t +
    dt/2, t + dt/2, t + dt and t + dt, where RK4's weights (1, 2, 2, 1)/6
    and uniform ones (1, 1, 1, 1)/4 give the same sum to second order in
    dt: a fault there moves ``cvar`` by ~1e-12 of itself, which no limit
    can tell from rounding, and the run stays correct."""
    correct, checks = _harness("cvar_weights_uniform")
    assert correct, checks


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 11, 2 ** 32 + 3])
def test_generator_seeds(seed):
    initial = spec.traffic("run_qg_d10")["initial"]
    a = lamb_dipole_scalar.make(48, 1e6, seed, initial, CPU)
    b = lamb_dipole_scalar.make(48, 1e6, seed, initial, CPU)
    other = lamb_dipole_scalar.make(48, 1e6, seed + 1, initial, CPU)
    assert set(a) == {"q", "c"}
    for k in a:
        assert a[k].shape == (48, 48) and a[k].dtype == torch.float64
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], other[k])
        assert torch.isfinite(a[k]).all()
    # the tracer: the plane wave's scale with its perturbation's rms
    scale = a["q"].abs().max()
    rms = torch.sqrt(((a["c"] / scale) ** 2).mean())
    assert float(rms) == pytest.approx(
        np.sqrt(0.5 + initial["c_perturbation"] ** 2), rel=0.05)
