"""The YBJ cell's plain reference (``portbench/reference/ybj.py``) against
the port on the host, with the configuration's physics and the harness's
seeded fields (``portbench/initial/lamb_dipole_waves.py``).

- The port in float64 at 64² follows the reference from the initial
  fields (the upstream's set_q/set_phi order) and resumed from the port's
  state mid-run, with ``faithful_quirks`` on and off and the reference
  switched the same way: phi to 1e-12 of its scale, every compared series
  to 1e-10 (the coupled and QG reference tests' tolerances), q bit for bit
  what ``set_q`` was given. A reference that ignored the step-start
  refraction would miss the faithful port by far more.
- The reference in bfloat16 (the control) departs from float64 by more
  than the configuration's phi limit.
- The harness's own run of ``ybj2048.run`` at 32² in float64 is correct,
  and with a fault planted in the program (``portbench/tests/ybj_faults.py``)
  it is not, under the configuration's limits (``check.judge``).
- The counters ``step.ybj`` (one an eager step or a capture, none a
  replay on the card) and ``diag.field_sources`` (one a diagnostics
  sample from the host).
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

from niwqg_tpu_torch import YBJModel  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402
from portbench import cell, check, run, spec  # noqa: E402
from portbench.initial import lamb_dipole_waves  # noqa: E402
from portbench.reference import ybj  # noqa: E402

CONFIG, CELL = "ybj_lamb_2048", "ybj2048.run"
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


def _model_kw(faithful, nx=NX):
    return dict(spec.config(CONFIG)["model"], nx=nx,
                faithful_quirks=faithful)


def _setup(seed, faithful=True, ref_faithful=None, mode="f64"):
    kw = _model_kw(faithful)
    initial = spec.traffic("run_d10")["initial"]
    fields = lamb_dipole_waves.make(NX, kw["L"], seed, initial, CPU)
    rkw = dict(kw, faithful_quirks=(faithful if ref_faithful is None
                                    else ref_faithful))
    return fields, ybj.Reference(ybj.params_from(rkw), CPU, mode)


def _port(fields, steps, faithful=True):
    kw = dict(_model_kw(faithful), dtype=np.float64)
    m = YBJModel.Model(tdiags=TDIAGS, tmax=kw["dt"] * (steps - 0.5),
                       device="cpu", **kw)
    m.set_q(fields["q"].numpy())
    m.set_phi(fields["phi"].numpy())
    m.run()
    return m


def _held(m, s, series, fields, skip=0):
    got = ybj.physical(s)
    assert check.rel_max(m.phi, got["phi"]) < 1e-12
    # the flow is frozen: q is what set_q was given, bit for bit
    assert np.array_equal(m.q, fields["q"].numpy())
    assert set(series) == set(spec.config(CONFIG)["compare"]["diagnostics"])
    for k, v in series.items():
        prog = np.asarray(m.diagnostics[k]["value"])[skip:]
        assert prog.shape == v.shape, k
        assert check.rel_max(prog, v.numpy()) < 1e-10, k


@pytest.mark.parametrize("faithful", [True, False])
def test_reference_follows_the_port(faithful):
    fields, ref = _setup(2024, faithful)
    m = _port(fields, 2 * STEPS, faithful)
    assert m.kernel.dtype == np.float64 and m.tc == 2 * STEPS
    assert m.kernel.faithful_quirks is faithful
    s, series = ybj.run_segment(ref, ref.start(**fields), 2 * STEPS, TDIAGS,
                                0)
    _held(m, s, series, fields)


@pytest.mark.parametrize("faithful", [True, False])
def test_reference_resumes_from_the_port_state(faithful):
    fields, ref = _setup(7, faithful)
    m = _port(fields, STEPS, faithful)
    mid = {k: torch.as_tensor(getattr(m, k)) for k in ybj.FIELDS}
    m2 = _port(fields, 2 * STEPS, faithful)
    s, series = ybj.run_segment(ref, ref.resume(**mid), STEPS, TDIAGS,
                                STEPS)
    _held(m2, s, series, fields, skip=STEPS // TDIAGS)


def test_the_step_start_refraction_is_seen():
    """The faithful port against a reference whose stages read their own
    phi: six orders of magnitude over the tolerance at 64²."""
    fields, ref = _setup(2024, True, ref_faithful=False)
    m = _port(fields, 2 * STEPS, True)
    s, _ = ybj.run_segment(ref, ref.start(**fields), 2 * STEPS, TDIAGS, 0)
    assert check.rel_max(m.phi, ybj.physical(s)["phi"]) > 1e-7


def test_bf16_control_departs_by_more_than_the_phi_limit():
    limits = spec.config(CONFIG)["limits"]
    out = {}
    for mode in ("f64", "bf16"):
        fields, ref = _setup(3, mode=mode)
        s, _ = ybj.run_segment(ref, ref.start(**fields), 5, TDIAGS, 0)
        out[mode] = ybj.physical(s)
    assert check.rel_max(out["bf16"]["phi"], out["f64"]["phi"]) > max(
        limits["phi_start"], limits["phi_end"])


def _harness(fault):
    """The harness's run of the cell at 32² in float64 (in a process of
    its own, so that a planted fault dies with it), judged by the
    configuration's limits as ``run.report`` judges it: ``(correct,
    checks)``. (``run.report`` itself refuses a process that holds JAX,
    as this suite's does.)"""
    job = cell.Job(workload=CELL, seed=3000000023, seconds=0.5, trace=False,
                   t_start=time.time(), device="cpu",
                   overrides={"model": {"nx": 32, "dtype": "float64"}},
                   prepare=fault and f"portbench.tests.ybj_faults:{fault}")
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        res = ex.submit(run.execute, job, 1).result(timeout=600)
    nums = {k: v for r in res["records"] for k, v in r["nums"].items()}
    correct, checks = check.judge(nums, spec.config(CONFIG)["limits"])
    return correct and all(r["finite"] for r in res["records"]), checks


@pytest.mark.parametrize("fault", [None, "step_unchanged", "phi_altered"])
def test_planted_fault_is_not_correct(fault):
    correct, checks = _harness(fault)
    assert correct is (fault is None), checks


def _counted():
    c = profiling.counters()
    return c.get("step.ybj", 0), c.get("diag.field_sources", 0)


def test_counters_on_the_host():
    """On the host every step is eager: one ``step.ybj`` a step, one
    ``diag.field_sources`` a diagnostics sample."""
    fields, _ = _setup(11)
    kw = dict(_model_kw(True, nx=32), dtype=np.float64)
    m = YBJModel.Model(tdiags=5, tmax=kw["dt"] * 19.5, device="cpu", **kw)
    m.set_q(fields["q"][::2, ::2].numpy())
    m.set_phi(fields["phi"][::2, ::2].numpy())
    steps0, samples0 = _counted()
    m.run_steps(3)
    assert _counted() == (steps0 + 3, samples0)
    m.run()  # to step 20, sampling at pre-step counters 5, 10 and 15
    samples = len(m.diagnostics["time"]["value"])
    assert samples == 3 and m.tc == 20
    assert _counted() == (steps0 + 20, samples0 + samples)


@pytest.mark.cuda
def test_replays_count_no_host_step():
    """On the card graph A's and B's eager first step and capture count
    once each; their replays count nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    nx = 256
    fields = lamb_dipole_waves.make(nx, 1e6, 5,
                                    spec.traffic("run_d10")["initial"], CPU)
    kw = dict(_model_kw(True, nx=nx), L=1e6, dtype=np.float32)
    m = YBJModel.Model(tdiags=5, tmax=kw["dt"] * 100, **kw)
    m.set_q(fields["q"].numpy())
    m.set_phi(fields["phi"].numpy())
    assert m._runner.graphs
    steps0, samples0 = _counted()
    m.run_steps(6)  # graph A: a first step, its capture, 5 replays
    assert _counted() == (steps0 + 2, samples0)
    m.run_steps(6)
    assert _counted() == (steps0 + 2, samples0)
    m._runner.advance(18)  # pre-step counters 15, 20, 25: graph B
    assert _counted() == (steps0 + 4, samples0 + 2)
    assert m._runner.replays == 5 + 6 + 17
    assert len(m.diagnostics["time"]["value"]) == 3
