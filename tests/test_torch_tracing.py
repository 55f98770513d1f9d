"""The port's spans and host counters (``niwqg_tpu_torch/utils/profiling.py``):
nesting and parents, totals, counters and ``reset``, the bound on the spans
kept one by one, ``record_function`` only under an active profiler, the run
loop's spans once per chunk in a ``torch.profiler`` trace, the set-up spans
of a model, none inside a step (K2's plans, set-up, open theirs only
outside a capture), and the counters of the ETDRK4 table cache. On the
host, at nx=16."""

import ctypes.util
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu_torch as tpkg  # noqa: E402
from niwqg_tpu_torch import cuda_build, etdrk4  # noqa: E402
from niwqg_tpu_torch.parallel import a2a, multihost  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402

DT = 10000.0


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _qg(nx=16, **kw):
    m = tpkg.QGModel.Model(nx=nx, dt=DT, device="cpu", **kw)
    rng = np.random.default_rng(5)
    m.set_q(1e-6 * rng.standard_normal((nx, nx)))
    return m


def test_nesting_and_parents():
    with profiling.span("a.outer"):
        with profiling.span("a.inner"):
            with profiling.span("a.leaf"):
                pass
        with profiling.span("a.inner"):
            pass
    with profiling.span("a.next"):
        pass
    recs = profiling.spans()["list"]
    assert [r["name"] for r in recs] == ["a.outer", "a.inner", "a.leaf",
                                         "a.inner", "a.next"]
    assert [r["parent"] for r in recs] == [None, 0, 1, 0, None]
    for r in recs:
        assert r["end_ns"] >= r["start_ns"]
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


def test_a_thread_has_its_own_parents():
    seen = threading.Event()

    def other():
        with profiling.span("t.other"):
            pass
        seen.set()

    with profiling.span("t.main"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert seen.is_set() and not th.is_alive()
    recs = {r["name"]: r for r in profiling.spans()["list"]}
    assert recs["t.other"]["parent"] is None
    assert recs["t.main"]["parent"] is None


def test_a_span_decorates_and_closes_on_a_raise():
    @profiling.span("d.fn")
    def fn(x):
        if x < 0:
            raise ValueError("negative")
        return 2 * x

    assert fn(3) == 6 and fn.__name__ == "fn"
    with pytest.raises(ValueError):
        fn(-1)
    tot = profiling.spans()["totals"]["d.fn"]
    assert tot["calls"] == 2 and tot["s"] >= 0
    assert all(r["end_ns"] is not None for r in profiling.spans()["list"])
    # the stack unwound: the next span has no parent
    with profiling.span("d.after"):
        pass
    assert profiling.spans()["list"][-1]["parent"] is None


def test_totals_counters_and_reset():
    for _ in range(3):
        with profiling.span("c.x"):
            pass
    with profiling.span("c.y"):
        with profiling.span("c.open"):
            inside = profiling.spans()
    assert inside["list"][-1]["end_ns"] is None  # c.open is still open
    profiling.count("c.n")
    profiling.count("c.n", 4)
    profiling.count("c.m", 0)
    tot = profiling.spans()["totals"]
    assert tot["c.x"]["calls"] == 3 and tot["c.y"]["calls"] == 1
    assert tot["c.y"]["s"] >= tot["c.open"]["s"]
    assert profiling.counters() == {"c.n": 5, "c.m": 0}
    profiling.reset()
    assert profiling.counters() == {}
    assert profiling.spans() == {"totals": {}, "dropped": 0, "list": []}


def test_the_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profiling.span("b.parent"):
        for _ in range(9):
            with profiling.span("b.child"):
                pass
    got = profiling.spans()
    assert len(got["list"]) == 5 and got["dropped"] == 5
    assert got["totals"]["b.child"]["calls"] == 9
    # kept in the order they opened: the parent first, every kept child's
    # parent kept too
    assert got["list"][0]["name"] == "b.parent"
    assert all(r["parent"] == 0 for r in got["list"][1:])


def test_record_function_only_under_a_profiler(monkeypatch):
    calls = []

    class Fake:
        def __init__(self, name):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Fake)
    with profiling.span("p.off"):
        pass
    assert calls == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("p.on"):
            pass
    assert calls == ["p.on"]
    assert profiling.spans()["totals"]["p.off"]["calls"] == 1


def test_run_loop_spans_once_per_chunk_in_a_profiler_trace():
    """``run_with_snapshots`` yields every 3 steps over 12 steps, the status
    line every 6: 4 chunks, each with its enqueue and its fetch (a sample
    every 3 steps), two with the status line; the spans lie in the
    profiler's host events and in the recorder, each inside its chunk."""
    from torch.profiler import ProfilerActivity, profile

    m = _qg(tmax=12 * DT, tdiags=3, twrite=6)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n = sum(1 for _ in m.run_with_snapshots(tsnapstart=0.0,
                                                tsnapint=3 * DT))
    assert n == 4 and m.tc == 12
    host = [e.name for e in prof.events()]
    for name, k in (("shell.chunk", 4), ("runner.enqueue", 4),
                    ("runner.fetch", 4), ("shell.status", 2)):
        assert host.count(name) == k, name
        assert profiling.spans()["totals"][name]["calls"] == k, name
    recs = profiling.spans()["list"]
    for r in recs:
        if r["name"] != "shell.chunk":
            assert recs[r["parent"]]["name"] == "shell.chunk", r["name"]
    assert "runner.copy_out" not in host  # no graphs on the host
    assert m._diag_acc.fetches == 4


def test_set_up_spans_of_a_model():
    m = _qg()
    tot = profiling.spans()["totals"]
    for name in ("model.init", "model.kernel", "model.transform",
                 "etdrk4.tables", "model.set_fields"):
        assert tot[name]["calls"] >= 1, name
    recs = profiling.spans()["list"]
    parent = {r["name"]: (recs[r["parent"]]["name"]
                          if r["parent"] is not None else None)
              for r in recs}
    assert parent["model.init"] is None
    assert parent["model.kernel"] == "model.init"
    assert parent["model.transform"] == "model.kernel"
    assert parent["etdrk4.tables"] == "model.kernel"
    assert parent["model.set_fields"] is None
    assert tot["model.set_fields"]["calls"] == 1  # set_q
    assert m.tc == 0


def test_no_span_inside_a_step_or_a_diagnostic(monkeypatch):
    """No span opens inside a step or a diagnostic. The host makes no K2
    plan: on the card a key's first eager call makes one inside its
    ``mesh.k2_group`` span (and may load the library), set-up that a
    capture never reaches (``test_k2_plan_spans_outside_a_capture_only``).
    """
    m = _qg(tmax=6 * DT, tdiags=2, twrite=3)
    inside = []
    K = m.kernel
    step, diag = K.step, m._diag_fn

    def mark(fn):
        def wrapped(*a, **kw):
            inside.append(True)
            try:
                return fn(*a, **kw)
            finally:
                inside.pop()
        return wrapped

    monkeypatch.setattr(K, "step", mark(step))
    monkeypatch.setattr(m, "_diag_fn", mark(diag))
    opened = []
    real_open = profiling._open

    def spy(name):
        opened.append((name, bool(inside)))
        return real_open(name)

    monkeypatch.setattr(profiling, "_open", spy)
    m.run()
    assert m.tc == 6 and opened
    assert not [name for name, within in opened if within]


def test_the_table_cache_counts(tmp_path, monkeypatch):
    """A model built twice at the table cache's size (the size lowered to
    nx=16's table; the cache a fresh directory): the first build misses
    and builds the table, the second hits."""
    monkeypatch.setenv("NIWQG_TORCH_TABLE_CACHE", str(tmp_path))
    monkeypatch.setattr(etdrk4, "_TABLE_CACHE_MIN_ELEMS", 16 * 9)
    tpkg.QGModel.Model(nx=16, dt=DT, device="cpu")
    assert profiling.counters() == {"etdrk4.cache_miss": 1,
                                     "etdrk4.built": 1}
    profiling.reset()
    tpkg.QGModel.Model(nx=16, dt=DT, device="cpu")
    assert profiling.counters() == {"etdrk4.cache_hit": 1}
    monkeypatch.setenv("NIWQG_TORCH_TABLE_CACHE", "0")
    profiling.reset()
    tpkg.QGModel.Model(nx=16, dt=DT, device="cpu")
    assert profiling.counters() == {"etdrk4.built": 1}


def test_a_kernel_library_load_is_a_span_once(monkeypatch):
    """``cuda_build.load`` spans and counts the first load of a library in
    the process, not the calls that find it loaded (a stand-in library:
    the host has no nvcc)."""
    libm = ctypes.util.find_library("m") or ctypes.util.find_library("c")
    if libm is None:
        pytest.skip("no C library to stand in for a kernel's")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build_all",
                        lambda names, defines=(): {n: libm for n in names})
    a = cuda_build.load("standin")
    assert cuda_build.load("standin") is a
    assert profiling.counters() == {}  # no nvcc build
    assert profiling.spans()["totals"]["cuda_build.load"]["calls"] == 1


def test_mesh_spans_of_a_one_process_run():
    multihost.initialize()  # bare: stays one process
    mesh = multihost.global_mesh(device="cpu")
    group = a2a.PeerGroup.local(["cpu", "cpu"])
    tot = profiling.spans()["totals"]
    assert tot["mesh.init"]["calls"] == 2
    assert tot["mesh.k2_group"]["calls"] == 1
    assert mesh.device.type == "cpu" and group.nP == 2


class _Stop(Exception):
    pass


def test_k2_plan_spans_outside_a_capture_only(monkeypatch):
    """A K2 plan is set-up under ``mesh.k2_group``; at a capture it is
    refused before its span opens (a stand-in library that stops the
    plan: the host has none)."""
    group = a2a.PeerGroup.local(["cpu", "cpu"])

    def stop():
        raise _Stop

    monkeypatch.setattr(a2a, "_library", stop)
    profiling.reset()
    with pytest.raises(_Stop):
        group._plan("fwd", (2, 4, 8), torch.complex64, 1)
    assert profiling.spans()["totals"]["mesh.k2_group"]["calls"] == 1
    profiling.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        group._plan("fwd", (2, 4, 8), torch.complex64, 1)
    assert profiling.spans() == {"totals": {}, "dropped": 0, "list": []}


@pytest.mark.cuda
def test_runner_spans_and_counters_on_the_card():
    """On the card: graph B's and graph A's eager first steps and their
    captures, a span each; every chunk copies its state out of the
    static buffers and fetches its samples."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = tpkg.QGModel.Model(nx=64, dt=DT, tmax=20 * DT, tdiags=5, twrite=10)
    m.set_q(1e-6 * np.random.default_rng(5).standard_normal((64, 64)))
    profiling.reset()
    assert sum(1 for _ in m.run_with_snapshots(tsnapstart=0.0,
                                               tsnapint=10 * DT)) == 2
    assert m._runner.graphs and m._runner.replays == 18
    assert profiling.counters() == {}
    tot = profiling.spans()["totals"]
    for name, k in (("runner.first_step", 2), ("runner.capture", 2),
                    ("shell.chunk", 2), ("runner.enqueue", 2),
                    ("runner.copy_out", 2), ("runner.fetch", 2),
                    ("shell.status", 2)):
        assert tot[name]["calls"] == k, name
