"""The arithmetic of the program's spans (``portbench/spans.py``) by hand
on synthetic spans: a group's seconds less its nested ``mesh.*`` spans, the
largest of four ranks, the idle stretches labelled by the innermost program
span (one under a nested span, one outside every span) beside the
harness's own labels, and the run loop's idle a step; and
``tools/trace_cell.py``'s run of each cell on the host."""

import io
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import spans, trace  # noqa: E402

S = 10 ** 9  # ns a second


def _rank(scale=1.0):
    """One rank's spans: a model build (10 s) that holds a K2 group (2 s,
    with a kernel load of 1.5 s inside it) and the fields (1 s); the first
    step (3 s, with a K2 plan of 0.5 s) and two captures (0.25 s each);
    the mesh's start (4 s) outside them; a chunk of the loop."""
    t = lambda x: int(x * scale * S)  # noqa: E731
    rows = [("mesh.init", None, 0, 4),
            ("model.init", None, 4, 14),
            ("model.transform", 1, 4, 7),
            ("mesh.k2_group", 2, 4.5, 6.5),
            ("cuda_build.load", 3, 5, 6.5),
            ("model.set_fields", None, 14, 15),
            ("runner.first_step", None, 15, 18),
            ("mesh.k2_group", 6, 16, 16.5),
            ("runner.capture", None, 18, 18.25),
            ("runner.first_step", None, 18.25, 18.25),
            ("runner.capture", None, 18.25, 18.5),
            ("shell.chunk", None, 20, 21)]
    return {"totals": {}, "dropped": 0, "counters": {},
            "list": [{"name": n, "parent": p, "start_ns": t(a),
                      "end_ns": t(b)} for n, p, a, b in rows]}


def test_setup_seconds_less_the_mesh():
    r = _rank()
    model = ("model.init", "model.set_fields")
    assert spans.setup_seconds(r, model) == pytest.approx(11 - 2)
    assert spans.setup_seconds(r, model, less=None) == pytest.approx(11)
    capture = ("runner.first_step", "runner.capture")
    assert spans.setup_seconds(r, capture) == pytest.approx(3.5 - 0.5)
    mesh = ("mesh.init", "mesh.k2_group")
    # the outermost of the group: the kernel load is inside a K2 group
    assert spans.setup_seconds(r, mesh, less=None) == pytest.approx(
        4 + 2 + 0.5)


def test_an_open_span_counts_nothing():
    r = _rank()
    r["list"][5]["end_ns"] = None  # model.set_fields still open
    assert spans.setup_seconds(r, ("model.set_fields",)) == 0.0


def test_the_largest_of_four_ranks_wins():
    ranks = [_rank(1.0), _rank(1.5), _rank(0.5), _rank(1.2)]
    names, less = spans.GROUPS["model"]
    assert spans.largest(ranks, names, less) == pytest.approx(1.5 * 9)
    names, less = spans.GROUPS["capture"]
    assert spans.largest(ranks, names, less) == pytest.approx(1.5 * 3)
    names, less = spans.GROUPS["mesh"]
    assert spans.largest(ranks, names, less) == pytest.approx(1.5 * 6.5)
    # a group no rank recorded, or no ranks, reads nothing, not 0
    assert spans.largest(ranks, ("model.absent",)) is None
    assert spans.largest([], names) is None


def test_idle_by_the_innermost_program_span():
    """Idle 0-10 under nothing of the program's (the harness's own span
    and a runtime call do not count), 40-50 under ``runner.fetch`` inside
    ``shell.chunk`` (the innermost program span wins over the chunk and
    over the runtime call inside it), 70-80 under the chunk alone, 90-100
    outside every span."""
    dev = [("k", 10.0, 40.0), ("k", 50.0, 70.0), ("k", 80.0, 90.0)]
    host = [("portbench.traced_window", 0.0, 100.0),
            ("cudaGraphLaunch", 0.0, 10.0),
            ("shell.chunk", 20.0, 85.0),
            ("runner.fetch", 35.0, 55.0),
            ("cudaMemcpyAsync", 38.0, 52.0),
            ("aten::copy_", 37.0, 53.0)]
    idle = dict(trace.summarize(dev, spans.program_host(host), 4)[
        "idle_gaps"])
    assert idle == pytest.approx({spans.OUTSIDE: 20e-6,
                                  "runner.fetch": 10e-6,
                                  "shell.chunk": 10e-6})
    # the harness's own labels, from every host event
    own = dict(trace.summarize(dev, host, 4)["idle_gaps"])
    assert own == pytest.approx({"cudaGraphLaunch": 10e-6,
                                 "cudaMemcpyAsync": 10e-6,
                                 "shell.chunk": 10e-6,
                                 "no host span": 10e-6})
    r = {"steps": 4, "idle_by_span": idle}
    assert spans.loop_idle_ms(r) == pytest.approx(1e3 * 20e-6 / 4)
    assert spans.loop_idle_ms({"steps": 4}) is None


@pytest.mark.parametrize("name,program", [
    ("shell.chunk", True), ("runner.fetch", True), ("mesh.init", True),
    ("cuda_build.load", True), ("etdrk4.tables", True),
    ("model.set_fields", True), ("aten::copy_", False),
    ("cudaGraphLaunch", False), ("portbench.traced_window", False),
    ("Command Buffer Full", False), ("shell", False),
])
def test_which_host_spans_are_the_programs(name, program):
    assert spans.is_program(name) is program


def _trace_cell_run(chips):
    """``tools/trace_cell.py``'s run of a cell, cut as ``_cpu`` cuts it,
    and its ``spans`` lines (in a process of its own: the tool patches
    ``trace.summarize`` in its ranks)."""
    import trace_cell
    from portbench import run
    from portbench.tests import _cpu

    workload = "coupled2048.run" if chips == 1 else "coupled4096x4.run"
    j = _cpu.job(workload, 2 ** 31 + 11, trace=True,
                 prepare="trace_cell:install")
    res = run.execute(j, chips)
    return ([trace_cell.rank_line(r) for r in res["records"]],
            run.report(res, j, out=io.StringIO(), err=io.StringIO()))


@pytest.mark.parametrize("chips", [1, 4])
def test_trace_cell_on_the_host(chips):
    """Every rank's set-up by part, idle by program span and the run
    loop's spans a chunk; the run itself as ``run.py``'s."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        lines, code = ex.submit(_trace_cell_run, chips).result(timeout=600)
    assert code == 0 and len(lines) == chips
    for ln in lines:
        setup = ln["program_setup_s"]
        assert setup["model"] > 0 and setup["capture"] == 0.0  # no graphs
        assert (setup["mesh"] > 0) is (chips > 1)
        assert set(ln["idle_by_span_s"]) <= {"shell.chunk", "shell.status",
                                             "runner.enqueue",
                                             "runner.fetch", spans.OUTSIDE}
        assert ln["loop_idle_ms"] > 0
        assert ln["loop_spans"]["shell.chunk"]["per_chunk"] == 1
        assert ln["loop_spans"]["runner.enqueue"]["per_chunk"] == 1
        assert ln["counters"]["etdrk4.built"] >= 1 and ln["dropped"] == 0
