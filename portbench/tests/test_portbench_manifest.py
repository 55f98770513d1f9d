"""``BENCHMARK.json`` and the files it names: they load, every name and
unit keeps to the allowed characters, no module of the benchmark imports
JAX or the JAX package (top-level names compared whole), and the plain
reference imports nothing of the program. Then the command itself: without
the cards a cell asks for it exits 2 and prints no result; on a card
(``cuda`` marker) a short run prints a correct result line."""

import ast
import json
import math
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import spec  # noqa: E402

BENCH = spec.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"expansion|experts_per_tok|_dim$|_rank$|^nx$)")


def _line(s):
    return (isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s
            and "\t" not in s)


def test_benchmark_and_every_file_it_names_load():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1:] == ["portbench/run.py"]
    assert os.path.isfile(os.path.join(ROOT, BENCH["command"][1]))
    for section, (need, extra) in ENTRY_KEYS.items():
        for e in BENCH[section]:
            assert need <= set(e) <= need | extra, (section, e["name"])
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) and set(cfg["compare"]["diagnostics"])
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["ranks"] == w["chips"] in (1, 4)
        trf = spec.traffic(w["traffic"])
        assert trf["name"] == w["traffic"]
        assert trf["yield_every"] % trf["tdiags"] == 0
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_names_units_and_lines():
    names = []
    for section in ENTRY_KEYS:
        for e in BENCH[section]:
            assert spec.NAME.fullmatch(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert spec.UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert spec.NAME.fullmatch(k) and not WIDTHS.search(k), k
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        rel = os.path.relpath(dirpath, ROOT)
        if "__pycache__" in rel or ".cache" in rel:
            continue
        for f in files:
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", os.path.join(rel, f))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_metrics_cells_and_budget():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= set(cells)
    for w in cells:
        ends = spec.metrics_of(BENCH, w, "end_to_end")
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert spec.metrics_of(BENCH, w, "per_layer")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)
    T = BENCH["run_seconds"]
    assert isinstance(T, int) and 1 <= T <= 51
    # a full check of 24 cells, each run with its minute of margin and each
    # cell with three minutes to compile, fits in twelve hours
    assert (2 + 14 * 24) * (T + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _modules(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    """Compared by the whole top-level name: ``niwqg_tpu_torch`` is the
    program, ``niwqg_tpu`` the JAX package."""
    banned = {"jax", "jaxlib", "flax", "niwqg_tpu"}
    for path in _modules():
        assert not set(_imports(path)) & banned, path


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "torch"}
    for path in _modules("reference"):
        assert set(_imports(path)) <= allowed, path


def test_without_the_cards_it_exits_2_and_prints_nothing():
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards")
    workload = next(w["name"] for w in BENCH["workloads"]
                    if w["chips"] > torch.cuda.device_count())
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs" in p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = next(w for w in BENCH["workloads"] if w["chips"] == 1)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", w["name"],
         "--seed", "3000000002", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    for m in spec.metrics_of(BENCH, w["name"], "end_to_end"):
        v = line["metrics"][m["name"]]["value"]
        assert math.isfinite(v) and v > 0
    last = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [s.split()[0] for s in last] == list(line["checks"])
