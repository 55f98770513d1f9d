"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files it names by name under ``portbench/``: a configuration
``configs/<config>.json``, a traffic mix ``traffic/<traffic>.json`` and a
per-layer metric's reader ``metrics/<metric>.py``. A cell, a mix or a
metric is added by adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def cell(bench: dict, workload: str) -> dict:
    """The workload entry named ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def metrics_of(bench: dict, workload: str, section: str) -> list:
    """The ``section`` (``end_to_end`` or ``per_layer``) metrics that cell
    ``workload`` reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """The ``read(r)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
