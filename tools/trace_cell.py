#!/usr/bin/env python3
"""The program's own spans and counters over one run of a benchmark cell.

    python3 tools/trace_cell.py --workload coupled2048.run --seed 7 \\
        --seconds 30
    python3 tools/trace_cell.py --workload coupled4096x4.run --seed 7 \\
        --seconds 30

Runs the cell through ``portbench/run.py``'s own ``execute``, as ``--trace
1`` does (``portbench/cell.py``: set-up, warm-up, the window, two traced
yields, the check against the plain reference; a rank per card), with
:func:`install` as every rank's ``Job.prepare``, and prints, besides
``run.py``'s own lines and result, one ``spans`` line a rank (JSON): the totals of each span
(``niwqg_tpu_torch/utils/profiling.py``) and the host counters; the set-up
split into the harness's logged parts (``setup_parts_s``) and the program's
spans (``mesh``: ``mesh.init`` and ``mesh.k2_group``; ``model``:
``model.init`` and ``model.set_fields``; ``capture``: ``runner.first_step``
and ``runner.capture``; the last two less the ``mesh.*`` spans inside them);
and the traced yields' device idle by the innermost program span over each
idle stretch (``portbench/spans.py``), with the run loop's share
(``shell.*`` and ``runner.*``) in ms a step; and the fused derive's counter
``step.derive_fused`` beside four times the eager steps and captures
(``runner.first_step``, ``runner.capture``), which it exceeds by set_q's
inversion on the half layout; and the YBJ stepper's counters ``step.ybj``
and ``step.ybj_fused`` (its fused step, one card's CUDA tensors) beside
those eager steps and captures, one each (the physical-space budget
samples, ``diag.field_sources``, are among the counters). The
spans are read after the traced yields. Exits as ``run.py`` does. A
stopgap: once the harness carries each rank's spans in its record, its
readers print these numbers and this tool goes (PERF.md, Open
questions).
"""

import argparse
import json
import os
import statistics
import sys
import time

T_START = time.time()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]  # HERE: the ranks import ``trace_cell``

from portbench import cell as cell_mod  # noqa: E402
from portbench import run as run_mod  # noqa: E402
from portbench import spans as S  # noqa: E402
from portbench import spec, trace  # noqa: E402

_summarize = trace.summarize


def _summarize_with_spans(dev, host, steps):
    """``trace.summarize`` and, beside it, the idle stretches by program
    span and this rank's spans and counters."""
    from niwqg_tpu_torch.utils import profiling

    out = _summarize(dev, host, steps)
    out["idle_by_span"] = dict(_summarize(dev, S.program_host(host),
                                          steps)["idle_gaps"])
    out["spans"] = dict(profiling.spans(), counters=profiling.counters())
    return out


def install():
    """Run in every rank before its model is built (``Job.prepare``):
    the rank's traced summary also carries its spans."""
    trace.summarize = _summarize_with_spans


def rank_line(r: dict) -> dict:
    t = r["traced"]
    sp = t.pop("spans")
    idle = t.pop("idle_by_span")
    tot = sp["totals"]
    chunks = tot.get("shell.chunk", {}).get("calls", 0)
    each = {}
    for rec in sp["list"]:
        if rec["end_ns"] is not None:
            each.setdefault(rec["name"], []).append(
                1e-6 * (rec["end_ns"] - rec["start_ns"]))
    loop = {k: {"per_chunk": v["calls"] / chunks,
                "ms_median": statistics.median(each[k]) if k in each
                else None, "ms_mean": 1e3 * v["s"] / v["calls"]}
            for k, v in tot.items()
            if chunks and k.startswith(("shell.", "runner."))}
    split = {k: S.setup_seconds(sp, names, less)
             for k, (names, less) in S.GROUPS.items()}
    # the fused derive: 4 a step of every eager step and capture (a replay
    # runs no host code), and set_q's inversion on the half layout
    steps = sum(tot.get(k, {}).get("calls", 0)
                for k in ("runner.first_step", "runner.capture"))
    derive = {"counted": sp["counters"].get("step.derive_fused", 0),
              "four_per_eager_step_and_capture": 4 * steps}
    ybj = {"counted": sp["counters"].get("step.ybj", 0),
           "fused": sp["counters"].get("step.ybj_fused", 0),
           "one_per_eager_step_and_capture": steps}
    return {"rank": r["rank"],
            "setup_parts_s": r["counters"]["setup_parts_s"],
            "program_setup_s": split, "idle_by_span_s": idle,
            "loop_idle_ms": S.loop_idle_ms(dict(t, idle_by_span=idle)),
            "loop_spans": loop, "totals": tot, "counters": sp["counters"],
            "derive_fused": derive, "ybj_steps": ybj,
            "dropped": sp["dropped"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.benchmark(), args.workload)
    chips = int(cell["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"trace_cell: {args.workload} needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    job = cell_mod.Job(workload=args.workload, seed=args.seed,
                       seconds=args.seconds, trace=True, t_start=T_START,
                       prepare="trace_cell:install")
    res = run_mod.execute(job, chips)
    ranks = [r["traced"]["spans"] for r in res["records"]]
    lines = [rank_line(r) for r in res["records"]]
    for line in lines:
        print("spans " + json.dumps(line))
    print("setup " + json.dumps({
        "setup_s": res["setup_s"],
        "program_largest_s": {k: S.largest(ranks, names, less)
                              for k, (names, less) in S.GROUPS.items()},
        "harness_parts_s": lines[0]["setup_parts_s"]}))
    return run_mod.report(res, job)


if __name__ == "__main__":
    sys.exit(main())
