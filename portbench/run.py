#!/usr/bin/env python3
"""The benchmark of ``niwqg_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload coupled2048.run --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout that holds the program. The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/``) and a traffic mix (``portbench/traffic/``); a cell
on more than one card spawns one process per rank, which meet over a free
TCP port of this host. The last line of standard output is the result as
one JSON object; the numbers compared with the plain reference, each with
its limit, are the last lines of standard error and the result's last key.
With ``--trace 1`` the metrics are the cell's per-layer metrics, each read
by ``portbench/metrics/<name>.py`` from the traced stretch and the census;
with ``--trace 0`` its end-to-end metrics. Exits 2 without the cards the
cell asks for, 3 if the process holds JAX or the JAX package.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import cell as cell_mod  # noqa: E402
from portbench import check, spec  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, nranks, port, job, out):
    res = cell_mod.run(job, rank, nranks, port)
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(res, fh)


def execute(job, chips: int) -> dict:
    """Rank 0's result of the run: in this process on one card, else from
    ``chips`` spawned ranks (after all of them have ended)."""
    if chips == 1:
        return cell_mod.run(job)
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="portbench_")
    out = os.path.join(tmp, "rank0.json")
    try:
        mp.spawn(_rank_main, args=(chips, _free_port(), job, out),
                 nprocs=chips, join=True)
        with open(out) as fh:
            return json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _card(device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "host CPU"}
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "power_limit": smi[0] if smi else "unknown"}


def _pace_rank(recs):
    """The rank whose device time outside the exchange kernel is largest:
    the exchange waits for the others inside its kernel, so this rank's
    work sets the pace."""
    from portbench.metrics.arithmetic import K2

    def own(r):
        t = r["traced"]
        return t["busy_s"] - t["families_s"].get(K2, 0.0)

    return max(recs, key=own)


def _finite(x):
    """``x`` with every number that is not finite as ``None`` (JSON has
    no infinity)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def report(res: dict, job, out=sys.stdout, err=sys.stderr) -> int:
    """Print the run's lines and its result; returns the exit code."""
    bench = spec.benchmark()
    recs = res["records"]
    bad = sorted(set(cell_mod.forbidden_modules())
                 | {n for r in recs for n in r["forbidden"]})
    if bad:
        print(f"portbench: the run holds {', '.join(bad)} (JAX or the JAX "
              "package): no result", file=err)
        return 3
    cfg, chips = res["cfg"], res["cell"]["chips"]
    nums, detail = {}, {}
    for r in recs:
        nums.update(r["nums"])
        detail.update(r["detail"])
    correct, checks = check.judge(nums, cfg["limits"])
    steps = res["steps"]
    device = dict(_card(job.device), count=chips,
                  memory_peak_bytes=max(r["peak"] for r in recs))
    metrics, extra = {}, {}
    if not job.trace:
        values = {"steps_per_s": (steps / res["window"], "steps/s"),
                  "setup_s": (res["setup_s"], "s")}
        for m in spec.metrics_of(bench, job.workload, "end_to_end"):
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        pick = _pace_rank(recs)
        t = pick["traced"]
        reading = dict(t, census=pick["census"])
        for m in spec.metrics_of(bench, job.workload, "per_layer"):
            v = spec.reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = sum(r["traced"]["busy_s"] for r in recs) / len(
            recs)
        device["window_s"] = sum(r["traced"]["window_s"]
                                 for r in recs) / len(recs)
        extra["breakdown"] = {"device_ops": t["device_ops"],
                              "idle_gaps": t["idle_gaps"]}
        print("traced rank " + json.dumps(
            {"rank": pick["rank"], "families_s": t["families_s"],
             "steps": t["steps"], "census": pick["census"]}), file=out)
    for r in recs:
        print("rank " + json.dumps(
            {"rank": r["rank"], "window_s": r["window"], "ref_s": r["ref_s"],
             "counters": r["counters"]}), file=out)
    print("run " + json.dumps(
        {"workload": job.workload, "seed": job.seed, "steps": steps,
         "window_s": res["window"], "warmup_rate": res["rate"],
         "diagnostics": _finite(detail)}), file=out)
    finite = all(r["finite"] for r in recs)
    line = {"correct": bool(correct and finite), "attempted": steps,
            "failed": 0 if finite else steps, "metrics": metrics,
            "device": device, **extra, "checks": checks}
    for k, c in checks.items():
        print(f"{k} {c['value']:.6e} limit {c['limit']:.6e}", file=err)
    err.flush()
    print(json.dumps(_finite(line)), file=out)
    out.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.benchmark(), args.workload)
    chips = int(cell["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    job = cell_mod.Job(workload=args.workload, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       t_start=T_START)
    return report(execute(job, chips), job)


if __name__ == "__main__":
    sys.exit(main())
