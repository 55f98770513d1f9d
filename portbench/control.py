#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed in
bfloat16 (``Arith("bf16")``) put in the program's place, held to the
float64 reference by the cell's own numbers and limits. It must come out
not correct. The benchmark's runs do not run it.

    python3 portbench/control.py --workload coupled2048.run --seeds 11,12,13

Both stretches of the check at the cell's own size on one card: the start
from the seed's initial fields, and the end from the float64 reference's
state after the start (the control has no program state to resume). One
JSON line a seed: the numbers, their limits and ``correct``.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import cell as cell_mod  # noqa: E402
from portbench import check  # noqa: E402


def readings(workload: str, seed: int, device, overrides=None) -> dict:
    """The control's numbers for ``seed``, judged by the cell's limits."""
    job = cell_mod.Job(workload=workload, seed=seed, seconds=0.0,
                       trace=False, t_start=0.0,
                       overrides=overrides or {})
    _, cfg, trf = cell_mod.resolve(job)
    ref_mod = importlib.import_module("portbench.reference."
                                      + cfg["reference"])
    initial = trf["initial"]
    gen = importlib.import_module("portbench.initial." + initial["kind"])
    mk = cfg["model"]
    fields = gen.make(int(mk["nx"]), float(mk["L"]), seed, initial, device)
    Y, tdiags = int(trf["yield_every"]), int(trf["tdiags"])
    params = ref_mod.params_from(mk)
    diags = cfg["compare"]["diagnostics"]
    nums, detail = {}, {}

    def both(name, tc0, first):
        """The stretch in float64 and in bfloat16, compared; returns the
        float64 stretch's end fields and budget integrals."""
        got = {}
        for mode in ("f64", "bf16"):
            ref = ref_mod.Reference(params, device, mode)
            s, ser = ref_mod.run_segment(ref, first(ref), Y, tdiags, tc0)
            got[mode] = (ref_mod.physical(s),
                         {k: v.numpy() for k, v in ser.items()},
                         {k: float(getattr(s, k)) for k in ref_mod.BUDGETS})
            del ref, s
        n, d = check.segment_numbers(name, got["bf16"][0], got["f64"][0],
                                     got["bf16"][1], got["f64"][1], diags)
        nums.update(n)
        detail[name] = d
        return got["f64"][0], got["f64"][2]

    phys, budgets = both("start", 0, lambda ref: ref.start(**fields))
    both("end", Y, lambda ref: ref.resume(
        **{k: torch.as_tensor(phys[k], device=device)
           for k in ref_mod.FIELDS}, **budgets))
    correct, checks = check.judge(nums, cfg["limits"])
    return {"workload": workload, "seed": seed, "correct": correct,
            "checks": checks, "diagnostics": detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = readings(args.workload, seed, dev)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
