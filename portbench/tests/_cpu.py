"""Runs of the harness on the host for the tests: the cell's path with
every size cut (``nx``, the stretch between yields), its look for a card
skipped."""

import io
import json
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor

from portbench import cell, run

# a host run's cut: small grids, a yield every 20 steps
TRAFFIC = {"yield_every": 20}


def job(workload, seed, nx=32, seconds=0.5, trace=False, prepare=None,
        **traffic):
    return cell.Job(workload=workload, seed=seed, seconds=seconds,
                    trace=trace, t_start=time.time(), device="cpu",
                    overrides={"model": {"nx": nx},
                               "traffic": {**TRAFFIC, **traffic}},
                    prepare=prepare)


def result(j, chips=1):
    """``(exit code, the result line or None, standard error)``. The run
    goes in a process of its own, so that a fault planted in it dies
    with it."""
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        res = ex.submit(run.execute, j, chips).result(timeout=600)
    out, err = io.StringIO(), io.StringIO()
    code = run.report(res, j, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if code == 0 else None
    return code, last, err.getvalue()
