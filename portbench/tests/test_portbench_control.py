"""The control (the reference in bfloat16 in the program's place) fails
each cell's limits, at a cut size on the host; on the chip
``portbench/control.py`` reads it at the cells' own sizes."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3000000021, 5])
def test_control_is_not_correct(workload, seed):
    rec = control.readings(workload, seed, torch.device("cpu"),
                           {"model": {"nx": 64},
                            "traffic": {"yield_every": 40}})
    assert rec["correct"] is False
    over = [k for k, c in rec["checks"].items() if c["value"] > c["limit"]]
    assert over, rec["checks"]
