"""The run's check against the program broken underneath: on the host, at
a cut size, each fault a cell can have makes ``correct`` false: a step
that returns its state unchanged, q altered where a step produces it, and
on the mesh the exchange between ranks left out. (No cell has a batch to
halve.) A sound run of the same cut is correct."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.tests import _cpu  # noqa: E402

ONE = "coupled2048.run"
MESH = "coupled4096x4.run"


@pytest.mark.parametrize("fault", [None, "step_unchanged",
                                   "answer_altered"])
def test_one_card_cell(fault):
    prepare = f"portbench.tests.faults:{fault}" if fault else None
    code, line, err = _cpu.result(_cpu.job(ONE, 3000000011, nx=32,
                                           prepare=prepare))
    assert code == 0
    assert line["correct"] is (fault is None), err[-2000:]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [None, "exchange_left_out"])
def test_mesh_cell(fault):
    prepare = f"portbench.tests.faults:{fault}" if fault else None
    code, line, err = _cpu.result(_cpu.job(MESH, 3000000012, nx=32,
                                           prepare=prepare), chips=4)
    assert code == 0
    assert line["correct"] is (fault is None), err[-2000:]
    assert line["device"]["count"] == 4
