"""The PyTorch port's examples (``examples/torch/``) run on the host at
nx=32 to their end, each checked on what it prints. ``Restart.py`` is run
by ``tests/test_torch_io.py``. A file of its own, so that ``--dist
loadfile`` gives these runs (about a minute) their own worker."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *extra, cwd, nx=32):
    # one intra-op thread: at these sizes it is the fastest, and the
    # suite's workers share the host's cores (threads that spin-wait on
    # busy cores slowed an example 25-fold)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch", script),
         "--device", "cpu", "--nx", str(nx), *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _number(pattern, text):
    match = re.search(pattern, text)
    assert match, (pattern, text)
    return [float(g) for g in match.groups()]


def test_lamb_dipole_example(tmp_path):
    """The flagship example closes its energy budgets: both residuals
    below 1e-6 of the initial KE (1e-8 and 2e-10 at nx=32 in f64)."""
    out = _run("LambDipole.py", cwd=tmp_path)
    for budget in ("KE", "PE"):
        (res,) = _number(rf"max \|{budget} budget residual\| / KE0: (\S+)",
                         out)
        assert res < 1e-6, (budget, res)
    assert "isotropic spectrum of q peaks" in out


def test_lamb_dipole_qg_example(tmp_path):
    """QG with a passive scalar: ``spec_var(ch)`` equals ``np.var(c)``
    (Parseval on the half spectrum) to 1e-12, of a tracer that keeps at
    least 1e-2 of its variance. At 64² the tracer's wavenumber (10, 10)
    lies inside the filter's cutoff (at 32² it does not, and the filter
    leaves ~1e-7 of it); 400 steps keep the run short."""
    out = _run("LambDipole_qg.py", "--steps", "400", cwd=tmp_path, nx=64)
    a, b = _number(r"variance of c: (\S+) by spec_var\(ch\), (\S+) by", out)
    assert abs(a - b) <= 1e-12 * abs(b)
    start, end = _number(r"variance of c: (\S+) at the start, (\S+) after "
                         r"400 steps", out)
    assert end >= 1e-2 * start, (start, end)


def test_lamb_dipole_ql_example(tmp_path):
    """QLModel in both modes: finite series, and the two modes differ."""
    out = _run("LambDipole_ql.py", cwd=tmp_path)
    assert "finite=True" in out
    (d,) = _number(r"max \|phih_intended - phih_faithful\| = (\S+)", out)
    assert np.isfinite(d) and d > 0


def test_lamb_dipole_sharded_example(tmp_path):
    """The sharded CoupledModel on two gloo ranks that the script starts
    itself runs its 80 steps and, where h5py is installed, writes its
    checkpoint collectively."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        ck = None
    else:
        ck = str(tmp_path / "end.h5")
    out = _run("LambDipole_sharded.py", "--nranks", "2",
               *(["--checkpoint", ck] if ck else []), cwd=tmp_path)
    assert "qh block on rank 0: (32, 16)" in out
    assert "done: 80 steps" in out
    assert ck is None or os.path.getsize(ck) > 0
