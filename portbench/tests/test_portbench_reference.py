"""The plain reference against the port on the host, both in float64 at
64², with the configurations' physics and the harness's seeded fields:
from the initial fields (the upstream's set_q/set_phi order) and resumed
from the port's state mid-run, fields and diagnostic series."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from niwqg_tpu_torch import CoupledModel  # noqa: E402
from portbench import check, spec  # noqa: E402
from portbench.initial import lamb_dipole_waves  # noqa: E402
from portbench.reference import coupled  # noqa: E402

NX, STEPS, TDIAGS = 64, 20, 10
CPU = torch.device("cpu")


def _port(cfg, fields, steps):
    kw = dict(cfg["model"], nx=NX, dtype=np.float64)
    m = CoupledModel.Model(tdiags=TDIAGS, tmax=kw["dt"] * (steps - 0.5),
                           device="cpu", **kw)
    m.set_q(fields["q"].numpy())
    m.set_phi(fields["phi"].numpy())
    m.run()
    return m


@pytest.mark.parametrize("config", ["coupled_lamb_2048",
                                    "coupled_lamb_4096x4_k2"])
def test_reference_follows_the_port(config):
    cfg = spec.config(config)
    trf = spec.traffic("run_d10")
    L = cfg["model"]["L"]
    fields = lamb_dipole_waves.make(NX, L, 2024, trf["initial"], CPU)
    m = _port(cfg, fields, 2 * STEPS)
    assert m.kernel.dtype == np.float64 and m.tc == 2 * STEPS

    params = coupled.params_from(dict(cfg["model"], nx=NX))
    ref = coupled.Reference(params, CPU, "f64")
    s, ser = coupled.run_segment(ref, ref.start(**fields), 2 * STEPS,
                                 TDIAGS, 0)
    got = coupled.physical(s)
    for k in coupled.FIELDS:
        assert check.rel_max(getattr(m, k), got[k]) < 1e-12, k
    for k, v in ser.items():
        prog = np.asarray(m.diagnostics[k]["value"])
        assert prog.shape == v.shape, k
        assert check.rel_max(prog, v.numpy()) < 1e-10, k


def test_reference_resumes_from_the_port_state():
    cfg = spec.config("coupled_lamb_2048")
    trf = spec.traffic("run_d10")
    fields = lamb_dipole_waves.make(NX, cfg["model"]["L"], 7, trf["initial"],
                                    CPU)
    m = _port(cfg, fields, STEPS)
    mid = {k: torch.as_tensor(getattr(m, k)) for k in coupled.FIELDS}
    budgets = {k: getattr(m, k) for k in coupled.BUDGETS}
    m2 = _port(cfg, fields, 2 * STEPS)

    params = coupled.params_from(dict(cfg["model"], nx=NX))
    ref = coupled.Reference(params, CPU, "f64")
    s, ser = coupled.run_segment(ref, ref.resume(**mid, **budgets), STEPS,
                                 TDIAGS, STEPS)
    got = coupled.physical(s)
    for k in coupled.FIELDS:
        assert check.rel_max(getattr(m2, k), got[k]) < 1e-12, k
    for k, v in ser.items():
        prog = np.asarray(m2.diagnostics[k]["value"])[STEPS // TDIAGS:]
        assert check.rel_max(prog, v.numpy()) < 1e-10, k


def test_bf16_control_departs_from_f64():
    """The control's precision changes the answer by orders of magnitude
    more than float64's rounding."""
    cfg = spec.config("coupled_lamb_2048")
    trf = spec.traffic("run_d10")
    fields = lamb_dipole_waves.make(NX, cfg["model"]["L"], 3, trf["initial"],
                                    CPU)
    params = coupled.params_from(dict(cfg["model"], nx=NX))
    out = {}
    for mode in ("f64", "bf16"):
        ref = coupled.Reference(params, CPU, mode)
        s, _ = coupled.run_segment(ref, ref.start(**fields), 5, TDIAGS, 0)
        out[mode] = coupled.physical(s)
    assert check.rel_max(out["bf16"]["q"], out["f64"]["q"]) > 1e-3
    assert check.rel_max(out["bf16"]["phi"], out["f64"]["phi"]) > 1e-4
