"""The PyTorch port's CoupledModel against the JAX package: the stored
fixture, the batched fast kernel in f64, the slice's K1 configuration in
f32, the run() diagnostics, and state conversion between the two."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from niwqg_tpu import CoupledModel as JCoupled  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu.carray import C  # noqa: E402
from niwqg_tpu.models import kernel as jkernel  # noqa: E402
from niwqg_tpu.ops import pallas_mm  # noqa: E402
from niwqg_tpu_torch import CoupledModel as TCoupled  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.api import CoupledModel as TCoupledModel  # noqa: E402
from niwqg_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from niwqg_tpu_torch.models.fast_kernel import FastWaveKernel  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = np.load(os.path.join(ROOT, "tests", "fixtures", "trajectory.npz"))
K1_OPTS = dict(use_pallas=True, formulation="swap", factors=None,
               half_factors=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and torch's OpenMP threads spin against them when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _fixture_model(mod, ic, **kw):
    """``tests/test_fixture_trajectory.py``'s coupled configuration."""
    m = mod.Model(L=2 * np.pi * 200e3, nx=64, dt=10000.0, tmax=10000.0 * 20,
                  m=1.0 / 325, N=0.005, f=1e-4, use_filter=True, nu4=5e10,
                  nu4w=5e10, **kw)
    q = ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=11)
    m.set_q(q)
    m.set_phi((np.ones_like(q) + 1j) * 0.05 / np.sqrt(2))
    return m


def _flagship(mod, ic, nx, **kw):
    """The flagship's physics (``__graft_entry__._build_coupled``)."""
    U0 = 0.05
    m = mod.Model(L=2 * np.pi * 200e3, nx=nx, dt=157.0, tmax=157.0 * 100,
                  m=1.0 / 325, N=0.005, f=1e-4, use_filter=True, nu4=7.5e9,
                  nu4w=7.5e9, **kw)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    m.set_q(q)
    m.set_phi((np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2))
    return m


def test_fixture_trajectory():
    """(a) the faithful kernel on the host reproduces the stored JAX
    trajectory at the fixture's rtol 1e-9."""
    m = _fixture_model(TCoupled, tic, device="cpu")
    assert not isinstance(m.kernel, FastWaveKernel)
    assert m.kernel.dtype == np.float64
    m.run_steps(20)
    rtol = 1e-9
    for name in ("q", "phi"):
        ref = FIXTURE["coupled_" + name]
        np.testing.assert_allclose(getattr(m, name), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max())
    for name in ("Ke", "Pw", "Kw"):
        np.testing.assert_allclose(getattr(m, name),
                                   float(FIXTURE["coupled_" + name]),
                                   rtol=rtol)


def test_fast_kernel_matches_jax_f64():
    """(b) the batched fast kernel (q_half, Parseval budgets, folded
    filter) against JAX ``fast=True``, 20 steps at nx=64 in f64."""
    t = _fixture_model(TCoupled, tic, device="cpu", fast=True)
    j = _fixture_model(JCoupled, jic, fast=True)
    assert t.kernel.q_half and t.kernel.fold_filter
    t.run_steps(20)
    j.run_steps(20)
    assert _rel(t.q, j.q) <= 1e-12
    assert _rel(t.phi, j.phi) <= 1e-12
    for name in ("Ke", "Pw", "Kw"):
        a, b = getattr(t, name), getattr(j, name)
        assert abs(a - b) <= 1e-12 * abs(b), name


def test_k1_configuration_f32_matches_jax(monkeypatch):
    """(c) the slice's K1 configuration at nx=256 in f32, 3 steps, against
    JAX with the Pallas kernel in interpret mode; and the port counts the
    same 40 K1 contractions per step that JAX traces."""
    kw = dict(backend="mxu", dtype=np.float32, precision="split")
    calls0 = csplit_mm.csplit_matmul.cpu_calls
    t = _flagship(TCoupled, tic, 256, device="cpu", transform_opts=K1_OPTS,
                  **kw)
    calls_set = csplit_mm.csplit_matmul.cpu_calls - calls0
    t.run_steps(3)
    per_step = (csplit_mm.csplit_matmul.cpu_calls - calls0 - calls_set) / 3

    traced = []
    orig = pallas_mm.csplit_matmul

    def counting(*a, **k):
        traced.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(pallas_mm, "csplit_matmul", counting)
    j = _flagship(JCoupled, jic, 256,
                  transform_opts=dict(K1_OPTS, pallas_interpret=True), **kw)
    state = j.state  # applies the queued set_q/set_phi
    traced_set = len(traced)
    traced.clear()
    jax.make_jaxpr(j.kernel.step)(state)
    assert (calls_set, per_step) == (traced_set, len(traced)) == (6, 40)
    assert all(s == (256, 256) for s in traced)
    j.run_steps(3)

    # f32 transforms summed in another order: held at 1e-4 relative
    diffs = {"q": _rel(t.q, j.q), "phi": _rel(t.phi, j.phi)}
    for name in ("Ke", "Pw", "Kw"):
        a, b = getattr(t, name), getattr(j, name)
        diffs[name] = abs(a - b) / abs(b)
    print("K1 configuration, nx=256 f32, 3 steps, port vs JAX:",
          {k: f"{v:.3e}" for k, v in diffs.items()})
    for name, d in diffs.items():
        assert d <= 1e-4, name


@pytest.mark.parametrize("fast", [False, True])
def test_run_diagnostics_match_jax(fast):
    """(d) ``run()`` with the tdiags/twrite cadence: every diagnostic
    series against JAX's at nx=64 in f64."""
    def build(mod, ic, **kw):
        m = mod.Model(L=2 * np.pi * 200e3, nx=64, dt=10000.0,
                      tmax=10000.0 * 9, m=1.0 / 325, N=0.005, f=1e-4,
                      use_filter=True, nu4=5e10, nu4w=5e10, tdiags=2,
                      twrite=4, fast=fast, **kw)
        q = ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=5)
        m.set_q(q)
        m.set_phi(ic.WavePacket(m, k=2 * np.pi / m.L * 4, R=m.L / 6,
                                x0=m.L / 2, y0=m.L / 2) * 0.05)
        m.run()
        return m

    t = build(TCoupled, tic, device="cpu")
    j = build(JCoupled, jic)
    assert t.tc == j.tc == 9
    td, jd = t.diagnostics, j.diagnostics
    assert sorted(td) == sorted(jd)
    for name in jd:
        a, b = td[name]["value"], jd[name]["value"]
        assert td[name]["count"] == jd[name]["count"] == 5, name
        # absolute floor: some conversion terms are rounding noise
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-10 * scale + 1e-20, name


def _jax_state(d):
    """A JAX ``WaveState`` from :func:`state_to_numpy`'s dict."""
    def leaf(v):
        if v is None:
            return None
        return C.from_complex(v) if np.iscomplexobj(v) else jnp.asarray(v)

    return jkernel.WaveState(
        t=jnp.asarray(d["t"]), tc=jnp.asarray(d["tc"], jnp.int32),
        qh=leaf(d["qh"]), phih=leaf(d["phih"]),
        d=jkernel.Derived(**{k: leaf(v) for k, v in d["d"].items()}),
        Ke=jnp.asarray(d["Ke"]), Pw=jnp.asarray(d["Pw"]),
        Kw=jnp.asarray(d["Kw"]))


@pytest.mark.parametrize("fast", [False, True])
def test_convert_round_trip(fast):
    """(e) a JAX state (full or q_half layout) carried into the port and
    back: both continue the same trajectory."""
    j = _fixture_model(JCoupled, jic, fast=fast)
    j.run_steps(2)
    t = _fixture_model(TCoupled, tic, device="cpu", fast=fast)
    t.state = state_from_numpy(t.kernel, jax.tree.map(np.asarray, j.state))
    assert t.tc == 2 and t.state.qh.shape == tuple(j.state.qh.re.shape)

    back = state_to_numpy(t.state)
    j2 = _fixture_model(JCoupled, jic, fast=fast)
    j2.state  # apply the queued set_q/set_phi before replacing the state
    j2.state = _jax_state(back)
    for m in (j, t, j2):
        m.run_steps(3)
    for m in (t, j2):
        assert m.tc == 5
        assert _rel(m.q, j.q) <= 1e-12
        assert _rel(m.phi, j.phi) <= 1e-12
        assert abs(m.Ke - j.Ke) <= 1e-12 * abs(j.Ke)


def test_convert_between_layouts():
    """A full-layout (faithful) JAX state into the port's q_half kernel."""
    j = _fixture_model(JCoupled, jic, fast=False)
    j.run_steps(1)
    t = _fixture_model(TCoupled, tic, device="cpu", fast=True)
    t.state = state_from_numpy(t.kernel, jax.tree.map(np.asarray, j.state))
    assert t.state.qh.shape == (64, 33) and t.state.d.p is None
    for m in (j, t):
        m.run_steps(2)
    assert _rel(t.q, j.q) <= 1e-10
    assert abs(t.Ke - j.Ke) <= 1e-10 * abs(j.Ke)


def test_model_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCoupledModel(nx=16)
    m = TCoupledModel(nx=16, device="cpu")
    assert m.device.type == "cpu" and m.kernel.dtype == np.float64


@pytest.mark.parametrize("fast", [False, True])
def test_kernel_needs_a_card_unless_cpu_is_asked(fast, monkeypatch):
    """A kernel built without the shell follows the same rule."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = TCoupledModel(nx=16, device="cpu", fast=fast).kernel
    cls = type(k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(k.params, k.physics)
    assert cls(k.params, k.physics, device="cpu").device.type == "cpu"


def test_unported_shell_options_raise():
    with pytest.raises(NotImplementedError):
        TCoupledModel(nx=16, device="cpu", save_to_disk=True)
    with pytest.raises(NotImplementedError):
        TCoupledModel(nx=16, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        TCoupledModel(nx=16, device="cpu", fast=True, pair_inverse=True)


def test_set_fields_capture_value_and_check_shape():
    m = TCoupledModel(nx=32, device="cpu")
    q = tic.McWilliams1984(m, k0=6, E=2.5e-4, seed=1)
    m.set_q(q)
    before = m.q.copy()
    q[:] = 0.0  # mutating the caller's array changes nothing
    np.testing.assert_array_equal(m.q, before)
    with pytest.raises(ValueError):
        m.set_q(np.zeros((32, 16)))
    with pytest.raises(ValueError):
        m.set_phi(np.zeros((16, 32), complex))


def test_cfl_guard_raises():
    m = TCoupledModel(nx=32, device="cpu", dt=1e7, tmax=2e7, twrite=1)
    m.set_q(tic.McWilliams1984(m, k0=6, E=2.5e-4, seed=2))
    m.set_phi(np.ones((32, 32), complex) * 0.5)
    with pytest.raises(AssertionError, match="CFL"):
        m.run()


def test_port_imports_no_jax():
    """The port runs where JAX is absent: importing it pulls in neither
    JAX nor the JAX package."""
    code = ("import sys, niwqg_tpu_torch.api, niwqg_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'niwqg_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
