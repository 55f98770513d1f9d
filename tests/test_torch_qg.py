"""The PyTorch port's QGModel (with its passive scalar) against the stored
fixture and the JAX package: 20 steps in f64 over its options, the run()
diagnostics, the K1 configuration (which sends QG no contraction), the
initial conditions on its half-spectrum grid, state conversion and the
shell's guards."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu import QGModel as JQG  # noqa: E402
from niwqg_tpu.carray import C  # noqa: E402
from niwqg_tpu.models import qg as jqg  # noqa: E402
from niwqg_tpu.ops import pallas_mm  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch import QGModel as TQG  # noqa: E402
from niwqg_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402

from _torch_common import K1_OPTS  # noqa: E402
from _torch_common import rel as _rel  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = np.load(os.path.join(ROOT, "tests", "fixtures", "trajectory.npz"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture_model(mod, ic, nsteps=20, seed=13, **kw):
    """``tests/test_fixture_trajectory.py::test_qg_trajectory``'s
    configuration (its defaults: beta 1e-11, the scalar on)."""
    kw = dict(dict(beta=1e-11, passive_scalar=True), **kw)
    m = mod.Model(L=2 * np.pi * 200e3, nx=64, dt=10000.0,
                  tmax=10000.0 * nsteps, nu4=5e10, use_filter=True, **kw)
    q = ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=seed)
    m.set_q(q)
    m.set_c(np.asarray(q, dtype=float).copy())
    return m


def test_fixture_trajectory():
    """The port reproduces the stored JAX QG trajectory at rtol 1e-9."""
    m = _fixture_model(TQG, tic, device="cpu")
    assert m.kernel.grid.spectrum == "half" and m.kernel.dtype == np.float64
    assert not m.kernel.fold_filter
    m.run_steps(20)
    rtol = 1e-9
    for name in ("q", "c"):
        ref = FIXTURE["qg_" + name]
        np.testing.assert_allclose(getattr(m, name), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max())
    np.testing.assert_allclose(m.Ke, float(FIXTURE["qg_Ke"]), rtol=rtol)
    np.testing.assert_allclose(m.cvar, float(FIXTURE["qg_cvar"]), rtol=rtol)


# (passive_scalar, spectral_budgets, fold_filter, beta, U)
CASES = [(True, True, False, 1e-11, 0.0), (True, False, True, 1e-11, 0.05),
         (False, True, True, 0.0, 0.05), (False, False, False, 1e-11, 0.0),
         (True, True, True, 0.0, 0.0)]


@pytest.mark.parametrize("scalar,spectral,fold,beta,U", CASES)
def test_matches_jax_f64(scalar, spectral, fold, beta, U):
    """20 steps at nx=64 in f64: q, c, p, Ke and cvar at 1e-12."""
    kw = dict(passive_scalar=scalar, spectral_budgets=spectral,
              fold_filter=fold, beta=beta, U=U, nu=2.0)
    t = _fixture_model(TQG, tic, device="cpu", **kw)
    j = _fixture_model(JQG, jic, **kw)
    t.run_steps(20)
    j.run_steps(20)
    assert t.tc == j.tc == 20
    assert _rel(t.q, j.q) <= 1e-12
    assert _rel(t.p, j.p) <= 1e-12
    assert abs(t.Ke - j.Ke) <= 1e-12 * abs(j.Ke)
    if scalar:
        assert _rel(t.c, j.c) <= 1e-12
        assert abs(t.cvar - j.cvar) <= 1e-12 * abs(j.cvar)
    else:  # the scalar is never stepped: c and cvar keep their set_c values
        assert _rel(t.c, j.c) == 0.0
        assert t.cvar == pytest.approx(j.cvar, rel=1e-14)


@pytest.mark.parametrize("scalar,spectral", [(True, True), (True, False),
                                             (False, True)])
def test_run_diagnostics_match_jax(scalar, spectral):
    """``run()`` with tdiags=2, twrite=4: every series against JAX's at
    1e-10 of its scale (zeros for the scalar's terms without one)."""
    kw = dict(passive_scalar=scalar, spectral_budgets=spectral, tdiags=2,
              twrite=4, nu=2.0, U=0.05)
    t = _fixture_model(TQG, tic, nsteps=9, device="cpu", **kw)
    j = _fixture_model(JQG, jic, nsteps=9, **kw)
    t.run()
    j.run()
    assert t.tc == j.tc == 9
    td, jd = t.diagnostics, j.diagnostics
    assert sorted(td) == sorted(jd)
    for k in jd:
        a, b = td[k]["value"], jd[k]["value"]
        assert td[k]["count"] == jd[k]["count"] == 5, k
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-10 * scale + 1e-20, k
    if not scalar:
        assert not td["Gamma_c"]["value"].any()


def test_k1_configuration_sends_no_contraction(monkeypatch):
    """In the K1 configuration at nx=256 in f32, QG's complex passes run
    over the half spectrum (nx/2+1 rows, not a multiple of 8): JAX traces
    no Pallas call and the port counts no K1 contraction; the state after
    one step matches JAX's at 1e-4."""
    kw = dict(backend="mxu", dtype=np.float32, precision="split", nx=256,
              L=2 * np.pi * 200e3, dt=157.0, tmax=157.0 * 10, beta=1e-11,
              U=-0.05, passive_scalar=True)
    calls0 = csplit_mm.FAMILY.plain_calls()
    t = TQG.Model(device="cpu", transform_opts=K1_OPTS, **kw)
    q = tic.LambDipole(t, U=0.05, R=2 * np.pi / (10 * 2 * np.pi / t.L))
    c = np.real(tic.PlaneWave(t, k=10 * 2 * np.pi / t.L,
                              l=10 * 2 * np.pi / t.L)) * 1e-2
    t.set_q(q)
    t.set_c(c)
    t.run_steps(1)
    assert csplit_mm.FAMILY.plain_calls() == calls0

    traced = []
    orig = pallas_mm.csplit_matmul

    def counting(*a, **k):
        traced.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(pallas_mm, "csplit_matmul", counting)
    j = JQG.Model(transform_opts=dict(K1_OPTS, pallas_interpret=True), **kw)
    j.set_q(q)
    j.set_c(c)
    jax.make_jaxpr(j.kernel.step)(j.state)
    assert traced == []
    j.run_steps(1)
    for a, b in ((t.q, j.q), (t.c, j.c)):
        assert _rel(a, b) <= 1e-4
    for name in ("Ke", "cvar"):
        a, b = getattr(t, name), getattr(j, name)
        assert abs(a - b) <= 1e-4 * abs(b), name


def test_half_spectrum_weights_match_jax():
    """``spec_var`` and ``spec_cross`` on the half spectrum: the mean mode
    (dropped by one, kept by the other) and the Nyquist column (weight 1,
    found by its index) as in JAX."""
    from niwqg_tpu.grid import Grid as JGrid
    from niwqg_tpu_torch.grid import Grid as TGrid

    rng = np.random.default_rng(7)
    z, w = (rng.standard_normal((2, 64, 33))
            + 1j * rng.standard_normal((2, 64, 33)))
    z[0, 0] = w[0, 0] = 3.0  # a mean mode to drop or keep
    tg = TGrid(nx=64, L=1e6, spectrum="half", device="cpu")
    jg = JGrid(nx=64, L=1e6, spectrum="half")
    tz, tw = torch.as_tensor(z), torch.as_tensor(w)
    jz, jw = C.from_complex(z), C.from_complex(w)
    assert float(tg.spec_var(tz)) == pytest.approx(float(jg.spec_var(jz)),
                                                   rel=1e-14)
    assert float(tg.spec_cross(tz, tw)) == pytest.approx(
        float(jg.spec_cross(jz, jw)), rel=1e-14)
    # the weights by hand: interior columns twice, k = 0 and nx/2 once
    d = np.abs(z) ** 2 / 64.0**4
    d[:, 1:32] *= 2.0
    d[0, 0] = 0.0
    assert float(tg.spec_var(tz)) == pytest.approx(d.sum(), rel=1e-14)


@pytest.mark.parametrize("gen", ["McWilliams1984", "Danioux2015",
                                 "LambDipole"])
def test_initial_conditions_on_the_half_grid(gen):
    """The generators on a QGModel's half-spectrum grid give JAX's fields."""
    t = TQG.Model(nx=64, L=2 * np.pi * 200e3, device="cpu")
    j = JQG.Model(nx=64, L=2 * np.pi * 200e3)
    kw = ({"U": 0.05, "R": 2 * np.pi / (10 * 2 * np.pi / t.L)}
          if gen == "LambDipole" else {"k0": 6, "E": 2.5e-4, "seed": 3})
    a = getattr(tic, gen)(t, **kw)
    b = getattr(jic, gen)(j, **kw)
    assert a.shape == (64, 64) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * np.abs(b).max())


def test_set_c_keeps_the_real_part():
    m = TQG.Model(nx=32, device="cpu", passive_scalar=True)
    c = tic.McWilliams1984(m, k0=6, E=2.5e-4, seed=4)
    m.set_c(c + 1j * np.ones_like(c))
    np.testing.assert_array_equal(m.c, c)
    assert m.cvar == pytest.approx(np.var(c), rel=1e-12)  # spec_var


def _jax_qg_state(d):
    leaf = (lambda v: C.from_complex(v) if np.iscomplexobj(v)
            else jnp.asarray(v))
    return jqg.QGState(**{k: (jnp.asarray(v, jnp.int32) if k == "tc"
                              else leaf(v)) for k, v in d.items()})


def test_convert_round_trip():
    """A JAX QG state carried into the port and back: all three continue
    the same trajectory."""
    j = _fixture_model(JQG, jic)
    j.run_steps(2)
    t = _fixture_model(TQG, tic, device="cpu")
    t.state = state_from_numpy(t.kernel, jax.tree.map(np.asarray, j.state))
    assert t.tc == 2 and t.state.qh.shape == (64, 33)
    j2 = _fixture_model(JQG, jic)
    j2.state  # apply the queued set_q/set_c before replacing the state
    j2.state = _jax_qg_state(state_to_numpy(t.state))
    for m in (j, t, j2):
        m.run_steps(3)
    for m in (t, j2):
        assert m.tc == 5
        assert _rel(m.q, j.q) <= 1e-12 and _rel(m.c, j.c) <= 1e-12
        assert abs(m.Ke - j.Ke) <= 1e-12 * abs(j.Ke)
        assert abs(m.cvar - j.cvar) <= 1e-12 * abs(j.cvar)


def test_model_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQG.Model(nx=16)
    m = TQG.Model(nx=16, device="cpu")
    assert m.device.type == "cpu" and m.kernel.dtype == np.float64


def test_cfl_guard_raises():
    """The QG status line guards CFL at 0.5."""
    m = TQG.Model(nx=32, device="cpu", dt=3e5, tmax=6e5, twrite=1)
    m.set_q(tic.McWilliams1984(m, k0=6, E=2.5e-2, seed=2))
    assert m.params.cflmax == 0.5
    with pytest.raises(AssertionError, match="CFL"):
        m.run()
