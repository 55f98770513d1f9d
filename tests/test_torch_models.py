"""The PyTorch port's UnCoupled, QL and YBJ models against the JAX package:
each quirks mode on both kernels in f64, the run() diagnostics with their
refresh cadence, the K1 configuration's contractions per step in f32, the
quirk defaults, state conversion and the shell's guards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu import QLModel as JQL  # noqa: E402
from niwqg_tpu import UnCoupledModel as JUnCoupled  # noqa: E402
from niwqg_tpu import YBJModel as JYBJ  # noqa: E402
from niwqg_tpu.ops import pallas_mm  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch import QLModel as TQL  # noqa: E402
from niwqg_tpu_torch import UnCoupledModel as TUnCoupled  # noqa: E402
from niwqg_tpu_torch import YBJModel as TYBJ  # noqa: E402
from niwqg_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from niwqg_tpu_torch.models.fast_kernel import FastWaveKernel  # noqa: E402
from niwqg_tpu_torch.models.ybj import YBJKernel  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402

from chip_smoke import K1_PER_STEP_FAMILY as FAMILY  # noqa: E402
from _torch_common import K1_OPTS  # noqa: E402
from _torch_common import flagship as _flagship  # noqa: E402
from _torch_common import jax_wave_state as _jax_state  # noqa: E402
from _torch_common import rel as _rel  # noqa: E402

MODELS = {"uncoupled": (TUnCoupled, JUnCoupled), "ql": (TQL, JQL),
          "ybj": (TYBJ, JYBJ)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(mod, ic, nx=64, nsteps=20, **kw):
    """The fixture's physics with a wave packet, so that the wave gradients
    (stale or fresh) are far from zero."""
    m = mod.Model(L=2 * np.pi * 200e3, nx=nx, dt=10000.0,
                  tmax=10000.0 * nsteps, m=1.0 / 325, N=0.005, f=1e-4,
                  use_filter=True, nu4=5e10, nu4w=5e10, **kw)
    q = ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=11)
    m.set_q(q)
    m.set_phi(ic.WavePacket(m, k=2 * np.pi / m.L * 4, R=m.L / 6,
                            x0=m.L / 2, y0=m.L / 2) * 0.05)
    return m


# (model, faithful_quirks, fast, fold_filter, U): each quirks mode on each
# kernel JAX has, and YBJ's folded filter
CASES = [("uncoupled", True, False, None, 0.0),
         ("uncoupled", True, True, None, 0.0),
         ("uncoupled", False, False, None, 0.0),
         ("uncoupled", False, True, None, 0.05),
         ("ql", False, False, None, 0.0), ("ql", False, True, None, 0.0),
         ("ql", True, False, None, 0.0), ("ql", True, True, None, 0.05),
         ("ybj", True, None, False, 0.0), ("ybj", False, None, False, 0.05),
         ("ybj", True, None, True, 0.05)]


@pytest.mark.parametrize("name,faithful,fast,fold,U", CASES)
def test_model_matches_jax_f64(name, faithful, fast, fold, U):
    """20 steps at nx=64 in f64: q, phi, Ke, Pw and Kw at 1e-12, and the
    Okubo–Weiss field of the evolving flows (half or full q side)."""
    tmod, jmod = MODELS[name]
    kw = dict(faithful_quirks=faithful, U=U)
    if name == "ybj":
        kw["fold_filter"] = fold
    else:
        kw["fast"] = fast
    t = _model(tmod, tic, device="cpu", **kw)
    j = _model(jmod, jic, **kw)
    if name == "ybj":
        assert t.kernel.fold_filter == j.kernel.fold_filter == fold
    else:
        assert isinstance(t.kernel, FastWaveKernel) == fast
    if name == "ql":
        assert not getattr(t.kernel, "q_half", False)
    q0 = t.q.copy()
    t.run_steps(20)
    j.run_steps(20)
    assert t.tc == j.tc == 20
    assert _rel(t.q, j.q) <= 1e-12
    assert _rel(t.phi, j.phi) <= 1e-12
    for k in ("Ke", "Pw", "Kw"):
        a, b = getattr(t, k), getattr(j, k)
        assert abs(a - b) <= 1e-12 * abs(b), k
    if name != "ybj":
        ow = t.kernel.okubo_weiss(t.state).numpy()
        assert _rel(ow, np.asarray(j.kernel.okubo_weiss(j.state))) <= 1e-12
    if name == "ybj":  # the flow is frozen: q is what set_q gave
        np.testing.assert_array_equal(t.q, q0)
    if name == "ql" and faithful:  # the reference's self.q never moves
        np.testing.assert_array_equal(t.q, q0)


@pytest.mark.parametrize("name,faithful,fast", [
    ("uncoupled", True, False), ("uncoupled", True, True),
    ("ql", True, False), ("ybj", True, False)])
def test_run_diagnostics_match_jax(name, faithful, fast):
    """``run()`` with tdiags=2, twrite=4: every series against JAX's at
    1e-10 of its scale (UnCoupled's gradient refreshes after each sample
    and status line; faithful QL's frozen ``ens``)."""
    tmod, jmod = MODELS[name]
    kw = dict(faithful_quirks=faithful, tdiags=2, twrite=4)
    if name != "ybj":
        kw["fast"] = fast
    t = _model(tmod, tic, nsteps=9, device="cpu", **kw)
    j = _model(jmod, jic, nsteps=9, **kw)
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
    assert _rel(t.phi, j.phi) <= 1e-12


# K1 contractions per step that JAX's trace gives in the K1 configuration;
# the default modes' counts are the ones chip_smoke.py holds the card to
K1_PER_STEP = {("uncoupled", None): FAMILY["UnCoupledModel"],
               ("ql", False): FAMILY["QLModel"], ("ql", True): 104,
               ("ybj", None): FAMILY["YBJModel"]}


@pytest.mark.parametrize("name,faithful", list(K1_PER_STEP))
def test_k1_configuration_f32_matches_jax(name, faithful, monkeypatch):
    """At nx=256 in f32 the port counts the K1 contractions per step that
    JAX traces through its Pallas kernel in the same configuration, all at
    (256, 256); after one step its state matches JAX's f64 run at 1e-4."""
    tmod, jmod = MODELS[name]
    kw = dict(backend="mxu", dtype=np.float32, precision="split")
    quirks = {} if faithful is None else {"faithful_quirks": faithful}
    counter = csplit_mm.FAMILY
    t = _flagship(tmod, tic, 256, packet=True, device="cpu",
                  transform_opts=K1_OPTS, **kw, **quirks)
    calls0 = counter.plain_calls()
    t.run_steps(1)
    per_step = counter.plain_calls() - calls0
    # the host runs the plain version
    assert csplit_mm.counts()["launches"] == 0

    traced = []
    orig = pallas_mm.csplit_matmul

    def counting(*a, **k):
        traced.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(pallas_mm, "csplit_matmul", counting)
    jk = jmod.Model(nx=256, transform_opts=dict(K1_OPTS, pallas_interpret=True),
                    **kw, **quirks).kernel
    jax.make_jaxpr(jk.step)(jk.zero_state())
    assert per_step == len(traced) == K1_PER_STEP[(name, faithful)]
    assert all(s == (256, 256) for s in traced)

    j = _flagship(jmod, jic, 256, packet=True, **quirks)  # f64, jnp.fft
    j.run_steps(1)
    diffs = {"q": _rel(t.q, j.q), "phi": _rel(t.phi, j.phi)}
    for k in ("Ke", "Pw", "Kw"):
        a, b = getattr(t, k), getattr(j, k)
        diffs[k] = abs(a - b) / abs(b) if b else abs(a)  # YBJ's Pw is 0
    print(f"K1 configuration, {name}, nx=256 f32, 1 step, port vs JAX f64:",
          {k: f"{v:.3e}" for k, v in diffs.items()})
    for k, d in diffs.items():
        assert d <= 1e-4, k


def test_uncoupled_defaults_to_reference_faithful():
    m = TUnCoupled.Model(nx=32, use_filter=False, device="cpu")
    assert m.kernel.physics.stale_phi_gradients is True
    m2 = TUnCoupled.Model(nx=32, use_filter=False, faithful_quirks=False,
                          device="cpu")
    assert m2.kernel.physics.stale_phi_gradients is False


def test_ybj_defaults_to_reference_faithful():
    m = TYBJ.Model(nx=32, use_filter=False, device="cpu")
    assert isinstance(m.kernel, YBJKernel) and m.kernel.faithful_quirks
    assert not m.kernel.fold_filter
    m2 = TYBJ.Model(nx=32, use_filter=False, faithful_quirks=False,
                    device="cpu")
    assert m2.kernel.faithful_quirks is False


def test_ql_defaults_to_intended_physics():
    m = TQL.Model(nx=32, use_filter=False, device="cpu")
    ph = m.kernel.physics
    assert not (ph.wave_pv_imag_jac or ph.stale_q_psi
                or ph.jac_reads_updated_qh)
    m2 = TQL.Model(nx=32, use_filter=False, faithful_quirks=True,
                   device="cpu")
    ph = m2.kernel.physics
    assert ph.wave_pv_imag_jac and ph.stale_q_psi and ph.jac_reads_updated_qh


def test_ql_keeps_the_full_spectrum_q_side():
    """QL's ph is unprojected, so the half layout and pair packing raise."""
    with pytest.raises(ValueError, match="Hermitian"):
        TQL.Model(nx=32, device="cpu", fast=True, q_half=True)
    with pytest.raises(ValueError, match="Hermitian"):
        TQL.Model(nx=32, device="cpu", fast=True, pair_inverse=True)
    assert not TQL.Model(nx=32, device="cpu", fast=True).kernel.q_half


@pytest.mark.parametrize("name,fast", [("ql", True), ("ybj", False)])
def test_convert_round_trip(name, fast):
    """A JAX QL state (faithful mode, full-spectrum q side, frozen q_psi)
    or YBJ state (frozen flow) carried into the port and back: all three
    continue the same trajectory."""
    tmod, jmod = MODELS[name]
    kw = dict(faithful_quirks=True)
    if name == "ql":
        kw["fast"] = fast
    j = _model(jmod, jic, **kw)
    j.run_steps(2)
    t = _model(tmod, tic, device="cpu", **kw)
    t.state = state_from_numpy(t.kernel, jax.tree.map(np.asarray, j.state))
    assert t.tc == 2 and t.state.qh.shape == (64, 64)
    j2 = _model(jmod, jic, **kw)
    j2.state  # apply the queued set_q/set_phi before replacing the state
    j2.state = _jax_state(state_to_numpy(t.state))
    for m in (j, t, j2):
        m.run_steps(3)
    for m in (t, j2):
        assert m.tc == 5
        assert _rel(m.q, j.q) <= 1e-12
        assert _rel(m.phi, j.phi) <= 1e-12
        assert abs(m.Ke - j.Ke) <= 1e-12 * abs(j.Ke)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_needs_a_card_unless_cpu_is_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmod = MODELS[name][0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmod.Model(nx=16)
    m = tmod.Model(nx=16, device="cpu")
    assert m.device.type == "cpu" and m.kernel.dtype == np.float64
