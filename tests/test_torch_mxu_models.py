"""The five models of the PyTorch port with JAX's default matmul-DFT
options (``backend='mxu'``: dotgen, a four-step, the even/odd real path
over a four-step half-length DFT, Gauss products, ``'high'``,
``max_batch=1``) against the JAX package with the same options: 20 steps
at nx=64 in f64, the four-step forced small (``factors=(8, 8)``,
``half_factors=(8, 4)``), one model also on the mirror-free real path; and
a JAX checkpoint of such a model resumed in the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu as jpkg  # noqa: E402
import niwqg_tpu_torch as tpkg  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.ops import fft as tfft  # noqa: E402

from _torch_common import rel as _rel  # noqa: E402

NX = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# precision 'high' (in f64 one exact product, as JAX's on the host),
# Gauss, max_batch=1, dotgen, even/odd: JAX's f32 defaults at nx=64 in f64
MXU_DEFAULTS = dict(backend="mxu", dtype=np.float64, precision="high")
DEFAULT_OPTS = dict(factors=(8, 8), half_factors=(8, 4), gauss=True,
                    max_batch=1)
MODELS = {"CoupledModel": {}, "UnCoupledModel": {}, "QLModel": {},
          "YBJModel": {}, "QGModel": {},
          "CoupledModel-mf": dict(realpath="mf")}
NSTEPS = 20


def _model(pkg, ic, name, nsteps=NSTEPS, **kw):
    """The model at nx=64 in f64 with the options: McWilliams q and a wave
    packet in phi (QG: a plane-wave scalar)."""
    mod = name.split("-")[0]
    opts = dict(DEFAULT_OPTS, **MODELS[name])
    common = dict(L=2 * np.pi * 200e3, nx=NX, dt=10000.0,
                  tmax=10000.0 * nsteps, use_filter=True,
                  transform_opts=opts, **MXU_DEFAULTS, **kw)
    if mod == "QGModel":
        m = getattr(pkg, mod).Model(nu4=5e10, beta=1e-11, U=-0.05,
                                    passive_scalar=True, **common)
        k0 = 10 * (2 * np.pi / m.L)
        m.set_q(ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=13))
        m.set_c(np.real(np.asarray(ic.PlaneWave(m, k=k0, l=k0))) * 1e-2)
        return m
    m = getattr(pkg, mod).Model(m=1.0 / 325, N=0.005, f=1e-4, nu4=5e10,
                                nu4w=5e10, **common)
    m.set_q(ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=11))
    m.set_phi(np.asarray(ic.WavePacket(m, k=2 * np.pi / m.L * 4, R=m.L / 6,
                                       x0=m.L / 2, y0=m.L / 2)) * 0.05)
    return m


def _fields(m):
    if hasattr(m, "cvar"):
        return {k: np.asarray(getattr(m, k)) for k in ("q", "c", "Ke",
                                                        "cvar")}
    return {k: np.asarray(getattr(m, k)) for k in ("q", "phi", "Ke", "Kw",
                                                    "Pw")}


def _hold(got, want, rtol=1e-12):
    for k, v in want.items():
        if np.ndim(v):
            assert _rel(got[k], v) <= rtol, k
        else:  # YBJ integrates no budgets: its Pw stays 0
            assert abs(got[k] - v) <= rtol * abs(v), k


@pytest.mark.parametrize("name", list(MODELS))
def test_models_with_jax_default_options_match_jax(name):
    """20 steps at nx=64 in f64: q, phi (c) and Ke, Kw, Pw (cvar) within
    1e-12 of JAX's run with the same transform options."""
    t = _model(tpkg, tic, name, device="cpu")
    j = _model(jpkg, jic, name)
    tr = t.kernel.tr
    assert isinstance(tr, tfft.MatmulTransform)
    assert (tr.formulation, tr.factors, tr.gauss, tr.precision) == \
        ("dotgen", (8, 8), True, "high")
    assert tr.realpath == MODELS[name].get("realpath", "evenodd")
    t.run_steps(NSTEPS)
    j.run_steps(NSTEPS)
    assert t.tc == j.tc == NSTEPS
    _hold(_fields(t), _fields(j))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint of the Coupled model with these options, after 5
    steps, resumed in the port for 5 more: within 1e-12 of JAX's
    uninterrupted run (the transform holds no state)."""
    pytest.importorskip("h5py")
    path = str(tmp_path / "jax.h5")
    j = _model(jpkg, jic, "CoupledModel", nsteps=10)
    j.run_steps(5)
    j.save_checkpoint(path)
    j.run_steps(5)
    t = _model(tpkg, tic, "CoupledModel", nsteps=10, device="cpu")
    t.load_checkpoint(path)
    assert t.tc == 5
    t.run_steps(5)
    assert t.tc == j.tc == 10
    _hold(_fields(t), _fields(j))
