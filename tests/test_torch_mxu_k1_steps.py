"""K1's contractions per model step of the PyTorch port against the JAX
package's trace: one port step at nx=512 in f32 counts, by shape, the
calls that ``jax.make_jaxpr`` of JAX's ``kernel.step`` sends to its
Pallas kernel, in the matmul-DFT's K1 configurations (dotgen dense, and
the even/odd real path under dotgen and swap) and with JAX's defaults
(none)."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import niwqg_tpu as jpkg  # noqa: E402
import niwqg_tpu_torch as tpkg  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402

from chip_smoke import K1_PER_STEP_EVENODD  # noqa: E402
from _torch_common import K1_CONFIGS, K1_NX, record_k1_calls  # noqa: E402
from _torch_common import flagship as _flagship  # noqa: E402

# per model step, as JAX's trace gives them: (M, K) -> calls
K1_PER_STEP = {
    ("CoupledModel", "dotgen-dense"): {(512, 512): 20},
    ("CoupledModel", "dotgen-evenodd"): {(512, 512): 20, (512, 256): 32},
    ("CoupledModel", "swap-evenodd"): {(512, 512): 40, (512, 256): 32},
    ("QGModel", "dotgen-evenodd"): {(512, 256): 22},
    ("QGModel+scalar", "dotgen-evenodd"): {(512, 256): 35},
    ("CoupledModel", "jax-defaults"): {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def k1_calls(monkeypatch):
    return record_k1_calls(monkeypatch)


@pytest.mark.parametrize("model,cfg", list(K1_PER_STEP))
def test_k1_calls_per_step_match_jax_trace(model, cfg, k1_calls):
    """One port step at nx=512 in f32 counts the K1 calls, by shape, that
    JAX's trace of ``kernel.step`` sends to its Pallas kernel."""
    jax_calls, port_calls = k1_calls
    if cfg == "jax-defaults":
        kw, opts = dict(backend="mxu", dtype=np.float32), {}
    else:
        kw = dict(backend="mxu", dtype=np.float32, precision="split")
        opts = dict(K1_CONFIGS[cfg], use_pallas=True)
    if model.startswith("QGModel"):
        qkw = dict(nx=K1_NX, beta=1e-11, U=-0.05,
                   passive_scalar=model.endswith("scalar"), **kw)
        t = tpkg.QGModel.Model(device="cpu", transform_opts=opts, **qkw)
        k0 = 10 * 2 * np.pi / t.L
        t.set_q(tic.LambDipole(t, U=0.05, R=2 * np.pi / k0))
        t.set_c(np.real(tic.PlaneWave(t, k=k0, l=k0)) * 1e-2)
        jk = jpkg.QGModel.Model(transform_opts=dict(opts, pallas_interpret=True),
                                **qkw).kernel
    else:
        t = _flagship(tpkg.CoupledModel, tic, K1_NX, packet=True,
                      device="cpu", transform_opts=opts, **kw)
        jk = jpkg.CoupledModel.Model(
            nx=K1_NX, transform_opts=dict(opts, pallas_interpret=True),
            **kw).kernel
    jax.make_jaxpr(jk.step)(jk.zero_state())
    del port_calls[:]
    calls0 = csplit_mm.FAMILY.plain_calls()
    t.run_steps(1)
    assert csplit_mm.FAMILY.plain_calls() - calls0 == len(port_calls)
    assert Counter(port_calls) == Counter(jax_calls) == K1_PER_STEP[
        (model, cfg)]
    # the pins chip_smoke.py phase 11(c) holds the card to
    pinned = {("CoupledModel", "dotgen-evenodd"): "CoupledModel",
              ("QGModel+scalar", "dotgen-evenodd"): "QGModel"}
    if (model, cfg) in pinned:
        assert len(port_calls) == K1_PER_STEP_EVENODD[pinned[(model, cfg)]]
    assert np.isfinite(t.q).all() and np.isfinite(t.Ke)
