"""The fast kernel's fused derive (``FastWaveKernel.derive`` in
``niwqg_tpu_torch/models/fast_kernel.py``, its launchers
``niwqg_tpu_torch/ops/derive_fused.py``, its kernels ``csrc/derive.cu``).

On the host: the plain chain, split into the gaps the kernels fill, gives
bit for bit what the chain that ``derive`` wrote inline gave (a copy of it
below), for each layout and physics at 64²; on host tensors ``derive``
runs that chain and launches nothing; each layout's plan names the
projection and the batch slots its plain chain makes; every kernel of
``csrc/derive.cu`` is filed by the benchmark's classifier with the
elementwise work it does.

On the card (marked ``cuda``, skipped without one): each kernel and the
whole derive against the plain chain run on the same CUDA tensors, bit for
bit (``chip_smoke.derive_gaps``), at 256² and 2048² in float32 and float64,
for every configuration that runs the derive, with the launches counted on
the card, a CUDA graph's replays included; and, at 256², on a pencil mesh
of four ranks sharing the card (``tests/_torch_sharded_worker.py``'s
``derive_card`` suite), on K2's route and on the default one. This file
imports neither JAX nor the JAX package; on the card::

    python -m pytest --noconftest -m cuda tests/test_torch_derive_fused.py
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu_torch as pkg  # noqa: E402
from niwqg_tpu_torch.models.kernel import Derived  # noqa: E402
from niwqg_tpu_torch.ops import derive_fused, spectral  # noqa: E402
from niwqg_tpu_torch.ops.spectral import abs2, jmul, mul_i  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import derive_gaps, derive_inputs  # noqa: E402

# every configuration that runs the fast kernel's derive: (model, keywords)
CONFIGS = {
    "coupled_half": ("CoupledModel", {}),
    "coupled_full": ("CoupledModel", {"q_half": False}),
    "coupled_pair": ("CoupledModel", {"pair_inverse": True}),
    "coupled_fields": ("CoupledModel", {"spectral_budgets": False}),
    "coupled_mxu": ("CoupledModel", {"backend": "mxu"}),
    "uncoupled": ("UnCoupledModel", {"faithful_quirks": False}),
    "uncoupled_quirks": ("UnCoupledModel", {"faithful_quirks": True}),
    "ql": ("QLModel", {}),
    "ql_quirks": ("QLModel", {"faithful_quirks": True}),
}
FIELDS = Derived._fields


def _model(name, nx, dtype, device):
    mod, kw = CONFIGS[name]
    return getattr(pkg, mod).Model(nx=nx, dtype=dtype, fast=True,
                                   device=device, **kw)


def _inputs(K, seed):
    return derive_inputs(torch, K, seed)


# -- the chain as FastWaveKernel.derive and _invert_core wrote it inline ----

def inline_derive(K, qh, phih, prev=None):
    g = K.grid
    pg = K.tr.ifft2(torch.stack([phih, mul_i(phih, g.k), mul_i(phih, g.l)]))
    phix, phiy = pg[1], pg[2]
    if K.physics.stale_phi_gradients and prev is not None:
        phix, phiy = prev.phix, prev.phiy
    D = inline_invert_core(K, qh, pg[0], phix, phiy)
    if K.physics.stale_q_psi and prev is not None:
        D = D._replace(q_psi=prev.q_psi)
    return D


def inline_invert_core(K, qh, phi, phix, phiy):
    qt, p = K.qtab, K.params
    if K.physics.has_wave_pv:
        z = phix.conj() * phiy - phiy.conj() * phix
        fj = K._fwd_real(torch.stack([abs2(phi), jmul(z).real]))
        gphi2h = fj[0] * (-qt.wv2)
        jach = spectral.zero_mean_mode(fj[1], K.grid.owns_mean_mode)
        if K.physics.wave_pv_imag_jac:
            jach = jmul(jach)
        qwh = ((0.5 * gphi2h + jach) * 0.5 / p.f) * qt.filtr
    else:
        qwh = torch.zeros_like(qh)
    ph = -((qh - qwh) * qt.wv2i)
    if K.physics.hermitian_ph:
        ph = K._project_ph(ph)
    specs = [mul_i(ph, -K._l_dy), mul_i(ph, qt.k), qh]
    if not K._drop_p:
        specs.insert(0, ph)
    if K.physics.subtracts_wave_pv:
        specs.append(qh - qwh)
    gb = K._inv_real(torch.stack(specs))
    i = 0 if K._drop_p else 1
    p_ = None if K._drop_p else gb[0]
    u, v, q = gb[i], gb[i + 1], gb[i + 2]
    q_psi = gb[i + 3] if K.physics.subtracts_wave_pv else q
    return Derived(ph=ph, p=p_, q=q, q_psi=q_psi, qwh=qwh, phi=phi,
                   phix=phix, phiy=phiy, u=u, v=v)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


# -- host ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_chain_is_the_inline_chain(name):
    m = _model(name, 64, np.float64, "cpu")
    K = m.kernel
    qh, phih = _inputs(K, 7)
    prev = inline_derive(K, qh * 0.5, phih * 0.5)
    for carried in (None, prev):
        want = inline_derive(K, qh, phih, carried)
        got = K.derive(qh, phih, carried)
        bad = [f for f in FIELDS if not _same(getattr(got, f),
                                              getattr(want, f))]
        assert not bad, f"{name}: fields differ from the inline chain: {bad}"
    # set_q's inversion with the carried wave fields
    want = inline_invert_core(K, qh, prev.phi, prev.phix, prev.phiy)
    got = K._invert_core(qh, prev.phi, prev.phix, prev.phiy)
    assert all(_same(getattr(got, f), getattr(want, f)) for f in FIELDS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_follows_the_layout(name):
    m = _model(name, 32, np.float32, "cpu")
    K = m.kernel
    plan = K._plan
    qh, _ = _inputs(K, 5)
    fj = None
    if K.physics.has_wave_pv:
        fj = torch.stack([qh, qh * 0.5])
    _, _, specs = K._invert_pack(qh, fj, True)
    # one slot per field the plain chain stacks, in its order
    used = sorted(s for s in plan.slots if s >= 0)
    assert used == list(range(specs.shape[0]))
    assert (plan.slots[0] >= 0) == (not K._drop_p)
    assert (plan.slots[4] >= 0) == K.physics.subtracts_wave_pv
    # the projection _project_ph makes, and where the batch is projected
    want = (derive_fused.PROJ_NONE if not K.physics.hermitian_ph else
            derive_fused.PROJ_MIRROR if K.q_half or K.pair_inverse else
            derive_fused.PROJ_REFLECT)
    q = plan.q
    assert q is K.layout is K._stage_plan.q
    assert q.proj == want
    assert (K._inv_prepare(specs) is specs) == (
        q.proj != derive_fused.PROJ_MIRROR)
    assert q.col0 == 0 and q.nx == 32
    assert q.kq.shape == (K._qshape[1],)
    assert q.nreal == (17 if K.q_half else 32)
    assert q.mirror == (0, 16)
    assert bool(plan.flags & derive_fused.WAVE_PV) == K.physics.has_wave_pv
    assert bool(plan.flags & derive_fused.OWNS_MEAN)
    # the inverse of every layout is _inv_packed after _inv_prepare
    assert torch.equal(K._inv_real(specs),
                       K._inv_packed(K._inv_prepare(specs)))


def test_host_tensors_take_the_plain_chain():
    m = _model("coupled_half", 32, np.float64, "cpu")
    K = m.kernel
    qh, phih = _inputs(K, 3)
    derive_fused.reset_counts()
    before = profiling.counters().get("step.derive_fused", 0)
    K.derive(qh, phih)
    K._invert_core(qh, m.state.d.phi, m.state.d.phix, m.state.d.phiy)
    c = derive_fused.counts()
    assert c["cpu_calls"] == derive_fused.FAMILY.plain_calls("invert") == 2
    assert all(c[k] == 0 for k in derive_fused.KERNELS)
    assert profiling.counters().get("step.derive_fused", 0) == before


def _globals(src):
    """Each ``__global__`` function of a CUDA source: its name and its
    declaration up to the parameter list's end."""
    return [(m.group(1), m.group(0))
            for m in re.finditer(r"__global__\s+void\s+(\w+)\s*\([^)]*\)",
                                 src)]


def test_kernel_names_file_as_elementwise():
    from portbench.metrics.arithmetic import OTHER, family

    with open(os.path.join(ROOT, "niwqg_tpu_torch", "csrc",
                           "derive.cu")) as fh:
        decls = _globals(fh.read())
    names = sorted(n for n, _ in decls)
    assert names == sorted(k + "_kernel" for k in derive_fused.KERNELS)
    for name, decl in decls:
        for dtype in ("float", "double"):
            # the profiler's name: the namespace, the template, the types
            traced = (f"void (anonymous namespace)::{name}<{dtype}>"
                      f"({decl[decl.index('(') + 1:]}")
            assert family(traced) == OTHER, traced
        assert family(name) == OTHER


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nx", [256, 2048])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernels_match_plain_chain_on_card(card, name, nx, dtype):
    m = _model(name, nx, dtype, card)
    K = m.kernel
    derive_fused.reset_counts()
    gaps = derive_gaps(torch, K, seed=nx + 11)
    c = derive_fused.counts()
    assert c["cpu_calls"] == 0
    assert c["derive_grad_pack"] == 2 and c["derive_invert"] == 2
    assert c["derive_wave_pv"] == (2 if K.physics.has_wave_pv else 0)
    assert c["derive_project_pack"] == 0
    print(f"{name} {nx} {np.dtype(dtype).name} ulps {gaps}")
    bad = {k: v for k, v in gaps.items() if v != 0.0}
    assert not bad, f"{name} at {nx}² in {np.dtype(dtype).name}: {bad}"


@pytest.mark.cuda
def test_kernels_on_a_shared_card_mesh(card, tmp_path):
    from _torch_sharded_common import run_suite

    res = run_suite("derive_card", tmp_path, timeout=600)
    gaps = {k: float(v) for k, v in res.items() if k.startswith("gap_")}
    print("mesh ulps", gaps)
    assert len(gaps) >= 4 * 3 * 8
    assert not {k: v for k, v in gaps.items() if v != 0.0}
    assert int(res["launches_project_pack"]) > 0


@pytest.mark.cuda
def test_launches_counted_on_the_card_in_a_graph(card):
    # a capture runs nothing and counts nothing; each replay counts one
    # launch of each kernel, as an eager call does
    m = _model("coupled_half", 256, np.float32, card)
    K = m.kernel
    qh, phih = _inputs(K, 2)
    K.derive(qh, phih)  # eager: the first launches outside the capture
    torch.cuda.synchronize()
    derive_fused.reset_counts()
    before = profiling.counters().get("step.derive_fused", 0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        D = K.derive(qh, phih)
    assert derive_fused.counts()["derive_invert"] == 0
    for _ in range(3):
        g.replay()
    c = derive_fused.counts()
    assert [c[k] for k in derive_fused.KERNELS] == [3, 3, 3, 0]
    # the host counter saw the one capture
    assert profiling.counters().get("step.derive_fused", 0) == before + 1
    assert torch.equal(D.u, K.derive(qh, phih, plain=True).u)
