"""The fast kernel's fused stage epilogue (``FastWaveKernel._epilogue`` in
``niwqg_tpu_torch/models/fast_kernel.py``, its launcher
``niwqg_tpu_torch/ops/stage_fused.py``, its kernel ``csrc/stage.cu``).

On the host: the plain chain, split at the epilogue's seams, gives bit for
bit what the chain of ``stage_terms``, ``nonlinear`` and
``stage_source_parts`` gave before the split (a copy of it below), for
each layout and physics at 32²; on host tensors the epilogue runs that
chain and launches nothing; the plan holds each layout's numbers (one
card's half, full and ``pair_inverse`` layouts, and blocks of the pencil
mesh and of the matmul-DFT's padded half on stand-in meshes, the owner of
the mean mode and the others), its rule for ``l_dy`` giving the kernel
object's table; the kernel is filed by the benchmark's classifier with the
elementwise work it does.

On the card (marked ``cuda``, skipped without one): in every use (a stage
with its partials, the right-hand sides alone, the partials alone) ``Fn``
and ``Fnw`` bit for bit the plain chain on the same CUDA tensors, each
budget partial within a few units of the working type's epsilon times the
sum of its terms' magnitudes of the float64 sum of the plain chain's own
terms, a second launch bit for bit the first (``chip_smoke.stage_gaps``),
at 256² and 2048² in float32 and float64 for every configuration; the
launches counted on the card, a CUDA graph's replays and a run's
diagnostics included; and, at 256², on a pencil mesh of four ranks sharing
the card (``tests/_torch_sharded_worker.py``'s ``stage_card`` suite). This
file imports neither JAX nor the JAX package; on the card::

    python -m pytest --noconftest -m cuda tests/test_torch_stage_fused.py
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu_torch as pkg  # noqa: E402
from niwqg_tpu_torch.models.coupled import CoupledPhysics  # noqa: E402
from niwqg_tpu_torch.models.fast_kernel import FastWaveKernel  # noqa: E402
from niwqg_tpu_torch.models.ql import QLPhysics  # noqa: E402
from niwqg_tpu_torch.ops import spectral, stage_fused  # noqa: E402
from niwqg_tpu_torch.ops.spectral import abs2, jmul, mul_i  # noqa: E402
from niwqg_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import STAGE_PART_LIMIT, derive_inputs, stage_gaps  # noqa: E402,E501

# every configuration that runs the fast kernel's stages: (model, keywords)
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


def _model(name, nx, dtype, device, **extra):
    mod, kw = CONFIGS[name]
    return getattr(pkg, mod).Model(nx=nx, dtype=dtype, fast=True,
                                   device=device, **kw, **extra)


# -- the chain as stage_terms, nonlinear and stage_source_parts wrote it ----

def inline_rhs_from_products(K, D, jacwh_raw, refrh_raw):
    qt = K.qtab
    uvqh = K._fwd_real(torch.stack([D.u * D.q, D.v * D.q]))
    own = K.grid.owns_mean_mode
    jacq = spectral.zero_mean_mode(mul_i(uvqh[0], qt.k)
                                   + mul_i(uvqh[1], K._l_dy), own)
    jacwh = jacwh_raw
    if K.physics.zero_mean_jac_psi_phi:
        jacwh = spectral.zero_mean_mode(jacwh, own)
    return -jacq, -jacwh - jmul(refrh_raw, 0.5)


def inline_spectral_source_parts(K, qh, phih, D, refrh_raw, jh_full):
    g = K.grid
    M2 = K._inv_M2
    aphi2 = abs2(phih)
    ep_phi = (K._w_d * aphi2).sum() * M2
    chi_phi = (K._w_chi * aphi2).sum() * M2
    ph = D.ph
    if not K.physics.hermitian_ph:
        ph = K._project_ph(ph)
    rqp = qh.real * ph.real + qh.imag * ph.imag
    ep_psi = (K._w_eppsi * rqp).sum() * M2
    pr, pim = phih.real, phih.imag
    rr, ri = refrh_raw.real, refrh_raw.imag
    jr, ji = jh_full.real, jh_full.imag
    g1 = M2 * ((-g.wv2) * (rr * pim - ri * pr)).sum()
    g2 = M2 * ((-g.wv2) * (pr * jr + pim * ji)).sum()
    x1 = M2 * (K._w_d * (pim * jr - pr * ji)).sum()
    x2 = M2 * (K._w_d * (pr * rr + pim * ri)).sum()
    if g.owns_mean_mode:
        M1 = K._inv_M
        mean_modes = [pr[0, 0] * M1, pim[0, 0] * M1, rr[0, 0] * M1,
                      ri[0, 0] * M1]
    else:
        mean_modes = [K._zero] * 4
    return torch.stack([ep_phi, chi_phi, ep_psi, g1, g2, x1, x2]
                       + mean_modes)


def inline_stage_terms(K, qh, phih, D, want_sources):
    jadv, refrh, jh = K._wave_products(qh, D)
    Fn, Fnw = inline_rhs_from_products(K, D, jadv, refrh)
    if not want_sources:
        parts = None
    elif K._spectral_src:
        parts = inline_spectral_source_parts(K, qh, phih, D, refrh, jh)
    else:
        parts = K._batched_source_parts(qh, phih, D)
    return Fn, Fnw, parts


def inline_nonlinear(K, qh, D):
    jadv, refrh, _ = K._wave_products(qh, D)
    return inline_rhs_from_products(K, D, jadv, refrh)


def inline_stage_source_parts(K, qh, phih, D):
    if K._spectral_src:
        _, refrh, jh = K._wave_products(qh, D)
        return inline_spectral_source_parts(K, qh, phih, D, refrh, jh)
    return K._batched_source_parts(qh, phih, D)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


# -- host ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_chain_is_the_inline_chain(name):
    K = _model(name, 32, np.float64, "cpu").kernel
    qh, phih = derive_inputs(torch, K, 7)
    D = K.derive(qh, phih)
    for want in (True, False):
        got = K.stage_terms(qh, phih, D, want)
        ref = inline_stage_terms(K, qh, phih, D, want)
        bad = [w for w, a, b in zip(("Fn", "Fnw", "parts"), got, ref)
               if not _same(a, b)]
        assert not bad, f"{name}: {bad} differ from the inline chain"
    assert all(_same(a, b) for a, b in zip(K.nonlinear(qh, D),
                                           inline_nonlinear(K, qh, D)))
    assert _same(K.stage_source_parts(qh, phih, D),
                 inline_stage_source_parts(K, qh, phih, D))


def _standin_mesh(rank, nP=4):
    """A stand-in for ``parallel.mesh.Mesh``: rank ``rank`` of ``nP``, no
    process group (nothing here makes a collective)."""
    m = object.__new__(Mesh)
    m.rank, m.nP, m.device, m.group, m.k2 = (rank, nP, torch.device("cpu"),
                                             None, None)
    m.backend, m.stage_host = None, False
    return m


def _mesh_kernel(transform, physics, rank):
    from niwqg_tpu_torch.parallel.mfft import MatmulPencilTransform
    from niwqg_tpu_torch.parallel.pfft import PencilTransform

    mesh = _standin_mesh(rank)
    cls = {"pencil": PencilTransform, "mxu": MatmulPencilTransform}[transform]
    params = _model("coupled_half", 32, np.float64, "cpu").params
    return FastWaveKernel(params, physics(), dtype=np.float64,
                          transform=cls(32, np.float64, mesh), mesh=mesh,
                          device="cpu")


LAYOUTS = {
    **{name: (lambda name=name: _model(name, 32, np.float32, "cpu").kernel)
       for name in ("coupled_half", "coupled_full", "coupled_pair",
                    "coupled_mxu", "uncoupled", "ql")},
    **{f"{tr}_{phys.__name__}_rank{r}":
       (lambda tr=tr, phys=phys, r=r: _mesh_kernel(tr, phys, r))
       for tr in ("pencil", "mxu") for phys in (CoupledPhysics, QLPhysics)
       for r in (0, 1, 3) if not (tr == "mxu" and phys is QLPhysics)},
}


def l_dy_from_grid(K):
    """``l_dy`` from the grid's host table of ``l``: the Nyquist row's
    interior columns zeroed in the half layout, all but ``k = 0, nx/2``
    under ``pair_inverse``, then cut to the q side's block (the half
    layout's padded columns zero)."""
    g, nx = K.grid, K.params.nx
    l = g.l_np.copy()
    if K.q_half or K.pair_inverse:
        l[g.ny // 2, 1:nx // 2] = 0.0
    if K.pair_inverse:
        l[g.ny // 2, nx // 2 + 1:] = 0.0
    cut = g.half_np(l, K.layout.pad) if K.q_half else g.spec_np(l)
    return torch.as_tensor(np.ascontiguousarray(cut).astype(K.dtype))


def _held_l_dy(K):
    """The layout's one ``l_dy`` is the grid's table, and the plain
    chain's."""
    assert torch.equal(K.layout.l_dy(), l_dy_from_grid(K))
    assert torch.equal(K._l_dy, l_dy_from_grid(K))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_follows_the_layout(layout):
    K = LAYOUTS[layout]()
    plan, g = K._stage_plan, K.grid
    q = plan.q
    ny, wq = K._qshape
    nP = 1 if K.mesh is None else K.mesh.nP
    rank = 0 if K.mesh is None else K.mesh.rank
    assert q is K.layout is K._plan.q
    assert q.kq.shape == (wq,) and q.l.shape == (ny,)
    assert q.col0 == rank * wq
    assert q.nx == 32
    assert q.nreal == (17 if K.q_half else 32)
    assert q.mirror == tuple(c - q.col0 for c in (0, 16)
                             if q.col0 <= c < q.col0 + wq)
    assert plan.owner == g.owns_mean_mode == (rank == 0)
    assert plan.zero_jac == K.physics.zero_mean_jac_psi_phi
    # the q side's tables as the plain chain reads them
    assert torch.equal(q.kq, K.qtab.k[0])
    assert torch.equal(q.l, g.l[:, 0])
    _held_l_dy(K)
    assert torch.equal(plan.w_eppsi, K._w_eppsi.expand(ny, wq))
    # the wave side's: this rank's columns of the full spectrum
    for t, ref in ((plan.w_d, K._w_d), (plan.w_chi, K._w_chi),
                   (plan.wv2, g.wv2)):
        assert t.shape == (ny, 32 // nP) and t.is_contiguous()
        assert torch.equal(t, ref)
    assert plan.w_eppsi.is_contiguous()
    # the scales, as the plain chain's 0-d tensors hold them
    assert plan.inv_m == K._inv_M.item() and plan.inv_m2 == K._inv_M2.item()
    # no workspace on the host
    assert plan.partials is None and plan.blocks == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_l_dy_is_the_grid_table(name):
    # the derive's layouts (tests/test_torch_derive_fused.py)
    _held_l_dy(_model(name, 32, np.float32, "cpu").kernel)


def test_host_tensors_take_the_plain_chain():
    m = _model("coupled_half", 32, np.float64, "cpu")
    K = m.kernel
    qh, phih = derive_inputs(torch, K, 3)
    D = K.derive(qh, phih)
    stage_fused.reset_counts()
    before = profiling.counters().get("step.stage_fused", 0)
    K.stage_terms(qh, phih, D, True)
    K.nonlinear(qh, D)
    K.stage_source_parts(qh, phih, D)
    c = stage_fused.counts()
    assert c["cpu_calls"] == stage_fused.FAMILY.plain_calls("epilogue") == 3
    assert all(c[k] == 0 for k in stage_fused.USES)
    assert profiling.counters().get("step.stage_fused", 0) == before


def _globals(src):
    """Each ``__global__`` function of a CUDA source: its name and its
    parameter list."""
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(([^)]*)\)", src)


def test_kernel_names_file_as_elementwise():
    from portbench.metrics.arithmetic import OTHER, family

    with open(os.path.join(ROOT, "niwqg_tpu_torch", "csrc",
                           "stage.cu")) as fh:
        decls = _globals(fh.read())
    assert sorted(n for n, _ in decls) == sorted(
        k + "_kernel" for k in stage_fused.KERNELS)
    for name, params in decls:
        args = re.sub(r"\bR\b", "{r}", params.replace("const ", "")).split()
        for r in ("float", "double"):
            for rhs, src in (("true", "true"), ("true", "false"),
                             ("false", "true")):
                # the profiler's name: the namespace, the template, the types
                traced = (f"void (anonymous namespace)::{name}<{r}, {rhs}, "
                          f"{src}>((anonymous namespace)::"
                          f"{args[0].format(r=r)})")
                assert family(traced) == OTHER, traced
        assert family(name) == OTHER


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _held(gaps, label):
    """Fn and Fnw bit for bit, a second launch bit for bit, each partial
    within STAGE_PART_LIMIT (the plain chain's own sums reported only)."""
    bad = {k: v for k, v in gaps.items() if "plain." not in k
           and v > (STAGE_PART_LIMIT if ".part." in k else 0.0)}
    assert not bad, f"{label}: {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nx", [256, 2048])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_matches_plain_chain_on_card(card, name, nx, dtype):
    K = _model(name, nx, dtype, card).kernel
    stage_fused.reset_counts()
    gaps = stage_gaps(torch, K, seed=nx + 5)
    c = stage_fused.counts()
    uses = 3 if K._spectral_src else 1
    # each use launched twice: once on its own, once more (bit for bit)
    assert c["cpu_calls"] == 0
    assert c["stage"] == 2 * min(uses, 2) and c["sources"] == 2 * (uses > 1)
    print(f"{name} {nx} {np.dtype(dtype).name} {gaps}")
    _held(gaps, f"{name} at {nx}² in {np.dtype(dtype).name}")


@pytest.mark.cuda
def test_kernel_on_a_shared_card_mesh(card, tmp_path):
    from _torch_sharded_common import run_suite

    res = run_suite("stage_card", tmp_path, timeout=600)
    gaps = {k[4:]: float(v) for k, v in res.items() if k.startswith("gap_")}
    print("mesh gaps", gaps)
    assert len(gaps) >= 4 * 5 * 4
    _held(gaps, "the mesh")


@pytest.mark.cuda
def test_launches_counted_on_the_card(card):
    # a capture runs nothing and counts nothing; each replay counts one
    # launch, as an eager call does
    m = _model("coupled_half", 256, np.float32, card, tdiags=1)
    K = m.kernel
    qh, phih = derive_inputs(torch, K, 2)
    D = K.derive(qh, phih)
    K.stage_terms(qh, phih, D, True)  # eager: outside the capture
    stage_fused.reset_counts()
    before = profiling.counters().get("step.stage_fused", 0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        Fn, Fnw, parts = K.stage_terms(qh, phih, D, True)
    assert stage_fused.counts()["stage"] == 0
    for _ in range(3):
        g.replay()
    c = stage_fused.counts()
    assert (c["stage"], c["sources"]) == (3, 0)
    assert profiling.counters().get("step.stage_fused", 0) == before + 1
    again = K.stage_terms(qh, phih, D, True)
    assert all(torch.equal(a, b) for a, b in zip((Fn, Fnw, parts), again))
    # a run's steps: 4 a step, and one sources-only launch a diagnostics
    # sample, replays of both graphs included
    m.set_q(np.zeros((256, 256)))
    m.set_phi(np.full((256, 256), 0.05 + 0j))
    stage_fused.reset_counts()
    m._runner.advance(5, diags=True)
    c = stage_fused.counts()
    assert (c["stage"], c["sources"], c["cpu_calls"]) == (20, 5, 0)
