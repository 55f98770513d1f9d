"""The QG model's fused stage gaps (``QGKernel._step_fused`` in
``niwqg_tpu_torch/models/qg.py``, its launchers
``niwqg_tpu_torch/ops/qg_fused.py``, its kernels ``csrc/qg_stage.cu``).

On the host: each plain function of ``ops/qg_fused.py`` (the pack, the
products and stages 1-4) gives bit for bit what the plain step's chain
gives (a copy of it below), in float32 and float64, with the scalar and
without, with the filter folded into the tables and not, on one card's
half spectrum and on padded column blocks of a four-rank mesh (stand-in
meshes, no collectives); the fused step with the plain functions standing
in for the kernels gives the plain step's fields bit for bit; the plan's
column weights and mean-mode handling give ``Grid.spec_var`` and
``Grid.spec_cross`` to rounding, the blocks of a mesh summing to the
one-card value; the host's steps run the plain step, count its stages as
the kernels' plain calls and load no library; the kernels' names are
filed by the benchmark's classifier with the elementwise work they do.

On the card (marked ``cuda``, skipped without one): every batch, right-hand
side and ``ph`` the kernels write bit for bit the plain chain on the same
CUDA tensors, a second launch bit for bit the first, each budget partial
within STAGE_PART_LIMIT of the float64 total of its terms, two whole steps'
fields bit for bit ``step(plain=True)`` (``chip_smoke.qg_gaps``), in
float32 and float64 at 256² and 2048² on one card, and on padded column
blocks of a four-rank stand-in mesh read in the column-led strides a
pencil's y-FFT hands over; a CUDA graph's replays counted by use. This
file imports neither JAX nor the JAX package; on the card::

    python -m pytest --noconftest -m cuda tests/test_torch_qg_fused.py
"""

import os
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu_torch as pkg  # noqa: E402
from niwqg_tpu_torch import cuda_build  # noqa: E402
from niwqg_tpu_torch.models.qg import QGKernel, QGParams  # noqa: E402
from niwqg_tpu_torch.ops import qg_fused as qf  # noqa: E402
from niwqg_tpu_torch.ops.spectral import mul_i  # noqa: E402
from niwqg_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import STAGE_PART_LIMIT, qg_gaps, qg_inputs  # noqa: E402

NX = 32
PARAMS = dict(nx=NX, L=2 * np.pi * 200e3, dt=1000.0, U=-0.05, beta=1e-11,
              nu4=5e9, passive_scalar=True)


def _standin_mesh(rank, device="cpu", nP=4):
    """A stand-in for ``parallel.mesh.Mesh``: rank ``rank`` of ``nP``, no
    process group (nothing here makes a collective)."""
    m = object.__new__(Mesh)
    m.rank, m.nP, m.device, m.group, m.k2 = (rank, nP, torch.device(device),
                                             None, None)
    m.backend, m.stage_host = None, False
    return m


def _kernel(dtype=np.float64, scalar=True, fold=False, rank=None,
            device="cpu", nx=NX, **kw):
    """A QG kernel object on one card's half spectrum, or (``rank``) on
    rank ``rank``'s padded column block of a four-rank stand-in mesh, with
    a stand-in transform that only names the pencil's padding."""
    params = QGParams(**dict(PARAMS, nx=nx, passive_scalar=scalar, **kw))
    if rank is None:
        return QGKernel(params, dtype=dtype, device=device, fold_filter=fold)
    pad = -(nx // 2 + 1) % 4
    tr = types.SimpleNamespace(rfft_pad=pad, rfft2=None, irfft2=None)
    return QGKernel(params, dtype=dtype, transform=tr, fold_filter=fold,
                    mesh=_standin_mesh(rank, device))


def _name(dtype, scalar, fold, rank):
    return (f"{np.dtype(dtype).name}-{'scalar' if scalar else 'q'}"
            f"-{'fold' if fold else 'filter'}"
            + ("-one_card" if rank is None else f"-rank{rank}"))


CONFIGS = {_name(*c): c for c in
           [(d, s, f, None) for d in (np.float32, np.float64)
            for s in (True, False) for f in (False, True)]
           + [(d, s, False, r) for d in (np.float32, np.float64)
              for s in (True, False) for r in (0, 1, 3)]}


# -- the plain step's chain, as models/qg.py's step writes it -----------------

def inline_stages(K, qh0, ch0, ph0, gbs, fjs):
    """The batches, right-hand sides and ``ph`` of the plain step's four
    stages, each stage's products taken from ``gbs`` and its forward
    output from ``fjs`` (random stand-ins for the transforms)."""
    g, cq, cc = K.grid, K.coefs_q, K.coefs_c
    flt = None if K.fold_filter else g.filtr
    mulf = K._mulf
    scalar = cc is not None

    def batch(ph, qh, ch):
        specs = [mul_i(ph, -g.l), mul_i(ph, g.k), qh]
        if ch is not None:
            specs.append(ch)
        return torch.stack(specs)

    def products(gb):
        u, v, q = gb[0], gb[1], gb[2]
        prods = [u * q, v * q]
        if scalar:
            prods += [u * gb[3], v * gb[3]]
        return torch.stack(prods)

    def jac(fj):
        jq = mul_i(fj[0], g.k) + mul_i(fj[1], g.l)
        jc = mul_i(fj[2], g.k) + mul_i(fj[3], g.l) if scalar else None
        return jq, jc

    out = {"pack": batch(ph0, qh0, ch0 if scalar else None),
           "products": [products(gb) for gb in gbs]}
    ch = None
    # stage 1
    j, jc = jac(fjs[0])
    Fn0 = -j
    qh = mulf(cq.expch_h * qh0 + Fn0 * cq.Qh, flt)
    qh1 = qh
    if scalar:
        Fn0c = -jc
        ch = mulf(cc.expch_h * ch0 + Fn0c * cc.Qh, flt)
        ch1 = ch
    ph = -(qh * g.wv2i)
    out[1] = (batch(ph, qh, ch), ph)
    # stage 2
    j, jc = jac(fjs[1])
    Fna = -j
    qh = mulf(cq.expch_h * qh0 + Fna * cq.Qh, flt)
    if scalar:
        Fnac = -jc
        ch = mulf(cc.expch_h * ch0 + Fnac * cc.Qh, flt)
    ph = -(qh * g.wv2i)
    out[2] = (batch(ph, qh, ch), ph)
    # stage 3
    j, jc = jac(fjs[2])
    Fnb = -j
    qh = mulf(cq.expch_h * qh1 + (2.0 * Fnb - Fn0) * cq.Qh, flt)
    if scalar:
        Fnbc = -jc
        ch = mulf(cc.expch_h * ch1 + (2.0 * Fnbc - Fn0c) * cc.Qh, flt)
    ph = -(qh * g.wv2i)
    out[3] = (batch(ph, qh, ch), ph)
    # stage 4 and the final inversion
    j, jc = jac(fjs[3])
    Fnc = -j
    qh = mulf(cq.expch * qh0 + Fn0 * cq.f0 + 2.0 * (Fna + Fnb) * cq.fab
              + Fnc * cq.fc, flt)
    if scalar:
        Fncc = -jc
        ch = mulf(cc.expch * ch0 + Fn0c * cc.f0
                  + 2.0 * (Fnac + Fnbc) * cc.fab + Fncc * cc.fc, flt)
    ph = -(qh * g.wv2i)
    out[4] = (torch.stack([ph, qh] + ([ch] if scalar else [])), ph)
    return out


def plain_stages(K, qh0, ch0, ph0, gbs, fjs):
    """The same through ``ops/qg_fused.py``'s plain functions, chained as
    ``QGKernel._step_fused`` chains the kernels."""
    P = K._qg_plan
    out = {"pack": qf.pack_plain(P, ph0, qh0, ch0),
           "products": [qf.products_plain(P, gb) for gb in gbs]}
    fns, base1 = [], None
    for n, fj in enumerate(fjs, 1):
        batch, fn, _, ph = qf.stage_plain(
            P, n, fj, base1 if n == 3 else (qh0, ch0),
            qh_q=qh0 if n == 3 else None,
            fns=((fns[0], fns[1]) if n == 3 else (fns[0], fns[2])
                 if n == 4 else (None, None)), ph=True)
        fns.append(fn)
        if n == 1:
            base1 = (batch[2], batch[3] if ch0 is not None else None)
        out[n] = (batch, ph)
    return out


# -- host ---------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_functions_are_the_inline_chain(config):
    K = _kernel(*CONFIGS[config])
    ph, qh, ch, gbs, fjs = qg_inputs(torch, K, 11, transposed=False)
    want = inline_stages(K, qh, ch, ph, gbs, fjs)
    got = plain_stages(K, qh, ch, ph, gbs, fjs)
    assert torch.equal(got["pack"], want["pack"])
    assert all(torch.equal(a, b) for a, b in zip(got["products"],
                                                 want["products"]))
    for n in (1, 2, 3, 4):
        for what, a, b in zip(("batch", "ph"), got[n], want[n]):
            assert torch.equal(a, b), f"{config}: stage {n}'s {what}"


STEP_CONFIGS = {
    "scalar": {}, "no_scalar": dict(passive_scalar=False),
    "fold": dict(fold_filter=True),
    "fields": dict(spectral_budgets=False),
    "nu_mu": dict(nu=1e2, mu=1e-7, nuc=1e1, muc=1e-7)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_fused_step_with_plain_stand_ins(monkeypatch, config, dtype):
    # the fused step's plumbing on the host: the plain functions stand in
    # for the kernels; every field bit for bit the plain step, the budgets
    # the same sums taken in float64
    for name in ("pack", "products", "stage"):
        monkeypatch.setattr(qf, name, getattr(qf, name + "_plain"))
    m = pkg.QGModel.Model(**dict(PARAMS, **STEP_CONFIGS[config]),
                          dtype=dtype, tmax=1e5, device="cpu")
    K = m.kernel
    rng = np.random.default_rng(5)
    m.set_q(rng.standard_normal((NX, NX)) * 1e-5)
    if K.params.passive_scalar:
        m.set_c(rng.standard_normal((NX, NX)))
    s = m.state
    eps = np.finfo(dtype).eps
    for _ in range(3):
        a, b = K._step_fused(s), K.step(s)
        for f in ("qh", "ch", "ph", "p", "q", "c", "u", "v"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for f in ("Ke", "cvar"):
            da = float(getattr(a, f) - getattr(s, f))
            db = float(getattr(b, f) - getattr(s, f))
            assert abs(da - db) <= 64 * eps * max(abs(db), 1e-30), (f, da,
                                                                   db)
        s = a


@pytest.mark.parametrize("scalar", [True, False])
def test_partials_are_spec_var_and_spec_cross(scalar):
    # one card: each partial against the Grid's sum on the same fields
    K = _kernel(np.float64, scalar, nu=1e2, mu=1e-7)
    g, P, p = K.grid, K._qg_plan, K.params
    ph, qh, ch, _, _ = qg_inputs(torch, K, 3, transposed=False)
    qq = qh * 0.5 + 1.0
    parts = qf.parts_plain(P, qq, qh, ph, ch)
    c = qh if ch is None else ch
    want = [g.spec_var(c), g.spec_var(c * g.wv), g.spec_var(c * g.wv2),
            g.spec_cross(qq, ph * (p.nu4 * g.wv4 + p.mu)),
            g.spec_cross(qh, ph * g.wv2)]
    for name, a, b in zip(qf.PARTS, parts, want):
        if name in ("C2", "gradC2", "lapc2") and not scalar:
            assert float(a) == 0.0
            continue
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b)), name


def test_partials_of_mesh_blocks_sum_to_one_card():
    # the ranks' blocks of a padded half spectrum: their partials add up to
    # the one-card sums of the same global field, the padding weighing
    # nothing and the mean mode only on its owner
    one = _kernel(np.float64, nu=1e2, mu=1e-7)
    ny, nk = one.grid.spec_shape
    rng = np.random.default_rng(4)

    def field():
        return rng.standard_normal((ny, nk)) + 1j * rng.standard_normal(
            (ny, nk))

    qq, qh, ph, ch = field(), field(), field(), field()
    ref = qf.parts_plain(one._qg_plan, *(torch.as_tensor(z) for z in
                                         (qq, qh, ph, ch)))
    total = torch.zeros_like(ref)
    for rank in range(4):
        K = _kernel(np.float64, rank=rank, nu=1e2, mu=1e-7)
        P = K._qg_plan
        assert P.owner == (rank == 0)
        assert P.col0 == rank * K.grid.spec_shape[1]
        blocks = [torch.as_tensor(np.ascontiguousarray(K.grid.spec_np(
            np.pad(z, [(0, 0), (0, K.grid.pad)])))) for z in (qq, qh, ph, ch)]
        total += qf.parts_plain(P, *blocks)
    assert torch.allclose(total, ref, rtol=1e-12, atol=0.0)


def test_plan_reads_the_grid():
    for rank in (None, 0, 2):
        K = _kernel(np.float32, rank=rank, fold=rank == 2)
        g, P = K.grid, K._qg_plan
        assert torch.equal(P.k, g.k[0]) and torch.equal(P.l, g.l[:, 0])
        assert P.kd.dtype == torch.float64
        assert torch.equal(P.kd.float(), P.k) and torch.equal(P.ld.float(),
                                                              P.l)
        assert P.filtr is None if K.fold_filter else torch.equal(P.filtr,
                                                                 g.filtr)
        assert P.cq is not None and P.cc is not None
        assert all(t.is_contiguous() for t in P.cq + P.cc)
        assert P.nreal == NX // 2 + 1 and P.nx == NX
        assert P.sums and P.inv_m2 == 1.0 / float(NX * NX) ** 2
        # no workspace on the host
        assert P.partials is None and P.blocks == 0


def test_host_steps_take_the_plain_chain():
    m = pkg.QGModel.Model(**PARAMS, tmax=1e5, device="cpu")
    m.set_q(np.random.default_rng(1).standard_normal((NX, NX)) * 1e-5)
    qf.reset_counts()
    before = profiling.counters().get("step.qg_fused", 0)
    m.run_steps(2)
    c = qf.counts()
    assert c == {"pack": 0, "products": 0, "stage": 0, "cpu_calls": 8}
    assert qf.FAMILY.plain_calls("stage") == 8
    assert profiling.counters().get("step.qg_fused", 0) == before
    assert not any(name == "qg_stage" for name, _ in cuda_build._loaded)


def _globals(src):
    """Each ``__global__`` function of a CUDA source: its name and its
    parameter list."""
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                      r"(?:\([^)]*\))?[^)]*\)\s+)?(\w+)\s*\(([^)]*)\)", src)


def test_kernel_names_file_as_elementwise():
    from portbench.metrics.arithmetic import OTHER, family

    with open(os.path.join(ROOT, "niwqg_tpu_torch", "csrc",
                           "qg_stage.cu")) as fh:
        decls = _globals(fh.read())
    assert sorted(n for n, _ in decls) == sorted(
        k + "_kernel" for k in qf.KERNELS)
    args = {"qg_stage_kernel": [f"{s}, {flat}" for s in range(5)
                                for flat in ("true", "false")],
            "qg_products_kernel": ["1", "2", "4"]}
    for name, params in decls:
        arg = params.replace("const ", "").split()[0].replace("<R>", "<{r}>")
        for r in ("float", "double"):
            for x in args[name]:
                # the profiler's name: the namespace, the template, the types
                traced = (f"void (anonymous namespace)::{name}<{r}, {x}>("
                          f"(anonymous namespace)::{arg.format(r=r)})")
                assert family(traced) == OTHER, traced
        assert family(name) == OTHER


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _held(gaps, label):
    """Every field bit for bit, a second launch bit for bit, each partial
    within STAGE_PART_LIMIT (whole steps' Ke and cvar reported only)."""
    bad = {k: v for k, v in gaps.items() if not k.startswith("plain.")
           and v > (STAGE_PART_LIMIT if ".part." in k else 0.0)}
    assert not bad, f"{label}: {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nx", [256, 2048])
@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_kernels_match_plain_chain_on_card(card, config, nx, dtype):
    kw = dict(STEP_CONFIGS[config])
    m = pkg.QGModel.Model(**dict(PARAMS, nx=nx, **kw), dtype=dtype,
                          tmax=1e5)
    qf.reset_counts()
    gaps = qg_gaps(torch, m.kernel, seed=nx + 9)
    c = qf.counts()
    assert c["cpu_calls"] == 0 and c["pack"] >= 2 and c["stage"] >= 8
    print(f"{config} {nx} {np.dtype(dtype).name} {gaps}")
    _held(gaps, f"{config} at {nx}² in {np.dtype(dtype).name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rank", [0, 1, 3])
@pytest.mark.parametrize("scalar", [True, False])
def test_kernels_on_padded_mesh_blocks(card, scalar, rank, dtype):
    # a pencil rank's padded column block, its spectra column-led as the
    # y-FFT hands them over (and row-major too)
    K = _kernel(dtype, scalar, rank=rank, device="cuda", nx=256)
    for transposed in (True, False):
        gaps = qg_gaps(torch, K, seed=rank + 40, transposed=transposed)
        _held(gaps, f"rank {rank}, transposed {transposed}")


@pytest.mark.cuda
def test_launches_counted_on_the_card(card):
    # a capture runs nothing and counts nothing; each replay counts its
    # launches by use, as an eager step does
    m = pkg.QGModel.Model(**dict(PARAMS, nx=256), dtype=np.float32,
                          tmax=1e5, tdiags=1)
    m.set_q(np.random.default_rng(2).standard_normal((256, 256)) * 1e-5)
    K, s = m.kernel, m.state
    K.step(s)  # eager: outside the capture
    qf.reset_counts()
    before = profiling.counters().get("step.qg_fused", 0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = K.step(s)
    assert qf.counts() == {"pack": 0, "products": 0, "stage": 0,
                           "cpu_calls": 0}
    for _ in range(3):
        g.replay()
    assert qf.counts() == {"pack": 3, "products": 12, "stage": 12,
                           "cpu_calls": 0}
    assert profiling.counters().get("step.qg_fused", 0) == before + 1
    again = K.step(s)
    assert all(torch.equal(getattr(out, f), getattr(again, f))
               for f in ("qh", "ch", "ph", "q", "c", "Ke", "cvar"))
    # a run's steps through graphs A and B: the same launches a step
    qf.reset_counts()
    m._runner.advance(5, diags=True)
    m._runner.advance(5, diags=False)
    assert qf.counts() == {"pack": 10, "products": 40, "stage": 40,
                           "cpu_calls": 0}
