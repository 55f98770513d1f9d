"""The YBJ model's fused stage gaps (``YBJKernel._step_fused`` in
``niwqg_tpu_torch/models/ybj.py``, its launchers
``niwqg_tpu_torch/ops/ybj_fused.py``, its kernels ``csrc/ybj_stage.cu``).

On the host: each plain function of ``ops/ybj_fused.py`` (the pack, the
products and stages 1-4) gives bit for bit what the plain step's chain
gives (a copy of it below), in float32 and float64, with the refraction
reading the step-start phi and the stage's own, with the filter folded
into the tables and not; the fused step with the plain functions standing
in for the kernels gives the plain step's fields bit for bit; the plan
reads the grid and the tables; host tensors and a mesh take the plain
chain, count its stages as the kernels' plain calls and load no library;
the kernels' names are filed by the benchmark's classifier with the
elementwise work they do.

On the card (marked ``cuda``, skipped without one): every batch,
right-hand side and ``phih`` the kernels write bit for bit the plain chain
on the same CUDA tensors, a second launch bit for bit the first, two whole
steps' ``phih``, ``phi``, ``phix`` and ``phiy`` bit for bit
``step(plain=True)`` (``chip_smoke.ybj_gaps``), in float32 and float64 at
256² and 2048²; a CUDA graph's replays counted by use. This file imports
neither JAX nor the JAX package; on the card::

    python -m pytest --noconftest -m cuda tests/test_torch_ybj_fused.py
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu_torch as pkg  # noqa: E402
from niwqg_tpu_torch import cuda_build  # noqa: E402
from niwqg_tpu_torch.models.kernel import KernelParams  # noqa: E402
from niwqg_tpu_torch.models.ybj import YBJKernel  # noqa: E402
from niwqg_tpu_torch.ops import ybj_fused as yf  # noqa: E402
from niwqg_tpu_torch.ops.fft import NativeTransform  # noqa: E402
from niwqg_tpu_torch.ops.spectral import jmul, mul_i  # noqa: E402
from niwqg_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import YBJ_FIELDS, ybj_gaps, ybj_inputs  # noqa: E402

NX = 32
PARAMS = dict(nx=NX, L=2 * np.pi * 200e3, dt=157.0, f=1e-4, N=0.005,
              m=1.0 / 325, nu4=7.5e9, nu4w=7.5e9, use_filter=True)
# (faithful_quirks, fold_filter)
MODES = {f"{'faithful' if q else 'own_phi'}-{'fold' if f else 'filter'}":
         (q, f) for q in (True, False) for f in (False, True)}
DTYPES = {"float32": np.float32, "float64": np.float64}


def _kernel(faithful=True, fold=False, dtype=np.float64, device="cpu",
            nx=NX, mesh=None):
    kw = dict(transform=NativeTransform(nx, dtype)) if mesh else {}
    return YBJKernel(KernelParams(**dict(PARAMS, nx=nx)),
                     faithful_quirks=faithful, fold_filter=fold, dtype=dtype,
                     device=device, mesh=mesh, **kw)


# -- the plain step's chain, as models/ybj.py's step writes it ---------------

def inline_stages(K, phih0, flow, gbs, nls):
    """The pack, the products and each stage's (batch, right-hand side
    kept, phih) of the plain step, each stage's inverse output taken from
    ``gbs`` and its forward output from ``nls`` (random stand-ins for the
    transforms)."""
    g, cw = K.grid, K.coefs_w
    flt = None if K.fold_filter else g.filtr
    mulf = K._mulf
    phi0, u, v, q = flow

    def batch(phih, full):
        grads = [mul_i(phih, g.k), mul_i(phih, g.l)]
        return torch.stack([phih] + grads if full else grads)

    def products(gb):
        phi = phi0 if K.faithful_quirks else gb[0]
        phix, phiy = gb[-2], gb[-1]
        return torch.stack([phix * u + phiy * v, phi * q])

    def rhs(nl):
        return -nl[0] - jmul(nl[1], 0.5)

    own = not K.faithful_quirks
    out = {"pack": batch(phih0, own),
           "products": [products(gb) for gb in gbs]}
    Fn0w = rhs(nls[0])
    phih = mulf(cw.expch_h * phih0 + Fn0w * cw.Qh, flt)
    phih1 = phih
    out[1] = (batch(phih, own), Fn0w, phih)
    Fnaw = rhs(nls[1])
    phih = mulf(cw.expch_h * phih0 + Fnaw * cw.Qh, flt)
    out[2] = (batch(phih, own), Fnaw, phih if own else None)
    Fnbw = rhs(nls[2])
    phih = mulf(cw.expch_h * phih1 + (2.0 * Fnbw - Fn0w) * cw.Qh, flt)
    out[3] = (batch(phih, own), Fnaw + Fnbw, phih if own else None)
    Fncw = rhs(nls[3])
    phih = mulf(cw.expch * phih0 + Fn0w * cw.f0
                + 2.0 * (Fnaw + Fnbw) * cw.fab + Fncw * cw.fc, flt)
    # the step's end: phi = ifft2(phih) and the gradients' spectra
    out[4] = (batch(phih, True), None, phih)
    return out


def plain_stages(K, phih0, flow, gbs, nls):
    """The same through ``ops/ybj_fused.py``'s plain functions, chained as
    ``YBJKernel._step_fused`` chains the kernels."""
    P = K._ybj_plan
    phi0, u, v, q = flow
    out = {"pack": yf.pack_plain(P, phih0), "products": [
        yf.products_plain(P, gb[-2], gb[-1], phi0 if P.faithful else gb[0],
                          u, v, q) for gb in gbs]}
    fns, phih1 = [], None
    for n, nl in enumerate(nls, 1):
        out[n] = yf.stage_plain(
            P, n, nl, phih1 if n == 3 else phih0,
            fns=((fns[0], fns[1]) if n == 3 else (fns[0], fns[2])
                 if n == 4 else (None, None)))
        fns.append(out[n][1])
        if n == 1:
            phih1 = out[n][2]
    return out


# -- host ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_functions_are_the_inline_chain(mode, dtype):
    K = _kernel(*MODES[mode], dtype=DTYPES[dtype])
    phih, flow, gbs, nls = ybj_inputs(torch, K, 11)
    want = inline_stages(K, phih, flow, gbs, nls)
    got = plain_stages(K, phih, flow, gbs, nls)
    assert torch.equal(got["pack"], want["pack"])
    assert all(torch.equal(a, b) for a, b in zip(got["products"],
                                                 want["products"]))
    for n in (1, 2, 3, 4):
        for what, a, b in zip(("batch", "fn", "phih"), got[n], want[n]):
            assert (a is None) == (b is None), f"stage {n}'s {what}"
            assert a is None or torch.equal(a, b), f"stage {n}'s {what}"


def _model(faithful, fold, dtype, nx=NX, device="cpu", **kw):
    """A YBJ model with a seeded flow and wave field."""
    m = pkg.YBJModel.Model(**dict(PARAMS, nx=nx), faithful_quirks=faithful,
                           fold_filter=fold, dtype=dtype, tmax=1e5,
                           device=device, **kw)
    rng = np.random.default_rng(5)
    m.set_q(rng.standard_normal((nx, nx)) * 1e-5)
    m.set_phi(rng.standard_normal((nx, nx))
              + 1j * rng.standard_normal((nx, nx)))
    return m


def _fields(s):
    return {"phih": s.phih, **{f: getattr(s.d, f) for f in YBJ_FIELDS[1:]}}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_step_with_plain_stand_ins(monkeypatch, mode, dtype):
    # the fused step's plumbing on the host: the plain functions stand in
    # for the kernels; every field bit for bit the plain step
    for name in ("pack", "products", "stage"):
        monkeypatch.setattr(yf, name, getattr(yf, name + "_plain"))
    m = _model(*MODES[mode], DTYPES[dtype])
    K, s = m.kernel, m.state
    for _ in range(3):
        a, b = K._step_fused(s), K.step(s)
        assert a.tc == b.tc and torch.equal(a.t, b.t)
        for f, x in _fields(a).items():
            assert torch.equal(x, _fields(b)[f]), f
        s = a


def test_host_and_mesh_take_the_plain_chain(monkeypatch):
    for name in ("pack", "products", "stage"):
        monkeypatch.setattr(yf, name, None)  # a call would raise
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    one = Mesh(0, 1, "cpu")
    assert yf.engages(cuda, None)
    assert not yf.engages(cuda, one) and not yf.engages(cpu, None)
    m = _model(True, False, np.float64)
    yf.reset_counts()
    before = profiling.counters().get("step.ybj_fused", 0)
    m.run_steps(2)
    assert yf.counts() == {"pack": 0, "products": 0, "stage": 0,
                           "cpu_calls": 8}
    # a one-rank mesh of the host: its blocks are the whole field
    K = _kernel(mesh=one)
    s = K.apply_set_phi(K.apply_set_q(K.zero_state(), m.q), m.phi)
    s = K.step(s)
    assert yf.FAMILY.plain_calls("stage") == 12
    assert torch.isfinite(s.phih).all()
    assert profiling.counters().get("step.ybj_fused", 0) == before
    assert not any(name == "ybj_stage" for name, _ in cuda_build._loaded)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plan_reads_the_grid(mode):
    faithful, fold = MODES[mode]
    K = _kernel(faithful, fold, np.float32)
    g, P = K.grid, K._ybj_plan
    assert torch.equal(P.k, g.k[0]) and torch.equal(P.l, g.l[:, 0])
    assert P.k.is_contiguous() and P.l.is_contiguous()
    assert P.filtr is None if fold else torch.equal(P.filtr, g.filtr)
    assert all(torch.equal(a, b) and a.is_contiguous()
               and a.dtype == torch.complex64
               for a, b in zip(P.cw, K.coefs_w))
    assert P.faithful is faithful
    # the frozen flow is row-major, as the fused products read it
    s = K.apply_set_q(K.zero_state(), np.ones((NX, NX)))
    assert s.d.u.is_contiguous() and s.d.v.is_contiguous()


def _globals(src):
    """Each ``__global__`` function of a CUDA source: its name and its
    parameter list."""
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                      r"(?:\([^)]*\))?[^)]*\)\s+)?(\w+)\s*\(([^)]*)\)", src)


def test_kernel_names_file_as_elementwise():
    from portbench.metrics.arithmetic import OTHER, family

    with open(os.path.join(ROOT, "niwqg_tpu_torch", "csrc",
                           "ybj_stage.cu")) as fh:
        decls = _globals(fh.read())
    assert sorted(n for n, _ in decls) == sorted(
        k + "_kernel" for k in yf.KERNELS)
    args = {"ybj_stage_kernel": [f", {s}" for s in range(5)],
            "ybj_products_kernel": [""]}
    for name, params in decls:
        arg = params.replace("const ", "").split()[0].replace("<R>", "<{r}>")
        for r in ("float", "double"):
            for x in args[name]:
                # the profiler's name: the namespace, the template, the types
                traced = (f"void (anonymous namespace)::{name}<{r}{x}>("
                          f"(anonymous namespace)::{arg.format(r=r)})")
                assert family(traced) == OTHER, traced
        assert family(name) == OTHER


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nx", [256, 2048])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_kernels_match_plain_chain_on_card(card, mode, nx, dtype):
    K = _kernel(*MODES[mode], dtype=DTYPES[dtype], device="cuda", nx=nx)
    yf.reset_counts()
    gaps = ybj_gaps(torch, K, seed=nx + 9)
    c = yf.counts()
    assert c["cpu_calls"] == 0 and c["pack"] >= 4 and c["stage"] >= 16
    print(f"{mode} {nx} {dtype} {gaps}")
    bad = {k: v for k, v in gaps.items() if v}
    assert not bad, f"{mode} at {nx}² in {dtype}: {bad}"


@pytest.mark.cuda
def test_launches_counted_on_the_card(card):
    # a capture runs nothing and counts nothing; each replay counts its
    # launches by use, as an eager step does
    m = _model(True, False, np.float32, nx=256, device="cuda", tdiags=1)
    K, s = m.kernel, m.state
    K.step(s)  # eager: outside the capture
    yf.reset_counts()
    before = profiling.counters().get("step.ybj_fused", 0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = K.step(s)
    assert yf.counts() == {"pack": 0, "products": 0, "stage": 0,
                           "cpu_calls": 0}
    for _ in range(3):
        g.replay()
    assert yf.counts() == {"pack": 3, "products": 12, "stage": 12,
                           "cpu_calls": 0}
    assert profiling.counters().get("step.ybj_fused", 0) == before + 1
    again = K.step(s)
    assert all(torch.equal(a, _fields(again)[f])
               for f, a in _fields(out).items())
    # a run's steps through graphs A and B: the same launches a step
    yf.reset_counts()
    m._runner.advance(5, diags=True)
    m._runner.advance(5, diags=False)
    assert yf.counts() == {"pack": 10, "products": 40, "stage": 40,
                           "cpu_calls": 0}
