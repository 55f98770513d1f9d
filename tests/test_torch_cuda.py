"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain versions (K1, the complex-split matmul; K2, the all-to-all
transpose, four ranks in this process on ``min(4, device_count)`` cards),
the K1 configuration on the card against the host, and the run path's
replayed CUDA graphs against the eager per-step loop.

They skip without a CUDA device. This file imports neither JAX nor the JAX
package, so it runs where JAX is absent; from the repository root::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from niwqg_tpu_torch import CoupledModel  # noqa: E402
from niwqg_tpu_torch import InitialConditions as ic  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402
from niwqg_tpu_torch.ops.fft import MatmulTransform, NativeTransform  # noqa: E402
from niwqg_tpu_torch.parallel import a2a  # noqa: E402

pytestmark = pytest.mark.cuda

K1_OPTS = dict(use_pallas=True, formulation="swap", factors=None,
               half_factors=None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _planes(M, K, N, seed, device):
    rng = np.random.default_rng(seed)
    ar, ai = (torch.as_tensor(rng.standard_normal((M, K), np.float32),
                              device=device) for _ in range(2))
    br, bi = (torch.as_tensor(rng.standard_normal((K, N), np.float32),
                              device=device) for _ in range(2))
    return (ar, ai) + csplit_mm.mask_split(br) + csplit_mm.mask_split(bi)


# each route against its own plain version: the tensor-core kernel takes
# the same bf16-rounded operands as csplit_matmul_ref_bf16 (f32 sums in
# another order: 2e-6 of max|ref|) and sits within bf16 rounding of x, x_lo
# and y_lo (2^-17..2^-16 a term: 2e-5 of max) of the exact product; the
# f32-FMA kernel forms full f32 products like csplit_matmul_ref (1e-5)
ROUTE_ORACLE = {"tc": ("csplit_matmul_ref_bf16", 2e-6),
                "f32": ("csplit_matmul_ref", 1e-5)}
EXACT_RTOL = 2e-5


@pytest.mark.parametrize("shape", [(2048, 2048, 2048), (520, 384, 264),
                                   (8, 256, 256), (1, 1, 1), (130, 17, 65)])
def test_kernel_matches_plain_version(card, shape):
    M, K, N = shape
    args = _planes(*shape, seed=sum(shape), device=card)
    route = csplit_mm.route(M, N, K)
    c0 = csplit_mm.counts()
    re, im = csplit_mm.csplit_matmul(*args)
    c1 = csplit_mm.counts()
    assert c1["launches"] == c0["launches"] + 1
    assert c1["launches_" + route] == c0["launches_" + route] + 1
    oracle, rtol = ROUTE_ORACLE[route]
    rre, rim = getattr(csplit_mm, oracle)(*args)
    scale = max(rre.abs().max().item(), rim.abs().max().item())
    err = max((re - rre).abs().max().item(), (im - rim).abs().max().item())
    assert err <= rtol * scale
    if route == "tc":
        exact = (torch.complex(args[0].double(), args[1].double())
                 @ torch.complex((args[2] + args[3]).double(),
                                 (args[4] + args[5]).double()))
        got = torch.complex(re.double(), im.double())
        assert (got - exact).abs().max() <= EXACT_RTOL * exact.abs().max()
        pre, pim = csplit_mm.csplit_matmul_prepared(
            args[0], args[1], csplit_mm.prepare_b(*args[2:]))
        assert torch.equal(pre, re) and torch.equal(pim, im)


def test_kernel_sums_same_sign_terms_two_level(card):
    """Column 0 of a constant A times the DFT matrix sums K equal terms
    (the mean mode of a near-uniform field), on the tensor-core route. The
    tensor cores add into their accumulator by truncation: on an H100 one
    running sum over K=2048 is off by 1.5e-5 here, a sum closed every 512 of K by
    4.6e-6, the kernel's (every 32-deep stage summed on its own, then
    added in with a rounded add) by 5.9e-7."""
    K = 2048
    c = np.float32(5 * 0.05 / np.sqrt(2))
    a = torch.full((64, K), float(c), dtype=torch.float32, device=card)
    idx = np.arange(K)
    F = np.exp(-2j * np.pi * np.outer(idx, idx) / K)
    br = torch.as_tensor(F.real.astype(np.float32), device=card)
    bi = torch.as_tensor(F.imag.astype(np.float32), device=card)
    assert csplit_mm.route(64, K, K) == "tc"
    n = csplit_mm.counts()["launches_tc"]
    re, im = csplit_mm.csplit_matmul(a, a, *csplit_mm.mask_split(br),
                                     *csplit_mm.mask_split(bi))
    assert csplit_mm.counts()["launches_tc"] == n + 1
    exact = K * float(c)
    for plane in (re, im):
        err = (plane[:, 0].double() - exact).abs().max().item() / exact
        assert err <= 2e-6


def test_refused_launch_raises(card):
    """A grid the card refuses (65,536 rows of blocks on the f32-FMA route)
    raises with the runtime's message: no other kernel and no plain version
    takes the call."""
    M = 128 * 65536
    a = torch.zeros((M, 1), dtype=torch.float32, device=card)
    b = torch.zeros((1, 1), dtype=torch.float32, device=card)
    assert csplit_mm.route(M, 1, 1) == "f32"
    n = csplit_mm.counts()["launches"]
    with pytest.raises(RuntimeError, match="launch failed"):
        csplit_mm.csplit_matmul(a, a, b, b, b, b)
    assert csplit_mm.counts()["launches"] == n
    with pytest.raises(ValueError, match="route"):  # tc refuses f32 shapes
        csplit_mm.csplit_matmul_tc(a[:8], a[:8], csplit_mm.prepare_b(b, b, b, b))
    torch.cuda.synchronize()


def test_kernel_raises_on_strided_planes(card):
    ar, ai, brh, brl, bih, bil = _planes(64, 64, 64, seed=0, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        csplit_mm.csplit_matmul(ar.t(), ai, brh, brl, bih, bil)


def test_k1_transform_matches_cufft(card):
    nx = 512
    tr = MatmulTransform(nx, np.float32, precision="split", device=card,
                         **K1_OPTS)
    ref = NativeTransform(nx, np.float64)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, nx, nx)) + 1j * rng.standard_normal((3, nx, nx))
    zt = torch.as_tensor(z, device=card)
    n = csplit_mm.counts()["launches"]
    out = tr.fft2(zt.to(torch.complex64))
    assert csplit_mm.counts()["launches"] == n + 6  # 3 fields x 2 passes
    exact = ref.fft2(zt)
    # two passes of bf16-rounded operands (x, x_lo, y_lo), f32 sums
    assert ((out.to(torch.complex128) - exact).abs().max()
            <= 2e-5 * exact.abs().max())


def test_flagship_k1_step_matches_host(card):
    """The K1 configuration at nx=256: the card (tensor-core kernel, bf16
    operands) against the host (f32 plain version), 2 steps. Measured on an
    H100: q 2.1e-7, phi 9.9e-7 of max, Ke equal; the kernel's 7e-6 per
    product is spread over all modes while the max norm is set by a few."""
    def build(device):
        U0 = 0.05
        m = CoupledModel.Model(
            L=2 * np.pi * 200e3, nx=256, dt=157.0, tmax=157.0 * 100,
            m=1.0 / 325, N=0.005, f=1e-4, use_filter=True, nu4=7.5e9,
            nu4w=7.5e9, backend="mxu", dtype=np.float32, precision="split",
            transform_opts=K1_OPTS, device=device)
        k0 = 10 * (2 * np.pi / m.L)
        q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
        m.set_q(q)
        m.set_phi((np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2))
        return m

    g, h = build(None), build("cpu")
    n = csplit_mm.counts()["launches"]
    g.run_steps(2)
    h.run_steps(2)
    assert csplit_mm.counts()["launches"] == n + 80
    for name in ("q", "phi"):
        a, b = getattr(g, name), getattr(h, name)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    assert abs(g.Ke - h.Ke) <= 1e-5 * abs(h.Ke)


# -- the run path: replayed CUDA graphs of the step -----------------------------
def _graph_model(name, nx, k1, **kw):
    """``chip_smoke.flagship`` (the wave models with its packet) or
    ``chip_smoke.qg_flagship`` at ``nx``: f32 in the K1 configuration
    where ``k1``, else on cuFFT."""
    import niwqg_tpu_torch as pkg
    from chip_smoke import flagship, qg_flagship

    opts = (dict(backend="mxu", precision="split", transform_opts=K1_OPTS)
            if k1 else dict(backend="native"))
    if name == "QGModel":
        return qg_flagship(pkg.QGModel, ic, nx=nx, dtype=np.float32, **opts,
                           **kw)
    return flagship(getattr(pkg, name), ic, nx=nx, packet=True,
                    dtype=np.float32, **opts, **kw)


def _same_model(a, b):
    from niwqg_tpu_torch.graphs import _leaves

    assert a.tc == b.tc
    for x, y in zip(_leaves(a.state), _leaves(b.state)):
        assert torch.equal(x, y)
    da, db = a.diagnostics, b.diagnostics
    for k in db:
        np.testing.assert_array_equal(da[k]["value"], db[k]["value"],
                                      err_msg=k)


GRAPH_CASES = ([(n, 64, False) for n in ("CoupledModel", "UnCoupledModel",
                                         "QLModel", "YBJModel", "QGModel")]
               + [(n, 256, True) for n in ("CoupledModel", "UnCoupledModel",
                                           "QLModel", "YBJModel")])


@pytest.mark.parametrize("name,nx,k1", GRAPH_CASES)
def test_graph_run_matches_step_loop(card, name, nx, k1):
    """``run()`` (tdiags=3, twrite=7 over 17 steps: both graphs, chunks
    ending at every status line) and ``run_steps`` replay CUDA graphs and
    equal the eager per-step loop bit for bit: state, every series, sample
    times. At nx=64 on cuFFT, at nx=256 in the K1 configuration."""
    kw = dict(tdiags=3, twrite=7, tmax=17 * 157.0)
    a, b = _graph_model(name, nx, k1, **kw), _graph_model(name, nx, k1, **kw)
    a.run()
    while b.tc < 17:
        b._step_forward()
    assert a._runner.graphs and a._runner.replays == 17 - 2
    assert a._diag_acc.fetches == 3  # chunks ending at 7, 14, 17
    _same_model(a, b)
    a.run_steps(5)
    for _ in range(5):
        b.state = b.kernel.step(b.state)
    _same_model(a, b)


@pytest.mark.parametrize("name", ["CoupledModel", "UnCoupledModel",
                                  "QLModel", "YBJModel"])
def test_k1_launches_per_replayed_step(card, name):
    """K1's counts under replay, which the kernels make on the card: a
    replay of graph A or B launches as many as the eager step of its kind,
    the counts that chip_smoke.py pins (a diagnostics sample of the coupled
    model adds K1_PER_DIAG), all on the tensor-core route; the capture
    counts nothing."""
    from chip_smoke import K1_PER_DIAG, K1_PER_STEP, K1_PER_STEP_FAMILY

    per_step = K1_PER_STEP_FAMILY.get(name, K1_PER_STEP)
    m = _graph_model(name, 256, True, tdiags=1, twrite=1000,
                     tmax=6 * 157.0)

    def launches(fn):
        c0 = csplit_mm.counts()
        fn()
        c1 = csplit_mm.counts()
        d = {k: c1[k] - c0[k] for k in c1}
        assert d["launches"] == d["launches_tc"] and d["cpu_calls"] == 0
        return d["launches"]

    # one eager step, the capture of A, three replays
    assert launches(lambda: m.run_steps(4)) == 4 * per_step
    replays = m._runner.replays
    assert launches(lambda: m.run_steps(1)) == per_step  # a replay of A
    # a sample at step 5 of 6: one eager step and the capture of B
    per_diag = launches(m.run)
    assert launches(lambda: m._runner.advance(1)) == per_diag  # replay of B
    assert m._runner.replays == replays + 2
    if name == "CoupledModel":
        assert per_diag == per_step + K1_PER_DIAG


def test_run_steps_state_survives_later_replays(card):
    """The state ``run_steps`` returns is fresh tensors: later replays,
    which write the static buffers in place, leave it as it was."""
    from niwqg_tpu_torch.graphs import _leaves

    m = _graph_model("CoupledModel", 64, False)
    m.run_steps(3)  # captured
    s = m.run_steps(2)
    kept = [x.clone() for x in _leaves(s)]
    m.run_steps(4)
    torch.cuda.synchronize()
    for x, y in zip(_leaves(s), kept):
        assert torch.equal(x, y)
    static = {x.data_ptr() for x in _leaves(m._runner._static)}
    assert not static & {x.data_ptr() for x in _leaves(m.state)}


# -- K2: the all-to-all transpose ---------------------------------------------
NRANKS = 4


@pytest.fixture
def peers(card):
    ncards = min(NRANKS, torch.cuda.device_count())
    devices = [torch.device("cuda", r % ncards) for r in range(NRANKS)]
    return a2a.PeerGroup.local(devices), devices


def _k2_blocks(shape, dtype, devices, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape),
                            device=d).to(dtype) for d in devices]


@pytest.mark.parametrize("shape,dtype,chunks", [
    ((3, 512, 2048), torch.complex64, 2),    # the sharded flagship's block
    ((2, 256, 512), torch.complex128, 1),
    ((24, 80), torch.complex64, 2),          # no leading fields, W = 20
    ((24, 84), torch.complex64, 2),          # W = 21: the 8-byte path
    ((512, 2048), torch.complex64, 2),       # lead = 1 at the flagship's width
    ((3, 520, 2048), torch.complex64, 2),    # 408 tasks: not a multiple of
                                             # the grid, a short last group
    ((2, 8, 4096), torch.complex128, 1),     # 16 KB segments in 4 pieces
])
def test_a2a_kernel_matches_plain_version(peers, shape, dtype, chunks):
    group, devices = peers
    inv_shape = shape[:-2] + (NRANKS * shape[-2], shape[-1] // NRANKS)
    kind = a2a.path(shape[-1] // NRANKS, chunks, dtype.itemsize)
    for fn, ref, shp in ((a2a.all_to_all_fwd, a2a.all_to_all_fwd_ref, shape),
                         (a2a.all_to_all_inv, a2a.all_to_all_inv_ref,
                          inv_shape)):
        zs = _k2_blocks(shp, dtype, devices, seed=sum(shp))
        n, n_path = fn.launches, getattr(fn, "launches_" + kind)
        got = fn(zs, group, chunks=chunks)
        torch.cuda.synchronize()
        assert fn.launches == n + NRANKS
        assert getattr(fn, "launches_" + kind) == n_path + NRANKS
        want = ref([z.cpu() for z in zs])
        for r in range(NRANKS):
            assert torch.equal(got[r].cpu(), want[r])  # a copy: bit-exact


def test_a2a_flagship_takes_the_aligned_path(peers):
    group, devices = peers
    assert a2a.path(512, 2, 8) == "aligned"
    zs = _k2_blocks((3, 512, 2048), torch.complex64, devices, seed=2)
    fwd = a2a.all_to_all_fwd
    n = (fwd.launches_aligned, fwd.launches_ragged)
    fwd(zs, group, chunks=2)
    torch.cuda.synchronize()
    assert (fwd.launches_aligned, fwd.launches_ragged) == (n[0] + NRANKS, n[1])


@pytest.mark.parametrize("inverse", [0, 1])
def test_a2a_chunks_give_the_same_bits(peers, inverse):
    """chunks = 1, 2 and 4 order the copy differently; the result is the
    same, bit for bit."""
    group, devices = peers
    fn = a2a.all_to_all_inv if inverse else a2a.all_to_all_fwd
    shape = (3, NRANKS * 512, 512) if inverse else (3, 512, NRANKS * 512)
    zs = _k2_blocks(shape, torch.complex64, devices, seed=11)
    got = {}
    for chunks in (1, 2, 4):
        out = fn(zs, group, chunks=chunks)
        torch.cuda.synchronize()
        got[chunks] = [o.cpu() for o in out]
    for chunks in (2, 4):
        assert all(torch.equal(a, b) for a, b in zip(got[1], got[chunks]))


def test_a2a_epochs_back_to_back(peers):
    """Forward then inverse 50 times with no host synchronise between."""
    group, devices = peers
    zs = _k2_blocks((3, 512, 2048), torch.complex64, devices, seed=9)
    first = [z.clone() for z in zs]
    cur = zs
    for _ in range(50):
        cur = a2a.all_to_all_inv(a2a.all_to_all_fwd(cur, group, chunks=2),
                                 group, chunks=2)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(cur, first))


def test_a2a_kernel_raises_on_strided_block(peers):
    group, devices = peers
    zs = _k2_blocks((64, 2 * 64), torch.complex64, devices, seed=1)
    zs[0] = zs[0][:, ::2]
    others = [z[:, :64].contiguous() for z in zs[1:]]
    with pytest.raises(ValueError, match="contiguous"):
        a2a.all_to_all_fwd([zs[0]] + others, group)
