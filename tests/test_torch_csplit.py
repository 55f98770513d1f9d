"""K1 of the PyTorch port — the complex-split matmul — against the JAX
package's Pallas kernel (interpret mode) and a complex128 product.

On the host the port's wrapper runs its plain version; the CUDA kernel
itself is held against the same plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from niwqg_tpu.ops import pallas_mm  # noqa: E402
from niwqg_tpu.ops.fft import _mask_split as jax_mask_split  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402

# f32 products summed in another order than the TPU kernel's tiles
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and torch's OpenMP threads spin against them when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    ar = rng.standard_normal((M, K)).astype(np.float32)
    ai = rng.standard_normal((M, K)).astype(np.float32)
    br = rng.standard_normal((K, N)).astype(np.float32)
    bi = rng.standard_normal((K, N)).astype(np.float32)
    return ar, ai, br, bi


def _split_np(x):
    hi, lo = csplit_mm.mask_split(torch.as_tensor(x))
    return hi.numpy(), lo.numpy()


@pytest.mark.parametrize("shape", [(256, 512, 256), (512, 256, 512)])
def test_ref_matches_jax_kernel_and_complex128(shape):
    M, K, N = shape
    ar, ai, br, bi = _inputs(M, K, N, seed=M + K + N)
    brh, brl = _split_np(br)
    bih, bil = _split_np(bi)
    planes = (ar, ai, brh, brl, bih, bil)

    re, im = csplit_mm.csplit_matmul_ref(*[torch.as_tensor(p) for p in planes])
    jre, jim = pallas_mm.csplit_matmul(*planes, interpret=True)
    out = re.numpy() + 1j * im.numpy()
    jout = np.asarray(jre) + 1j * np.asarray(jim)
    exact = ((ar.astype(np.float64) + 1j * ai)
             @ (br.astype(np.float64) + 1j * bi))
    scale = np.abs(exact).max()
    assert np.abs(out - jout).max() <= RTOL * scale
    assert np.abs(out - exact).max() <= RTOL * scale


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_split_bitwise_equal_to_jax(seed):
    x = np.random.default_rng(seed).standard_normal((64, 96)).astype(
        np.float32) * 10.0 ** seed
    hi, lo = csplit_mm.mask_split(torch.as_tensor(x))
    jhi, jlo = jax_mask_split(x)
    assert np.array_equal(hi.numpy().view(np.uint32),
                          np.asarray(jhi).view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32),
                          np.asarray(jlo).view(np.uint32))
    # hi is exactly representable in bf16
    assert torch.equal(hi, hi.to(torch.bfloat16).to(torch.float32))


def test_wrapper_takes_plain_version_on_host():
    ar, ai, br, bi = _inputs(40, 24, 16, seed=3)
    brh, brl = _split_np(br)
    bih, bil = _split_np(bi)
    args = [torch.as_tensor(p) for p in (ar, ai, brh, brl, bih, bil)]
    c0 = csplit_mm.counts()
    re, im = csplit_mm.csplit_matmul(*args)
    rre, rim = csplit_mm.csplit_matmul_ref(*args)
    assert torch.equal(re, rre) and torch.equal(im, rim)
    c1 = csplit_mm.counts()
    assert c1["launches"] == c0["launches"]
    assert c1["cpu_calls"] == c0["cpu_calls"] + 1


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((8, 4))
    b = torch.zeros((4, 6))
    with pytest.raises(TypeError):
        csplit_mm.csplit_matmul(a.double(), a, b, b, b, b)
    with pytest.raises(ValueError):
        csplit_mm.csplit_matmul(a, a, b, b, b, torch.zeros((4, 5)))
    with pytest.raises(ValueError):
        csplit_mm.csplit_matmul(a, torch.zeros((8, 5)), b, b, b, b)
    m = torch.zeros((8, 4), device="meta")
    mb = torch.zeros((4, 6), device="meta")
    with pytest.raises(ValueError):
        csplit_mm.csplit_matmul(m, m, mb, mb, mb, mb)


# -- the tensor-core route's model, checked where it can be -------------------
BF16_RTOL = 2e-5  # bf16 rounding of x, x_lo, y_lo: 2^-17..2^-16 per term


def _dft_planes(n):
    a = np.arange(n)
    F = np.exp(-2j * np.pi * np.outer(a, a) / n)
    return F.real.astype(np.float32), F.imag.astype(np.float32)


@pytest.mark.parametrize("b_kind", ["normal", "dft"])
def test_bf16_plain_version_models_the_rounding(b_kind):
    """``csplit_matmul_ref_bf16`` against ``csplit_matmul_ref`` and a
    float64 product at (256, 256, 256): the error of bf16 operands with f32
    sums, 2e-5 of the largest output."""
    ar, ai, br, bi = _inputs(256, 256, 256, seed=11)
    if b_kind == "dft":
        br, bi = _dft_planes(256)
    args = [torch.as_tensor(p) for p in
            (ar, ai) + _split_np(br) + _split_np(bi)]
    re, im = csplit_mm.csplit_matmul_ref_bf16(*args)
    fre, fim = csplit_mm.csplit_matmul_ref(*args)
    exact = ((ar.astype(np.float64) + 1j * ai)
             @ (br.astype(np.float64) + 1j * bi))
    scale = np.abs(exact).max()
    out = re.numpy() + 1j * im.numpy()
    err_exact = np.abs(out - exact).max()
    err_f32 = np.abs(out - (fre.numpy() + 1j * fim.numpy())).max()
    assert err_exact <= BF16_RTOL * scale
    assert err_f32 <= BF16_RTOL * scale
    # and it does round: the bf16 model is not the f32 version
    assert err_f32 > 1e-7 * scale


def test_prepare_b_round_trips():
    br, bi = _dft_planes(256)
    brh, brl = _split_np(br)
    bih, bil = _split_np(bi)
    planes = [torch.as_tensor(p) for p in (brh, brl, bih, bil)]
    b = csplit_mm.prepare_b(*planes)
    assert b.shape == (256, 256)
    assert b.bf16.shape == (4, 256, 256) and b.bf16.dtype == torch.bfloat16
    assert b.bf16.is_contiguous()
    back = b.bf16.to(torch.float32)
    for i in (0, 2):  # hi planes: bit-exact
        assert torch.equal(back[i], planes[i])
    for i in (1, 3):  # lo planes: one bf16 rounding, half an ulp of 8 bits
        assert torch.all((back[i] - planes[i]).abs()
                         <= 2.0 ** -8 * planes[i].abs())
        assert not torch.equal(back[i], planes[i])
    assert all(p is q for p, q in zip(b.planes, planes))


def test_prepare_b_rejects_mismatched_planes():
    b = torch.zeros((4, 6))
    with pytest.raises(ValueError):
        csplit_mm.prepare_b(b, b, b, torch.zeros((4, 5)))
    with pytest.raises(TypeError):
        csplit_mm.prepare_b(b, b.double(), b, b)


@pytest.mark.parametrize("shape", [(16, 256, 256), (40, 24, 16)])
def test_prepared_call_equals_six_plane_call_on_host(shape):
    M, K, N = shape
    ar, ai, br, bi = _inputs(M, K, N, seed=5)
    planes = [torch.as_tensor(p) for p in _split_np(br) + _split_np(bi)]
    a = [torch.as_tensor(ar), torch.as_tensor(ai)]
    calls = csplit_mm.FAMILY.plain_calls()
    re, im = csplit_mm.csplit_matmul(*a, *planes)
    pre, pim = csplit_mm.csplit_matmul_prepared(
        *a, csplit_mm.prepare_b(*planes))
    assert torch.equal(re, pre) and torch.equal(im, pim)
    assert csplit_mm.FAMILY.plain_calls() == calls + 2
    with pytest.raises(ValueError):  # A's K against the prepared planes' K
        csplit_mm.csplit_matmul_prepared(
            torch.zeros((M, K + 1)), torch.zeros((M, K + 1)),
            csplit_mm.prepare_b(*planes))


@pytest.mark.parametrize("shape,want", [
    ((2048, 2048, 2048), "tc"),   # the main path
    ((520, 384, 264), "tc"),      # ragged tile edges
    ((8, 256, 256), "tc"),        # the eligibility rule's smallest
    ((1, 1, 1), "f32"),
    ((130, 17, 65), "f32"),
    ((1025, 2048, 2048), "f32"),  # rows % 8 != 0
    ((64, 256, 260), "f32"),      # N % 8 != 0: rows cannot be 16-byte aligned
    ((64, 260, 256), "f32"),      # K % 8 != 0
    ((64, 248, 256), "f32"),      # K < 256
])
def test_route_is_a_function_of_the_shape(shape, want):
    M, K, N = shape
    assert csplit_mm.route(M, N, K) == want


def test_route_functions_refuse_host_planes():
    ar, ai, br, bi = _inputs(8, 256, 256, seed=2)
    planes = [torch.as_tensor(p) for p in _split_np(br) + _split_np(bi)]
    a = [torch.as_tensor(ar), torch.as_tensor(ai)]
    with pytest.raises(ValueError, match="CUDA"):
        csplit_mm.csplit_matmul_f32(*a, *planes)
    with pytest.raises(ValueError, match="CUDA"):
        csplit_mm.csplit_matmul_tc(*a, csplit_mm.prepare_b(*planes))


def test_transform_prepares_its_constants_once():
    """The K1 configuration converts its DFT's _F and _G when it is built
    and hands the prepared planes to the wrapper; the plain configuration
    prepares nothing."""
    from niwqg_tpu_torch.ops.fft import MatmulTransform

    opts = dict(formulation="swap", factors=None, half_factors=None)
    tr = MatmulTransform(256, np.float32, precision="split", device="cpu",
                         use_pallas=True, **opts)
    F, G = tr._cdft._F, tr._cdft._G
    assert set(tr._prepared) == {id(F), id(G)}
    b = tr._prepared[id(F)]
    assert b.planes == F[0] + F[1]
    plain = MatmulTransform(256, np.float32, precision="split", device="cpu",
                            use_pallas=False, gauss=False, **opts)
    assert plain._prepared == {}
    z = np.random.default_rng(4).standard_normal((2, 256, 256)).astype(
        np.float32)
    zt = torch.complex(torch.as_tensor(z), torch.as_tensor(z[::-1].copy()))
    calls = csplit_mm.FAMILY.plain_calls()
    out = tr.fft2(zt)
    assert csplit_mm.FAMILY.plain_calls() == calls + 4  # 2 fields x 2
    want = plain.fft2(zt)
    assert (out - want).abs().max() <= 1e-5 * want.abs().max()
