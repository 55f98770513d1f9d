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
    launches, calls = (csplit_mm.csplit_matmul.launches,
                       csplit_mm.csplit_matmul.cpu_calls)
    re, im = csplit_mm.csplit_matmul(*args)
    rre, rim = csplit_mm.csplit_matmul_ref(*args)
    assert torch.equal(re, rre) and torch.equal(im, rim)
    assert csplit_mm.csplit_matmul.launches == launches
    assert csplit_mm.csplit_matmul.cpu_calls == calls + 1


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
