"""Card-only tests of the PyTorch port: the CUDA kernel against its plain
version, and the K1 configuration on the card against the host.

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


@pytest.mark.parametrize("shape", [(2048, 2048, 2048), (520, 384, 264),
                                   (8, 256, 256), (1, 1, 1), (130, 17, 65)])
def test_kernel_matches_plain_version(card, shape):
    args = _planes(*shape, seed=sum(shape), device=card)
    n = csplit_mm.csplit_matmul.launches
    re, im = csplit_mm.csplit_matmul(*args)
    torch.cuda.synchronize()
    assert csplit_mm.csplit_matmul.launches == n + 1
    rre, rim = csplit_mm.csplit_matmul_ref(*args)
    scale = max(rre.abs().max().item(), rim.abs().max().item())
    err = max((re - rre).abs().max().item(), (im - rim).abs().max().item())
    assert err <= 1e-5 * scale  # f32 sums in another order


def test_kernel_sums_same_sign_terms_two_level(card):
    """Column 0 of a constant A times the DFT matrix sums K equal terms
    (the mean mode of a near-uniform field). One running f32 sum over
    K=2048 is off by 8.6e-6 here, the kernel's two-level sum by 8.4e-7
    (the kernel's order of summation emulated in numpy)."""
    K = 2048
    c = np.float32(5 * 0.05 / np.sqrt(2))
    a = torch.full((64, K), float(c), dtype=torch.float32, device=card)
    idx = np.arange(K)
    F = np.exp(-2j * np.pi * np.outer(idx, idx) / K)
    br = torch.as_tensor(F.real.astype(np.float32), device=card)
    bi = torch.as_tensor(F.imag.astype(np.float32), device=card)
    re, im = csplit_mm.csplit_matmul(a, a, *csplit_mm.mask_split(br),
                                     *csplit_mm.mask_split(bi))
    exact = K * float(c)
    for plane in (re, im):
        err = (plane[:, 0].double() - exact).abs().max().item() / exact
        assert err <= 2e-6


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
    n = csplit_mm.csplit_matmul.launches
    out = tr.fft2(zt.to(torch.complex64))
    assert csplit_mm.csplit_matmul.launches == n + 6  # 3 fields x 2 passes
    exact = ref.fft2(zt)
    assert ((out.to(torch.complex128) - exact).abs().max()
            <= 1e-5 * exact.abs().max())


def test_flagship_k1_step_matches_host(card):
    """The K1 configuration at nx=256: the card (kernel) against the host
    (plain version), 2 steps."""
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
    n = csplit_mm.csplit_matmul.launches
    g.run_steps(2)
    h.run_steps(2)
    assert csplit_mm.csplit_matmul.launches == n + 80
    for name in ("q", "phi"):
        a, b = getattr(g, name), getattr(h, name)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    assert abs(g.Ke - h.Ke) <= 1e-5 * abs(h.Ke)
