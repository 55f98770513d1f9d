"""Spectral substrate of the PyTorch port against the JAX package: the
transform providers, the ETDRK4 tables, the grid and the spectral helpers.
Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from niwqg_tpu import etdrk4 as jetdrk4  # noqa: E402
from niwqg_tpu.carray import C  # noqa: E402
from niwqg_tpu.grid import Grid as JGrid  # noqa: E402
from niwqg_tpu.ops import fft as jfft  # noqa: E402
from niwqg_tpu.ops import spectral as jspec  # noqa: E402
from niwqg_tpu_torch import etdrk4 as tetdrk4  # noqa: E402
from niwqg_tpu_torch.grid import Grid as TGrid  # noqa: E402
from niwqg_tpu_torch.ops import fft as tfft  # noqa: E402
from niwqg_tpu_torch.ops import spectral as tspec  # noqa: E402

# the slice's K1 configuration of the matmul-DFT
K1_OPTS = dict(formulation="swap", factors=None, half_factors=None)
OPS = ["fft2", "ifft2", "rfft2", "irfft2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and torch's OpenMP threads spin against them when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(shape, seed, complex_=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if complex_ else x


def _run(op, jtr, ttr, nx, dtype, seed):
    """The same input through both providers; returns (port, jax)."""
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    if op in ("fft2", "ifft2"):
        z = _field((2, nx, nx), seed).astype(cdt)
        jout = getattr(jtr, op)(C.from_complex(z, dtype=dtype)).to_complex()
        tout = getattr(ttr, op)(torch.as_tensor(z)).numpy()
    elif op == "rfft2":
        x = _field((2, nx, nx), seed, complex_=False).astype(dtype)
        jout = jtr.rfft2(x).to_complex()
        tout = ttr.rfft2(torch.as_tensor(x)).numpy()
    else:  # irfft2 of a Hermitian half spectrum
        zh = np.fft.rfft2(_field((2, nx, nx), seed, complex_=False)).astype(cdt)
        jout = np.asarray(jtr.irfft2(C.from_complex(zh, dtype=dtype)))
        tout = ttr.irfft2(torch.as_tensor(zh)).numpy()
    return tout, jout


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("op", OPS)
def test_k1_configuration_f32_matches_jax_pallas(op):
    nx = 256
    jtr = jfft.MXUTransform(nx, np.float32, precision="split",
                            use_pallas=True, pallas_interpret=True, **K1_OPTS)
    ttr = tfft.MatmulTransform(nx, np.float32, precision="split",
                               use_pallas=True, pallas_interpret=True,
                               device="cpu", **K1_OPTS)
    assert ttr.use_pallas and ttr.max_batch == 1
    tout, jout = _run(op, jtr, ttr, nx, np.float32, seed=OPS.index(op))
    assert _rel(tout, jout) < 1e-5


@pytest.mark.parametrize("op", OPS)
def test_matmul_f64_matches_jax(op):
    nx = 64
    jtr = jfft.MXUTransform(nx, np.float64, precision="f32", **K1_OPTS)
    ttr = tfft.MatmulTransform(nx, np.float64, precision="f32",
                               device="cpu", **K1_OPTS)
    tout, jout = _run(op, jtr, ttr, nx, np.float64, seed=10 + OPS.index(op))
    assert _rel(tout, jout) < 1e-12


@pytest.mark.parametrize("op", OPS)
def test_native_f64_matches_jax(op):
    nx = 64
    tout, jout = _run(op, jfft.NativeTransform(nx, np.float64),
                      tfft.NativeTransform(nx, np.float64), nx, np.float64,
                      seed=20 + OPS.index(op))
    assert _rel(tout, jout) < 1e-12


@pytest.mark.parametrize("backend", ["native", "mxu"])
def test_real_field_transforms_f64(backend):
    """fft2_real/ifft2_real of both providers against numpy."""
    nx = 32
    tr = tfft.make_transform(nx, np.float64, backend, device="cpu",
                             **K1_OPTS)
    x = _field((nx, nx), 30, complex_=False)
    xh = tr.fft2_real(torch.as_tensor(x)).numpy()
    assert _rel(xh, np.fft.fft2(x)) < 1e-12
    zh = _field((nx, nx), 31)
    y = tr.ifft2_real(torch.as_tensor(zh)).numpy()
    assert _rel(y, np.real(np.fft.ifft2(zh))) < 1e-12


def test_backend_selection():
    assert isinstance(tfft.make_transform(16, np.float64, "auto"),
                      tfft.NativeTransform)
    assert isinstance(tfft.make_transform(16, np.float64, "mxu",
                                          device="cpu", **K1_OPTS),
                      tfft.MatmulTransform)
    with pytest.raises(ValueError):
        tfft.make_transform(16, np.float64, "fftw")


@pytest.mark.parametrize("build", [
    lambda **kw: TGrid(nx=16, L=5e5, **kw),
    lambda **kw: tfft.MatmulTransform(16, np.float64, precision="f32",
                                      **K1_OPTS, **kw),
    lambda **kw: tfft.make_transform(16, np.float64, "mxu", **K1_OPTS, **kw),
], ids=["grid", "matmul_transform", "make_transform"])
def test_device_defaults_to_the_card(build, monkeypatch):
    """Without a device the tables go to the card, and without a card that
    raises; the host is used only when asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    assert build(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("use_filter,dealias", [(True, False), (False, True),
                                                (False, False)])
@pytest.mark.parametrize("spectrum", ["full", "half"])
def test_grid_tables_equal(use_filter, dealias, spectrum):
    kw = dict(nx=48, L=2 * np.pi * 200e3, spectrum=spectrum,
              use_filter=use_filter, dealias=dealias)
    jg, tg = JGrid(**kw), TGrid(**kw, device="cpu")
    for name in ("x", "y", "k", "l", "wv", "wv2", "wv4", "wv2i", "filtr"):
        assert np.array_equal(getattr(tg, name + "_np"),
                              getattr(jg, name + "_np")), name
        assert np.array_equal(getattr(tg, name).numpy(),
                              np.asarray(getattr(jg, name))), name
    zh = _field((tg.nl, tg.nk), 40)
    gh = _field((tg.nl, tg.nk), 41)
    jv = float(jg.spec_var(C.from_complex(zh)))
    assert abs(float(tg.spec_var(torch.as_tensor(zh))) - jv) <= 1e-14 * jv
    jc = float(jg.spec_cross(C.from_complex(zh), C.from_complex(gh)))
    tc = float(tg.spec_cross(torch.as_tensor(zh), torch.as_tensor(gh)))
    assert abs(tc - jc) <= 1e-13 * abs(jc)


@pytest.mark.parametrize("nx,dtype", [(64, np.float64), (96, np.float32)])
def test_etdrk4_tables_bitwise_equal(nx, dtype):
    kw = dict(nx=nx, L=2 * np.pi * 200e3, dtype=np.dtype(dtype))
    jg, tg = JGrid(**kw), TGrid(**kw, device="cpu")
    dt, f, kappa2 = 157.0, 1e-4, (1.0 / 325 * 1e-4 / 0.005) ** 2
    ops = [
        (jetdrk4.linear_operator_q(jg, 0.01, 7.5e9, 0.0, 0.0),
         tetdrk4.linear_operator_q(tg, 0.01, 7.5e9, 0.0, 0.0)),
        (jetdrk4.linear_operator_phi(jg, 0.01, f, kappa2, 7.5e9, 0.0, 0.0),
         tetdrk4.linear_operator_phi(tg, 0.01, f, kappa2, 7.5e9, 0.0, 0.0)),
    ]
    for jc, tc in ops:
        assert np.array_equal(jc, tc)
        jco = jetdrk4.build_coefs(jg, jc, dt)
        tco = tetdrk4.build_coefs(tg, tc, dt)
        for name in jetdrk4.ETDRK4Coefs._fields:
            jt, tt = getattr(jco, name), getattr(tco, name).numpy()
            assert np.array_equal(tt.real, np.asarray(jt.re)), name
            assert np.array_equal(tt.imag, np.asarray(jt.im)), name
    flt = np.random.default_rng(0).random((nx, nx)).astype(dtype)
    jf = jetdrk4.fold_filter_into(jco, flt)
    tf = tetdrk4.fold_filter_into(tco, torch.as_tensor(flt))
    for name in jetdrk4.ETDRK4Coefs._fields:
        assert np.array_equal(getattr(tf, name).numpy(),
                              getattr(jf, name).to_complex()), name


def test_etdrk4_disk_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("NIWQG_TORCH_TABLE_CACHE", str(tmp_path))
    monkeypatch.setattr(tetdrk4, "_TABLE_CACHE_MIN_ELEMS", 1)
    g = TGrid(nx=32, L=5e5, device="cpu")
    c = tetdrk4.linear_operator_q(g, 0.0, 1e9, 20.0, 0.0)
    cold = tetdrk4.build_tables_np(c, 1e4)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    warm = tetdrk4.build_tables_np(c, 1e4)
    for a, b in zip(cold, warm):
        assert np.array_equal(a, b)


SPECTRAL = ["hermitian_project", "hermitian_project_half",
            "expand_half_to_full", "project_full_to_half", "zero_mean_mode"]


@pytest.mark.parametrize("name", SPECTRAL)
def test_spectral_helpers_match_jax(name):
    nx = 16
    half = name in ("hermitian_project_half", "expand_half_to_full")
    z = _field((3, nx, nx // 2 + 1 if half else nx), 50 + SPECTRAL.index(name))
    extra = (nx,) if name == "hermitian_project_half" else ()
    jout = getattr(jspec, name)(C.from_complex(z), *extra).to_complex()
    tout = getattr(tspec, name)(torch.as_tensor(z), *extra).numpy()
    assert np.array_equal(tout, jout)
