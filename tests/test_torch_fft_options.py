"""The matmul-DFT's options in the PyTorch port against the JAX package's
``MXUTransform``: every transform in every real path, formulation,
factorisation and Gauss setting (f64, 1e-12); each precision mode in f32;
the resolution of every ``'auto'``; the option errors; K1's contractions
per transform against JAX's trace (``tests/test_torch_mxu_k1_steps.py``
counts them per model step, ``tests/test_torch_mxu_models.py`` runs the
five models with these options).

Inputs are made with numpy from a seed. At nx=64 the four-step is forced
with small factors, ``factors=(8, 8)`` and ``half_factors=(8, 4)``, as
``tests/test_fft.py`` forces them."""

import functools
import itertools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from niwqg_tpu.carray import C  # noqa: E402
from niwqg_tpu.ops import fft as jfft  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm  # noqa: E402
from niwqg_tpu_torch.ops import fft as tfft  # noqa: E402

from chip_smoke import resolved_options  # noqa: E402
from _torch_common import K1_CONFIGS, K1_NX, record_k1_calls  # noqa: E402
from _torch_common import rel as _rel  # noqa: E402

NX = 64
DENSE = dict(factors=None, half_factors=None)
FOUR = dict(factors=(8, 8), half_factors=(8, 4))
OPS = ["fft2", "ifft2", "rfft2", "irfft2", "fft2_real", "ifft2_real",
       "ifft2_real_pairs"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(op, nx, seed, dtype=np.float64, generic=True):
    """The op's numpy input: complex fields, real fields, a half spectrum
    (``generic``: not Hermitian, else a real field's), a generic full
    spectrum, or three Hermitian spectra."""
    rng = np.random.default_rng(seed)
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    x = rng.standard_normal((2, nx, nx))
    z = x + 1j * rng.standard_normal((2, nx, nx))
    if op in ("rfft2", "fft2_real"):
        return x.astype(dtype)
    if op == "irfft2":
        half = z[..., :nx // 2 + 1] if generic else np.fft.rfft2(x)
        return half.astype(cdt)
    if op == "ifft2_real_pairs":
        return np.fft.fft2(rng.standard_normal((3, nx, nx))).astype(cdt)
    return z.astype(cdt)


def _run(op, jtr, ttr, arr):
    """The same numpy input through both providers: (port, jax)."""
    jin = C.from_complex(arr) if np.iscomplexobj(arr) else arr
    jout = getattr(jtr, op)(jin)
    jout = jout.to_complex() if isinstance(jout, C) else np.asarray(jout)
    return getattr(ttr, op)(torch.as_tensor(arr)).numpy(), jout


@functools.lru_cache(maxsize=None)
def _pair(nx, dtype, items):
    """JAX's transform and the port's for one option set (cached: each
    configuration builds once for all its ops)."""
    kw = dict(items)
    return (jfft.MXUTransform(nx, dtype, **kw),
            tfft.MatmulTransform(nx, dtype, device="cpu", **kw))


# (realpath, formulation, gauss, factorisation); the mirror-free path
# needs a four-step
CONFIGS = [c for c in itertools.product(
    ["dense", "evenodd", "mf"], ["dotgen", "swap"], [False, True],
    ["dense", "four"]) if not (c[0] == "mf" and c[3] == "dense")]


def _cfg_id(c):
    return "-".join([c[0], c[1], "gauss" if c[2] else "nogauss", c[3]])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
def test_transform_matches_jax_f64(cfg, op):
    """Each transform at nx=64 in f64 (a batch of fields, so leading axes
    fold into the products' rows) within 1e-12 of JAX's."""
    realpath, formulation, gauss, steps = cfg
    kw = dict(DENSE if steps == "dense" else FOUR, realpath=realpath,
              formulation=formulation, gauss=gauss, evenodd=True)
    jtr, ttr = _pair(NX, np.float64, tuple(sorted(kw.items())))
    assert (ttr.realpath, ttr.factors, ttr.gauss) == \
        (jtr.realpath, jtr.factors, jtr.gauss) == \
        (realpath, kw["factors"], gauss)
    tout, jout = _run(op, jtr, ttr, _inputs(op, NX, seed=OPS.index(op)))
    assert tout.shape == jout.shape
    assert _rel(tout, jout) <= 1e-12


# JAX's default options with the four-step forced small (dotgen, even/odd
# with half factors, Gauss in f32, max_batch=1 in f32)
DEFAULTS_SMALL = dict(FOUR)


@pytest.mark.parametrize("op", ["fft2", "ifft2", "rfft2", "irfft2"])
@pytest.mark.parametrize("precision", ["split", "split3", "high", "fast"])
def test_precision_modes_f32_match_jax(precision, op, recwarn):
    """Each precision mode in f32 against JAX's f32 run of the same mode.
    Both take the same products of the same split operands and sum them
    in f32 in another order (XLA's dots against PyTorch's), so they agree
    to 1e-5 of the largest output; each is within 2e-5 of the f64 DFT."""
    jtr, ttr = _pair(NX, np.float32,
                     tuple(sorted(dict(DEFAULTS_SMALL,
                                       precision=precision).items())))
    assert ttr.precision == jtr.precision == precision
    assert ttr.gauss and ttr.max_batch == 1 and ttr.realpath == "evenodd"
    arr = _inputs(op, NX, seed=40 + OPS.index(op), dtype=np.float32,
                  generic=False)
    tout, jout = _run(op, jtr, ttr, arr)
    assert tout.dtype == jout.dtype
    assert _rel(tout, jout) <= 1e-5
    a = arr.astype(np.complex128 if np.iscomplexobj(arr) else np.float64)
    exact = {"fft2": np.fft.fft2, "ifft2": np.fft.ifft2,
             "rfft2": np.fft.rfft2,
             "irfft2": lambda v: np.fft.irfft2(v, s=(NX, NX))}[op](a)
    assert _rel(tout, exact) <= 2e-5


# the option sets that raised before the port had them (at nx=2048, where
# factors='auto' is a (128, 16) four-step and half_factors='auto' a
# (128, 8) one); at nx=64 an 'auto' they left is forced to the same shape
FORMER_UNPORTED = {
    "split-dotgen-dense": dict(precision="split", formulation="dotgen",
                               factors=None, half_factors=None),
    "split-swap-fourstep": dict(precision="split", formulation="swap",
                                half_factors=None),
    "high-swap-dense": dict(precision="high", formulation="swap",
                            factors=None, half_factors=None),
    "split3-swap-dense": dict(precision="split3", formulation="swap",
                              factors=None, half_factors=None),
    "split-swap-evenodd": dict(precision="split", formulation="swap",
                               factors=None),
    "split-swap-dense-gauss": dict(precision="split", formulation="swap",
                                   factors=None, half_factors=None,
                                   use_pallas=False),
}


@pytest.mark.parametrize("name", list(FORMER_UNPORTED))
def test_former_unported_option_sets_match_jax(name):
    """Each option set, its 'auto' factors forced small, at nx=64 in f32:
    the four transforms within 1e-5 of JAX's f32 run (as above)."""
    kw = dict(FOUR, **FORMER_UNPORTED[name])
    jtr, ttr = _pair(NX, np.float32, tuple(sorted(kw.items())))
    for attr in ("precision", "formulation", "factors", "gauss",
                 "realpath", "use_pallas"):
        assert getattr(ttr, attr) == getattr(jtr, attr), attr
    for i, op in enumerate(["fft2", "ifft2", "rfft2", "irfft2"]):
        arr = _inputs(op, NX, seed=60 + i, dtype=np.float32)
        assert _rel(*_run(op, jtr, ttr, arr)) <= 1e-5, op


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nx", [64, 2048, 4096])
def test_auto_options_resolve_as_jax(nx, dtype):
    """With no options every 'auto' resolves as JAX's does; in f32 at
    2048 that is JAX's chip configuration: dotgen, a (128, 16) four-step,
    even/odd with (128, 8), Gauss, 'high', max_batch=1; at 4096 the
    mirror-free path."""
    ttr = tfft.MatmulTransform(nx, dtype, device="cpu")
    jtr = jfft.MXUTransform(nx, dtype)
    t = resolved_options(ttr)
    assert t == resolved_options(jtr)
    assert (ttr.evenodd, ttr.nk_half) == (jtr.evenodd, jtr.nk_half)
    if nx == 2048 and dtype == np.float32:
        assert t == dict(precision="high", factors=(128, 16),
                         half_factors=(128, 8), gauss=True,
                         realpath="evenodd", formulation="dotgen",
                         max_batch=1, use_pallas=False)
    if nx == 4096 and dtype == np.float32:
        assert t["realpath"] == "mf"


def test_fast_precision_warns():
    with pytest.warns(UserWarning, match="precision='fast'"):
        jfft.MXUTransform(NX, np.float32, precision="fast")
    with pytest.warns(UserWarning, match="precision='fast'.*TF32 off"):
        tfft.MatmulTransform(NX, np.float32, precision="fast", device="cpu")


@pytest.mark.parametrize("nx,factors", [(64, None), (72, (9, 8)),
                                        (63, (9, 7))])
def test_mirror_free_needs_even_factors(nx, factors):
    """realpath='mf' without an even-factor four-step raises, in both."""
    kw = dict(factors=factors, realpath="mf")
    with pytest.raises(ValueError, match="realpath='mf'"):
        jfft.MXUTransform(nx, np.float64, **kw)
    with pytest.raises(ValueError, match="realpath='mf'"):
        tfft.MatmulTransform(nx, np.float64, device="cpu", **kw)


@pytest.mark.parametrize("precision", ["split", "split3"])
def test_split_precisions_need_float32(precision):
    with pytest.raises(ValueError, match="needs float32"):
        tfft.MatmulTransform(NX, np.float64, precision=precision,
                             device="cpu")


@pytest.fixture
def k1_calls(monkeypatch):
    return record_k1_calls(monkeypatch)


@pytest.mark.parametrize("op", ["fft2", "ifft2", "rfft2", "irfft2"])
@pytest.mark.parametrize("cfg", list(K1_CONFIGS))
def test_k1_calls_per_transform_match_jax_trace(cfg, op, k1_calls):
    """Two fields (max_batch=1: one call each) through one transform: the
    port's K1 calls (``FAMILY.plain_calls()`` on the host) have JAX's
    traced Pallas calls' count and shapes, and the output JAX's (1e-5)."""
    jax_calls, port_calls = k1_calls
    kw = dict(K1_CONFIGS[cfg], precision="split", use_pallas=True)
    jtr = jfft.MXUTransform(K1_NX, np.float32, pallas_interpret=True, **kw)
    ttr = tfft.MatmulTransform(K1_NX, np.float32, device="cpu", **kw)
    assert ttr.use_pallas and not ttr.gauss
    arr = _inputs(op, K1_NX, seed=80, dtype=np.float32, generic=False)
    jin = C.from_complex(arr) if np.iscomplexobj(arr) else arr
    jax.make_jaxpr(getattr(jtr, op))(jin)
    calls0 = csplit_mm.FAMILY.plain_calls()
    tout = getattr(ttr, op)(torch.as_tensor(arr)).numpy()
    assert csplit_mm.FAMILY.plain_calls() - calls0 == len(port_calls)
    assert Counter(port_calls) == Counter(jax_calls)
    n = K1_NX
    if op in ("fft2", "ifft2"):   # the x-pass (swap: both passes) dense
        want = {(n, n): 2 * (2 if cfg.startswith("swap") else 1)}
    elif cfg == "dotgen-dense":   # the dense real path: XLA's dots only
        want = {}
    else:                         # the half-length DFT of the even/odd path
        want = {(n, n // 2): 2}
    assert Counter(port_calls) == want
    ref = {"fft2": np.fft.fft2, "ifft2": np.fft.ifft2, "rfft2": np.fft.rfft2,
           "irfft2": lambda v: np.fft.irfft2(v, s=(n, n))}[op](
        arr.astype(np.complex128 if np.iscomplexobj(arr) else np.float64))
    assert _rel(tout, ref) <= 1e-5
