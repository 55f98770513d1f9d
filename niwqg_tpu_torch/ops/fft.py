"""2-D Fourier transform providers (port of ``niwqg_tpu/ops/fft.py``).

Both providers take and return complex tensors with arbitrary leading
batch axes ``(..., ny, nx)``; real fields are real tensors.

``NativeTransform``
    ``torch.fft`` (cuFFT on the card, pocketfft on the host).

``MatmulTransform``
    The counterpart of the JAX package's ``MXUTransform``, selected by
    ``backend="mxu"`` so that one set of keyword arguments builds both:
    the DFT evaluated as dense matrix products ``Zh = F @ Z @ F`` with the
    symmetric DFT matrix ``F[a,b] = exp(-2*pi*i*a*b/n)``. On the card its
    complex contractions go through the hand-written K1 kernel
    (:mod:`.csplit_mm`) under exactly the JAX package's eligibility rule.
    Ported options: ``precision`` ``'split'`` (f32, masked hi/lo operands,
    three products per real product) and ``'f32'`` (one plain product, the
    f64 path); ``formulation='swap'``; dense ``factors=None``; the dense
    real path (``realpath='dense'``: ``_Rf``/``_Ri`` tables); ``max_batch``.
    Every other option raises ``NotImplementedError``: see ROADMAP.md,
    queue 1, "matmul-DFT options".
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import complex_dtype, resolve_device
from .csplit_mm import csplit_matmul_prepared, mask_split, prepare_b
from .spectral import expand_half_to_full, project_full_to_half

_TODO = "not ported yet (ROADMAP.md, queue 1, 'matmul-DFT options')"


# ----------------------------------------------------------------------
# native (torch.fft) provider
# ----------------------------------------------------------------------
class NativeTransform:
    """torch.fft-backed transforms."""

    def __init__(self, nx: int, dtype=np.float64):
        self.nx = nx
        self._cdtype = complex_dtype(dtype)

    def fft2(self, z):
        return torch.fft.fft2(z)

    def ifft2(self, zh):
        return torch.fft.ifft2(zh)

    def fft2_real(self, x):
        """Full-spectrum transform of a real field."""
        return torch.fft.fft2(x.to(self._cdtype))

    def ifft2_real(self, zh):
        """Real part of the inverse transform."""
        return torch.fft.ifft2(zh).real

    def rfft2(self, x):
        return torch.fft.rfft2(x)

    def irfft2(self, zh):
        return torch.fft.irfft2(zh, s=(zh.shape[-2], self.nx))

    def ifft2_real_pairs(self, zh):
        """Pair-packed real inverses of a stack of full-spectrum Hermitian
        transforms ``(nf, ny, nx)`` -> ``(nf, ny, nx)`` real fields: two
        spectra ride one complex inverse."""
        return _pairs_via_ifft2(self, zh)


def _pairs_via_ifft2(tr, zh):
    """Shared pair-packing routine: ``ifft2(A + iB) = a + i b`` for real
    fields a, b whose full spectra A, B are Hermitian.

    Contract: the caller has projected anti-Hermitian residue out of each
    spectrum first. The imaginary plane of each packed inverse is the
    partner field, so any residual ``Im(ifft2(A))`` becomes additive noise
    on ``b`` where a ``real(ifft(.))`` read would discard it. In this
    solver all q-side spectra are Hermitian to rounding except the two
    self-mirror columns ``k = 0, nx/2`` (mean-flow advection phase), which
    ``spectral.hermitian_project_half`` fixes in O(ny) per field.

    All pairs go through one batched ``tr.ifft2`` call, so on the pencil
    provider the whole group rides one all-to-all transpose."""
    nf = zh.shape[0]
    npairs = nf // 2
    outs = []
    if npairs:
        a, b = zh[0:2 * npairs:2], zh[1:2 * npairs:2]
        # A + iB on the planes
        z = tr.ifft2(torch.complex(a.real - b.imag, a.imag + b.real))
        # (a_j, b_j) = (re_j, im_j), back in field order
        outs.append(torch.stack([z.real, z.imag], dim=1).reshape(
            (2 * npairs,) + tuple(z.shape[1:])))
    if nf % 2:
        outs.append(tr.ifft2_real(zh[-1:]))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ----------------------------------------------------------------------
# matmul-DFT provider
# ----------------------------------------------------------------------
def _mm_split(a, b):
    """Contraction of the last axis of ``a`` at ~16-mantissa-bit accuracy
    via 3 products; ``b`` is pre-split ``(b_hi, b_lo)``. The ``a . b_lo``
    term uses the full ``a`` so the lo*lo cross term rides along."""
    b_hi, b_lo = b
    a_hi, a_lo = mask_split(a)
    return a @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _mm_plain(a, b):
    return a @ b[0]


def _auto_factors(nx: int, min_n: int = 1024):
    """The JAX package's four-step choice: (n1, n2) or None for dense."""
    if nx < min_n or (nx & (nx - 1)) != 0:
        return None
    return (128, nx // 128)


class MatmulTransform:
    """DFT-as-matmul transforms (counterpart of ``MXUTransform``).

    2-D transforms apply a dense 1-D pass along each axis; the pass along
    y transposes, contracts the last axis and transposes back (the
    ``'swap'`` formulation). Complex algebra is spelled out on the real
    and imaginary planes."""

    def __init__(self, nx: int, dtype=np.float32, precision: str = "auto",
                 factors="auto", half_factors="auto", evenodd="auto",
                 gauss="auto", formulation: str = "dotgen",
                 max_batch="auto", realpath: str = "auto",
                 use_pallas: bool = False, pallas_interpret: bool = False,
                 device=None):
        self.nx = nx
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        f32 = self.dtype == np.float32
        if formulation != "swap":
            raise NotImplementedError(f"formulation={formulation!r} {_TODO}")
        if precision == "auto":
            precision = "high" if f32 else "f32"
        if precision not in ("split", "f32"):
            raise NotImplementedError(f"precision={precision!r} {_TODO}")
        if precision == "split" and not f32:
            raise ValueError("precision='split' needs float32")
        self.precision = precision
        self._mm = _mm_split if precision == "split" else _mm_plain
        self.factors = _auto_factors(nx) if factors == "auto" else factors
        if self.factors is not None:
            raise NotImplementedError(
                f"four-step factors={self.factors} {_TODO}; pass factors=None")
        # the K1 kernel: 'split' precision in f32 only, as in JAX
        self.use_pallas = bool(use_pallas) and precision == "split" and f32
        if gauss == "auto":
            gauss = f32
        if bool(gauss) and not self.use_pallas:
            raise NotImplementedError(f"gauss=True {_TODO}")
        # pallas_interpret is accepted so that one set of options builds
        # both providers; the card kernel has no interpret mode (tensors on
        # the host take its plain version)
        del pallas_interpret
        if max_batch == "auto":
            max_batch = 1 if f32 else 0
        self.max_batch = int(max_batch)

        if half_factors == "auto":
            half_factors = (_auto_factors(nx // 2, min_n=1024)
                            if nx % 2 == 0 else None)
        if evenodd == "auto":
            evenodd = nx % 2 == 0 and half_factors is not None
        if realpath == "auto":
            realpath = "evenodd" if (bool(evenodd) and nx % 2 == 0) \
                else "dense"
        if realpath == "evenodd" and nx % 2:
            realpath = "dense"
        if realpath != "dense":
            raise NotImplementedError(
                f"realpath={realpath!r} {_TODO}; pass half_factors=None")

        a = np.arange(nx)
        F = np.exp(-2j * np.pi * np.outer(a, a) / nx)
        G = np.conj(F) / nx  # inverse, 1/n folded
        self._F = (self._const(F.real), self._const(F.imag))
        self._G = (self._const(G.real), self._const(G.imag))
        # K1 takes the constant planes converted once (bf16 for its
        # tensor-core route), keyed by the table they came from
        self._prepared = {}
        if self.use_pallas:
            for M in (self._F, self._G):
                self._prepared[id(M)] = prepare_b(*M[0], *M[1])
        # dense half-spectrum matrices: forward keeps nk = nx//2+1 columns;
        # the inverse folds the Hermitian weights w = [1, 2, ..., 2, 1]
        nk = nx // 2 + 1
        Fh = F[:, :nk]
        self._Rf = (self._const(Fh.real), self._const(Fh.imag))
        m = np.arange(nk)
        w = np.full(nk, 2.0)
        w[0] = 1.0
        if nx % 2 == 0:
            w[-1] = 1.0
        ang = 2.0 * np.pi * np.outer(m, a) / nx
        self._Ri = (self._const((w[:, None] * np.cos(ang)) / nx),
                    self._const((-w[:, None] * np.sin(ang)) / nx))

    def _const(self, m: np.ndarray):
        t = torch.as_tensor(m.astype(self.dtype), device=self.device)
        return mask_split(t) if self.precision == "split" else (t,)

    # -- core complex contraction of the last axis --------------------------
    def _cdot(self, zr, zi, M):
        """``(zr + i*zi) @ M`` for a complex constant ``M`` = (re, im), each
        in :meth:`_const` form; contracts the last axis."""
        Mr, Mi = M
        prepared = self._prepared.get(id(M))
        if prepared is not None:
            out = self._kernel_or_none(zr, zi, prepared)
            if out is not None:
                return out
        mm = self._mm
        return mm(zr, Mr) - mm(zi, Mi), mm(zr, Mi) + mm(zi, Mr)

    def _kernel_or_none(self, zr, zi, prepared):
        """K1 for the shapes the JAX package sends to its Pallas kernel
        (``ops/fft.py:_pallas_or_none``): K >= 256, N >= 256, rows % 8 == 0."""
        lead = zr.shape[:-1]
        K = zr.shape[-1]
        N = prepared.shape[1]
        rows = int(np.prod(lead)) if lead else 1
        if K >= 256 and N >= 256 and rows % 8 == 0:
            re, im = csplit_matmul_prepared(zr.reshape(rows, K).contiguous(),
                                            zi.reshape(rows, K).contiguous(),
                                            prepared)
            return re.reshape(lead + (N,)), im.reshape(lead + (N,))
        return None

    def _along(self, zr, zi, inverse: bool, axis: int):
        """Dense 1-D DFT along ``axis`` (-1 or -2) of the planes."""
        M = self._G if inverse else self._F
        if axis == -1:
            return self._cdot(zr, zi, M)
        re, im = self._cdot(zr.transpose(-1, -2), zi.transpose(-1, -2), M)
        return re.transpose(-1, -2), im.transpose(-1, -2)

    # -- batch splitting (``max_batch``) -------------------------------------
    def _batched(self, fn, x):
        mb = self.max_batch
        if not mb or x.dim() < 3 or x.shape[0] <= mb:
            return fn(x)
        return torch.cat([fn(x[i:i + mb]) for i in range(0, x.shape[0], mb)])

    # -- public API ----------------------------------------------------------
    def fft2(self, z):
        return self._batched(self._fft2_one, z)

    def _fft2_one(self, z):
        re, im = self._along(z.real, z.imag, False, -1)
        return torch.complex(*self._along(re, im, False, -2))

    def ifft2(self, zh):
        return self._batched(self._ifft2_one, zh)

    def _ifft2_one(self, zh):
        re, im = self._along(zh.real, zh.imag, True, -1)
        return torch.complex(*self._along(re, im, True, -2))

    def fft2_real(self, x):
        """Full-spectrum transform of a real field, via ``rfft2`` and the
        exact Hermitian expansion (odd ``nx``: the complex path)."""
        if self.nx % 2:
            return self.fft2(torch.complex(x, torch.zeros_like(x)))
        return expand_half_to_full(self.rfft2(x))

    def ifft2_real(self, zh):
        """``real(ifft2(zh))`` via Hermitian projection and ``irfft2``."""
        if self.nx % 2:
            return self.ifft2(zh).real
        return self.irfft2(project_full_to_half(zh))

    def rfft2(self, x):
        return self._batched(self._rfft2_one, x)

    def _rfft2_one(self, x):
        # real DFT along x keeping nk columns, then the complex DFT along y
        re = self._mm(x, self._Rf[0])
        im = self._mm(x, self._Rf[1])
        return torch.complex(*self._along(re, im, False, -2))

    def irfft2(self, zh):
        return self._batched(self._irfft2_one, zh)

    def _irfft2_one(self, zh):
        re, im = self._along(zh.real, zh.imag, True, -2)
        return self._mm(re, self._Ri[0]) + self._mm(im, self._Ri[1])


def make_transform(nx: int, dtype, backend: str = "auto",
                   precision: str = "auto", device=None, **mxu_opts):
    """Pick a transform provider: ``'auto'`` and ``'native'`` give
    ``torch.fft`` (the JAX package's choice on CPU and GPU platforms),
    ``'mxu'`` the matmul-DFT on ``device`` (the card unless ``"cpu"``).
    ``mxu_opts`` pass through to :class:`MatmulTransform` and are ignored
    by the native provider, which follows its input tensors."""
    if backend in ("auto", "native"):
        return NativeTransform(nx, dtype)
    if backend == "mxu":
        return MatmulTransform(nx, dtype, precision=precision, device=device,
                               **mxu_opts)
    raise ValueError(f"unknown transform backend {backend!r}")
