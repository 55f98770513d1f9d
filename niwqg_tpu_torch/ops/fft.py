"""2-D Fourier transform providers (port of ``niwqg_tpu/ops/fft.py``).

Both providers take and return complex tensors with arbitrary leading
batch axes ``(..., ny, nx)``; real fields are real tensors.

``NativeTransform``
    ``torch.fft`` (cuFFT on the card, pocketfft on the host).

``MatmulTransform``
    The counterpart of the JAX package's ``MXUTransform``, selected by
    ``backend="mxu"`` so that one set of keyword arguments builds both,
    with every option of it and the same resolution of each ``'auto'``:
    the DFT evaluated as matrix products on the real and imaginary planes,
    each 1-D pass (:class:`_CDFT`) either dense (``Zh = Z @ F`` with the
    symmetric DFT matrix ``F[a,b] = exp(-2*pi*i*a*b/n)``) or by the
    four-step (Bailey) factorisation ``n = n1*n2``.

    ``precision``
        ``'split'`` (masked hi/lo operands, three products per real
        product), ``'split3'`` (three-way split, six products), ``'high'``
        and ``'fast'`` (one product; on the card a full-float32 GEMM with
        TF32 off), ``'f32'`` (one product, the f64 path).
    ``formulation``
        ``'dotgen'`` contracts each pass's axis where it lies (one index
        transpose per four-step pass); ``'swap'`` transposes the axis last
        before every product.
    ``gauss``
        three real products per complex product instead of four.
    ``realpath``
        the real transforms: ``'dense'`` (dedicated half-spectrum
        tables), ``'evenodd'`` (one half-length complex DFT and an exact
        butterfly) or ``'mf'`` (mirror-free: the Hermitian mirror folded
        into half-range four-step tables).

    On the card the complex contractions that the JAX package sends to its
    Pallas kernel go through the hand-written K1 kernel (:mod:`.csplit_mm`),
    under exactly its eligibility rule (``_kernel_or_none``); every other
    product is a ``torch.matmul``, as JAX leaves it to XLA's dots.

Inside, a complex value is a pair of real planes ``(re, im)``. Where JAX
appends a contracted axis minor-most, the port leaves the result in the
contracted axis's place (``_prod``), which PyTorch does without a copy;
each pass's layout and twiddle tables follow from that, and every public
output is in canonical index order.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..device import complex_dtype, resolve_device
from ..utils.profiling import span
from .csplit_mm import csplit_matmul_prepared, mask_split, prepare_b
from .spectral import expand_half_to_full, project_full_to_half


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
def _cmap(f, z):
    """Apply a shape/layout function to both planes of a pair."""
    return f(z[0]), f(z[1])


def _cmul(a, b):
    """Complex product of two plane pairs (JAX's ``C.__mul__``)."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _swap(z):
    return _cmap(lambda x: x.transpose(-1, -2), z)


def _prod(a, b, dim: int):
    """Contract axis ``dim`` of ``a`` with axis 0 of the 2-D ``b``; the
    result axis takes ``dim``'s place (JAX's ``_dot`` appends it
    minor-most). An interior axis is contracted as ``b.T @ a`` over the
    axes after it, flattened: no transpose of ``a``."""
    d = dim % a.dim()
    if d == a.dim() - 1:
        return a @ b
    lead, rest = a.shape[:d], a.shape[d + 1:]
    out = b.mT @ a.reshape(lead + (a.shape[d], math.prod(rest)))
    return out.reshape(lead + (b.shape[1],) + rest)


def _mask_split3(a):
    """3-way masked split (top 16 / next 16 / rest) for 6-pass products."""
    hi, rest = mask_split(a)
    mid, lo = mask_split(rest)
    return hi, mid, lo


def _mm_split(a, b, dim):
    """Contraction at ~16-mantissa-bit accuracy via 3 products; ``b`` is
    pre-split ``(b_hi, b_lo)``. The ``a . b_lo`` term uses the full ``a``
    so the lo*lo cross term rides along."""
    b_hi, b_lo = b
    a_hi, a_lo = mask_split(a)
    return (_prod(a, b_lo, dim) + _prod(a_lo, b_hi, dim)
            + _prod(a_hi, b_hi, dim))


def _mm_split3(a, b, dim):
    """Contraction via 6 products of 3-way splits (~f32 on the TPU)."""
    b_hi, b_mid, b_lo = b
    a_hi, a_mid, a_lo = _mask_split3(a)
    return (_prod(a_hi, b_hi, dim)
            + (_prod(a_hi, b_mid, dim) + _prod(a_mid, b_hi, dim))
            + (_prod(a, b_lo, dim) + _prod(a_mid, b_mid, dim)
               + _prod(a_lo, b_hi, dim)))


def _mm_plain(a, b, dim):
    """One product in the operands' precision ('f32' and 'fast')."""
    return _prod(a, b[0], dim)


def _mm_high(a, b, dim):
    """JAX's ``'high'``: one product that reads each operand once. On the
    TPU that is the matrix unit's multi-pass bf16 (~1.4e-5); on the card
    the one operation of that grade or better is a full-float32 GEMM, so
    TF32 (~1e-3) must be off, as ``device.resolve_device`` leaves it."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("precision='high' needs full-float32 products; "
                           "TF32 is on (device.full_fp32_matmul turns it "
                           "off)")
    return _prod(a, b[0], dim)


_MM = {"split": _mm_split, "split3": _mm_split3, "fast": _mm_plain,
       "f32": _mm_plain, "high": _mm_high}


def _auto_factors(nx: int, min_n: int = 1024):
    """The JAX package's four-step choice: (n1, n2) or None for dense."""
    if nx < min_n or (nx & (nx - 1)) != 0:
        return None
    return (128, nx // 128)


class _CDFT:
    """1-D complex DFT of one length ``n``, dense or four-step over
    ``factors = (n1, n2)``; ``owner`` supplies the precision-split tables
    and the complex contraction (``_cdot``)."""

    def __init__(self, owner: "MatmulTransform", n: int, factors):
        self.owner = owner
        self.n = n
        self.factors = factors
        a = np.arange(n)
        if factors is None:
            F = np.exp(-2j * np.pi * np.outer(a, a) / n)
            G = np.conj(F) / n  # inverse, 1/n folded
            self._F = owner._cconst(F.real, F.imag)
            self._G = owner._cconst(G.real, G.imag)
        else:
            n1, n2 = factors
            if n1 * n2 != n:
                raise ValueError(f"four-step factors {factors} do not "
                                 f"multiply to {n}")

            def dft_mat(m, inverse, scale=1.0):
                idx = np.arange(m)
                return np.exp((1j if inverse else -1j) * 2.0 * np.pi
                              * np.outer(idx, idx) / m) * scale

            # twiddle T[x2, k1] = exp(∓2πi k1 x2 / n), JAX's layout
            Tf = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n1))
                        / n)
            self._fwd = owner._four_tables(dft_mat(n1, False),
                                           dft_mat(n2, False), Tf)
            # fold the full 1/n into the n2-stage of the inverse
            self._inv = owner._four_tables(dft_mat(n1, True),
                                           dft_mat(n2, True, 1.0 / n),
                                           np.conj(Tf))

    def __call__(self, z, inverse: bool):
        return self.along(z, inverse, axis=-1)

    def along(self, z, inverse: bool, axis: int):
        """DFT along ``axis`` (-1 or -2) with canonical index order in and
        out. ``'dotgen'``: every stage contracts its axis in place, one
        index transpose per four-step pass; ``'swap'``: see
        :meth:`_along_last_swap`."""
        assert axis in (-1, -2), axis
        ow = self.owner
        if ow.formulation == "swap":
            if axis == -1:
                return self._along_last_swap(z, inverse)
            return _swap(self._along_last_swap(_swap(z), inverse))

        if self.factors is None:
            return ow._cdot(z, self._G if inverse else self._F, axis)

        tab = self._inv if inverse else self._fwd
        tw = _cmap(lambda t: t.mT, tab["T"])      # (k1, x2)
        n1, n2 = self.factors
        if axis == -1:
            lead = z[0].shape[:-1]
            zr = _cmap(lambda x: x.reshape(lead + (n1, n2)), z)
            a = ow._cdot(zr, tab["M1"], -2)       # (..., k1, x2)
            a = _cmul(a, tw)
            # JAX contracts x2 as an interior axis of (..., x2, k1): no K1
            a = ow._cdot(a, tab["M2"], -1, k1=False)   # (..., k1, k2)
            # canonical k = k2*n1 + k1: one transpose + flatten
            return _cmap(lambda x: x.transpose(-1, -2)
                         .reshape(lead + (self.n,)), a)
        lead = z[0].shape[:-2]
        ncols = z[0].shape[-1]
        zr = _cmap(lambda x: x.reshape(lead + (n1, n2, ncols)), z)
        a = ow._cdot(zr, tab["M1"], -3)           # (..., k1, y2, ncols)
        a = _cmul(a, _cmap(lambda t: t[:, :, None], tw))
        a = ow._cdot(a, tab["M2"], -2)            # (..., k1, k2, ncols)
        return _cmap(lambda x: x.transpose(-3, -2)
                     .reshape(lead + (self.n, ncols)), a)

    def _along_last_swap(self, z, inverse: bool):
        """The ``'swap'`` formulation: each stage's axis transposed last
        before its product, three transposes per four-step pass."""
        ow = self.owner
        if self.factors is None:
            return ow._cdot(z, self._G if inverse else self._F, -1)
        tab = self._inv if inverse else self._fwd
        n1, n2 = self.factors
        lead = z[0].shape[:-1]
        zr = _cmap(lambda x: x.reshape(lead + (n1, n2)), z)
        # DFT over x1: layout (..., x2, x1) @ M1 -> (..., x2, k1)
        a1 = _cmul(ow._cdot(_swap(zr), tab["M1"], -1), tab["T"])
        # DFT over x2: layout (..., k1, x2) @ M2 -> (..., k1, k2)
        a2 = ow._cdot(_swap(a1), tab["M2"], -1)
        # output index k = k2*n1 + k1 -> (..., k2, k1) then flatten
        return _cmap(lambda x: x.reshape(lead + (self.n,)), _swap(a2))


class MatmulTransform:
    """DFT-as-matmul transforms (counterpart of ``MXUTransform``).

    2-D transforms apply a 1-D pass (:class:`_CDFT`) along both axes.
    Leading batch axes are flattened into the product's rows, in chunks
    of ``max_batch`` fields. Real-field transforms take the path that
    ``realpath`` names (module docstring).
    """

    def __init__(self, nx: int, dtype=np.float32, precision: str = "auto",
                 factors="auto", half_factors="auto", evenodd="auto",
                 gauss="auto", formulation: str = "dotgen",
                 max_batch="auto", realpath: str = "auto",
                 use_pallas: bool = False, pallas_interpret: bool = False,
                 device=None):
        self.nx = nx
        self.dtype = np.dtype(dtype)
        self.nk_half = nx // 2 + 1
        self.device = resolve_device(device)
        f32 = self.dtype == np.float32
        if formulation not in ("dotgen", "swap"):
            raise ValueError(f"formulation={formulation!r}: 'dotgen' or "
                             "'swap'")
        self.formulation = formulation
        if precision == "auto":
            precision = "high" if f32 else "f32"
        if precision in ("split", "split3") and not f32:
            raise ValueError(f"precision={precision!r} needs float32")
        if precision == "fast" and f32:
            warnings.warn(
                "MatmulTransform precision='fast' is the JAX package's "
                "single-pass mode: on the TPU its products are bf16-grade "
                "(~2.6e-3 relative error) and f32 simulations are known to "
                "go NaN with it. On a CUDA card it is one float32 product a "
                "real product with TF32 off, the arithmetic of the default "
                "'high'; use 'high', 'split' (3 explicit passes) or "
                "'split3' (6 passes) unless you have validated your "
                "configuration.",
                stacklevel=2,
            )
        self.precision = precision
        self._mm = _MM[precision]
        self.factors = _auto_factors(nx) if factors == "auto" else factors
        # the K1 kernel: 'split' precision in f32 only, as in JAX
        self.use_pallas = bool(use_pallas) and precision == "split" and f32
        if gauss == "auto":
            gauss = f32
        self.gauss = bool(gauss) and not self.use_pallas
        # pallas_interpret is accepted so that one set of options builds
        # both providers; the card kernel has no interpret mode (tensors on
        # the host take its plain version)
        del pallas_interpret
        if max_batch == "auto":
            max_batch = 1 if f32 else 0
        self.max_batch = int(max_batch)
        # K1 takes the constant planes converted once (bf16 for its
        # tensor-core route), keyed by the table they came from
        self._prepared = {}

        self._cdft = _CDFT(self, nx, self.factors)

        # -- real-transform machinery ---------------------------------------
        if half_factors == "auto":
            half_factors = (_auto_factors(nx // 2, min_n=1024)
                            if nx % 2 == 0 else None)
        if evenodd == "auto":
            evenodd = nx % 2 == 0 and half_factors is not None
        mf_ok = (nx % 2 == 0 and self.factors is not None
                 and self.factors[0] % 2 == 0 and self.factors[1] % 2 == 0)
        if realpath == "auto":
            if mf_ok and f32 and nx >= 4096:
                realpath = "mf"
            else:
                realpath = "evenodd" if (bool(evenodd) and nx % 2 == 0) \
                    else "dense"
        if realpath == "mf" and not mf_ok:
            raise ValueError(
                f"realpath='mf' needs an even-factor four-step at nx={nx} "
                f"(factors={self.factors})")
        if realpath not in ("mf", "evenodd", "dense"):
            raise ValueError(f"realpath={realpath!r}: 'mf', 'evenodd', "
                             "'dense' or 'auto'")
        if realpath == "evenodd" and nx % 2:
            realpath = "dense"
        self.realpath = realpath
        if realpath == "mf":
            self._init_mf_tables()
        self.evenodd = realpath == "evenodd"
        self._cdft_half = None
        if self.evenodd:
            nh = nx // 2
            self._cdft_half = _CDFT(self, nh, half_factors)
            # butterfly twiddle W[k] = exp(-2*pi*i*k/nx), k in [0, nh)
            self._w_f = self._planes(np.exp(-2j * np.pi * np.arange(nh) / nx))
        if realpath == "dense":
            # dense half-spectrum matrices: forward keeps nk = nx//2+1
            # columns; the inverse folds the Hermitian weights
            # w = [1, 2, ..., 2, 1]
            a = np.arange(nx)
            F = np.exp(-2j * np.pi * np.outer(a, a) / nx)
            nk = self.nk_half
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

    # -- constant tables -------------------------------------------------------
    def _tensor(self, m: np.ndarray):
        return torch.as_tensor(m.astype(self.dtype), device=self.device)

    def _planes(self, z: np.ndarray):
        """A complex table as a pair of real planes, unsplit."""
        return self._tensor(z.real), self._tensor(z.imag)

    def _const(self, m: np.ndarray):
        """A real constant in the precision's pre-split form."""
        t = self._tensor(m)
        if self.precision == "split":
            return mask_split(t)
        if self.precision == "split3":
            return _mask_split3(t)
        return (t,)

    def _cconst(self, Mre: np.ndarray, Mim: np.ndarray):
        """A complex constant: the pair ``(const(Re), const(Im))`` for the
        four-product contraction, or with ``gauss`` the dict of the three
        Gauss combinations ``Re``, ``Im - Re``, ``Im + Re`` (three
        products). Under ``use_pallas`` a pair of a shape K1 can take
        (K, N >= 256) is also prepared for it."""
        if self.gauss:
            return {"c": self._const(Mre), "s2": self._const(Mim - Mre),
                    "s3": self._const(Mim + Mre)}
        M = (self._const(Mre), self._const(Mim))
        if self.use_pallas and min(Mre.shape) >= 256:
            self._prepared[id(M)] = prepare_b(*M[0], *M[1])
        return M

    def _four_tables(self, M1, M2, T):
        return {"M1": self._cconst(M1.real, M1.imag),
                "M2": self._cconst(M2.real, M2.imag),
                "T": self._planes(T)}

    def _init_mf_tables(self):
        """Half-range four-step tables for the mirror-free real path.

        Forward (real x -> nk columns): stage 1 is a full (n1 x n1) DFT of
        a real input (2 real products, no Gauss form), stage 2 keeps only
        the ``k2 <= n2/2`` output columns; the flattened ``k = k2*n1 + k1``
        output is then sliced to ``nk = nx/2+1``.

        Inverse (nk columns -> real x): only the retained ``m < nx/2``
        input columns are contracted (stage 1 uses the first n1/2 rows of
        the inverse DFT table), and the final stage computes the real plane
        only, the mirror half's contribution folded as a 2x scale. The
        endpoint columns m=0 and m=nx/2 are rank-1 corrections.
        """
        nx = self.nx
        n1, n2 = self.factors
        i1 = np.arange(n1)
        i2 = np.arange(n2)
        M1f = np.exp(-2j * np.pi * np.outer(i1, i1) / n1)
        Tf = np.exp(-2j * np.pi * np.outer(i2, i1) / nx)      # (x2, k1)
        M2f = np.exp(-2j * np.pi * np.outer(i2, i2) / n2)[:, :n2 // 2 + 1]
        self._mf_fwd = {
            "M1": (self._const(M1f.real), self._const(M1f.imag)),
            "T": self._planes(Tf),
            "M2": self._cconst(M2f.real, M2f.imag),
        }
        M1i = np.exp(2j * np.pi * np.outer(i1[: n1 // 2], i1) / n1)
        Ti = np.exp(2j * np.pi * np.outer(i2, i1) / nx)       # (m_b, x_a)
        M2i = np.exp(2j * np.pi * np.outer(i2, i2) / n2) * (2.0 / nx)
        self._mf_inv = {
            "M1": self._cconst(M1i.real, M1i.imag),
            "T": self._planes(Ti),
            "M2": (self._const(M2i.real), self._const(M2i.imag)),
        }
        alt = np.where(np.arange(nx) % 2 == 0, 1.0, -1.0) / nx
        self._mf_alt = self._tensor(alt)

    # -- mirror-free real 1-D passes ---------------------------------------
    def _rdft_last_mf(self, x):
        """Real DFT along the last axis keeping nk = nx//2+1 columns via
        half-output-range four-step tables (no strided layout op)."""
        n1, n2 = self.factors
        lead = x.shape[:-1]
        xr = x.reshape(lead + (n1, n2))
        M1r, M1i = self._mf_fwd["M1"]
        s = (self._mm(xr, M1r, -2), self._mm(xr, M1i, -2))   # (..., k1, x2)
        s = _cmul(s, _cmap(lambda t: t.mT, self._mf_fwd["T"]))
        # JAX contracts x2 as an interior axis of (..., x2, k1): no K1
        a = self._cdot(s, self._mf_fwd["M2"], -1, k1=False)  # (..., k1, k2h)
        nkk = (n2 // 2 + 1) * n1
        return _cmap(lambda t: t.transpose(-1, -2).reshape(lead + (nkk,))
                     [..., :self.nk_half], a)

    def _irdft_last_mf(self, z):
        """Inverse of :meth:`_rdft_last_mf`: half-spectrum rows (..., nk)
        -> real (..., nx), as ``2*Re(four-step over the m < nx/2
        columns)`` plus endpoint corrections. Anti-Hermitian residue in the
        self-mirror columns m=0 and m=nx/2 is annihilated by the ``Re``,
        matching ``real(ifft(.))`` semantics."""
        n1, n2 = self.factors
        nh = self.nx // 2
        lead = z[0].shape[:-1]
        body = _cmap(lambda t: t[..., :nh].reshape(lead + (n1 // 2, n2)), z)
        a = self._cdot(body, self._mf_inv["M1"], -2)         # (..., x_a, m_b)
        a = _cmul(a, _cmap(lambda t: t.mT, self._mf_inv["T"]))
        M2r, M2i = self._mf_inv["M2"]
        out = self._mm(a[0], M2r, -1) - self._mm(a[1], M2i, -1)  # (x_a, x_b)
        out = out.transpose(-1, -2).reshape(lead + (self.nx,))
        # (1/nx)*[-Re(V0) + (-1)^x * Re(V_nyq)]; 1/nx is baked into _mf_alt
        c0 = z[0][..., 0:1]
        cn = z[0][..., nh:nh + 1]
        return out + cn * self._mf_alt - c0 * self._mf_alt[0]

    # -- core complex contraction ------------------------------------------
    def _cdot(self, z, M, dim: int, k1: bool = True):
        """Contract axis ``dim`` of the pair ``z`` with axis 0 of the
        complex constant ``M`` (either :meth:`_cconst` form); the result
        axis takes ``dim``'s place. A last-axis contraction of a pair
        constant goes to K1 where JAX's would go to its Pallas kernel;
        ``k1=False`` marks the contractions that are last here but
        interior in JAX's layout."""
        zr, zi = z
        mm = self._mm
        if isinstance(M, dict):
            # Gauss 3-multiplication product: for (a+bi)(c+di) with the
            # constant combinations c, d-c, c+d precomputed,
            #   t1 = (a+b)c, t2 = a(d-c), t3 = b(c+d)
            #   re = t1 - t3, im = t1 + t2
            t1 = mm(zr + zi, M["c"], dim)
            t2 = mm(zr, M["s2"], dim)
            t3 = mm(zi, M["s3"], dim)
            return t1 - t3, t1 + t2
        prepared = self._prepared.get(id(M))
        if prepared is not None and k1 and dim in (-1, zr.dim() - 1):
            out = self._kernel_or_none(zr, zi, prepared)
            if out is not None:
                return out
        Mr, Mi = M
        return mm(zr, Mr, dim) - mm(zi, Mi, dim), mm(zr, Mi, dim) + mm(zi, Mr, dim)

    def _kernel_or_none(self, zr, zi, prepared):
        """K1 for the shapes the JAX package sends to its Pallas kernel
        (``ops/fft.py:_pallas_or_none``): leading axes flattened into rows,
        K >= 256, N >= 256, rows % 8 == 0."""
        lead = zr.shape[:-1]
        K = zr.shape[-1]
        N = prepared.shape[1]
        rows = math.prod(lead)
        if K >= 256 and N >= 256 and rows % 8 == 0:
            re, im = csplit_matmul_prepared(zr.reshape(rows, K).contiguous(),
                                            zi.reshape(rows, K).contiguous(),
                                            prepared)
            return re.reshape(lead + (N,)), im.reshape(lead + (N,))
        return None

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
        z = self.pass_x((z.real, z.imag), False)
        return torch.complex(*self.pass_y(z, False))

    def ifft2(self, zh):
        return self._batched(self._ifft2_one, zh)

    def _ifft2_one(self, zh):
        z = self.pass_x((zh.real, zh.imag), True)
        return torch.complex(*self.pass_y(z, True))

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

    def ifft2_real_pairs(self, zh):
        """Pair-packed real inverses: two Hermitian spectra per complex
        inverse (see ``_pairs_via_ifft2`` for the input contract)."""
        return _pairs_via_ifft2(self, zh)

    # -- even/odd real 1-D passes ------------------------------------------
    @staticmethod
    def _reflect_conj_1d(z):
        """conj(Z[(n-k) % n]) along the last axis."""
        re = torch.roll(torch.flip(z[0], (-1,)), 1, -1)
        im = -torch.roll(torch.flip(z[1], (-1,)), 1, -1)
        return re, im

    def _rdft_last_evenodd(self, x):
        """Real DFT along the last axis keeping nk = nx//2+1 columns, via
        one half-length complex DFT of ``x[0::2] + i*x[1::2]`` and the
        exact (same-field) butterfly."""
        U = self._cdft_half((x[..., 0::2], x[..., 1::2]), inverse=False)
        Ur = self._reflect_conj_1d(U)
        E = ((U[0] + Ur[0]) * 0.5, (U[1] + Ur[1]) * 0.5)  # even samples' DFT
        # odd samples' DFT: (-0.5i)*(U - Ur)
        O = (0.5 * (U[1] - Ur[1]), -0.5 * (U[0] - Ur[0]))
        Ow = _cmul(O, self._w_f)
        # X[k], k in [0, nh); the Nyquist column X[nh] = E[0] - O[0] =
        # Re(U[0]) - Im(U[0]), real
        ny_re = U[0][..., :1] - U[1][..., :1]
        return (torch.cat([E[0] + Ow[0], ny_re], -1),
                torch.cat([E[1] + Ow[1], torch.zeros_like(ny_re)], -1))

    def _irdft_last_evenodd(self, z):
        """Inverse of :meth:`_rdft_last_evenodd`: half-spectrum rows
        (..., nk) -> real (..., nx). Non-Hermitian residue in the input is
        implicitly projected out, matching ``real(ifft(...))``."""
        nh = self.nx // 2
        Xm = _cmap(lambda t: t[..., :nh], z)
        # conj(X[nh-k]), k in [0, nh): flip of columns 1..nh
        Xr = (torch.flip(z[0][..., 1:nh + 1], (-1,)),
              -torch.flip(z[1][..., 1:nh + 1], (-1,)))
        E = ((Xm[0] + Xr[0]) * 0.5, (Xm[1] + Xr[1]) * 0.5)
        D = ((Xm[0] - Xr[0]) * 0.5, (Xm[1] - Xr[1]) * 0.5)
        O = _cmul(D, (self._w_f[0], -self._w_f[1]))    # W^{-k} * (...)
        u = self._cdft_half((E[0] - O[1], E[1] + O[0]), inverse=True)
        # interleave: out[0::2] = Re(u), out[1::2] = Im(u)
        lead = u[0].shape[:-1]
        return torch.stack(u, dim=-1).reshape(lead + (self.nx,))

    # -- half-spectrum 2-D API ---------------------------------------------
    def rfft2(self, x):
        return self._batched(self._rfft2_one, x)

    def _rfft2_one(self, x):
        # the real DFT along x keeping nk columns, then the complex one
        # along y (on nk columns)
        return torch.complex(*self.pass_y(self.rpass_x(x), False))

    def irfft2(self, zh):
        return self._batched(self._irfft2_one, zh)

    def _irfft2_one(self, zh):
        return self.irpass_x(self.pass_y((zh.real, zh.imag), True))

    # -- the 1-D passes, on their own ----------------------------------------
    # A 2-D transform is a pass along x and one along y; a provider that
    # shards the grid (``parallel/mfft.py``) runs them on its local blocks,
    # with a transpose between. Each takes and gives a pair of planes.
    def pass_x(self, z, inverse: bool):
        """Complex DFT along x (the last axis)."""
        return self._cdft.along(z, inverse, axis=-1)

    def pass_y(self, z, inverse: bool):
        """Complex DFT along y (axis -2), on any number of columns."""
        return self._cdft.along(z, inverse, axis=-2)

    def rpass_x(self, x):
        """Real DFT along x of a real field, keeping nk = nx//2+1 columns,
        by the ``realpath``."""
        if self.realpath == "mf":
            return self._rdft_last_mf(x)
        if self.evenodd:
            return self._rdft_last_evenodd(x)
        return self._mm(x, self._Rf[0], -1), self._mm(x, self._Rf[1], -1)

    def irpass_x(self, z):
        """Real reconstruction along x from nk columns (the inverse of
        :meth:`rpass_x`, ``real(ifft(.))`` of the Hermitian extension)."""
        if self.realpath == "mf":
            return self._irdft_last_mf(z)
        if self.evenodd:
            return self._irdft_last_evenodd(z)
        return self._mm(z[0], self._Ri[0], -1) + self._mm(z[1], self._Ri[1], -1)


@span("model.transform")
def make_transform(nx: int, dtype, backend: str = "auto",
                   precision: str = "auto", device=None, **mxu_opts):
    """Pick a transform provider: ``'auto'`` and ``'native'`` give
    ``torch.fft`` (the JAX package's choice on CPU and GPU platforms),
    ``'mxu'`` the matmul-DFT on ``device`` (the card unless ``"cpu"``).
    ``mxu_opts`` (``factors``, ``half_factors``, ``evenodd``, ``gauss``,
    ``formulation``, ``max_batch``, ``realpath``, ``use_pallas``,
    ``pallas_interpret``) pass through to :class:`MatmulTransform` and are
    ignored by the native provider, which follows its input tensors."""
    if backend in ("auto", "native"):
        return NativeTransform(nx, dtype)
    if backend == "mxu":
        return MatmulTransform(nx, dtype, precision=precision, device=device,
                               **mxu_opts)
    raise ValueError(f"unknown transform backend {backend!r}")
