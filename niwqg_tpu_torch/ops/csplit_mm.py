"""Complex-split matrix product of the matmul-DFT (K1 of the port).

``csplit_matmul(ar, ai, brh, brl, bih, bil) -> (out_re, out_im)`` computes
``(ar + i*ai) @ B`` with ``B`` pre-split into the f32 planes ``re_hi,
re_lo, im_hi, im_lo`` — the contract of the TPU kernel
``niwqg_tpu/ops/pallas_mm.py:csplit_matmul``. Each real product is formed
as ``x@y_lo + x_lo@y_hi + x_hi@y_hi``.

On a CUDA tensor it launches one of the two hand-written Hopper kernels of
``csrc/csplit_mm.cu``, chosen by :func:`route` from the shape alone:

``"tc"``
    the tensor-core kernel (bf16 ``wgmma``, f32 sums), for the shapes the
    main path sends: ``K >= 256``, ``N >= 256`` and ``M``, ``K``, ``N``
    multiples of 8. Its operands ``x``, ``x_lo`` and ``y_lo`` are rounded to
    bf16 as on the TPU's matrix unit, so it is held to
    :func:`csplit_matmul_ref_bf16` (tightly) and to the exact product at
    about 1e-5 of the largest output.
``"f32"``
    the f32-FMA kernel, for every other shape (any ``M, N, K >= 1``), held
    to :func:`csplit_matmul_ref`.

The choice is no fallback: a launch that is refused, or a build that
fails, raises. On a CPU tensor the wrapper runs :func:`csplit_matmul_ref`.

The B planes of a transform are constants: :func:`prepare_b` converts them
to bf16 once, and :func:`csplit_matmul_prepared` takes its result. The
six-plane call prepares on the fly.

The kernels count their own launches, on the card: each adds one to its
route's counter in device memory as it runs, so a launch replayed from a
CUDA graph counts as one from the host does, and a capture, which runs
nothing, counts none (``FAMILY``, a ``cuda_build.Family``). :func:`counts`
reads them (``launches``, and ``launches_tc`` and ``launches_f32`` per
route) with ``cpu_calls``, the calls served on the host
(``FAMILY.plain_calls()``); :func:`reset_counts` sets all to 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import Family

_HI_MASK = -65536  # 0xFFFF0000 as a signed 32-bit integer


def mask_split(x: torch.Tensor):
    """Bit-masked hi/lo split of f32: hi keeps the top 16 bits (exactly
    bf16-representable), lo = x - hi."""
    if x.dtype != torch.float32:
        raise TypeError(f"mask_split needs float32, got {x.dtype}")
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, x - hi


def _smm(x, xh, xl, yh, yl):
    return x @ yl + xl @ yh + xh @ yh


def csplit_matmul_ref(ar, ai, brh, brl, bih, bil):
    """Plain PyTorch version: the 12 split products as f32 matmuls, in the
    TPU kernel's order of summation."""
    arh, arl = mask_split(ar)
    aih, ail = mask_split(ai)
    re = _smm(ar, arh, arl, brh, brl) - _smm(ai, aih, ail, bih, bil)
    im = _smm(ar, arh, arl, bih, bil) + _smm(ai, aih, ail, brh, brl)
    return re, im


def _bf16_round(x):
    """f32 rounded to bf16 (nearest even), held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def csplit_matmul_ref_bf16(ar, ai, brh, brl, bih, bil):
    """Plain version of the tensor-core kernel: the same 12 products with
    ``x``, ``x_lo`` and ``y_lo`` rounded to bf16 (the hi parts are bf16
    already), every product and sum in f32."""
    arh, arl = mask_split(ar)
    aih, ail = mask_split(ai)
    ar, arl, ai, ail, brl, bil = (_bf16_round(t) for t in
                                  (ar, arl, ai, ail, brl, bil))
    re = _smm(ar, arh, arl, brh, brl) - _smm(ai, aih, ail, bih, bil)
    im = _smm(ar, arh, arl, bih, bil) + _smm(ai, aih, ail, brh, brl)
    return re, im


def route(M: int, N: int, K: int) -> str:
    """Which kernel a CUDA call of this shape launches: ``"tc"`` under the
    JAX package's eligibility rule (K >= 256, N >= 256, rows % 8 == 0) where
    the bulk loads can also be aligned (K % 8 == 0, N % 8 == 0), else
    ``"f32"``."""
    if K >= 256 and N >= 256 and M % 8 == 0 and K % 8 == 0 and N % 8 == 0:
        return "tc"
    return "f32"


class PreparedB:
    """The four B planes of a transform, ready for either kernel: the f32
    planes as given (``planes``) and one ``(4, K, N)`` bf16 tensor
    (``bf16``: re_hi, re_lo, im_hi, im_lo; hi exact, lo rounded)."""

    __slots__ = ("planes", "bf16")

    def __init__(self, planes, bf16):
        self.planes = planes
        self.bf16 = bf16

    @property
    def shape(self):
        return tuple(self.planes[0].shape)


def _check_planes(planes, name):
    """Equal-shaped 2-D f32 planes on one device."""
    first = planes[0]
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"csplit_matmul takes float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"csplit_matmul takes 2-D planes, got {t.dim()}-D")
        if t.device != first.device:
            raise ValueError("csplit_matmul operands lie on different devices")
        if t.shape != first.shape:
            raise ValueError(f"{name} planes differ in shape: "
                             f"{tuple(t.shape)} != {tuple(first.shape)}")


def prepare_b(brh, brl, bih, bil) -> PreparedB:
    """Convert the four f32 B planes ``(K, N)`` once for many products."""
    planes = (brh, brl, bih, bil)
    _check_planes(planes, "B")
    return PreparedB(planes, torch.stack(planes).to(torch.bfloat16))


def _check(ar, ai, planes, need_cuda=None):
    """Validate the six planes; returns ``(M, N, K)``. ``need_cuda`` names
    a function that launches a kernel whatever the device."""
    _check_planes((ar, ai), "A")
    _check_planes(planes, "B")
    if planes[0].device != ar.device:
        raise ValueError("csplit_matmul operands lie on different devices")
    M, K = ar.shape
    if planes[0].shape[0] != K:
        raise ValueError(f"B planes {tuple(planes[0].shape)} do not continue "
                         f"A {(M, K)}")
    N = planes[0].shape[1]
    if min(M, N, K) == 0:
        raise ValueError(f"empty product {(M, K)} @ {(K, N)}")
    kind = ar.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"csplit_matmul: unsupported device {ar.device}")
    if need_cuda and kind != "cuda":
        raise ValueError(f"{need_cuda} launches a CUDA kernel; got planes "
                         f"on {ar.device}")
    if kind == "cuda":
        for t in (ar, ai) + tuple(planes):
            if not t.is_contiguous():
                raise ValueError(
                    "csplit_matmul's kernel takes contiguous planes")
    return M, N, K


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# the kernels' library: a launch counter per route
FAMILY = Family(
    "csplit_mm",
    {"csplit_matmul_f32": [_ptr] * 8 + [_i32] * 3 + [_ptr] * 2,
     "csplit_matmul_tc": [_ptr] * 5 + [_i32] * 3 + [_ptr] * 2},
    keys=["launches_tc", "launches_f32"], plain=["csplit_matmul"],
    error="csplit_error_string")


def _launch(route_name, ar, ai, b, M, N, K):
    """Launch one of the library's kernels on A's stream; raises if the
    launch is refused."""
    out_re = torch.empty((M, N), device=ar.device, dtype=torch.float32)
    out_im = torch.empty((M, N), device=ar.device, dtype=torch.float32)
    FAMILY.launch("csplit_matmul_" + route_name, ar.device, ar, ai, *b,
                  out_re, out_im, M, N, K, key="launches_" + route_name)
    return out_re, out_im


def csplit_matmul_f32(ar, ai, brh, brl, bih, bil):
    """The f32-FMA kernel on CUDA planes of any shape ``M, N, K >= 1``
    (the route of the shapes :func:`route` does not send to the tensor
    cores; callable on its own to time it beside the other)."""
    planes = (brh, brl, bih, bil)
    M, N, K = _check(ar, ai, planes, need_cuda="csplit_matmul_f32")
    return _launch("f32", ar, ai, planes, M, N, K)


def csplit_matmul_tc(ar, ai, b: PreparedB):
    """The tensor-core kernel on CUDA planes of a shape with
    ``route(M, N, K) == "tc"``; raises on any other."""
    M, N, K = _check(ar, ai, b.planes, need_cuda="csplit_matmul_tc")
    if route(M, N, K) != "tc":
        raise ValueError(f"the tensor-core kernel does not take {(M, K)} @ "
                         f"{(K, N)}: see route()")
    if b.bf16.device != ar.device or not b.bf16.is_contiguous():
        raise ValueError("prepared B planes must be contiguous on A's device")
    return _launch("tc", ar, ai, [b.bf16], M, N, K)


def _dispatch(ar, ai, planes, prepared):
    M, N, K = _check(ar, ai, planes)
    if ar.device.type == "cpu":
        FAMILY.plain_call("csplit_matmul")
        return csplit_matmul_ref(ar, ai, *planes)
    if route(M, N, K) == "tc":
        return csplit_matmul_tc(ar, ai, prepared or prepare_b(*planes))
    return csplit_matmul_f32(ar, ai, *planes)


def csplit_matmul_prepared(ar, ai, b: PreparedB):
    """``(ar + i*ai) @ B`` for a :func:`prepare_b` result; returns
    ``(out_re, out_im)``. ``ar``/``ai``: (M, K) f32, any M, N, K >= 1."""
    return _dispatch(ar, ai, b.planes, b)


def csplit_matmul(ar, ai, brh, brl, bih, bil):
    """(ar + i*ai) @ (b) with pre-split b planes; returns (out_re, out_im).

    ``ar``/``ai``: (M, K) f32. ``b*``: (K, N) f32 planes re_hi, re_lo,
    im_hi, im_lo. Any M, N, K >= 1; :func:`route` says which kernel a CUDA
    call launches. The tensor-core route converts the B planes on the fly:
    a caller with constant planes prepares them once (:func:`prepare_b`)."""
    return _dispatch(ar, ai, (brh, brl, bih, bil), None)


def counts() -> dict:
    """K1's counters: the kernels' launches on every card (read after a
    synchronise of the card, so that every launch queued has run), in all
    (``launches``) and per route (``launches_tc``, ``launches_f32``), and
    ``cpu_calls``."""
    out = FAMILY.counts()
    out["launches"] = sum(out[k] for k in FAMILY.keys)
    return out


reset_counts = FAMILY.reset
