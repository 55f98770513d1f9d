"""Complex-split matrix product of the matmul-DFT (K1 of the port).

``csplit_matmul(ar, ai, brh, brl, bih, bil) -> (out_re, out_im)`` computes
``(ar + i*ai) @ B`` with ``B`` pre-split into the f32 planes ``re_hi,
re_lo, im_hi, im_lo`` — the contract of the TPU kernel
``niwqg_tpu/ops/pallas_mm.py:csplit_matmul``. On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/csplit_mm.cu`` (the source says what
bounds it and why its first design is plain f32 FMAs); on a CPU tensor it
runs :func:`csplit_matmul_ref`. There is no fallback between the two: a
CUDA call that the kernel refuses raises.

``csplit_matmul.launches`` counts kernel launches and nothing else;
``csplit_matmul.cpu_calls`` counts the calls served on the host.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import load

_HI_MASK = -65536  # 0xFFFF0000 as a signed 32-bit integer


def mask_split(x: torch.Tensor):
    """Bit-masked hi/lo split of f32: hi keeps the top 16 bits (exactly
    bf16-representable), lo = x - hi."""
    if x.dtype != torch.float32:
        raise TypeError(f"mask_split needs float32, got {x.dtype}")
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, x - hi


def csplit_matmul_ref(ar, ai, brh, brl, bih, bil):
    """Plain PyTorch version: the 12 split products as f32 matmuls, in the
    TPU kernel's order of summation."""
    arh, arl = mask_split(ar)
    aih, ail = mask_split(ai)

    def smm(x, xh, xl, yh, yl):
        return x @ yl + xl @ yh + xh @ yh

    re = smm(ar, arh, arl, brh, brl) - smm(ai, aih, ail, bih, bil)
    im = smm(ar, arh, arl, bih, bil) + smm(ai, aih, ail, brh, brl)
    return re, im


def _check(ar, ai, brh, brl, bih, bil):
    ts = (ar, ai, brh, brl, bih, bil)
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"csplit_matmul takes float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"csplit_matmul takes 2-D planes, got {t.dim()}-D")
        if t.device != ar.device:
            raise ValueError("csplit_matmul operands lie on different devices")
    M, K = ar.shape
    N = brh.shape[1]
    if ai.shape != (M, K):
        raise ValueError(f"ai {tuple(ai.shape)} != ar {(M, K)}")
    for t in (brh, brl, bih, bil):
        if t.shape != (K, N):
            raise ValueError(f"B plane {tuple(t.shape)} != {(K, N)}")
    if min(M, N, K) == 0:
        raise ValueError(f"empty product {(M, K)} @ {(K, N)}")
    return M, N, K


def _library():
    """The kernel's library, built at first use, with its C signatures."""
    lib = load("csplit_mm")
    fn = lib.csplit_matmul_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.csplit_error_string.argtypes = [ctypes.c_int]
        lib.csplit_error_string.restype = ctypes.c_char_p
    return lib


def csplit_matmul(ar, ai, brh, brl, bih, bil):
    """(ar + i*ai) @ (b) with pre-split b planes; returns (out_re, out_im).

    ``ar``/``ai``: (M, K) f32. ``b*``: (K, N) f32 planes re_hi, re_lo,
    im_hi, im_lo. Any M, N, K >= 1."""
    M, N, K = _check(ar, ai, brh, brl, bih, bil)
    if ar.device.type == "cpu":
        csplit_matmul.cpu_calls += 1
        return csplit_matmul_ref(ar, ai, brh, brl, bih, bil)
    if ar.device.type != "cuda":
        raise ValueError(f"csplit_matmul: unsupported device {ar.device}")
    for t in (ar, ai, brh, brl, bih, bil):
        if not t.is_contiguous():
            raise ValueError("csplit_matmul's kernel takes contiguous planes")
    lib = _library()
    out_re = torch.empty((M, N), device=ar.device, dtype=torch.float32)
    out_im = torch.empty((M, N), device=ar.device, dtype=torch.float32)
    with torch.cuda.device(ar.device):
        stream = torch.cuda.current_stream(ar.device).cuda_stream
        err = lib.csplit_matmul_f32(
            ar.data_ptr(), ai.data_ptr(), brh.data_ptr(), brl.data_ptr(),
            bih.data_ptr(), bil.data_ptr(), out_re.data_ptr(),
            out_im.data_ptr(), M, N, K, stream)
    if err != 0:
        raise RuntimeError("csplit_matmul kernel launch failed: "
                           + lib.csplit_error_string(err).decode())
    csplit_matmul.launches += 1
    return out_re, out_im


csplit_matmul.launches = 0
csplit_matmul.cpu_calls = 0
