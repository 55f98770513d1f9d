"""The yardstick's arithmetic: peaks, the kernel-family classifier, the
exchange bound, the bytes of a step's 2-D transforms and the union of
device intervals. Copied from the repository's chip scripts
(``chip_smoke.py``: the peaks and ``k2_bound_ms``;
``tools/profile_torch_step.py``: ``family``) so that the yardstick does not
move when they, or the program's kernel names, do.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM, data sheet, at 700 W
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_LINK = 450e9     # NVLink, each way, per card, bytes/s

FFT = "FFT (cuFFT)"
K2 = "K2 a2a"
COPIES = "copies and transposes"
OTHER = "other (elementwise, reductions)"

# a copy's word, not inside a longer word: "roll" is in "unrolled", as in
# PyTorch's ``unrolled_elementwise_kernel``, which is arithmetic
_COPY = re.compile(r"(?<![a-z])(copy|memcpy|catarray|flip|roll|transpose)")


def family(name: str) -> str:
    """The family of a device operation by its kernel name."""
    n = name.lower()
    if "csplit_mm" in n:
        return "K1 csplit_mm"
    if "a2a_kernel" in n:
        return K2
    if "nccl" in n:
        return "NCCL"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "sm90_xmma" in n:
        return "GEMM (torch.matmul)"
    if "fft" in n:
        return FFT
    if _COPY.search(n):
        return COPIES
    return OTHER


def k2_bound_ms(nbytes_rank: float, cards: int, nranks: int):
    """Least time for the exchange of ``nbytes_rank`` bytes a rank, every
    rank at once: each rank's block read once and written once in HBM
    (ranks that share a card share its HBM), and what changes cards
    crossing NVLink, each card sending at ``PEAK_LINK``. Returns
    ``(bound, hbm, link)`` in ms."""
    per_card = nranks // cards
    t_hbm = per_card * 2.0 * nbytes_rank / PEAK_BYTES
    t_link = (per_card * nbytes_rank * (nranks - per_card) / nranks
              / PEAK_LINK)
    return max(t_hbm, t_link) * 1e3, t_hbm * 1e3, t_link * 1e3


def transform_bytes(counts: dict, nx: int, ranks: int, itemsize: int,
                    half_width: int) -> float:
    """Bytes a rank's 2-D transforms must move in a step: each field's
    input read once and its output written once, at its dtype and layout.
    ``counts`` are the fields per transform method (the census);
    ``itemsize`` is the complex dtype's, a real value takes half;
    ``half_width`` is a half spectrum's global column count (``nx//2+1``
    and any padding). A full field is ``nx*nx/ranks`` values, a half
    spectrum ``nx*half_width/ranks``."""
    full = nx * nx / ranks
    half = nx * half_width / ranks
    c, r = itemsize, itemsize / 2
    per_field = {
        "fft2": 2 * c * full, "ifft2": 2 * c * full,
        "fft2_real": (r + c) * full, "ifft2_real": (r + c) * full,
        "ifft2_real_pairs": (r + c) * full,
        "rfft2": r * full + c * half, "irfft2": r * full + c * half,
    }
    unknown = set(counts) - set(per_field)
    if unknown:
        raise ValueError(f"transform methods without a byte count: "
                         f"{sorted(unknown)}")
    return float(sum(per_field[k] * n for k, n in counts.items()))


def merge(intervals):
    """Sorted, disjoint ``(start, end)`` covering the union of
    ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo=None, hi=None) -> float:
    """Length of the union of ``intervals``, clipped to ``[lo, hi]``."""
    total = 0.0
    for s, e in merge(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        total += max(0.0, e - s)
    return total


def gaps(intervals, lo, hi):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in merge(intervals):
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
