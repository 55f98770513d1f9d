"""Device and dtype resolution for the PyTorch port.

Entry points run on the first CUDA card unless the caller passes
``device="cpu"`` (as the CPU tests do). Without a card and without an
explicit CPU request they raise: nothing silently carries on on the host.

Float32 matrix products run in full float32. TF32 keeps about three
decimal digits, and reduced-precision transforms are known to make the
coupled physics go NaN within tens of steps, so :func:`resolve_device`
switches it off for every CUDA caller.
"""

from __future__ import annotations

import numpy as np
import torch


def full_fp32_matmul() -> None:
    """Full-precision float32 products: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the first CUDA card (raises without one);
    ``"cpu"`` -> the host, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "niwqg_tpu_torch: no CUDA device found; pass device='cpu' "
                "to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        full_fp32_matmul()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_dtype(device: torch.device):
    """float32 on the card, float64 on the host (the JAX shell's
    ``_default_dtype``: f64 on CPU, f32 on the accelerator)."""
    return np.float32 if device.type == "cuda" else np.float64


def real_dtype(dtype) -> torch.dtype:
    return {np.dtype("float32"): torch.float32,
            np.dtype("float64"): torch.float64}[np.dtype(dtype)]


def complex_dtype(dtype) -> torch.dtype:
    return {np.dtype("float32"): torch.complex64,
            np.dtype("float64"): torch.complex128}[np.dtype(dtype)]
