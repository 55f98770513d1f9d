#!/usr/bin/env python3
"""Probe K1's tensor-core kernel on the card: right first, then its time.

Builds ``csrc/csplit_mm.cu``, prints the compiler's resource report, and
checks:

  - the kernel against ``csplit_matmul_ref_bf16`` (the same rounded
    operands; relative to max|ref|) and against the complex128 product, at
    2048x2048 @ 2048x2048 with the DFT matrix as B, at a ragged shape and at
    an 8-row one;
  - the mean-mode sum: column 0 of a constant A times the DFT matrix, K
    equal terms, against K times the rounded constant (what the operands
    hold) and against K times the constant;
  - with ``--time``, the mean device time over ``--reps`` launches at 2048³,
    beside the f32-FMA kernel and complex64 ``torch.matmul``.

    python3 tools/probe_csplit_tc.py --time
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_ms, k1_planes  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_csplit_tc: no CUDA device available", file=sys.stderr)
        return 1
    from niwqg_tpu_torch import cuda_build
    from niwqg_tpu_torch.device import full_fp32_matmul
    from niwqg_tpu_torch.ops import csplit_mm as mm

    full_fp32_matmul()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    path = cuda_build.build_all(["csplit_mm"])["csplit_mm"]
    with open(path + ".log") as fh:
        for line in fh.read().splitlines():
            if any(w in line for w in ("registers", "spill", "warning",
                                       "Compiling")):
                print("  " + line.strip()[:200])

    bad = 0
    for M, K, N, dft in ((2048, 2048, 2048, True), (520, 384, 264, False),
                         (8, 256, 256, False)):
        a, br, bi = k1_planes(torch, mm, M, K, N, seed=M + K + N, dft=dft)
        b = mm.prepare_b(*a[2:])
        rre, rim = mm.csplit_matmul_ref_bf16(*a)
        scale = max(rre.abs().max().item(), rim.abs().max().item())
        exact = (torch.complex(a[0].double(), a[1].double())
                 @ torch.complex(br.double(), bi.double()))
        xscale = exact.abs().max().item()
        re, im = mm.csplit_matmul_tc(a[0], a[1], b)
        torch.cuda.synchronize()
        err = max((re - rre).abs().max().item(),
                  (im - rim).abs().max().item()) / scale
        errx = max((re.double() - exact.real).abs().max().item(),
                   (im.double() - exact.imag).abs().max().item()) / xscale
        ok = err <= 2e-6 and errx <= 2e-5
        bad += not ok
        print(f"{M}x{K}@{K}x{N}: vs bf16 plain {err:.3e}, vs complex128 "
              f"{errx:.3e} {'ok' if ok else 'FAIL'}", flush=True)

    # the mean mode: K equal terms
    K = 2048
    c = np.float32(5 * 0.05 / np.sqrt(2))
    a = torch.full((64, K), float(c), dtype=torch.float32, device="cuda")
    idx = np.arange(K)
    F = np.exp(-2j * np.pi * np.outer(idx, idx) / K)
    fr = torch.as_tensor(F.real.astype(np.float32), device="cuda")
    fi = torch.as_tensor(F.imag.astype(np.float32), device="cuda")
    b = mm.prepare_b(*mm.mask_split(fr), *mm.mask_split(fi))
    hi, lo = mm.mask_split(a[:1, :1])
    held = float(hi.double() + lo.to(torch.bfloat16).double())
    print(f"mean mode: c={float(c)!r}, operands hold {held!r} "
          f"(rel {abs(held - float(c)) / float(c):.3e})")
    re, im = mm.csplit_matmul_tc(a, a, b)
    got = np.array([re[:, 0].double().cpu().numpy(),
                    im[:, 0].double().cpu().numpy()])
    e_held = np.abs(got - K * held).max() / (K * held)
    e_c = np.abs(got - K * float(c)).max() / (K * float(c))
    bad += e_c > 2e-6
    print(f"mean mode: vs K*held {e_held:.3e}, vs K*c {e_c:.3e}", flush=True)

    if args.time:
        a, br, bi = k1_planes(torch, mm, 2048, 2048, 2048, seed=1, dft=True)
        b = mm.prepare_b(*a[2:])
        t = [cuda_ms(torch, lambda: mm.csplit_matmul_tc(a[0], a[1], b),
                     args.reps) for _ in range(2)]
        print(f"time 2048^3 tensor-core kernel: {t[0]:.4f}/{t[1]:.4f} ms",
              flush=True)
        t = cuda_ms(torch, lambda: mm.csplit_matmul_f32(*a), 5)
        print(f"time 2048^3 f32-FMA kernel: {t:.4f} ms")
        ac, bc = torch.complex(a[0], a[1]), torch.complex(br, bi)
        t = cuda_ms(torch, lambda: ac @ bc, args.reps)
        print(f"time 2048^3 complex64 torch.matmul: {t:.4f} ms")
        t = cuda_ms(torch, lambda: mm.csplit_matmul_ref_bf16(*a), 5)
        print(f"time 2048^3 bf16 plain version: {t:.4f} ms")
    print("FAILED" if bad else "all checks passed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
