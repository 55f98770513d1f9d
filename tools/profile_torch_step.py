#!/usr/bin/env python3
"""Where a step of the PyTorch port's flagship spends its time on the card.

Builds the flagship coupled model (``chip_smoke.flagship``) at
``--nx`` on the first CUDA card, in one or both configurations:

  k1      the matmul-DFT with the hand-written complex-split kernel (f32,
          'split' precision, dense swap formulation) — the slice's main path;
  cufft   the same model on ``torch.fft`` (cuFFT), f32.

For each it times ``--steps`` steps with the host clock (closed by a
synchronise), then profiles ``--steps`` more with ``torch.profiler`` and
prints the device time per step grouped by kernel family (the K1 kernel,
cuBLAS/CUTLASS GEMMs, FFTs, the rest) with the device's idle share, and
the top kernels. A Chrome trace per configuration goes to ``--out``.

    python3 tools/profile_torch_step.py --nx 2048 --out output_profile
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, ROOT)

from chip_smoke import K1_TRANSFORM, flagship  # noqa: E402

CONFIGS = {
    "k1": dict(backend="mxu", precision="split", transform_opts=K1_TRANSFORM),
    "cufft": dict(backend="native"),
}


def family(name: str) -> str:
    n = name.lower()
    if "csplit_mm" in n:
        return "K1 csplit_mm"
    if "gemm" in n or "cutlass" in n or "sm90_xmma" in n:
        return "GEMM (torch.matmul)"
    if "fft" in n:
        return "FFT (cuFFT)"
    return "other (elementwise, reductions, copies)"


def profile(name, nx, steps, out_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic

    m = flagship(CoupledModel, ic, nx=nx, dtype=np.float32, **CONFIGS[name])
    m.run_steps(2)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    m.run_steps(steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        t0 = time.perf_counter()
        m.run_steps(steps)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / steps
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))

    fam, kernels = {}, []
    for evt in prof.key_averages():
        # device-side events only: CPU operators carry their kernels'
        # device time too, and would count it twice
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us <= 0:
            continue
        kernels.append((dev_us / steps, evt.count // steps, evt.key))
        f = family(evt.key)
        fam[f] = fam.get(f, 0.0) + dev_us / steps
    busy_ms = sum(fam.values()) / 1e3
    print(f"== {name} at {nx}^2: {1e3 * wall:.1f} ms/step "
          f"({1.0 / wall:.3f} steps/s) unprofiled, "
          f"{1e3 * wall_prof:.1f} ms/step profiled; device busy "
          f"{busy_ms:.1f} ms/step, idle share "
          f"{max(0.0, 1.0 - busy_ms / (1e3 * wall_prof)):.3f}")
    for f, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"   {us / 1e3:9.2f} ms/step  {100 * us / 1e3 / busy_ms:5.1f}%"
              f"  {f}")
    print("   top kernels (ms/step, launches/step, name):")
    for us, cnt, key in sorted(kernels, reverse=True)[:8]:
        print(f"   {us / 1e3:9.3f}  {cnt:5d}  {key[:110]}")
    return dict(config=name, nx=nx, ms_per_step=1e3 * wall,
                ms_per_step_profiled=1e3 * wall_prof, device_busy_ms=busy_ms,
                families_ms={f: us / 1e3 for f, us in fam.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--configs", default="k1,cufft")
    ap.add_argument("--out", default=os.path.join(ROOT, "output_profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device available", file=sys.stderr)
        return 1
    # no disk cache of the ETDRK4 tables: write nothing outside the build
    os.environ.setdefault("NIWQG_TORCH_TABLE_CACHE", "0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = [profile(c, args.nx, args.steps, args.out)
           for c in args.configs.split(",")]
    print(json.dumps({"card": card, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
