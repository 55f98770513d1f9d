#!/usr/bin/env python3
"""How far a wave model's f32 runs part from its f64 run, field by field.

Builds one wave model of the PyTorch port with the flagship's physics and
a wave packet in phi (``chip_smoke.flagship(packet=True)``) four ways:
f32 in the K1 configuration (``chip_smoke.py`` phase 8), f32 on the
matmul-DFT with the JAX package's defaults (phase 11a: one f32 GEMM a
real product, no K1), f32 on the native FFT, and f64 on the native FFT. Prints the relative difference of
q, phi, Ke, Pw and Kw of each f32 run against the f64 run after
``set_q``/``set_phi`` and after each of ``--steps`` steps (fields: largest
difference over the largest magnitude).

    python3 tools/probe_wave_budgets.py                    # the card, 2048²
    python3 tools/probe_wave_budgets.py --device cpu --nx 512 --k1-plain bf16
    python3 tools/probe_wave_budgets.py --nu4w 0     # no wave hyperviscosity

On the host K1 runs its plain version. ``--k1-plain bf16`` puts the plain
version of the card's tensor-core route (operands rounded to bf16) in its
place, so that the host shows what that rounding does at small grids.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, ROOT)

from chip_smoke import K1_TRANSFORM, NX, flagship  # noqa: E402

FIELDS = ("q", "phi", "Ke", "Pw", "Kw")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="UnCoupledModel",
                    choices=("UnCoupledModel", "QLModel", "CoupledModel"))
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k1-plain", choices=("f32", "bf16"), default="f32",
                    help="K1's plain version on the host")
    ap.add_argument("--nu4w", type=float, default=None,
                    help="the waves' hyperviscosity (default: the "
                         "flagship's)")
    args = ap.parse_args(argv)

    import torch

    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.device import full_fp32_matmul
    from niwqg_tpu_torch.ops import csplit_mm

    full_fp32_matmul()
    if args.k1_plain == "bf16":
        csplit_mm.csplit_matmul_ref = csplit_mm.csplit_matmul_ref_bf16
    mod = getattr(pkg, args.model)
    physics = {} if args.nu4w is None else {"nu4w": args.nu4w}
    runs = {"f32 K1": dict(dtype=np.float32, backend="mxu", precision="split",
                           transform_opts=K1_TRANSFORM),
            "f32 matmul-DFT defaults": dict(dtype=np.float32, backend="mxu"),
            "f32 native": dict(dtype=np.float32, backend="native"),
            "f64 native": dict(dtype=np.float64, backend="native")}
    states = {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        m = flagship(mod, ic, nx=args.nx, packet=True, device=args.device,
                     fast=True, **physics, **kw)
        seq = [{k: getattr(m, k) for k in FIELDS}]
        for _ in range(args.steps):
            m.run_steps(1)
            seq.append({k: getattr(m, k) for k in FIELDS})
        states[name] = seq
        print(f"{name}: built and stepped in {time.perf_counter() - t0:.1f} s",
              flush=True)
        del m
        if args.device != "cpu":
            torch.cuda.empty_cache()

    ref = states.pop("f64 native")
    print(f"{args.model} at {args.nx}² on {args.device} (K1 plain version on "
          f"the host: {args.k1_plain}; {physics or 'flagship physics'}), "
          "relative to the f64 native run:")
    for name, seq in states.items():
        for step, (a, b) in enumerate(zip(seq, ref)):
            d = {k: float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()
                          / np.abs(np.asarray(b[k])).max()) for k in FIELDS}
            print(f"  {name}, {'set' if step == 0 else f'step {step}'}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in d.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
