#!/usr/bin/env python3
"""Drive the PyTorch port (``niwqg_tpu_torch``) on one NVIDIA card and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and the float32 matmul settings (TF32 off);
  2. build every CUDA source of the port with ``nvcc``;
  3. the complex-split matmul kernel (K1) against its plain PyTorch version
     at the main path's shape (2048x2048 @ 2048x2048) and a ragged one,
     with its time, the plain version's, one library call's
     (complex64 ``torch.matmul``) and the bound (one complex product,
     8*M*N*K flop, at the f32 peak: the split is exact);
  4. the main path: the flagship coupled model at 2048² through
     ``CoupledModel.Model`` in the configuration that runs K1 (matmul-DFT,
     f32, 'split' precision, dense swap formulation), 2 warm-up steps and
     3 timed ones, with K1's launch count per step;
  5. the same model in f64 on cuFFT (``backend='native'``), 2 steps, held
     against the f32 K1 run.

The line before the last holds the card's name and power limit; the one
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NX = 2048
U0 = 0.05
WARM_STEPS = 2
TIMED_STEPS = 3
K1_PER_STEP = 40  # 20 complex 2-D transforms x 2 passes (see PERF.md)
K1_TRANSFORM = dict(use_pallas=True, formulation="swap", factors=None,
                    half_factors=None)
# H100 SXM published peaks at 700 W (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3
K1_RTOL = 1e-5            # max-abs error / max|ref| (f32 sum order)
CROSS_RTOL = 1e-4         # f32 K1 run vs f64 cuFFT run after 2 steps


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flagship(CoupledModel, ic, nx=NX, **kw):
    """``__graft_entry__._build_coupled``'s configuration: Lamb dipole,
    U0=0.05, dt=157, L=2*pi*200 km, filter on, nu4=nu4w=7.5e9."""
    m = CoupledModel.Model(L=2 * np.pi * 200e3, nx=nx, dt=157.0,
                           tmax=157.0 * 100, m=1.0 / 325, N=0.005, f=1e-4,
                           use_filter=True, nu4=7.5e9, nu4w=7.5e9, **kw)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    m.set_q(q)
    m.set_phi((np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2))
    return m


def k1_record(torch, mm, M, K, N, seed, dft, reps):
    """K1 against its plain version at one shape; times at that shape."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    ar = torch.as_tensor(rng.standard_normal((M, K), np.float32), device=dev)
    ai = torch.as_tensor(rng.standard_normal((M, K), np.float32), device=dev)
    if dft:  # the main path's B: the forward DFT matrix
        a = np.arange(K)
        B = np.exp(-2j * np.pi * np.outer(a, a) / K)
    else:
        B = rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))
    br = torch.as_tensor(B.real.astype(np.float32), device=dev)
    bi = torch.as_tensor(B.imag.astype(np.float32), device=dev)
    brh, brl = mm.mask_split(br)
    bih, bil = mm.mask_split(bi)
    args = (ar, ai, brh, brl, bih, bil)

    re, im = mm.csplit_matmul(*args)
    torch.cuda.synchronize()
    rre, rim = mm.csplit_matmul_ref(*args)
    scale = max(rre.abs().max().item(), rim.abs().max().item())
    err = max((re - rre).abs().max().item(), (im - rim).abs().max().item())
    exact = (torch.complex(ar.double(), ai.double())
             @ torch.complex(br.double(), bi.double()))
    err_c128 = max((re.double() - exact.real).abs().max().item(),
                   (im.double() - exact.imag).abs().max().item())
    log(f"K1 {M}x{K} @ {K}x{N}: max_abs_err={err:.3e} vs plain "
        f"(max|ref|={scale:.3e}, rel {err / scale:.3e}); "
        f"vs complex128 {err_c128:.3e}")
    check(err <= K1_RTOL * scale,
          f"K1 disagrees with its plain version at {(M, K, N)}: "
          f"{err:.3e} > {K1_RTOL} * {scale:.3e}")
    if not reps:
        return None

    a_c = torch.complex(ar, ai)
    b_c = torch.complex(br, bi)
    kern = lambda: mm.csplit_matmul(*args)
    plain = lambda: mm.csplit_matmul_ref(*args)
    # in turns: plain, kernel, kernel, plain
    p1 = cuda_ms(torch, plain, reps)
    k1 = cuda_ms(torch, kern, reps)
    k2 = cuda_ms(torch, kern, reps)
    p2 = cuda_ms(torch, plain, reps)
    lib = cuda_ms(torch, lambda: a_c @ b_c, reps)
    # The split is exact (hi + lo = x), so the function is one complex
    # product: 4 real products, 8*M*N*K flop. The kernel's design does 12
    # real products (24*M*N*K flop); that count is printed, not the bound.
    flops = 8.0 * M * N * K
    design_flops = 24.0 * M * N * K
    nbytes = (2 * M * K + 4 * K * N + 2 * M * N) * 4.0
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    ms = 0.5 * (k1 + k2)
    log(f"K1 timing {M}x{K}x{N}: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms, complex64 torch.matmul {lib:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {flops:.3e} flop; "
        f"{100 * bound_ms / ms:.1f}% of it reached); the design's own "
        f"{design_flops:.3e} flop run at "
        f"{design_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=0.5 * (p1 + p2),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "niwqg_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(niwqg_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # no disk cache of the ETDRK4 tables: write nothing outside the build
    os.environ.setdefault("NIWQG_TORCH_TABLE_CACHE", "0")

    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch import cuda_build
    from niwqg_tpu_torch.device import full_fp32_matmul
    from niwqg_tpu_torch.ops import csplit_mm as mm

    # -- 1. the card and the software -------------------------------------
    card = smi_name_power()
    full_fp32_matmul()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in sorted(libs.items()):
        if os.path.exists(path + ".log"):
            with open(path + ".log") as fh:
                for line in fh.read().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"  {name}: {line.strip()}")

    # -- 3. K1 against its plain version -------------------------------------
    rec = k1_record(torch, mm, NX, NX, NX, seed=1, dft=True, reps=10)
    k1_record(torch, mm, 520, 384, 264, seed=2, dft=False, reps=0)

    # -- 4. the main path ------------------------------------------------------
    mm.csplit_matmul.launches = 0
    mm.csplit_matmul.cpu_calls = 0
    t0 = time.perf_counter()
    m = flagship(CoupledModel, ic, backend="mxu", dtype=np.float32,
                 precision="split", transform_opts=K1_TRANSFORM)
    torch.cuda.synchronize()
    log(f"flagship f32 K1 model built and initialised in "
        f"{time.perf_counter() - t0:.1f} s ({type(m.kernel).__name__}, "
        f"q_half={m.kernel.q_half})")
    n_set = mm.csplit_matmul.launches
    m.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    n_warm = mm.csplit_matmul.launches - n_set
    q32, phi32, ke32 = m.q, m.phi, m.Ke
    t0 = time.perf_counter()
    m.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    ke_end = m.Ke
    wall = time.perf_counter() - t0
    launches = mm.csplit_matmul.launches
    n_timed = launches - n_set - n_warm
    log(f"main path: {TIMED_STEPS} steps in {wall:.3f} s = "
        f"{TIMED_STEPS / wall:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f} "
        f"ms/step); K1 launches: set_q/set_phi {n_set}, warm-up {n_warm}, "
        f"timed {n_timed} ({n_timed / TIMED_STEPS:.1f}/step)")
    check(mm.csplit_matmul.cpu_calls == 0, "K1 ran its plain version")
    check(n_warm == K1_PER_STEP * WARM_STEPS
          and n_timed == K1_PER_STEP * TIMED_STEPS,
          f"expected {K1_PER_STEP} K1 launches per step")
    q, phi = m.q, m.phi
    check(np.isfinite(q).all() and np.isfinite(phi).all()
          and math.isfinite(ke_end), "non-finite state after the main path")
    check(q.shape == (NX, NX) and phi.shape == (NX, NX), "bad state shape")
    rec["launches"] = launches
    del m
    torch.cuda.empty_cache()

    # -- 5. cross-check: f64 on cuFFT ------------------------------------------
    t0 = time.perf_counter()
    m64 = flagship(CoupledModel, ic, backend="native", dtype=np.float64)
    m64.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    q64, phi64, ke64 = m64.q, m64.phi, m64.Ke
    log(f"f64 cuFFT reference: {WARM_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s with its build")
    dq = np.abs(q32 - q64).max() / np.abs(q64).max()
    dphi = np.abs(phi32 - phi64).max() / np.abs(phi64).max()
    dke = abs(ke32 - ke64) / abs(ke64)
    log(f"f32 K1 vs f64 cuFFT after {WARM_STEPS} steps: q {dq:.3e}, "
        f"phi {dphi:.3e}, Ke {dke:.3e} (relative; limit {CROSS_RTOL})")
    check(max(dq, dphi, dke) <= CROSS_RTOL,
          "f32 K1 run disagrees with the f64 cuFFT run")

    kernel = dict(name="csplit_matmul", route="cuda",
                  source="niwqg_tpu_torch/csrc/csplit_mm.cu",
                  replaces="niwqg_tpu/ops/pallas_mm.py:63",
                  launches=rec["launches"], max_abs_err=rec["max_abs_err"],
                  ms=rec["ms"], plain_ms=rec["plain_ms"],
                  bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                  library_ms=rec["library_ms"])
    print(json.dumps({"kernels": [kernel]}))
    print(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
