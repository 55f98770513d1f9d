#!/usr/bin/env python3
"""Where a step of the PyTorch port's models spends its time on the card.

Builds the flagship coupled model (``chip_smoke.flagship``) at
``--nx`` on the first CUDA card, in one or more configurations:

  k1      the matmul-DFT with the hand-written complex-split kernel (f32,
          'split' precision, dense swap formulation) — the slice's main path;
  mxu     the matmul-DFT with the JAX package's defaults (no precision, no
          transform options: dotgen, four-step, even/odd, Gauss, 'high';
          ``chip_smoke.py`` phase 11a), which sends K1 nothing;
  k1eo    the even/odd K1 configuration (``chip_smoke.K1_EVENODD``, 'split'
          precision; phase 11c): K1 takes the dense x-passes and the
          half-length DFTs;
  cufft   the same model on ``torch.fft`` (cuFFT), f32;
  sharded the sharded flagship of ``chip_smoke.py`` phase 7: four ranks in
          four processes (rank r on card r % device_count), f32 on the
          pencil FFT with K2 as the transpose
          (``transform_opts={"pallas_a2a": True, "overlap_chunks": 2}``);
          rank 0 is profiled while all four step;
  uncoupled, ql, ybj
          the other wave models with the flagship's physics in the k1
          configuration, in their default quirk modes (``chip_smoke.py``
          phase 8);
  qg      ``QGModel`` with its passive scalar (``chip_smoke.qg_flagship``),
          f32 on cuFFT.

Each configuration runs in one or both ``--forms``:

  eager   a loop of ``kernel.step`` from Python, every operation launched
          from the host (the per-step path);
  graph   ``run_steps``: on one card, replays of the step's CUDA graph
          (``niwqg_tpu_torch/graphs.py``); the sharded configuration has
          no graph form (a mesh calls the step directly).

For each it times ``--steps`` steps with the host clock (closed by a
synchronise, on a mesh also by a barrier), then profiles ``--steps`` more
with ``torch.profiler`` and prints the device time per step grouped by
kernel family (the K1 kernel, the K2 kernel, cuBLAS/CUTLASS GEMMs, FFTs,
NCCL, copies and transposes, the rest) with the device's idle share, and the top kernels. A
Chrome trace per configuration and form goes to ``--out``.

    python3 tools/profile_torch_step.py --nx 2048 --out output_profile
    python3 tools/profile_torch_step.py --configs cufft,qg,k1 --forms eager,graph
    python3 tools/profile_torch_step.py --configs sharded --forms eager

``--root DIR`` imports ``niwqg_tpu_torch`` from another checkout (one
unpacked with ``git archive``, say the parent commit), so that one call
can time the eager step of two trees in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, ROOT)

from chip_smoke import (K1_EVENODD, K1_TRANSFORM, NRANKS,  # noqa: E402
                        SHARD_OPTS, flagship, qg_flagship)

K1_CONFIG = dict(backend="mxu", precision="split", transform_opts=K1_TRANSFORM)
# configuration -> (model module of niwqg_tpu_torch, its keywords)
CONFIGS = {
    "k1": ("CoupledModel", K1_CONFIG),
    "mxu": ("CoupledModel", dict(backend="mxu")),
    "k1eo": ("CoupledModel", dict(backend="mxu", precision="split",
                                  transform_opts=K1_EVENODD)),
    "cufft": ("CoupledModel", dict(backend="native")),
    "sharded": ("CoupledModel", dict(backend="native", fast=True,
                                     transform_opts=SHARD_OPTS)),
    "uncoupled": ("UnCoupledModel", K1_CONFIG),
    "ql": ("QLModel", K1_CONFIG),
    "ybj": ("YBJModel", K1_CONFIG),
    "qg": ("QGModel", dict(backend="native")),
}


def family(name: str) -> str:
    n = name.lower()
    if "csplit_mm" in n:
        return "K1 csplit_mm"
    if "a2a_kernel" in n:
        return "K2 a2a"
    if "nccl" in n:
        return "NCCL"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "sm90_xmma" in n:
        return "GEMM (torch.matmul)"
    if "fft" in n:
        return "FFT (cuFFT)"
    if any(w in n for w in ("copy", "memcpy", "catarray", "flip", "roll",
                            "transpose")):
        return "copies and transposes"
    return "other (elementwise, reductions)"


def advance(m, form, n):
    """``n`` steps of model ``m`` in one form (see the module docstring)."""
    if form == "graph":
        m.run_steps(n)
        return
    for _ in range(n):
        m.state = m.kernel.step(m.state)


def profile(name, nx, steps, out_dir, mesh=None, forms=("eager",)):
    """Time and profile ``steps`` steps of one configuration in each form;
    on a mesh every rank steps and rank 0 alone is profiled and reports.
    Returns the model and rank 0's results, one per form."""
    import torch
    from torch.profiler import ProfilerActivity

    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    model, kw = CONFIGS[name]
    kw = dict(kw)
    if mesh is not None:
        kw["mesh"] = mesh
    build = qg_flagship if model == "QGModel" else flagship
    m = build(getattr(pkg, model), ic, nx=nx, dtype=np.float32, **kw)

    def sync():
        torch.cuda.synchronize()
        if mesh is not None:
            mesh.barrier()

    out = []
    for form in forms:
        if form == "graph" and (mesh is not None or not getattr(
                getattr(m, "_runner", None), "graphs", False)):
            raise ValueError(f"{name}: no graph form here (a mesh, or a "
                             "tree without niwqg_tpu_torch/graphs.py)")
        advance(m, form, 2)  # warm-up (the graph form captures)
        sync()
        t0 = time.perf_counter()
        advance(m, form, steps)
        sync()
        wall = (time.perf_counter() - t0) / steps
        if not (mesh is None or mesh.rank == 0):
            advance(m, form, steps)
            sync()
            continue
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
            t0 = time.perf_counter()
            advance(m, form, steps)
            sync()
            wall_prof = (time.perf_counter() - t0) / steps
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{name}_{form}.json"))
        out.append(summarize(prof, f"{name} ({form})", nx, steps, wall,
                             wall_prof))
    return m, out


def summarize(prof, name, nx, steps, wall, wall_prof):
    from torch.autograd import DeviceType

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
          f"{max(0.0, 1.0 - busy_ms / (1e3 * wall_prof)):.3f}", flush=True)
    for f, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"   {us / 1e3:9.2f} ms/step  {100 * us / 1e3 / busy_ms:5.1f}%"
              f"  {f}")
    print("   top kernels (ms/step, launches/step, name):")
    for us, cnt, key in sorted(kernels, reverse=True)[:8]:
        print(f"   {us / 1e3:9.3f}  {cnt:5d}  {key[:110]}", flush=True)
    return dict(config=name, nx=nx, ms_per_step=1e3 * wall,
                ms_per_step_profiled=1e3 * wall_prof, device_busy_ms=busy_ms,
                families_ms={f: us / 1e3 for f, us in fam.items()})


def _sharded_rank(rank, port, nx, steps, out_dir, result):
    """One rank of the sharded configuration (a child process)."""
    import torch

    os.environ.setdefault("NIWQG_TORCH_TABLE_CACHE", "0")
    os.environ.setdefault("NIWQG_ETDRK4_WORKERS", "2")
    from niwqg_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", NRANKS, rank, timeout_s=300)
    mesh = multihost.global_mesh()
    torch.cuda.set_device(mesh.device)
    m, res = profile("sharded", nx, steps, out_dir, mesh)
    if res:
        res = res[0]
        res["ranks"] = NRANKS
        res["backend"] = str(torch.distributed.get_backend())
        with open(result, "w") as fh:
            json.dump(res, fh)
    if m.kernel.tr._group is not None:
        m.kernel.tr._group.close()
    multihost.shutdown()


def profile_sharded(nx, steps, out_dir):
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="profile_sharded_")
    result = os.path.join(tmp, "rank0.json")
    with socket.socket() as sock:  # a free port for the rendezvous
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        mp.spawn(_sharded_rank, args=(port, nx, steps, out_dir, result),
                 nprocs=NRANKS, join=True)
        with open(result) as fh:
            return json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--configs", default="k1,cufft")
    ap.add_argument("--forms", default="eager,graph",
                    help="eager, graph or both (the sharded configuration "
                         "takes eager only)")
    ap.add_argument("--root", default=None,
                    help="import niwqg_tpu_torch from this checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "output_profile"))
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    forms = tuple(args.forms.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device available", file=sys.stderr)
        return 1
    # no disk cache of the ETDRK4 tables: write nothing outside the build
    os.environ.setdefault("NIWQG_TORCH_TABLE_CACHE", "0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    import niwqg_tpu_torch

    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f"; package {os.path.dirname(niwqg_tpu_torch.__file__)}")
    res = []
    for c in args.configs.split(","):
        if c == "sharded":
            res.append(profile_sharded(args.nx, args.steps, args.out))
        else:
            res += profile(c, args.nx, args.steps, args.out, forms=forms)[1]
    print(json.dumps({"card": card, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
