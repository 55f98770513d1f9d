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
  mxu-mesh, k1-mesh
          the same four ranks with the matmul-DFT on the mesh
          (``backend='mxu'``, ``chip_smoke.py`` phase 12): JAX's default
          options, and the K1 configuration, each with K2 as the
          transpose;
  sharded-default, mxu-mesh-default
          ``sharded`` and ``mxu-mesh`` on the mesh's default route
          (``transform_opts={"overlap_chunks": 2}``, no ``pallas_a2a``):
          NCCL's ``all_to_all_single``, ``all_reduce`` and the
          reflection's uneven exchange where every rank has its own card;
  uncoupled, ql, ybj
          the other wave models with the flagship's physics in the k1
          configuration, in their default quirk modes (``chip_smoke.py``
          phase 8);
  qg      ``QGModel`` with its passive scalar (``chip_smoke.qg_flagship``),
          f32 on cuFFT.

Each configuration runs in one or both ``--forms``:

  eager   a loop of ``kernel.step`` from Python, every operation launched
          from the host (the per-step path);
  graph   ``run_steps``: replays of the step's CUDA graph
          (``niwqg_tpu_torch/graphs.py``), on one card and, on every rank,
          for the mesh configurations (K2's exchanges, or NCCL's on the
          default route; not gloo's, where ranks share a card).

For each it times ``--steps`` steps with the host clock (closed by a
synchronise, on a mesh also by a barrier), then profiles ``--steps`` more
with ``torch.profiler`` and prints the device time per step grouped by
kernel family (``portbench/metrics/arithmetic.family``: the K1 kernel, the
K2 kernel, cuBLAS/CUTLASS GEMMs, FFTs, NCCL, copies and transposes, the
rest) with the device's idle share, and the top kernels. A Chrome trace per
configuration and form goes to ``--out``.

    python3 tools/profile_torch_step.py --nx 2048 --out output_profile
    python3 tools/profile_torch_step.py --configs cufft,qg,k1 --forms eager,graph
    python3 tools/profile_torch_step.py --configs sharded --forms eager
    python3 tools/profile_torch_step.py --configs mxu-mesh,k1-mesh --forms graph
    python3 tools/profile_torch_step.py --configs sharded-default,mxu-mesh-default
    python3 tools/profile_torch_step.py --nx 4096 --configs cufft,mxu --forms graph

The ETDRK4 tables' disk cache lives in a directory of the run's own,
removed at its end, so that the configurations and a mesh's ranks build
the tables once.

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

from chip_smoke import (DEFAULT_FLAGSHIP, DEFAULT_MXU_MESH_RUNS,  # noqa: E402
                        K1_EVENODD, K1_MESH_MODEL, K1_TRANSFORM,
                        MXU_MESH_MODEL, NRANKS, SHARD_OPTS, flagship,
                        qg_flagship)
# the benchmark's classifier of kernels by name
from portbench.metrics.arithmetic import family  # noqa: E402

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
    "mxu-mesh": ("CoupledModel", {k: v for k, v in MXU_MESH_MODEL.items()
                                  if k != "dtype"}),
    "k1-mesh": ("CoupledModel", {k: v for k, v in K1_MESH_MODEL.items()
                                 if k != "dtype"}),
    "sharded-default": ("CoupledModel", {k: v for k, v in
                                         DEFAULT_FLAGSHIP.build.items()
                                         if k != "dtype"}),
    "mxu-mesh-default": ("CoupledModel", {
        k: v for k, v in DEFAULT_MXU_MESH_RUNS[0].build.items()
        if k != "dtype"}),
    "uncoupled": ("UnCoupledModel", K1_CONFIG),
    "ql": ("QLModel", K1_CONFIG),
    "ybj": ("YBJModel", K1_CONFIG),
    "qg": ("QGModel", dict(backend="native")),
}


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
        if form == "graph" and not getattr(getattr(m, "_runner", None),
                                           "graphs", False):
            raise ValueError(f"{name}: no graph form here (a tree without "
                             "graphs on this layout)")
        # warm-up: the graph form captures, on a mesh each variant of K2's
        # buffer parities, and uploads each graph at its first replay
        advance(m, form, 4)
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

    # a host span (record_function: the program's spans among them) is
    # mirrored on the device's timeline as an annotation, no device work
    spans = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    fam, kernels = {}, []
    for evt in prof.key_averages():
        # device-side events only: CPU operators carry their kernels'
        # device time too, and would count it twice
        if (evt.device_type != DeviceType.CUDA or evt.key in spans
                or getattr(evt, "is_user_annotation", False)):
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


MESH_CONFIGS = ("sharded", "mxu-mesh", "k1-mesh", "sharded-default",
                "mxu-mesh-default")


def _sharded_rank(rank, port, name, nx, steps, out_dir, result, forms):
    """One rank of a mesh configuration (a child process)."""
    import torch

    os.environ.setdefault("NIWQG_ETDRK4_WORKERS", "2")
    from niwqg_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", NRANKS, rank, timeout_s=300)
    mesh = multihost.global_mesh()
    torch.cuda.set_device(mesh.device)
    m, res = profile(name, nx, steps, out_dir, mesh, forms)
    if res:
        for r in res:
            r["ranks"] = NRANKS
            r["backend"] = str(torch.distributed.get_backend())
        with open(result, "w") as fh:
            json.dump(res, fh)
    if m.kernel.tr._group is not None:
        m.kernel.tr._group.close()
    multihost.shutdown()


def profile_sharded(name, nx, steps, out_dir, forms):
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="profile_sharded_")
    result = os.path.join(tmp, "rank0.json")
    with socket.socket() as sock:  # a free port for the rendezvous
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        mp.spawn(_sharded_rank,
                 args=(port, name, nx, steps, out_dir, result, forms),
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
                    help="eager, graph or both")
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
    # the ETDRK4 tables' disk cache in a directory of this run's own,
    # removed at the end: the configurations (and a mesh's ranks, which cut
    # their columns from the global tables) share one build of the tables,
    # which takes tens of seconds at 4096²
    tables = tempfile.mkdtemp(prefix="niwqg_tables_")
    os.environ["NIWQG_TORCH_TABLE_CACHE"] = tables
    try:
        return _profile_all(args, forms, torch)
    finally:
        shutil.rmtree(tables, ignore_errors=True)


def _profile_all(args, forms, torch) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    import niwqg_tpu_torch

    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f"; package {os.path.dirname(niwqg_tpu_torch.__file__)}")
    res = []
    for c in args.configs.split(","):
        if c in MESH_CONFIGS:
            res += profile_sharded(c, args.nx, args.steps, args.out, forms)
        else:
            res += profile(c, args.nx, args.steps, args.out, forms=forms)[1]
            torch.cuda.empty_cache()  # the next model's room at 4096²
    print(json.dumps({"card": card, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
