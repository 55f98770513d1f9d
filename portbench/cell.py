"""One run of a cell on one rank: build the configuration's model, set the
seed's initial fields, warm up, measure the window, trace a stretch after
it (``--trace 1``), then hold what the run produced to the plain reference
(``check.py``) once the program's state is freed.

The window drives the traffic mix's loop: ``Model.run_with_snapshots``
with a yield every ``yield_every`` steps, the diagnostics sampled on the
device every ``tdiags`` steps and the status line every ``twrite``. Its
number of steps is fixed before it opens, from the warm-up's rate (on a
mesh the slowest rank's) and ``--seconds``, in whole yields, so that every
rank takes the same steps. It closes with a synchronise of every card; on
a mesh the slowest rank's window counts.

The warm-up and the traced stretch are the harness's, the same for every
traffic mix: see the constants below.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench import check, spec, trace

# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "niwqg_tpu")
# the program's cache directories, fixed inside the checkout
CACHE = os.path.join(spec.HERE, ".cache")
# the warm-up: at least WARMUP_YIELDS yields and at most WARMUP_MAX_YIELDS,
# until the last RATE_YIELDS captured no graph; their rate sizes the window
WARMUP_YIELDS, WARMUP_MAX_YIELDS, RATE_YIELDS = 3, 6, 2
# the yields traced after the window (--trace 1)
TRACE_YIELDS = 2
# the loop's length is fixed when it starts, before the rate is known: it
# holds a window of --seconds at up to this many steps a second
MAX_STEPS_PER_S = 2000


@dataclasses.dataclass
class Job:
    """What every rank of one run is given."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    t_start: float                 # wall clock at the process's start
    device: str = "cuda"           # "cpu" only in the tests
    overrides: dict = dataclasses.field(default_factory=dict)
    prepare: Optional[str] = None  # "module:function" run in every rank
                                   # before the model is built (tests)


def cache_env():
    """Point the program's caches at fixed directories of the checkout."""
    env = os.environ
    env.setdefault("NIWQG_TORCH_TABLE_CACHE", os.path.join(CACHE, "etdrk4"))
    env.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    env.setdefault("TORCH_EXTENSIONS_DIR",
                   os.path.join(CACHE, "torch_extensions"))


def resolve(job: Job):
    """``(cell, config, traffic)`` with the job's overrides applied."""
    bench = spec.benchmark()
    cell = spec.cell(bench, job.workload)
    cfg = spec.config(cell["config"])
    trf = spec.traffic(cell["traffic"])
    ov = job.overrides
    cfg["model"] = {**cfg["model"], **ov.get("model", {})}
    trf = {**trf, **ov.get("traffic", {})}
    return cell, cfg, trf


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _clone(s):
    """A state (nested ``NamedTuple`` of tensors) of fresh copies."""
    if torch.is_tensor(s):
        return s.clone()
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*[_clone(v) for v in s])
    return s


class Ranks:
    """This rank in the run's mesh (``mesh`` None: one process)."""

    def __init__(self, mesh, device):
        self.mesh, self.device = mesh, device
        self.rank = 0 if mesh is None else mesh.rank
        self.n = 1 if mesh is None else mesh.nP

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.mesh is not None:
            self.mesh.barrier()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def reduce(self, x: float, op: str) -> float:
        if self.mesh is None:
            return float(x)
        import torch.distributed as dist

        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self.mesh.device)
        return float(self.mesh.all_reduce(
            t, getattr(dist.ReduceOp, op)).item())

    def gather(self, obj) -> list:
        return [obj] if self.mesh is None else self.mesh.all_gather_object(
            obj)


def _check_program():
    """Raise unless the program's package is this checkout's."""
    import niwqg_tpu_torch

    where = os.path.dirname(os.path.abspath(niwqg_tpu_torch.__file__))
    if os.path.dirname(where) != spec.ROOT:
        raise RuntimeError(f"niwqg_tpu_torch imported from {where}, not "
                           f"from this checkout ({spec.ROOT})")


def build(cfg: dict, trf: dict, job: Job, R: Ranks, steps_cap: int):
    """The configuration's model with the traffic mix's cadence, set to
    the seed's initial fields; returns ``(model, initial fields)``."""
    _check_program()
    mod = importlib.import_module("niwqg_tpu_torch." + cfg["class"])
    kw = dict(cfg["model"])
    kw["dtype"] = np.dtype(kw["dtype"])
    dt = float(kw["dt"])
    m = mod.Model(tdiags=int(trf["tdiags"]), twrite=int(trf["twrite"]),
                  tmax=dt * (steps_cap + 0.5), device=R.device, mesh=R.mesh,
                  **kw)
    initial = trf["initial"]
    gen = importlib.import_module("portbench.initial." + initial["kind"])
    fields = gen.make(int(kw["nx"]), float(kw["L"]), job.seed, initial,
                      R.device)
    ref = importlib.import_module("portbench.reference." + cfg["reference"])
    for name in ref.FIELDS:  # the upstream's order: set_q, then set_phi
        getattr(m, "set_" + name)(fields[name].cpu().numpy())
    return m, fields


def outputs(m, s, fields, budgets) -> dict:
    """The program's fields and budget integrals of state ``s`` on the
    host (on a mesh gathered: every rank calls)."""
    live, m.state = m.state, s
    try:
        out = {k: np.asarray(getattr(m, k)) for k in fields}
        out.update({k: float(getattr(m, k)) for k in budgets})
    finally:
        m.state = live
    return out


def run(job: Job, rank: int = 0, nranks: int = 1, port: int = 0):
    """One rank's part of a run; returns the result on rank 0, else
    ``None``."""
    cache_env()
    cell, cfg, trf = resolve(job)
    if job.prepare:
        mod, fn = job.prepare.split(":")
        getattr(importlib.import_module(mod), fn)()
    mesh = None
    if nranks > 1:
        from niwqg_tpu_torch.parallel import multihost

        multihost.initialize(f"localhost:{port}", nranks, rank,
                             device=job.device if job.device == "cpu"
                             else None, timeout_s=600)
        mesh = multihost.global_mesh(
            device=job.device if job.device == "cpu" else None)
        device = mesh.device
    else:
        device = torch.device("cuda", 0) if job.device == "cuda" else \
            torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    R = Ranks(mesh, device)
    try:
        return _run(job, cell, cfg, trf, R, time.time())
    finally:
        if mesh is not None:
            from niwqg_tpu_torch.parallel import multihost

            multihost.shutdown()


def _run(job, cell, cfg, trf, R: Ranks, t_up: float):
    ref_mod = importlib.import_module("portbench.reference."
                                      + cfg["reference"])
    Y = int(trf["yield_every"])
    dt = float(cfg["model"]["dt"])
    n_max = Y * math.ceil(MAX_STEPS_PER_S * job.seconds / Y)
    cap = Y * (WARMUP_MAX_YIELDS + TRACE_YIELDS + 1) + n_max
    m, fields0 = build(cfg, trf, job, R, cap)
    t_built = time.time()
    gen = m.run_with_snapshots(tsnapstart=0.0, tsnapint=(Y - 0.5) * dt)
    runner = m._runner

    # warm-up: every graph variant captured, then the rate
    times, start_out = [], None
    for y in range(WARMUP_MAX_YIELDS):
        before = runner.variants()
        R.sync()
        t0 = time.perf_counter()
        next(gen)
        R.sync()
        times.append((time.perf_counter() - t0,
                      runner.variants() != before))
        if y == 0:
            # the first stretch, for the check: the state after it
            start_out = outputs(m, m.state, ref_mod.FIELDS, ())
        recent = times[-RATE_YIELDS:]
        settled = (len(times) >= WARMUP_YIELDS
                   and not any(new for _, new in recent))
        if R.reduce(0.0 if settled else 1.0, "MAX") == 0.0:
            break
    rate = Y * len(recent) / sum(t for t, _ in recent)
    rate = R.reduce(rate, "MIN")
    n_yields = max(2, round(rate * job.seconds / Y))
    if n_yields * Y > n_max:
        raise RuntimeError(f"{rate:.1f} steps/s would take "
                           f"{n_yields * Y} steps, more than the loop holds "
                           f"({n_max}: MAX_STEPS_PER_S)")
    variants0 = runner.variants()
    tc_open = m.tc

    # the window
    R.sync()
    t_open_wall = time.time()
    setup_parts = {"start_to_rank_up": t_up - job.t_start,
                   "model_and_fields": t_built - t_up,
                   "warmup": t_open_wall - t_built}
    t_open = time.perf_counter()
    for k in range(n_yields):
        next(gen)
        if k == n_yields - 2:
            mid, tc_mid = _clone(m.state), m.tc
    if R.device.type == "cuda":
        torch.cuda.synchronize(R.device)
    window = time.perf_counter() - t_open
    window = R.reduce(window, "MAX")
    end = _clone(m.state)
    peak = (torch.cuda.max_memory_allocated(R.device)
            if R.device.type == "cuda" else 0)
    counters = {"replays": runner.replays, "graphs": runner.graphs,
                "variants": runner.variants(),
                "captures_in_window": runner.variants() != variants0,
                "capture_ms": runner.capture_ms(),
                "diag_fetches": m._diag_acc.fetches,
                "warmup_yields": len(times), "tc_open": tc_open,
                "setup_parts_s": setup_parts}
    bad = forbidden_modules()

    traced = census = None
    if job.trace:
        R.sync()
        with trace.traced() as prof:
            for _ in range(TRACE_YIELDS):
                next(gen)
            if R.device.type == "cuda":
                torch.cuda.synchronize(R.device)
        dev, host = trace.events(prof)
        traced = trace.summarize(dev, host, TRACE_YIELDS * Y)
        del prof, dev, host
    gen.close()
    if job.trace:
        census = _census(m, R)

    # the program's outputs, on the host; then its state is freed
    diag_names = cfg["compare"]["diagnostics"]
    series = {k: np.asarray(v["value"], dtype=np.float64)
              for k, v in m.diagnostics.items() if k in diag_names}
    mid_out = outputs(m, mid, ref_mod.FIELDS, ref_mod.BUDGETS)
    end_out = outputs(m, end, ref_mod.FIELDS, ())
    finite = all(np.isfinite(end_out[k]).all() for k in ref_mod.FIELDS)
    del mid, end, gen, runner
    group = getattr(m.kernel.tr, "_group", None)
    del m
    from niwqg_tpu_torch.graphs import release_all

    if R.device.type == "cuda":
        release_all()
    gc.collect()
    if R.device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, a segment per rank in turn
    tdiags = int(trf["tdiags"])
    segments = [
        ("start", 0, lambda ref: ref.start(**fields0), start_out),
        ("end", tc_mid, lambda ref: ref.resume(
            **{k: torch.as_tensor(mid_out[k], device=R.device)
               for k in ref_mod.FIELDS},
            **{k: mid_out[k] for k in ref_mod.BUDGETS}), end_out),
    ]
    nums, detail = {}, {}
    t_ref = time.perf_counter()
    params = ref_mod.params_from(cfg["model"])
    for i, (name, tc0, first, prog) in enumerate(segments):
        if i % R.n != R.rank:
            continue
        ref = ref_mod.Reference(params, R.device, "f64")
        s, ref_series = ref_mod.run_segment(ref, first(ref), Y, tdiags, tc0)
        j0 = tc0 // tdiags
        prog_series = {k: v[j0:j0 + len(ref_series[k])]
                       for k, v in series.items()}
        n, dtl = check.segment_numbers(
            name, {k: prog[k] for k in ref_mod.FIELDS},
            ref_mod.physical(s),
            prog_series, {k: v.numpy() for k, v in ref_series.items()},
            diag_names)
        nums.update(n)
        detail[name] = dtl
        del ref, s
    t_ref = time.perf_counter() - t_ref
    if group is not None:
        group.close()

    rec = dict(rank=R.rank, window=window, peak=peak, traced=traced,
               census=census, counters=counters, forbidden=bad,
               nums=nums, detail=detail, finite=finite, ref_s=t_ref)
    recs = R.gather(rec)
    if R.rank != 0:
        return None
    return dict(records=recs, steps=n_yields * Y, window=window,
                setup_s=t_open_wall - job.t_start, rate=rate, cell=cell,
                cfg=cfg, trf=trf)


def _census(m, R: Ranks) -> dict:
    """The transform fields and exchange bytes of one eager step (every
    rank; the model's state advances by it)."""
    from niwqg_tpu_torch.parallel import a2a
    from niwqg_tpu_torch.utils.census import step_census

    c = step_census(m)
    K = m.kernel
    cards = R.n
    if R.device.type == "cuda" and R.n > 1:
        cards = min(R.n, torch.cuda.device_count())
    return {
        "counts": c["census"], "nx": c["nx"], "ranks": c["P"],
        "cards": cards, "itemsize": c["itemsize"],
        "half_width": c["nx"] // 2 + 1 + getattr(K.tr, "rfft_pad", 0),
        "k2_bytes": sum(c["transport_bytes"].get(k, 0) for k in a2a.KINDS),
        "k2_launches": c["k2_launches"],
        "transposed_fields": c["transposed_fields_per_step"],
        "transport_over_model": c["transport_over_model"],
    }
