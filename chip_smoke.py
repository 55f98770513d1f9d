#!/usr/bin/env python3
"""Drive the PyTorch port (``niwqg_tpu_torch``) on NVIDIA cards and check it.

Run from the root of a checkout, with no arguments; one card is enough,
and with more the sharded phases spread their four ranks over up to four::

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and the float32 matmul settings (TF32 off);
  2. build every CUDA source of the port with ``nvcc``;
  3. the complex-split matmul (K1), each of its two kernels against the
     plain PyTorch version of its route: the tensor-core kernel against
     the bf16-operand plain version and the complex128 product at the main
     path's shape (2048x2048 @ 2048x2048, the DFT matrix as B), at the
     even/odd configuration's half-length DFT (2048x1024 @ 1024x1024,
     phase 11c) and a ragged one, the f32-FMA kernel against the f32 plain
     version at a shape that takes that route, and a sum of 2048 equal
     terms (the mean mode); then the times at 2048³ and at 2048x1024x1024
     of both kernels, both plain versions and one library call (complex64
     ``torch.matmul``), with two bounds: the
     twelve split products on the bf16 tensor cores (24*M*N*K flop, the
     ``bound_ms`` of the result line) and one complex product on f32 FMAs
     (8*M*N*K flop);
  4. the main path: the flagship coupled model at 2048² through
     ``CoupledModel.Model`` in the configuration that runs K1 (matmul-DFT,
     f32, 'split' precision, dense swap formulation), 2 warm-up steps and
     3 timed ones, with K1's launch count per step, every launch on the
     tensor-core route;
  5. the same model in f64 on cuFFT (``backend='native'``), 2 steps, held
     against the f32 K1 run; and in f32 on cuFFT, the one-card reference
     of the sharded run, with its steps per second;
  6. the all-to-all kernel (K2) against its plain version, four ranks in
     this process on ``min(4, device_count)`` cards: the sharded path's
     shape (3 fields, R=512, W=512, complex64), one whose rows leave a
     short last group of tasks, a complex128 one, two ragged ones (one
     on the 8-byte path) and sharded QG's block (4 fields, R=512, W=257,
     the 8-byte path, timed too), both directions, bit-exact; then forward and
     inverse 50 times back to back with no host synchronise; its time per
     launch on the device (CUDA events around calls enqueued behind a
     device-side sleep) and per call on the host, the old host-clock figure
     (back-to-back calls closed by a synchronise, the first design's), the
     plain version's time and the bound (bytes: each block read and
     written once in HBM, the share that changes cards over NVLink);
  7. the sharded main path: four ranks in four processes, the flagship at
     2048² in f32 on the pencil FFT, first with K2 as the transpose
     (``transform_opts={"pallas_a2a": True, "overlap_chunks": 2}``), then
     with the default ``all_to_all_single`` route; 2 warm-up and 3 timed
     steps each, K2's launch count per step (the counts set to 0 just
     before the model is built) and per path (all aligned), the gathered
     state against the one-card f32 run and the f64 run, and the two routes
     against each other; K2's time in that layout, both directions, on the
     device and on the host as in phase 6. Where every rank has its own
     card it also times NCCL's ``all_to_all_single`` on the forward's and
     the inverse's blocks (``library_ms``), and K2's ``ms`` in the result
     line is this layout's device time; otherwise it is phase 6's. On the
     K2 route every rank then checkpoints the sharded state (the in-memory
     tree, a collective), takes 2 steps, loads the checkpoint and takes the
     same 2 steps again: bitwise equal, with K2's launches per step
     unchanged (they count in ``launches``). In the same K2 spawn every
     rank then drives ``QGModel`` with its passive scalar
     (``qg_flagship``) and ``UnCoupledModel`` (default quirks, fast
     kernel, the flagship's physics with the packet) at 2048² in f32 on
     the K2 route, each with K2's counts set to 0 just before it: steps/s
     over 2 warm-up and 3 timed steps, K2's launches per step against
     ``K2_PER_STEP_FAMILY`` (QG's all on the ragged path, UnCoupled's all
     aligned, no plain-version call), the gathered fields after 2 steps
     against the one-card f32 cuFFT run (``SHARD_RTOL``), QG's checkpoint
     round trip bitwise; then K2 alone at QG's block shape, each
     direction bit-exact against its plain version and timed on the
     device (with NCCL at the same blocks in the default route's spawn
     where every rank has its own card). Their launches count in the
     result line's ``launches`` too;
  8. the model family at 2048² with the flagship's physics, each model in
     its default ``faithful_quirks`` mode: ``UnCoupledModel``, ``QLModel``
     and ``YBJModel`` in the K1 configuration of phase 4, their phi the
     flagship's plus a wave packet (non-zero gradients, which UnCoupled
     carries stale from ``set_phi``) (2 warm-up and 3 timed steps, steps
     per second, K1's launches per step against the count the CPU tests
     hold to JAX's trace, every launch on the tensor-core route, no
     plain-version call), each held after 2 steps against the same model
     in f64 on cuFFT (q, phi and Ke, with Pw and Kw shown beside them;
     YBJ: phi, and q bitwise what ``set_q`` gave); then ``QGModel`` with its passive
     scalar (beta=1e-11, a plane-wave tracer) in f32 on cuFFT, timed the
     same way, against its f64 cuFFT run (q, c, Ke and cvar);
  9. output and checkpoints: a fresh flagship in the K1 configuration of
     phase 4 with a diagnostics sample every step, ``run_with_snapshots``
     over 6 steps with t, q and phi written as ``.npy`` files every 2 by
     the step loop through an ``io.Saver`` with ``npy-async`` snapshots
     (the HDF5 setup and diagnostics files, which need h5py, are left to
     the CPU tests) and a checkpoint at step 2 (the in-memory tree); the
     last snapshot bitwise the live fields; the checkpoint
     loaded and ``run()`` to tmax bitwise the first pass (q, phi, Ke, Pw,
     Kw, every diagnostic series); K1's launches per step (40, and 8 a
     diagnostics sample), none from a snapshot, all on the tensor-core
     route; steps/s beside phase 4's, ms per snapshot, the checkpoint's
     size and its save and load ms;
 10. the run path, on six configurations at 2048² that phases 4, 5 and 8
     build and step (the coupled model in the K1 configuration and on f32
     cuFFT with ``q_half``, UnCoupled, QL and YBJ in the K1 configuration
     with the packet, QG + scalar on f32 cuFFT), each held inside its
     phase, before the model is freed (``--phases 10`` alone builds
     them): ``run()`` with a diagnostics sample every step and a status
     line every 5, and ``run_steps``, 10 steps each from one in-memory
     checkpoint, as replayed CUDA graphs held to the eager loop
     (``_step_forward``, ``kernel.step``) bit for bit (1e-6 where not);
     K1's launches in every run against the eager loop's, and in one
     replay of each graph against the pins; diagnostics fetches per chunk,
     steps/s with graphs and eagerly, capture ms and peak memory;
 11. the matmul-DFT's options at 2048², each model built with K1's counts
     set to 0 and held after 2 steps to its f64 cuFFT run of phases 5 and
     8 (1e-4 on q, phi/c, Ke): (a) JAX's defaults (``MXU_MODEL``: dotgen,
     a (128, 16) four-step, even/odd over a (128, 8) one, Gauss, 'high'
     = one float32 GEMM with TF32 off, ``max_batch=1``) on all five
     models, the options as resolved printed and checked, no K1 launch,
     the Coupled model also through phase 10's check; (b) the mirror-free
     real path forced on the Coupled model; (c) the even/odd K1
     configuration (``K1_EVENODD_MODEL``) on Coupled and QG + scalar,
     ``K1_PER_STEP_EVENODD`` launches a step, all on the tensor-core
     route; steps/s of each over 3 timed steps; then (d) a table of the
     routes at 2048 (``transform_table``): dense and four-step passes,
     each real path, Gauss on and off, each precision mode, the K1
     configurations and cuFFT, with round-trip ms and the error against
     complex128 ``torch.fft``.

On one card every ``run_steps``, ``run`` and ``run_with_snapshots``
above replays the step's CUDA graphs (``niwqg_tpu_torch/graphs.py``).
K1's kernels count their own launches on the card, so a replayed launch
counts as any other (``csplit_mm.counts``). K1's ``launches`` in the
result line counts phases 4, 8, 9 and 11, each with its graph runs. The
ETDRK4 tables' disk cache lives in a directory of the run's own, removed
at its end, so models of one physics share their tables.

The line before the last holds the card's name and power limit; the one
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NX = 2048
U0 = 0.05
DT = 157.0
WARM_STEPS = 2
TIMED_STEPS = 3
K1_PER_STEP = 40  # 20 complex 2-D transforms x 2 passes (see PERF.md)
# a diagnostics sample of the coupled model: stage_sources' 2 fields and
# the registry's 2, both passes
K1_PER_DIAG = 8
IO_STEPS, IO_SNAP_EVERY = 6, 2  # phase 9: tmax and the snapshot cadence
# K1 launches per step of the other wave models in their default quirk
# modes; tests/test_torch_models.py holds this table to JAX's trace
K1_PER_STEP_FAMILY = {"UnCoupledModel": 72, "QLModel": 48, "YBJModel": 38}
K1_TRANSFORM = dict(use_pallas=True, formulation="swap", factors=None,
                    half_factors=None)
# H100 SXM published peaks at 700 W (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12      # HBM3
K1_RTOL = 1e-5            # f32-FMA route vs the f32 plain version, max-abs
                          # error / max|ref| (f32 sums in another order)
K1_TC_RTOL = 2e-6         # tensor-core route vs the bf16 plain version (the
                          # same rounded operands, f32 sums in another order)
K1_EXACT_RTOL = 2e-5      # tensor-core route vs the complex128 product (bf16
                          # rounding of x, x_lo, y_lo: 2^-17..2^-16 a term)
K1_MEAN_RTOL = 2e-6       # a sum of K equal terms vs K times the term
CROSS_RTOL = 1e-4         # an f32 run vs the f64 cuFFT run after 2 steps
PEAK_LINK = 450e9         # NVLink, each way, per card
NRANKS = 4
K2_LEAD, K2_R, K2_W = 3, NX // NRANKS, NX // NRANKS  # the sharded path's shape
K2_PAIRS = 50             # forward + inverse, back to back
K2_SLEEP_CYCLES = 200_000_000  # ~0.1 s: the host enqueues the timed calls
# 4 stages x (3 forward + 2 inverse) transposes of the fast kernel on the
# pencil mesh (see PERF.md)
K2_FWD_PER_STEP, K2_INV_PER_STEP = 12, 8
# K2 launches (forward, inverse) per step and rank of two more models on the
# pencil mesh, in their default quirk modes: QG's 4 stages x 1 forward and
# 4 + 1 inverses, all on the ragged path (nx/2+1+pad columns); UnCoupled's
# fast kernel with its physical-space sources; tests/test_torch_sharded_models.py
# holds this table to JAX's trace
K2_PER_STEP_FAMILY = {"QGModel": (4, 5), "UnCoupledModel": (8, 16)}
SHARD_OPTS = {"pallas_a2a": True, "overlap_chunks": 2}
# QG's half-spectrum transposes on the mesh: nx/2+1 = 1025 columns padded to
# 1028, 257 a rank (complex64 rows of 2056 bytes: K2's ragged path); the
# stage inverse (u, v, q, c) and the forward of its 4 products
QG_WR = (NX // 2 + 1 + (-(NX // 2 + 1)) % NRANKS) // NRANKS
QG_LEAD = 4
# sharded f32 run vs the one-card f32 cuFFT run after 2 steps: the same
# arithmetic with sums and transforms taken in another order
SHARD_RTOL = 1e-5
ROUTE_RTOL = 1e-6         # K2 route vs all_to_all_single route, same steps
# phase 10: steps of each run, the status line's cadence (a chunk ends
# there), and the limit of a graph run against the eager loop where the
# two are not bitwise equal
GRAPH_STEPS, GRAPH_TWRITE = 10, 5
GRAPH_RTOL = 1e-6
# the cadence of the models that phase 10 holds (phases 4, 5 and 8 build
# them so): a sample every step, GRAPH_STEPS to tmax after a phase's steps
GRAPH_RUN = dict(tdiags=1, twrite=GRAPH_TWRITE,
                 tmax=(WARM_STEPS + TIMED_STEPS + GRAPH_STEPS) * DT)
GRAPH_LABEL = {"CoupledModel": "CoupledModel, K1 configuration",
               "q_half": "CoupledModel, f32 cuFFT, q_half",
               **{name: f"{name}, K1 configuration"
                  for name in K1_PER_STEP_FAMILY},
               "QGModel": "QGModel + scalar, f32 cuFFT"}
K1_MODEL = dict(backend="mxu", dtype=np.float32, precision="split",
                transform_opts=K1_TRANSFORM)
WAVE_FIELDS = ("q", "phi", "Ke")
# phase 11: the matmul-DFT with JAX's defaults (no precision, no
# transform_opts: dotgen, a (128, 16) four-step, even/odd over a (128, 8)
# half-length four-step, Gauss, 'high', max_batch=1), which sends K1
# nothing; and the even/odd K1 configuration, whose dense x-passes
# (2048, 2048, 2048) and half-length DFTs (2048, 1024, 1024) go to K1
MXU_MODEL = dict(backend="mxu", dtype=np.float32)
MXU_RESOLVED = dict(formulation="dotgen", factors=(128, 16),
                    half_factors=(128, 8), realpath="evenodd", gauss=True,
                    precision="high", max_batch=1, use_pallas=False)
K1_EVENODD = dict(use_pallas=True, formulation="dotgen", factors=None,
                  half_factors=None, evenodd=True)
K1_EVENODD_MODEL = dict(backend="mxu", dtype=np.float32, precision="split",
                        transform_opts=K1_EVENODD)
# K1 launches per step in the even/odd K1 configuration; QG's with its
# passive scalar; tests/test_torch_fft_options.py holds them to JAX's trace
K1_PER_STEP_EVENODD = {"CoupledModel": 52, "QGModel": 35}
TABLE_REPS = 5  # phase 11(d): round trips timed per configuration


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


def k2_times(torch, call, cards, reps, barrier=None):
    """Device ms per launch and host µs per call of ``call`` (one K2 call
    of this process's ranks, or any other call): ``reps`` calls enqueued
    behind a device-side sleep on each card, so that the device runs them
    back to back whatever the host's pace. Device: CUDA events on each
    card's current stream around every call, the mean interval after the
    first, on the slowest card. Host: ``time.perf_counter_ns`` around each
    call (no synchronise), mean and median after the first."""
    call()  # warm
    for d in cards:
        torch.cuda.synchronize(d)
    if barrier is not None:
        barrier()
    for d in cards:
        with torch.cuda.device(d):
            torch.cuda._sleep(K2_SLEEP_CYCLES)
    ev = {d: [] for d in cards}
    host = []

    def mark():
        for d in cards:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(d))
            ev[d].append(e)

    for _ in range(reps):
        mark()
        t0 = time.perf_counter_ns()
        call()
        host.append((time.perf_counter_ns() - t0) / 1e3)
    mark()
    for d in cards:
        torch.cuda.synchronize(d)
    dev = max(float(np.mean([a.elapsed_time(b) for a, b in
                             zip(ev[d][1:-1], ev[d][2:])])) for d in cards)
    return dev, float(np.mean(host[1:])), float(np.median(host[1:]))


def flagship(CoupledModel, ic, nx=NX, packet=False, **kw):
    """``__graft_entry__._build_coupled``'s configuration: Lamb dipole,
    U0=0.05, dt=157, L=2*pi*200 km, filter on, nu4=nu4w=7.5e9. With
    ``packet`` the constant phi gains a wave packet, so that the wave
    gradients (which a stale-gradient model carries from ``set_phi``) are
    not zero. ``kw`` may override the hyperviscosities and ``tmax``."""
    kw = {"nu4": 7.5e9, "nu4w": 7.5e9, "tmax": DT * 100, **kw}
    m = CoupledModel.Model(L=2 * np.pi * 200e3, nx=nx, dt=DT, m=1.0 / 325,
                           N=0.005, f=1e-4, use_filter=True, **kw)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    m.set_q(q)
    phi = (np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2)
    if packet:
        phi = phi + 5 * U0 * ic.WavePacket(m, k=2 * k0, l=k0, R=m.L / 6,
                                           x0=m.L / 2, y0=m.L / 2)
    m.set_phi(phi)
    return m


def qg_flagship(QGModel, ic, nx=NX, **kw):
    """The QG(+scalar) counterpart of ``flagship`` (its grid, dt and
    hyperviscosity), with ``__graft_entry__._run_qg``'s mean flow U=-U0,
    beta=1e-11 and plane-wave tracer. ``kw`` may override ``tmax``."""
    kw = {"tmax": DT * 100, **kw}
    m = QGModel.Model(L=2 * np.pi * 200e3, nx=nx, dt=DT, use_filter=True,
                      nu4=7.5e9, U=-U0, beta=1e-11, passive_scalar=True,
                      **kw)
    k0 = 10 * (2 * np.pi / m.L)
    m.set_q(ic.LambDipole(m, U=U0, R=2 * np.pi / k0))
    m.set_c(np.real(ic.PlaneWave(m, k=k0, l=k0)) * 1e-2)
    return m


def timed_steps(torch, m, fields):
    """WARM_STEPS steps, the state then, and TIMED_STEPS more on the host
    clock closed by a synchronise: ({field: value after warm-up},
    seconds)."""
    m.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    state = {k: getattr(m, k) for k in fields}
    t0 = time.perf_counter()
    m.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def cross(name, a, b, keys, shown=()):
    """Hold ``keys`` of the f32 run ``a`` to the f64 cuFFT run ``b`` at
    CROSS_RTOL; print ``shown`` beside them."""
    d = {}
    for k in keys + shown:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        d[k] = float(np.abs(x - y).max() / np.abs(y).max())
    log(f"{name} f32 vs f64 cuFFT after {WARM_STEPS} steps: "
        + ", ".join(f"{k} {d[k]:.3e}" for k in keys)
        + f" (relative; limit {CROSS_RTOL})"
        + "".join(f"; {k} {d[k]:.3e}" for k in shown))
    check(max(d[k] for k in keys) <= CROSS_RTOL,
          f"{name}: the f32 run disagrees with the f64 cuFFT run")


def model_fields(name):
    """(held, shown) fields of a model against its f64 run: YBJ holds phi
    (its q is frozen, it integrates no budgets), QG q, c, Ke and cvar, the
    other wave models q, phi and Ke with Pw and Kw shown beside them (with
    K1's bf16 rounding Pw ends step 1 about 2.5e-4 off its f64 run at
    2048²: tools/probe_wave_budgets.py, PERF.md)."""
    if name == "YBJModel":
        return ("phi",), ()
    if name == "QGModel":
        return ("q", "c", "Ke", "cvar"), ()
    return WAVE_FIELDS, ("Pw", "Kw")


def family_phase(torch, mm):
    """Phase 8: UnCoupled, QL and YBJ in the K1 configuration, QG (+scalar)
    in f32 on cuFFT, each against its f64 cuFFT run and held by phase 10's
    ``graph_check``. Returns the K1 launches of the three wave models, and
    the f64 runs' fields after WARM_STEPS steps by model."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    launches, refs = 0, {}
    for name, per_step in K1_PER_STEP_FAMILY.items():
        mod = getattr(pkg, name)
        fields, shown = model_fields(name)
        torch.cuda.reset_peak_memory_stats()
        mm.reset_counts()
        t0 = time.perf_counter()
        m = flagship(mod, ic, packet=True, **K1_MODEL, **GRAPH_RUN)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_set = mm.counts()["launches"]
        s32, wall = timed_steps(torch, m, fields + shown)
        count = mm.counts()
        n = count["launches"]
        n_steps = n - n_set
        launches += n
        log(f"{name} (K1 configuration, {type(m.kernel).__name__}): built "
            f"and initialised in {t_build:.1f} s; {TIMED_STEPS} steps in "
            f"{wall:.3f} s = {TIMED_STEPS / wall:.3f} steps/s "
            f"({1e3 * wall / TIMED_STEPS:.1f} ms/step); K1 launches: "
            f"set_q/set_phi {n_set}, steps {n_steps} "
            f"({n_steps / (WARM_STEPS + TIMED_STEPS):.1f}/step), "
            f"{count['launches_tc']} on the tensor-core route")
        check(count["cpu_calls"] == 0, f"{name}: K1 ran its plain version")
        check(n_steps == per_step * (WARM_STEPS + TIMED_STEPS),
              f"{name}: expected {per_step} K1 launches per step")
        check(count["launches_tc"] == n and count["launches_f32"] == 0,
              f"{name}: K1 launches off the tensor-core route")
        q_end, phi_end = m.q, m.phi
        check(np.isfinite(q_end).all() and np.isfinite(phi_end).all()
              and q_end.shape == (NX, NX), f"{name}: bad state")
        if name == "YBJModel":
            # the flow is frozen: q is bitwise what set_q was given
            k0 = 10 * (2 * np.pi / m.L)
            q0 = ic.LambDipole(m, U=U0, R=2 * np.pi / k0).astype(np.float32)
            check(np.array_equal(q_end, q0), "YBJModel: q moved")
        launches += graph_check(torch, mm, GRAPH_LABEL[name], m, per_step,
                                WAVE_FIELDS)
        del m
        torch.cuda.empty_cache()
        m64 = flagship(mod, ic, packet=True, backend="native",
                       dtype=np.float64)
        m64.run_steps(WARM_STEPS)
        refs[name] = {k: getattr(m64, k) for k in fields + shown}
        cross(name, s32, refs[name], fields, shown)
        del m64
        torch.cuda.empty_cache()

    qg_fields = model_fields("QGModel")[0]
    torch.cuda.reset_peak_memory_stats()
    mm.reset_counts()
    t0 = time.perf_counter()
    m = qg_flagship(pkg.QGModel, ic, backend="native", dtype=np.float32,
                    **GRAPH_RUN)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s32, wall = timed_steps(torch, m, qg_fields)
    log(f"QGModel (passive scalar, f32 cuFFT): built and initialised in "
        f"{t_build:.1f} s; {TIMED_STEPS} steps in {wall:.3f} s = "
        f"{TIMED_STEPS / wall:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f} "
        f"ms/step)")
    check(np.isfinite(m.q).all() and np.isfinite(m.c).all()
          and math.isfinite(m.cvar), "QGModel: non-finite state")
    count = mm.counts()
    check(count["launches"] == 0 and count["cpu_calls"] == 0,
          "QGModel on cuFFT called K1")
    graph_check(torch, mm, GRAPH_LABEL["QGModel"], m, None, ("q", "c", "Ke"))
    del m
    torch.cuda.empty_cache()
    m64 = qg_flagship(pkg.QGModel, ic, backend="native", dtype=np.float64)
    m64.run_steps(WARM_STEPS)
    refs["QGModel"] = {k: getattr(m64, k) for k in qg_fields}
    cross("QGModel", s32, refs["QGModel"], qg_fields)
    del m64
    torch.cuda.empty_cache()
    return launches, refs


def io_phase(torch, mm, main_sps):
    """Phase 9: output, ``run_with_snapshots`` and a checkpoint on the
    flagship in the K1 configuration (a model of its own), 6 steps with a
    diagnostics sample each and a snapshot every 2; a checkpoint at step 2,
    loaded after the run, and a second pass to tmax that must give the
    same bits. ``main_sps`` is phase 4's steps/s (None when it did not
    run). Returns K1's launches in the phase.

    The snapshots go through the model's own cadence into an
    ``io.Saver`` with ``npy-async`` snapshots, and the checkpoint is the
    in-memory tree, so that the phase needs no h5py (the HDF5 files,
    ``setup.h5``, ``diagnostics.h5`` and checkpoint files, are held to the
    JAX package's by the CPU tests)."""
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch import io as nio

    tmp = tempfile.mkdtemp(prefix="niwqg_io_")
    snapdir = os.path.join(tmp, "snapshots")
    try:
        mm.reset_counts()
        t0 = time.perf_counter()
        m = flagship(CoupledModel, ic, **K1_MODEL, tdiags=1,
                     tsave_snapshots=IO_SNAP_EVERY, tmax=IO_STEPS * DT)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_set = mm.counts()["launches"]
        # the Saver that save_to_disk=True builds, without its HDF5 setup
        # and diagnostics files; the step loop calls it every
        # tsave_snapshots steps, and the time of each call and of the
        # copies to the host inside it is kept
        saver = m.saver = nio.Saver(tmp, True, snapshot_format="npy-async")
        snap_ms, fetch_ms, snap_launches = [], [], 0
        save_snapshot, get_field = saver.save_snapshot, m.get_field

        def timed_get_field(name):
            t0 = time.perf_counter()
            value = get_field(name)
            fetch_ms.append(1e3 * (time.perf_counter() - t0))
            return value

        def timed_snapshot(model, fields):
            nonlocal snap_launches
            torch.cuda.synchronize()
            n0, t0 = mm.counts()["launches"], time.perf_counter()
            save_snapshot(model, fields)
            torch.cuda.synchronize()
            snap_ms.append(1e3 * (time.perf_counter() - t0))
            snap_launches += mm.counts()["launches"] - n0

        saver.save_snapshot, m.get_field = timed_snapshot, timed_get_field

        ckpt, save_s = None, 0.0
        t_start = time.perf_counter()
        for _ in m.run_with_snapshots(tsnapint=IO_SNAP_EVERY * DT):
            if m.tc == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt = nio.checkpoint_tree(m)
                save_s = time.perf_counter() - t0
        torch.cuda.synchronize()  # run_with_snapshots drained the writer
        wall = time.perf_counter() - t_start - save_s
        n_pass1 = mm.counts()["launches"] - n_set
        fields = ("q", "phi", "Ke", "Pw", "Kw")
        end = {k: getattr(m, k) for k in fields}
        series = {k: v["value"].copy() for k, v in m.diagnostics.items()}
        size = sum(a.nbytes for a in (list(ckpt["state"].values())
                                      + list(ckpt["state"]["d"].values())
                                      + list(ckpt["diagnostics"].values()))
                   if hasattr(a, "nbytes"))
        stems = sorted(f.split(".")[0] for f in os.listdir(snapdir)
                       if f.endswith(".q.npy"))
        check(len(stems) == IO_STEPS // IO_SNAP_EVERY == len(snap_ms),
              f"phase 9: {len(stems)} q snapshot files for {len(snap_ms)} "
              "snapshots")
        stem = "{:015.0f}".format(m.t)
        for name in ("q", "phi"):
            snap = np.load(os.path.join(snapdir, f"{stem}.{name}.npy"))
            check(snap.dtype == end[name].dtype
                  and np.array_equal(snap, end[name]),
                  f"phase 9: the last {name} snapshot differs from the live "
                  "field")

        m.saver = nio.Saver(tmp, False)  # the resumed pass writes nothing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nio.restore_tree(m, ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(m.tc == 2, f"phase 9: the checkpoint resumed at step {m.tc}")
        n0 = mm.counts()["launches"]
        m.run()
        n_pass2 = mm.counts()["launches"] - n0
        for k, v in end.items():
            check(np.array_equal(getattr(m, k), v),
                  f"phase 9: {k} after the resume differs from the first "
                  "pass")
        for k, v in m.diagnostics.items():
            check(np.array_equal(v["value"], series[k]),
                  f"phase 9: the {k} series after the resume differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    per_step = K1_PER_STEP + K1_PER_DIAG
    count = mm.counts()
    log(f"phase 9 (IO, K1 configuration, tdiags=1, a snapshot every "
        f"{IO_SNAP_EVERY} steps): built in {t_build:.1f} s; "
        f"run_with_snapshots, {IO_STEPS} steps in {wall:.3f} s = "
        f"{IO_STEPS / wall:.3f} steps/s with output and a diagnostics sample "
        f"a step (phase 4, run_steps: "
        + (f"{main_sps:.3f}" if main_sps else "not run") + " steps/s)")
    n_snap = len(snap_ms)
    log(f"  snapshots (t, q and phi through io.Saver, npy-async; h5py "
        f"{'installed' if has_h5py() else 'not installed'} here): {n_snap} "
        f"of {np.mean(snap_ms):.1f} ms each "
        f"({', '.join(f'{x:.1f}' for x in snap_ms)}), host clock with a "
        f"synchronise; of which the copies to the host (get_field) "
        f"{sum(fetch_ms) / n_snap:.1f} ms and the writer's submits (np.save "
        f"to memory, the C++ copy) "
        f"{(sum(snap_ms) - sum(fetch_ms)) / n_snap:.1f} ms a snapshot; K1 "
        f"launches in them: {snap_launches}")
    log(f"  checkpoint (in memory, io.checkpoint_tree) {size / 1e6:.1f} MB: "
        f"save {1e3 * save_s:.1f} ms, load (io.restore_tree) "
        f"{1e3 * load_s:.1f} ms; the resumed run to tmax equals the first "
        "pass bitwise (q, phi, Ke, Pw, Kw and every diagnostic series)")
    log(f"  K1 launches: set_q/set_phi {n_set}, first pass {n_pass1} "
        f"({n_pass1 / IO_STEPS:.1f}/step), resumed pass {n_pass2}; "
        f"{count['launches_tc']} of {count['launches']} on the tensor-core "
        f"route; "
        f"card {smi_name_power()}")
    check(snap_launches == 0, "phase 9: a snapshot launched K1")
    check(count["cpu_calls"] == 0, "phase 9: K1 ran its plain version")
    check(n_pass1 == per_step * IO_STEPS
          and n_pass2 == per_step * (IO_STEPS - 2),
          f"phase 9: expected {per_step} K1 launches per step "
          f"({K1_PER_STEP} a step, {K1_PER_DIAG} a diagnostics sample)")
    check(count["launches_tc"] == count["launches"]
          and count["launches_f32"] == 0,
          "phase 9: K1 launches off the tensor-core route")
    return count["launches"]


def k1_planes(torch, mm, M, K, N, seed, dft):
    """Seeded K1 operands on the card: the six f32 planes, and B's two."""
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
    return (ar, ai) + mm.mask_split(br) + mm.mask_split(bi), br, bi


def k1_record(torch, mm, M, K, N, seed, dft, reps):
    """K1 at one shape against the plain version of the route the shape
    takes; times of both routes at that shape where ``reps``."""
    args, br, bi = k1_planes(torch, mm, M, K, N, seed, dft)
    ar, ai = args[:2]
    route = mm.route(M, N, K)
    keys = ("launches", "launches_tc", "launches_f32")
    before = tuple(map(mm.counts().get, keys))
    re, im = mm.csplit_matmul(*args)
    after = tuple(map(mm.counts().get, keys))
    want = (1, 1, 0) if route == "tc" else (1, 0, 1)
    check(tuple(y - x for x, y in zip(before, after)) == want,
          f"K1 at {(M, K, N)}: route {route!r} expected, counters moved "
          f"from {before} to {after}")
    oracle, rtol = ((mm.csplit_matmul_ref_bf16, K1_TC_RTOL) if route == "tc"
                    else (mm.csplit_matmul_ref, K1_RTOL))
    rre, rim = oracle(*args)
    scale = max(rre.abs().max().item(), rim.abs().max().item())
    err = max((re - rre).abs().max().item(), (im - rim).abs().max().item())
    exact = (torch.complex(ar.double(), ai.double())
             @ torch.complex(br.double(), bi.double()))
    xscale = exact.abs().max().item()
    err_c128 = max((re.double() - exact.real).abs().max().item(),
                   (im.double() - exact.imag).abs().max().item())
    log(f"K1 {M}x{K} @ {K}x{N}, route {route}: max_abs_err={err:.3e} vs "
        f"{oracle.__name__} (max|ref|={scale:.3e}, rel {err / scale:.3e}, "
        f"limit {rtol}); vs complex128 {err_c128:.3e} "
        f"(rel {err_c128 / xscale:.3e})")
    check(err <= rtol * scale,
          f"K1 disagrees with its plain version at {(M, K, N)}: "
          f"{err:.3e} > {rtol} * {scale:.3e}")
    if route == "tc":
        check(err_c128 <= K1_EXACT_RTOL * xscale,
              f"K1 is off the complex128 product at {(M, K, N)}: "
              f"{err_c128:.3e} > {K1_EXACT_RTOL} * {xscale:.3e}")
        b = mm.prepare_b(*args[2:])
        pre, pim = mm.csplit_matmul_prepared(ar, ai, b)
        check(torch.equal(pre, re) and torch.equal(pim, im),
              "the prepared call and the six-plane call differ")
    if not reps:
        return None

    check(route == "tc", "the timed shape is the main path's")
    a_c = torch.complex(ar, ai)
    b_c = torch.complex(br, bi)
    kern = lambda: mm.csplit_matmul_prepared(ar, ai, b)  # the main path's call
    fma = lambda: mm.csplit_matmul_f32(*args)  # the first design, same run
    plain = lambda: mm.csplit_matmul_ref_bf16(*args)
    plain32 = lambda: mm.csplit_matmul_ref(*args)
    # in turns: plain, kernel, kernel, plain
    p1 = cuda_ms(torch, plain, reps)
    q1 = cuda_ms(torch, plain32, reps)
    k1 = cuda_ms(torch, kern, 5 * reps)
    f1 = cuda_ms(torch, fma, reps)
    f2 = cuda_ms(torch, fma, reps)
    k2 = cuda_ms(torch, kern, 5 * reps)
    q2 = cuda_ms(torch, plain32, reps)
    p2 = cuda_ms(torch, plain, reps)
    lib = cuda_ms(torch, lambda: a_c @ b_c, reps)
    # The function is the twelve split products with bf16 operands and f32
    # sums, 24*M*N*K flop: the least the card can take for it is that count
    # at the bf16 tensor-core peak. One complex product in f32 FMAs
    # (8*M*N*K flop, exact split) was the bound of the first design.
    nbytes = (2 * M * K + 4 * K * N + 2 * M * N) * 4.0
    t_bytes = nbytes / PEAK_BYTES
    t_tc = 24.0 * M * N * K / PEAK_BF16_FLOPS
    t_f32 = 8.0 * M * N * K / PEAK_F32_FLOPS
    bound_ms = max(t_tc, t_bytes) * 1e3
    bound_by = "operations" if t_tc >= t_bytes else "bytes"
    ms = 0.5 * (k1 + k2)
    log(f"K1 timing {M}x{K}x{N}: tensor-core kernel {k1:.4f}/{k2:.4f} ms, "
        f"f32-FMA kernel {f1:.4f}/{f2:.4f} ms, bf16 plain {p1:.4f}/{p2:.4f} "
        f"ms, f32 plain {q1:.4f}/{q2:.4f} ms, complex64 torch.matmul "
        f"{lib:.4f} ms")
    log(f"K1 bounds {M}x{K}x{N}: on the tensor cores {bound_ms:.4f} ms "
        f"({bound_by}: {24.0 * M * N * K:.3e} flop at the bf16 peak; bytes "
        f"{1e3 * t_bytes:.4f} ms), {100 * bound_ms / ms:.1f}% of it reached, "
        f"{24.0 * M * N * K / (ms * 1e-3) / 1e12:.1f} TFLOP/s; on f32 FMAs "
        f"{1e3 * t_f32:.4f} ms ({8.0 * M * N * K:.3e} flop at the f32 peak), "
        f"the f32-FMA kernel at {100 * 2e3 * t_f32 / (f1 + f2):.1f}% of it")
    return dict(max_abs_err=err, ms=ms, plain_ms=0.5 * (p1 + p2),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib)


def k1_mean_mode(torch, mm):
    """Column 0 of a constant A times the DFT matrix: K equal terms, the
    mean mode of a near-uniform field, on the tensor-core route."""
    K = NX
    c = np.float32(5 * U0 / np.sqrt(2))
    a = torch.full((64, K), float(c), dtype=torch.float32, device="cuda")
    idx = np.arange(K)
    F = np.exp(-2j * np.pi * np.outer(idx, idx) / K)
    planes = (mm.mask_split(torch.as_tensor(F.real.astype(np.float32),
                                            device="cuda"))
              + mm.mask_split(torch.as_tensor(F.imag.astype(np.float32),
                                              device="cuda")))
    check(mm.route(64, K, K) == "tc", "the mean-mode check is the tc route's")
    re, im = mm.csplit_matmul(a, a, *planes)
    exact = K * float(c)
    err = max((p[:, 0].double() - exact).abs().max().item() / exact
              for p in (re, im))
    log(f"K1 mean mode, {K} equal terms: off by {err:.3e} of the sum "
        f"(limit {K1_MEAN_RTOL})")
    check(err <= K1_MEAN_RTOL, "K1's sum of same-sign terms drifts")


def k2_bound_ms(nbytes_rank, cards):
    """Least time for one launch of all NRANKS ranks: every rank's block is
    read once and written once in HBM (ranks that share a card share its
    HBM), and what changes cards crosses NVLink, each card sending at
    PEAK_LINK."""
    per_card = NRANKS // cards
    t_hbm = per_card * 2.0 * nbytes_rank / PEAK_BYTES
    t_link = per_card * nbytes_rank * (NRANKS - per_card) / NRANKS / PEAK_LINK
    return max(t_hbm, t_link) * 1e3, t_hbm * 1e3, t_link * 1e3


def k2_phase(torch, a2a):
    """Phase 6: K2 against its plain version, four ranks in one process."""
    ncards = min(NRANKS, torch.cuda.device_count())
    devices = [torch.device("cuda", r % ncards) for r in range(NRANKS)]
    group = a2a.PeerGroup.local(devices)
    log(f"K2: {NRANKS} ranks of one process on {ncards} card(s): "
        f"{[str(d) for d in devices]}")

    def sync():
        for d in set(devices):
            torch.cuda.synchronize(d)

    def blocks(shape, dtype, seed):
        rng = np.random.default_rng(seed)
        out = []
        for d in devices:
            z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            out.append(torch.as_tensor(z, device=d).to(dtype))
        return out

    def exact(shape_fwd, dtype, chunks, seed):
        """Both directions at one shape, bit-exact against the plain
        version; ``shape_fwd`` is the forward input (..., R, P*W)."""
        for fn, ref, shape in (
                (a2a.all_to_all_fwd, a2a.all_to_all_fwd_ref, shape_fwd),
                (a2a.all_to_all_inv, a2a.all_to_all_inv_ref,
                 shape_fwd[:-2] + (NRANKS * shape_fwd[-2],
                                   shape_fwd[-1] // NRANKS))):
            zs = blocks(shape, dtype, seed)
            got = fn(zs, group, chunks=chunks)
            sync()
            want = ref([z.cpu() for z in zs])
            for r in range(NRANKS):
                check(got[r].device == devices[r], "K2 output on wrong card")
                check(torch.equal(got[r].cpu(), want[r]),
                      f"K2 {fn.__name__} differs from its plain version at "
                      f"{shape} {dtype} chunks={chunks}, rank {r}")
        log(f"K2 {shape_fwd} {dtype} chunks={chunks}: both directions "
            f"bit-exact on all {NRANKS} ranks")

    main_shape = (K2_LEAD, K2_R, NRANKS * K2_W)
    exact(main_shape, torch.complex64, 2, seed=3)
    exact((2, 256, NRANKS * 128), torch.complex128, 1, seed=4)
    exact((24, NRANKS * 20), torch.complex64, 2, seed=5)  # ragged, no fields
    exact((24, NRANKS * 21), torch.complex64, 2, seed=7)  # 8-byte units
    # 17 row groups of tasks, the last one short; 408 tasks a rank, not a
    # multiple of the grid
    exact((K2_LEAD, K2_R + 8, NRANKS * K2_W), torch.complex64, 2, seed=8)
    # QG's block on the mesh: 257 columns a rank, the 8-byte path
    qg_shape = (QG_LEAD, K2_R, NRANKS * QG_WR)
    exact(qg_shape, torch.complex64, 1, seed=9)

    # forward then inverse, K2_PAIRS times with no host synchronise: the
    # epochs of both directions advance and the round trip is the identity
    zs = blocks(main_shape, torch.complex64, seed=6)
    first = [z.clone() for z in zs]
    cur = zs
    sync()
    t0 = time.perf_counter()
    for _ in range(K2_PAIRS):
        cur = a2a.all_to_all_inv(a2a.all_to_all_fwd(cur, group, chunks=2),
                                 group, chunks=2)
    sync()
    pair_ms = 1e3 * (time.perf_counter() - t0) / K2_PAIRS
    for r in range(NRANKS):
        check(torch.equal(cur[r], first[r]),
              f"K2: {K2_PAIRS} forward+inverse pairs changed rank {r}'s block")
    log(f"K2 {K2_PAIRS} forward+inverse pairs back to back: identity, "
        f"{pair_ms:.4f} ms per pair")

    def timed(fn, arg, reps=K2_PAIRS):
        fn(arg)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(arg)
        sync()
        return 1e3 * (time.perf_counter() - t0) / reps

    nbytes = int(np.prod(main_shape)) * 8
    bound, t_hbm, t_link = k2_bound_ms(nbytes, ncards)
    recs = {}
    zi = [o.clone() for o in a2a.all_to_all_fwd(zs, group, chunks=2)]
    cards = sorted(set(devices), key=str)
    for name, fn, ref, arg in (
            ("all_to_all_fwd", a2a.all_to_all_fwd, a2a.all_to_all_fwd_ref, zs),
            ("all_to_all_inv", a2a.all_to_all_inv, a2a.all_to_all_inv_ref, zi)):
        kern = lambda x, fn=fn: fn(x, group, chunks=2)
        # in turns: plain, kernel, kernel, plain (host clock, the old figure)
        p1 = timed(ref, arg, 10)
        k1 = timed(kern, arg)
        k2 = timed(kern, arg)
        p2 = timed(ref, arg, 10)
        dev, host, host_med = k2_times(torch, lambda: kern(arg), cards,
                                       K2_PAIRS)
        log(f"K2 {name}, {NRANKS} ranks x {nbytes / 1e6:.1f} MB on {ncards} "
            f"card(s) in one process: device {dev:.4f} ms per launch of all "
            f"ranks (CUDA events, {K2_PAIRS} calls enqueued behind a sleep), "
            f"host {host:.1f} µs per call (median {host_med:.1f}); host clock "
            f"over {K2_PAIRS} calls: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"(slices and torch.cat) {p1:.4f}/{p2:.4f} ms; bound "
            f"{bound:.4f} ms (bytes: HBM {t_hbm:.4f}, NVLink {t_link:.4f}; "
            f"{100 * bound / dev:.1f}% of it reached)")
        recs[name] = dict(max_abs_err=0.0, ms=dev, plain_ms=0.5 * (p1 + p2),
                          bound_ms=bound, bound_by="bytes", library_ms=None)
    # the ragged path at QG's block, device time only
    nbytes_qg = int(np.prod(qg_shape)) * 8
    bound_qg = k2_bound_ms(nbytes_qg, ncards)[0]
    zq = blocks(qg_shape, torch.complex64, seed=10)
    zqi = [o.clone() for o in a2a.all_to_all_fwd(zq, group, chunks=1)]
    for name, fn, arg in (("all_to_all_fwd", a2a.all_to_all_fwd, zq),
                          ("all_to_all_inv", a2a.all_to_all_inv, zqi)):
        check(a2a.path(QG_WR, 1, 8) == "ragged", "QG's block is not ragged")
        dev = k2_times(torch, lambda: fn(arg, group, chunks=1), cards,
                       K2_PAIRS)[0]
        log(f"K2 {name} at QG's block {qg_shape} (ragged path), {NRANKS} "
            f"ranks x {nbytes_qg / 1e6:.2f} MB on {ncards} card(s) in one "
            f"process: device {dev:.4f} ms per launch; bound {bound_qg:.4f} "
            f"ms, {100 * bound_qg / dev:.1f}% of it reached")
    if ncards < NRANKS:
        log(f"K2 times above were taken with {NRANKS} ranks on {ncards} "
            "card(s): ranks that share a card share its HBM and SMs, so "
            "these are not multi-card times")
    return recs, ncards


def _sharded_rank(rank, port, route, outdir):
    """One rank of phase 7 (a child process)."""
    import torch

    sys.path.insert(0, ROOT)
    os.environ.setdefault("NIWQG_TORCH_TABLE_CACHE", "0")
    os.environ.setdefault("NIWQG_ETDRK4_WORKERS", "2")
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.parallel import a2a, multihost

    multihost.initialize(f"localhost:{port}", NRANKS, rank, timeout_s=300)
    mesh = multihost.global_mesh()
    import torch.distributed as dist

    backend = dist.get_backend()
    opts = dict(SHARD_OPTS) if route == "k2" else {"overlap_chunks": 2}
    fwd, inv = a2a.all_to_all_fwd, a2a.all_to_all_inv
    counts = ("launches", "launches_aligned", "launches_ragged", "cpu_calls")
    for f in (fwd, inv):  # every K2 count to 0 just before the main path
        for c in counts:
            setattr(f, c, 0)
    t0 = time.perf_counter()
    m = flagship(CoupledModel, ic, backend="native", dtype=np.float32,
                 fast=True, mesh=mesh, transform_opts=opts)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_set = (fwd.launches, inv.launches)
    m.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    n_warm = (fwd.launches - n_set[0], inv.launches - n_set[1])
    q, phi, ke = m.q, m.phi, m.Ke  # collectives: every rank takes part
    mesh.barrier()
    t0 = time.perf_counter()
    m.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    mesh.barrier()
    wall = time.perf_counter() - t0
    n_timed = (fwd.launches - n_set[0] - n_warm[0],
               inv.launches - n_set[1] - n_warm[1])
    q_end, ke_end = m.q, m.Ke
    finite = bool(np.isfinite(q_end).all() and math.isfinite(ke_end))
    n_ckpt, ckpt_equal, ckpt_ms = (0, 0), True, (np.nan, np.nan)
    if route == "k2":
        n_ckpt, ckpt_equal, ckpt_ms = sharded_checkpoint(torch, m)
        n_ckpt = (n_ckpt[0] - n_timed[0] - n_warm[0] - n_set[0],
                  n_ckpt[1] - n_timed[1] - n_warm[1] - n_set[1])
    paths = (fwd.launches_aligned + inv.launches_aligned,
             fwd.launches_ragged + inv.launches_ragged)

    # the transposes alone at the path's shape, in this process layout
    shape = (K2_LEAD, K2_R, NRANKS * K2_W)
    z = torch.zeros(shape, dtype=torch.complex64, device=mesh.device)
    z += rank
    tr = m.kernel.tr
    zi = torch.zeros((K2_LEAD, NRANKS * K2_R, K2_W), dtype=torch.complex64,
                     device=mesh.device)
    zi += rank
    nan3 = (np.nan,) * 3
    lib_ms = lib_inv_ms = k2_ms = k2_inv_ms = np.nan
    k2_dev = k2_inv_dev = lib_dev = lib_inv_dev = nan3
    reps = 20
    cards = [mesh.device]

    def timed(fn):
        """Host clock over ``reps`` calls, closed by a synchronise (the
        figure kept from the first design)."""
        fn()
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    if route == "k2":
        main_path = {f: [getattr(f, c) for c in counts] for f in (fwd, inv)}
        kf = lambda: fwd(z, tr._group, chunks=2)
        ki = lambda: inv(zi, tr._group, chunks=2)
        k2_ms, k2_inv_ms = timed(kf), timed(ki)
        k2_dev = k2_times(torch, kf, cards, K2_PAIRS, mesh.barrier)
        k2_inv_dev = k2_times(torch, ki, cards, K2_PAIRS, mesh.barrier)
        for f, vals in main_path.items():  # timing is not the main path
            for c, v in zip(counts, vals):
                setattr(f, c, v)
    elif backend == "nccl":
        send = z.reshape(K2_LEAD, K2_R, NRANKS, K2_W).movedim(-2, 0)
        send = send.contiguous()
        recv = torch.empty_like(send)
        lf = lambda: dist.all_to_all_single(recv, send)
        lib_ms = timed(lf)
        lib_dev = k2_times(torch, lf, cards, K2_PAIRS, mesh.barrier)
        # the inverse's blocks: row block r of each field goes to rank r
        sendi = zi.reshape(K2_LEAD, NRANKS, K2_R, K2_W).movedim(-3, 0)
        sendi = sendi.contiguous()
        li = lambda: dist.all_to_all_single(recv, sendi)
        lib_inv_ms = timed(li)
        lib_inv_dev = k2_times(torch, li, cards, K2_PAIRS, mesh.barrier)
    cpu_calls = fwd.cpu_calls + inv.cpu_calls
    if tr._group is not None:
        tr._group.close()
    del m, tr
    torch.cuda.empty_cache()

    extra = {}
    if route == "k2":
        # the other models on the K2 route, in this spawn
        extra.update(_family_on_mesh(torch, mesh, rank, counts))
    elif backend == "nccl":
        # NCCL at QG's blocks (the ragged path's shape), both directions
        shape = (QG_LEAD, NX // NRANKS, NRANKS * QG_WR)
        zq = torch.full(shape, float(rank), dtype=torch.complex64,
                        device=mesh.device)
        send = zq.reshape(QG_LEAD, NX // NRANKS, NRANKS, QG_WR).movedim(-2, 0)
        send = send.contiguous()
        recv = torch.empty_like(send)
        extra["lib_qg_dev"] = k2_times(
            torch, lambda: dist.all_to_all_single(recv, send), cards,
            K2_PAIRS, mesh.barrier)
        sendi = torch.full((QG_LEAD, NX, QG_WR), float(rank),
                           dtype=torch.complex64, device=mesh.device)
        sendi = sendi.reshape(QG_LEAD, NRANKS, NX // NRANKS, QG_WR)
        sendi = sendi.movedim(-3, 0).contiguous()
        extra["lib_qg_inv_dev"] = k2_times(
            torch, lambda: dist.all_to_all_single(recv, sendi), cards,
            K2_PAIRS, mesh.barrier)
    if rank == 0:
        np.savez(os.path.join(outdir, f"{route}.npz"), q=q, phi=phi, ke=ke,
                 wall=wall, t_build=t_build, n_set=n_set, n_warm=n_warm,
                 n_timed=n_timed, n_ckpt=n_ckpt, ckpt_equal=ckpt_equal,
                 ckpt_ms=ckpt_ms, paths=paths, finite=finite,
                 backend=backend, cpu_calls=cpu_calls,
                 k2_ms=k2_ms, k2_inv_ms=k2_inv_ms, lib_ms=lib_ms,
                 lib_inv_ms=lib_inv_ms, k2_dev=k2_dev, k2_inv_dev=k2_inv_dev,
                 lib_dev=lib_dev, lib_inv_dev=lib_inv_dev,
                 device=str(mesh.device), **extra)
    multihost.shutdown()


def _family_on_mesh(torch, mesh, rank, counts):
    """Phase 7's other models on the K2 route, in the flagship's spawn:
    QG + passive scalar and UnCoupled (default quirks, fast kernel) at
    2048² in f32, each driven with K2's counts set to 0 just before it and
    read just after; QG's checkpoint round trip; then K2 alone at QG's
    block shape (the ragged path), bit-exact against its plain version and
    timed. Returns what rank 0 saves, each key prefixed by the model."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.parallel import a2a

    fwd, inv = a2a.all_to_all_fwd, a2a.all_to_all_inv
    out = {}
    for name, key in (("QGModel", "qg"), ("UnCoupledModel", "unc")):
        for f in (fwd, inv):  # every K2 count to 0 just before the path
            for c in counts:
                setattr(f, c, 0)
        t0 = time.perf_counter()
        if name == "QGModel":
            m = qg_flagship(pkg.QGModel, ic, backend="native",
                            dtype=np.float32, mesh=mesh,
                            transform_opts=dict(SHARD_OPTS))
            fields = ("q", "c", "Ke")
        else:
            m = flagship(pkg.UnCoupledModel, ic, packet=True,
                         backend="native", dtype=np.float32, fast=True,
                         mesh=mesh, transform_opts=dict(SHARD_OPTS))
            fields = ("q", "phi", "Ke")
        torch.cuda.synchronize()
        out[f"{key}_t_build"] = time.perf_counter() - t0
        n_set = (fwd.launches, inv.launches)
        m.run_steps(WARM_STEPS)
        torch.cuda.synchronize()
        n_warm = (fwd.launches - n_set[0], inv.launches - n_set[1])
        warm = {k: getattr(m, k) for k in fields}  # collectives
        mesh.barrier()
        t0 = time.perf_counter()
        m.run_steps(TIMED_STEPS)
        torch.cuda.synchronize()
        mesh.barrier()
        out[f"{key}_wall"] = time.perf_counter() - t0
        n_timed = (fwd.launches - n_set[0] - n_warm[0],
                   inv.launches - n_set[1] - n_warm[1])
        end = {k: getattr(m, k) for k in fields}
        out[f"{key}_finite"] = all(np.isfinite(v).all() for v in end.values())
        n_ckpt, equal, ms = (0, 0), True, (np.nan, np.nan)
        if name == "QGModel":
            n_ckpt, equal, ms = sharded_checkpoint(torch, m, fields)
            n_ckpt = tuple(n_ckpt[i] - n_set[i] - n_warm[i] - n_timed[i]
                           for i in range(2))
        out.update({f"{key}_{k}": v for k, v in warm.items()})
        out.update({f"{key}_n_set": n_set, f"{key}_n_warm": n_warm,
                    f"{key}_n_timed": n_timed, f"{key}_n_ckpt": n_ckpt,
                    f"{key}_ckpt_equal": equal, f"{key}_ckpt_ms": ms,
                    f"{key}_paths": (fwd.launches_aligned
                                     + inv.launches_aligned,
                                     fwd.launches_ragged
                                     + inv.launches_ragged),
                    f"{key}_cpu_calls": fwd.cpu_calls + inv.cpu_calls})
        group = m.kernel.tr._group
        if name == "QGModel":
            main_path = {f: [getattr(f, c) for c in counts]
                         for f in (fwd, inv)}
            out.update(_ragged_k2(torch, mesh, rank, group))
            for f, vals in main_path.items():  # not the main path
                for c, v in zip(counts, vals):
                    setattr(f, c, v)
        group.close()
        del m, group
        torch.cuda.empty_cache()
    return out


def _ragged_k2(torch, mesh, rank, group):
    """K2 at QG's block shape on the mesh (the ragged path): each
    direction bit-exact against its plain version on seeded blocks, then
    its device and host times as ``k2_times`` takes them."""
    from niwqg_tpu_torch.parallel import a2a

    R = NX // NRANKS
    out = {}
    for key, fn, ref, shape in (
            ("fwd", a2a.all_to_all_fwd, a2a.all_to_all_fwd_ref,
             (QG_LEAD, R, NRANKS * QG_WR)),
            ("inv", a2a.all_to_all_inv, a2a.all_to_all_inv_ref,
             (QG_LEAD, NX, QG_WR))):
        check(a2a.path(QG_WR, 1, 8) == "ragged",
              "QG's block shape is not on K2's ragged path")
        rng = np.random.default_rng(100 + rank)
        z = torch.as_tensor(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape),
                            device=mesh.device).to(torch.complex64)
        launches = fn.launches_ragged
        got = fn(z, group, chunks=1).clone()
        torch.cuda.synchronize()
        check(fn.launches_ragged == launches + 1,
              f"K2 {key} at QG's shape did not launch on the ragged path")
        want = ref(mesh.all_gather(z))[rank]
        out[f"ragged_{key}_equal"] = bool(torch.equal(got, want))
        check(out[f"ragged_{key}_equal"], f"K2 {key} at QG's block shape "
              f"{shape} differs from its plain version on rank {rank}")
        out[f"ragged_{key}_dev"] = k2_times(
            torch, lambda: fn(z, group, chunks=1), [mesh.device], K2_PAIRS,
            mesh.barrier)
    return out


def graph_configs(pkg):
    """Phase 10's configurations, as phases 4, 5 and 8 build them: (label,
    a function that builds the model, K1 launches per step or None where
    K1 does not run, fields held)."""
    from niwqg_tpu_torch import InitialConditions as ic

    cufft = dict(backend="native", dtype=np.float32, **GRAPH_RUN)
    out = [(GRAPH_LABEL["CoupledModel"],
            lambda: flagship(pkg.CoupledModel, ic, **K1_MODEL, **GRAPH_RUN),
            K1_PER_STEP, WAVE_FIELDS),
           (GRAPH_LABEL["q_half"],
            lambda: flagship(pkg.CoupledModel, ic, **cufft, fast=True,
                             q_half=True), None, WAVE_FIELDS)]
    for name, per_step in K1_PER_STEP_FAMILY.items():
        out.append((GRAPH_LABEL[name],
                    lambda name=name: flagship(getattr(pkg, name), ic,
                                               packet=True, **K1_MODEL,
                                               **GRAPH_RUN),
                    per_step, WAVE_FIELDS))
    out.append((GRAPH_LABEL["QGModel"],
                lambda: qg_flagship(pkg.QGModel, ic, **cufft), None,
                ("q", "c", "Ke")))
    return out


def graph_phase(torch, mm):
    """Phase 10 alone (``--phases 10``): each configuration of
    ``graph_configs`` built, stepped as its phase steps it, and held by
    ``graph_check``; a full run makes these checks inside phases 4, 5 and
    8, on the models those phases build."""
    import niwqg_tpu_torch as pkg

    for label, build, per_step, fields in graph_configs(pkg):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m = build()
        m.run_steps(WARM_STEPS + TIMED_STEPS)
        graph_check(torch, mm, label, m, per_step, fields)
        del m
        torch.cuda.empty_cache()


def graph_check(torch, mm, label, m, per_step, fields):
    """Phase 10 on one model, built with ``GRAPH_RUN`` and stepped
    WARM_STEPS + TIMED_STEPS by its phase (peak memory counts from its
    build): ``run()`` (a diagnostics sample every step, a status line
    every GRAPH_TWRITE) and ``run_steps`` as replayed CUDA graphs, each
    from the same state as the eager loop it is held to (``_step_forward``
    for ``run()``, ``kernel.step`` for ``run_steps``), over GRAPH_STEPS:
    bit for bit expected, GRAPH_RTOL otherwise, on the fields and every
    series; K1's launches in every run (counted on the card) against the
    eager loop's, and in one replay of each graph (A: a step; B: a step
    with a sample) against the pins, all on the tensor-core route;
    diagnostics fetches per chunk; steps/s of each with graphs (``run()``:
    a second run, B captured; A was captured by the phase's own steps) and
    eagerly; capture ms and peak memory (since the build, graph A live
    throughout). Returns K1's launches in the graph runs."""
    from niwqg_tpu_torch import io as nio
    from niwqg_tpu_torch.diagnostics import SeriesAccumulator

    tc0 = m.tc
    check(m._count_steps(m.params.tmax) == GRAPH_STEPS
          and tc0 % GRAPH_TWRITE == 0,
          f"phase 10, {label}: not built with GRAPH_RUN's cadence")
    chunks = -(-GRAPH_STEPS // GRAPH_TWRITE)

    def reset(m, start):
        nio.restore_tree(m, start)
        m._diag_acc = SeriesAccumulator(m.registry)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def rel(a, b):
        a = np.asarray(a).astype(np.result_type(a, np.float64))
        b = np.asarray(b).astype(a.dtype)
        return float(np.abs(a - b).max(initial=0.0)
                     / max(float(np.abs(b).max(initial=0.0)), 1e-300))

    def held(what, ref, series=None):
        """The largest relative difference of ``fields`` (and the series)
        to ``ref``; exact equality is reported as bitwise."""
        d, exact = 0.0, True
        for k in fields:
            a = getattr(m, k)
            exact &= bool(np.array_equal(a, ref[k]))
            d = max(d, rel(a, ref[k]))
        for k, v in (series or {}).items():
            a = m.diagnostics[k]["value"]
            exact &= bool(np.array_equal(a, v))
            d = max(d, rel(a, v))
        check(d <= GRAPH_RTOL, f"phase 10, {label}: {what} is {d:.3e} off "
              f"the eager loop (limit {GRAPH_RTOL})")
        return "bitwise" if exact else f"{d:.3e}"

    def k1_launches(what):
        c = mm.counts()
        check(c["cpu_calls"] == 0 and c["launches_f32"] == 0
              and c["launches_tc"] == c["launches"],
              f"phase 10, {label}: K1 off the tensor-core route in {what}")
        return c["launches"]

    start = nio.checkpoint_tree(m)
    # an eager step, a sample and a status line first, so that the eager
    # loop is timed without its one-time costs (cuFFT plans, the grid's
    # lazy tables), as the graphs' second runs are
    m._step_forward()
    m._print_status()
    # the eager loops: the references
    reset(m, start)
    mm.reset_counts()
    eager_run = timed(lambda: [m._step_forward()
                               for _ in range(GRAPH_STEPS)])
    n_eager = [k1_launches("the eager run")]
    ref = {k: getattr(m, k) for k in fields}
    series = {k: v["value"].copy() for k, v in m.diagnostics.items()}
    reset(m, start)

    def eager_steps():
        for _ in range(GRAPH_STEPS):
            m.state = m.kernel.step(m.state)

    mm.reset_counts()
    eager_steps_s = timed(eager_steps)
    n_eager.append(k1_launches("the eager steps"))
    ref_steps = {k: getattr(m, k) for k in fields}
    eager_peak = torch.cuda.max_memory_allocated()
    # the graphs: run() twice (the first captures B), then run_steps, each
    # from the start
    times, n_launch = [], []
    for i, fn in enumerate((m.run, m.run,
                            lambda: m.run_steps(GRAPH_STEPS))):
        reset(m, start)
        mm.reset_counts()
        times.append(timed(fn))
        n_launch.append(k1_launches("a graph run"))
        if i < 2:
            run_d = held("run()", ref, series)
            fetches = m._diag_acc.fetches
    steps_d = held("run_steps", ref_steps)
    runner = m._runner
    check(runner.graphs, f"phase 10, {label}: no graphs on one card")
    # one replay of A, then one of B (tdiags=1: a sample at every step)
    reset(m, start)
    per_replay = []
    for diags in (False, True):
        r = runner.replays
        mm.reset_counts()
        runner.advance(1, diags=diags)
        per_replay.append(k1_launches("one replay"))
        check(runner.replays == r + 1,
              f"phase 10, {label}: a step of the graph run was no replay")
    launches = sum(n_launch) + sum(per_replay)
    if per_step is None:
        check(launches == 0, f"phase 10, {label}: K1 was called")
        k1 = "none"
    else:
        per_a, per_b = per_replay
        if label == GRAPH_LABEL["CoupledModel"]:
            check(per_b == per_step + K1_PER_DIAG,
                  f"phase 10, {label}: {per_b} K1 launches in a replay of "
                  f"B, expected {per_step + K1_PER_DIAG}")
        check(per_a == per_step,
              f"phase 10, {label}: {per_a} K1 launches in a replay of A, "
              f"expected {per_step}")
        # the status lines launch K1 too (pe_niw's gradients), in both
        # loops alike
        check(n_eager[1] == per_step * GRAPH_STEPS
              and n_launch == [n_eager[0]] * 2 + [n_eager[1]],
              f"phase 10, {label}: K1 launches {n_launch} in the graph "
              f"runs, {n_eager} in the eager loops")
        k1 = (f"{per_a} in one replay of A, {per_b} in one of B (counted "
              f"on the card), all tensor-core; {n_launch[0]} in run() as "
              "in the eager loop, status lines included")
    check(fetches == chunks, f"phase 10, {label}: {fetches} diagnostics "
          f"fetches for {chunks} chunks")
    peak = torch.cuda.max_memory_allocated()
    sps = lambda t: f"{GRAPH_STEPS / t:.3f}"
    log(f"phase 10 {label}: run() vs the eager _step_forward loop "
        f"{run_d}, run_steps vs the eager step loop {steps_d} "
        f"(q, phi/c, Ke and every series over {GRAPH_STEPS} steps; "
        f"limit {GRAPH_RTOL} where not bitwise); K1 {k1}; "
        f"diagnostics fetches {fetches / chunks:.0f} per chunk "
        f"({fetches} in {chunks} chunks, a sample every step)")
    log(f"  steps/s: run() {sps(times[1])} with graphs (first run, "
        f"with the eager step and capture of graph B: {sps(times[0])}), "
        f"{sps(eager_run)} eagerly; run_steps {sps(times[2])} with graphs, "
        f"{sps(eager_steps_s)} eagerly; "
        f"capture {runner.capture_ms():.1f} ms for both graphs; peak memory "
        f"since the build {peak / 2**20:.0f} MiB (before the capture of B "
        f"{eager_peak / 2**20:.0f} MiB); card {smi_name_power()}")
    check(all(np.isfinite(np.asarray(getattr(m, k))).all()
              for k in fields), f"phase 10, {label}: non-finite state")
    return launches


def resolved_options(tr):
    """The options a ``MatmulTransform`` resolved, as MXU_RESOLVED lists
    them."""
    half = tr._cdft_half.factors if tr._cdft_half is not None else None
    return dict(formulation=tr.formulation, factors=tr.factors,
                half_factors=half, realpath=tr.realpath, gauss=tr.gauss,
                precision=tr.precision, max_batch=tr.max_batch,
                use_pallas=tr.use_pallas)


def mxu_phase(torch, mm, refs64):
    """Phase 11: the matmul-DFT's options at 2048². (a) JAX's defaults
    (``MXU_MODEL``) on all five models, (b) ``realpath='mf'`` on the
    Coupled model, (c) the even/odd K1 configuration on Coupled and QG +
    scalar: each built with K1's counts set to 0, WARM_STEPS + TIMED_STEPS
    steps (steps/s, K1 launches per step: none in (a) and (b), the pins
    of ``K1_PER_STEP_EVENODD`` in (c), all tensor-core), held after
    WARM_STEPS steps to its f64 cuFFT run (``refs64`` by model, from
    phases 5 and 8; made here where missing); (a)'s Coupled model through
    ``graph_check`` (its replayed ``run_steps`` bitwise the eager loop);
    then (d), ``transform_table``. Returns K1's launches in the phase."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    def build(name, **kw):
        if name == "QGModel":
            return qg_flagship(pkg.QGModel, ic, **kw)
        return flagship(getattr(pkg, name), ic,
                        packet=name != "CoupledModel", **kw)

    names = ("CoupledModel", "UnCoupledModel", "QLModel", "YBJModel",
             "QGModel")
    runs = [("(a) JAX's defaults", name, MXU_MODEL, 0) for name in names]
    runs.append(("(b) realpath='mf'", "CoupledModel",
                 dict(MXU_MODEL, transform_opts={"realpath": "mf"}), 0))
    runs += [("(c) even/odd K1 configuration", name, K1_EVENODD_MODEL,
              K1_PER_STEP_EVENODD[name]) for name in ("CoupledModel",
                                                      "QGModel")]
    launches = 0
    for label, name, kw, per_step in runs:
        held, shown = model_fields(name)
        if name not in refs64:
            m64 = build(name, backend="native", dtype=np.float64)
            m64.run_steps(WARM_STEPS)
            refs64[name] = {k: getattr(m64, k) for k in held + shown}
            del m64
        graphs = label.startswith("(a)") and name == "CoupledModel"
        torch.cuda.empty_cache()
        mm.reset_counts()
        t0 = time.perf_counter()
        m = build(name, **kw, **(GRAPH_RUN if graphs else {}))
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_set = mm.counts()["launches"]
        s32, wall = timed_steps(torch, m, held + shown)
        count = mm.counts()
        n_steps = count["launches"] - n_set
        launches += count["launches"]
        opts = resolved_options(m.kernel.tr)
        log(f"phase 11 {label}, {name}: built and initialised in "
            f"{t_build:.1f} s; {TIMED_STEPS} steps in {wall:.3f} s = "
            f"{TIMED_STEPS / wall:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f}"
            f" ms/step); K1 launches: set_q/set_phi {n_set}, steps {n_steps} "
            f"({n_steps / (WARM_STEPS + TIMED_STEPS):.1f}/step, "
            f"{per_step} expected), {count['launches_tc']} on the "
            f"tensor-core route; transform {opts}")
        check(count["cpu_calls"] == 0, f"phase 11, {name}: K1 ran its plain "
              "version")
        check(n_steps == per_step * (WARM_STEPS + TIMED_STEPS),
              f"phase 11 {label}, {name}: expected {per_step} K1 launches "
              "per step")
        check(count["launches_tc"] == count["launches"]
              and count["launches_f32"] == 0,
              f"phase 11 {label}, {name}: K1 launches off the tensor-core "
              "route")
        if label.startswith("(a)"):
            check(opts == MXU_RESOLVED, f"phase 11 (a): the defaults "
                  f"resolved to {opts}, not {MXU_RESOLVED}")
        if label.startswith("(b)"):
            check(opts["realpath"] == "mf", "phase 11 (b): not mirror-free")
        check(all(np.isfinite(np.asarray(getattr(m, k))).all()
                  for k in held), f"phase 11, {name}: non-finite state")
        cross(f"phase 11 {label}, {name}", s32, refs64[name], held, shown)
        if graphs:
            launches += graph_check(
                torch, mm, "CoupledModel, matmul-DFT with JAX's defaults", m,
                None, WAVE_FIELDS)
        del m
    torch.cuda.empty_cache()
    transform_table(torch)
    return launches


def transform_table(torch):
    """Phase 11(d): the matmul-DFT's routes at 2048, one field. For the
    dense and the four-step passes, each real path, Gauss on and off and
    each precision mode: the forward transform's error against complex128
    ``torch.fft`` on the card (relative to its largest magnitude) and the
    ``fft2``+``ifft2`` and ``rfft2``+``irfft2`` round trips' device ms
    (CUDA events, TABLE_REPS back to back; the complex round trip does not
    depend on the real path and is timed with the dense one); then the
    K1 configurations of phases 4 and 11(c) and cuFFT in f32."""
    import itertools
    import warnings

    from niwqg_tpu_torch.ops.fft import MatmulTransform, NativeTransform

    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal((NX, NX)), device="cuda")
    z = torch.complex(x, torch.as_tensor(rng.standard_normal((NX, NX)),
                                         device="cuda"))
    want_c, want_r = torch.fft.fft2(z), torch.fft.rfft2(x)
    z32, x32 = z.to(torch.complex64), x.float()

    def rel(a, b):
        return float((a.to(b.dtype) - b).abs().max() / b.abs().max())

    def row(name, tr, complex_too=True):
        err_r = rel(tr.rfft2(x32), want_r)
        ms_r = cuda_ms(torch, lambda: tr.irfft2(tr.rfft2(x32)), TABLE_REPS)
        out = (f"rfft2 err {err_r:.3e}, rfft2+irfft2 {ms_r:.3f} ms")
        if complex_too:
            err_c = rel(tr.fft2(z32), want_c)
            ms_c = cuda_ms(torch, lambda: tr.ifft2(tr.fft2(z32)), TABLE_REPS)
            out = (f"fft2 err {err_c:.3e}, fft2+ifft2 {ms_c:.3f} ms; " + out)
        log(f"  {name}: {out}")

    log(f"phase 11 (d) transform table at {NX} (one field, f32; errors "
        "against complex128 torch.fft on the card; card "
        f"{smi_name_power()}):")
    for steps, realpath, gauss, precision in itertools.product(
            ("dense", "four-step"), ("dense", "evenodd", "mf"),
            (False, True), ("split", "split3", "high", "fast")):
        if realpath == "mf" and steps == "dense":
            continue  # the mirror-free path is a four-step one
        opts = (dict(factors=None, half_factors=None) if steps == "dense"
                else {})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # 'fast' warns
            tr = MatmulTransform(NX, np.float32, precision=precision,
                                 gauss=gauss, realpath=realpath, **opts)
        row(f"{steps} passes, realpath={realpath}, "
            f"gauss={'on' if gauss else 'off'}, {precision} "
            f"(factors {tr.factors}, half "
            f"{tr._cdft_half.factors if tr._cdft_half else None})", tr,
            complex_too=realpath == "dense")
        del tr
    for name, kw in (("K1 configuration (phase 4)", K1_TRANSFORM),
                     ("even/odd K1 configuration (11c)", K1_EVENODD)):
        row(name, MatmulTransform(NX, np.float32, precision="split", **kw))
    row("cuFFT f32 (NativeTransform)", NativeTransform(NX, np.float32))
    torch.cuda.empty_cache()


def has_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def sharded_checkpoint(torch, m, fields=("q", "phi", "Ke", "Pw", "Kw")):
    """Phase 7's checkpoint round trip on every rank: the in-memory tree
    of the sharded state (a collective: every rank gathers the global
    fields; no h5py needed), 2 steps, the tree loaded (each rank cuts its
    shard), the same 2 steps again, bitwise against the first. Returns
    K2's (forward, inverse) launch totals after it, whether every field
    agreed, and the (save, load) ms."""
    from niwqg_tpu_torch import io as nio
    from niwqg_tpu_torch.parallel import a2a

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = nio.checkpoint_tree(m)
    torch.cuda.synchronize()
    t_save = time.perf_counter() - t0
    m.run_steps(2)
    first = {k: getattr(m, k) for k in fields}  # collectives
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nio.restore_tree(m, tree)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    m.run_steps(2)
    equal = all(np.array_equal(getattr(m, k), v) for k, v in first.items())
    counts = (a2a.all_to_all_fwd.launches, a2a.all_to_all_inv.launches)
    return counts, equal, (1e3 * t_save, 1e3 * t_load)


def sharded_phase(torch, refs, family_refs):
    """Phase 7: the sharded main path on both routes; ``refs`` maps a name
    to the (q, phi, Ke) of a one-card run after WARM_STEPS steps, and
    ``family_refs`` a model's name to its one-card f32 cuFFT run's fields
    after WARM_STEPS steps (the K2 route's QG and UnCoupled are held to
    them). Returns K2's launches on the main paths (forward, inverse),
    NCCL's and K2's device ms."""
    import torch.multiprocessing as mp

    ndev = torch.cuda.device_count()
    ncards = min(NRANKS, ndev)
    log(f"sharded run: {NRANKS} ranks in {NRANKS} processes on {ncards} "
        f"card(s)" + ("" if ncards == NRANKS else
                      "; times taken with ranks sharing a card are not "
                      "multi-card times"))
    outdir = tempfile.mkdtemp(prefix="niwqg_smoke_")
    out = {}
    try:
        for route in ("k2", "default"):
            with socket.socket() as sock:  # a free port for the rendezvous
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            # raises if any rank fails
            mp.spawn(_sharded_rank, args=(port, route, outdir),
                     nprocs=NRANKS, join=True)
            with np.load(os.path.join(outdir, f"{route}.npz")) as z:
                out[route] = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    for route, r in out.items():
        nf, ni = (int(x) for x in r["n_timed"])
        log(f"sharded {route} route ({r['backend']} group, rank 0 on "
            f"{r['device']}): built in {float(r['t_build']):.1f} s; "
            f"{TIMED_STEPS} steps in {float(r['wall']):.3f} s = "
            f"{TIMED_STEPS / float(r['wall']):.3f} steps/s; K2 launches on "
            f"rank 0: set_q/set_phi {tuple(int(x) for x in r['n_set'])}, "
            f"warm-up {tuple(int(x) for x in r['n_warm'])}, timed "
            f"({nf}, {ni}) (forward, inverse)")
        check(bool(r["finite"]), f"non-finite state on the {route} route")
        check(int(r["cpu_calls"]) == 0, "K2 ran its plain version")
        want = ((K2_FWD_PER_STEP * TIMED_STEPS, K2_INV_PER_STEP * TIMED_STEPS)
                if route == "k2" else (0, 0))
        check((nf, ni) == want, f"{route} route: expected {want} K2 launches "
              f"in {TIMED_STEPS} steps, counted {(nf, ni)}")
        if route == "k2":
            nc = tuple(int(x) for x in r["n_ckpt"])
            save_ms, load_ms = (float(x) for x in r["ckpt_ms"])
            log(f"  checkpoint of the sharded state (in memory, "
                f"io.checkpoint_tree), 2 steps, load, the same 2 steps: bitwise equal {bool(r['ckpt_equal'])}; save "
                f"{save_ms:.1f} ms, load {load_ms:.1f} ms (rank 0); K2 "
                f"launches {nc} in the 4 steps")
            check(bool(r["ckpt_equal"]), "the sharded run resumed from its "
                  "checkpoint differs from the run it was taken from")
            check(nc == (4 * K2_FWD_PER_STEP, 4 * K2_INV_PER_STEP),
                  "the checkpoint round trip changed K2's launches per step")
        for name, (rq, rphi, rke) in refs.items():
            limit = SHARD_RTOL if name == "one-card f32 cuFFT" else CROSS_RTOL
            dq = np.abs(r["q"] - rq).max() / np.abs(rq).max()
            dphi = np.abs(r["phi"] - rphi).max() / np.abs(rphi).max()
            dke = abs(float(r["ke"]) - rke) / abs(rke)
            log(f"  vs {name} after {WARM_STEPS} steps: q {dq:.3e}, phi "
                f"{dphi:.3e}, Ke {dke:.3e} (relative; limit {limit})")
            check(max(dq, dphi, dke) <= limit,
                  f"sharded {route} route disagrees with {name}")
    a, b = out["k2"], out["default"]
    dq = np.abs(a["q"] - b["q"]).max() / np.abs(b["q"]).max()
    dphi = np.abs(a["phi"] - b["phi"]).max() / np.abs(b["phi"]).max()
    log(f"K2 route vs all_to_all_single route: q {dq:.3e}, phi {dphi:.3e} "
        f"(relative; limit {ROUTE_RTOL}: the transposes are copies, the "
        "y-FFTs run in other batch shapes)")
    check(max(dq, dphi) <= ROUTE_RTOL, "the two routes give different states")
    n_all = sum(int(x) for key in ("n_set", "n_warm", "n_timed", "n_ckpt")
                for x in a[key])
    aligned, ragged = (int(x) for x in a["paths"])
    log(f"K2 paths on rank 0's main path: {aligned} launches aligned, "
        f"{ragged} ragged, of {n_all}")
    check((aligned, ragged) == (n_all, 0),
          "the sharded flagship's K2 launches did not all take the aligned "
          "path")
    for name, key, host in (("forward", "k2_dev", "k2_ms"),
                            ("inverse", "k2_inv_dev", "k2_inv_ms")):
        dev, us, us_med = (float(x) for x in a[key])
        log(f"K2 {name} in the {NRANKS}-process layout, rank 0, {K2_LEAD} "
            f"fields: device {dev:.4f} ms per launch (CUDA events, "
            f"{K2_PAIRS} launches behind a sleep), host {us:.1f} µs per call "
            f"(median {us_med:.1f}); host clock over 20 launches "
            f"{float(a[host]):.4f} ms")
    lib = (float(b["lib_dev"][0]), float(b["lib_inv_dev"][0]))
    if math.isnan(lib[0]):
        lib = (None, None)
        log(f"library_ms is null: NCCL's all_to_all_single needs a card per "
            f"rank, and {NRANKS} ranks share {ncards} card(s) here (the "
            "default route ran on gloo through the host)")
    else:
        log(f"NCCL all_to_all_single at the same shape: forward's blocks "
            f"{lib[0]:.4f} ms, inverse's blocks {lib[1]:.4f} ms a call on "
            f"the device (CUDA events); host clock over 20 calls "
            f"{float(b['lib_ms']):.4f} and {float(b['lib_inv_ms']):.4f} ms")
    launches = tuple(sum(int(a[key][i]) for key in
                         ("n_set", "n_warm", "n_timed", "n_ckpt"))
                     for i in range(2))
    launches = tuple(x + y for x, y in
                     zip(launches, family_checks(a, family_refs)))
    ragged_report(a, b, ncards)
    k2_dev = (float(a["k2_dev"][0]), float(a["k2_inv_dev"][0]))
    return launches, lib, k2_dev


def family_checks(a, family_refs):
    """Phase 7's QG and UnCoupled runs on the K2 route (rank 0's record
    ``a``): steps/s, K2's launches per step against ``K2_PER_STEP_FAMILY``
    and per path (QG all ragged, UnCoupled all aligned, no plain-version
    call), the fields after WARM_STEPS steps against the one-card f32
    cuFFT run, QG's checkpoint round trip. Returns their K2 launches
    (forward, inverse)."""
    total = [0, 0]
    for name, key, fields in (("QGModel", "qg", ("q", "c", "Ke")),
                              ("UnCoupledModel", "unc", ("q", "phi", "Ke"))):
        wall = float(a[f"{key}_wall"])
        n = {k: tuple(int(x) for x in a[f"{key}_{k}"])
             for k in ("n_set", "n_warm", "n_timed", "n_ckpt")}
        per_step = K2_PER_STEP_FAMILY[name]
        log(f"sharded {name} on the K2 route: built in "
            f"{float(a[f'{key}_t_build']):.1f} s; {TIMED_STEPS} steps in "
            f"{wall:.3f} s = {TIMED_STEPS / wall:.3f} steps/s; K2 launches on "
            f"rank 0: set {n['n_set']}, warm-up {n['n_warm']}, timed "
            f"{n['n_timed']} (forward, inverse; {per_step} a step expected)")
        check(bool(a[f"{key}_finite"]), f"{name}: non-finite sharded state")
        check(int(a[f"{key}_cpu_calls"]) == 0, f"{name}: K2 ran its plain "
              "version")
        for k, steps in (("n_warm", WARM_STEPS), ("n_timed", TIMED_STEPS)):
            check(n[k] == (per_step[0] * steps, per_step[1] * steps),
                  f"{name}: expected {per_step} K2 launches a step, counted "
                  f"{n[k]} in {steps}")
        n_all = sum(sum(v) for v in n.values())
        aligned, ragged = (int(x) for x in a[f"{key}_paths"])
        log(f"  K2 paths: {aligned} aligned, {ragged} ragged, of {n_all}")
        want = (0, n_all) if name == "QGModel" else (n_all, 0)
        check((aligned, ragged) == want, f"{name}: K2 launches expected "
              f"{'all ragged' if name == 'QGModel' else 'all aligned'}")
        if name == "QGModel":
            save_ms, load_ms = (float(x) for x in a[f"{key}_ckpt_ms"])
            log(f"  checkpoint (in memory), 2 steps, load, the same 2 "
                f"steps: bitwise equal {bool(a[f'{key}_ckpt_equal'])}; save "
                f"{save_ms:.1f} ms, load {load_ms:.1f} ms (rank 0); K2 "
                f"launches {n['n_ckpt']} in the 4 steps")
            check(bool(a[f"{key}_ckpt_equal"]), "the sharded QG run resumed "
                  "from its checkpoint differs from the run it was taken from")
            check(n["n_ckpt"] == (4 * per_step[0], 4 * per_step[1]),
                  "QG's checkpoint round trip changed K2's launches per step")
        ref = family_refs.get(name)
        if ref is not None:
            d = {}
            for k, want_k in zip(fields, ref):
                x = np.asarray(a[f"{key}_{k}"])
                d[k] = float(np.abs(x - want_k).max() / np.abs(want_k).max())
            log(f"  vs the one-card f32 cuFFT run after {WARM_STEPS} steps: "
                + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
                + f" (relative; limit {SHARD_RTOL})")
            check(max(d.values()) <= SHARD_RTOL,
                  f"sharded {name} disagrees with its one-card run")
        for i in range(2):
            total[i] += sum(v[i] for v in n.values())
    return tuple(total)


def ragged_report(a, b, ncards):
    """K2 at QG's block shape (the ragged path), rank 0: bit-exact, device
    and host times, the bound and, on an NCCL group, NCCL at the same
    blocks."""
    nbytes = QG_LEAD * (NX // NRANKS) * NRANKS * QG_WR * 8
    bound, t_hbm, t_link = k2_bound_ms(nbytes, ncards)
    for key, name, lib in (("fwd", "forward", "lib_qg_dev"),
                           ("inv", "inverse", "lib_qg_inv_dev")):
        check(bool(a[f"ragged_{key}_equal"]), f"K2 {name} at QG's shape "
              "differs from its plain version")
        dev, us, us_med = (float(x) for x in a[f"ragged_{key}_dev"])
        nccl = (f"NCCL all_to_all_single at the same blocks {float(b[lib][0]):.4f} "
                "ms" if lib in b else "NCCL: none (the ranks share a card)")
        log(f"K2 {name} at QG's block shape ({QG_LEAD}, {NX // NRANKS}, "
            f"{NRANKS}x{QG_WR}) complex64, ragged path, rank 0 of "
            f"{NRANKS} processes on {ncards} card(s): bit-exact vs its plain "
            f"version; device {dev:.4f} ms per launch (CUDA events, "
            f"{K2_PAIRS} behind a sleep), host {us:.1f} µs per call (median "
            f"{us_med:.1f}); bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB a "
            f"rank; HBM {t_hbm:.4f}, NVLink {t_link:.4f}), "
            f"{100 * bound / dev:.1f}% of it reached; {nccl}")


def family_refs(torch):
    """The one-card f32 cuFFT runs phase 7's QG and UnCoupled are held to:
    their fields after WARM_STEPS steps (UnCoupled with the full-spectrum
    q side a mesh keeps, ``q_half=False``)."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    out = {}
    m = qg_flagship(pkg.QGModel, ic, backend="native", dtype=np.float32)
    m.run_steps(WARM_STEPS)
    out["QGModel"] = (m.q, m.c, m.Ke)
    del m
    m = flagship(pkg.UnCoupledModel, ic, packet=True, backend="native",
                 dtype=np.float32, fast=True, q_half=False)
    m.run_steps(WARM_STEPS)
    out["UnCoupledModel"] = (m.q, m.phi, m.Ke)
    del m
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="3,4,5,6,7,8,9,10,11",
                    help="phases to run beyond the card report and the "
                         "build (default: all; a partial run is for "
                         "debugging and prints no result lines)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",") if x}
    full = phases >= {3, 4, 5, 6, 7, 8, 9, 10, 11}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "niwqg_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(niwqg_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # the ETDRK4 tables' disk cache in a directory of this run's own,
    # removed at the end: models of one physics share their tables (the
    # f32 and f64 runs, phases 8 and 11), and nothing is written elsewhere
    table_cache = tempfile.mkdtemp(prefix="niwqg_tables_")
    os.environ["NIWQG_TORCH_TABLE_CACHE"] = table_cache
    try:
        return run_phases(torch, phases, full)
    finally:
        shutil.rmtree(table_cache, ignore_errors=True)


def run_phases(torch, phases, full) -> int:
    """The phases of ``main``, after its checks of the card and the
    checkout."""
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch import cuda_build
    from niwqg_tpu_torch.device import full_fp32_matmul
    from niwqg_tpu_torch.ops import csplit_mm as mm
    from niwqg_tpu_torch.parallel import a2a

    laps, t_lap = [], time.perf_counter()

    def lap(phase):
        """Note the wall time since the last lap as ``phase``'s."""
        nonlocal t_lap
        now = time.perf_counter()
        laps.append(f"{phase} {now - t_lap:.0f} s")
        t_lap = now

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

    lap("1-2")
    refs = {}
    if 6 in phases and not full:
        k2_phase(torch, a2a)
    if 7 in phases and not full:
        sharded_phase(torch, refs, family_refs(torch))
    if 8 in phases and not full:
        family_phase(torch, mm)
    if 9 in phases and not full:
        io_phase(torch, mm, None)
    if 10 in phases and not full:
        graph_phase(torch, mm)
    if 11 in phases and not full:
        mxu_phase(torch, mm, {})
    if not full:
        log("partial run: no result lines")
        return 0

    # -- 3. K1 against its plain version -------------------------------------
    rec = k1_record(torch, mm, NX, NX, NX, seed=1, dft=True, reps=10)
    # the even/odd configuration's half-length DFT (phase 11c)
    k1_record(torch, mm, NX, NX // 2, NX // 2, seed=4, dft=True, reps=10)
    k1_record(torch, mm, 520, 384, 264, seed=2, dft=False, reps=0)  # ragged
    k1_record(torch, mm, 130, 17, 65, seed=3, dft=False, reps=0)  # f32 route
    k1_mean_mode(torch, mm)
    lap("3")

    # -- 4. the main path ------------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mm.reset_counts()
    t0 = time.perf_counter()
    m = flagship(CoupledModel, ic, **K1_MODEL, **GRAPH_RUN)
    torch.cuda.synchronize()
    log(f"flagship f32 K1 model built and initialised in "
        f"{time.perf_counter() - t0:.1f} s ({type(m.kernel).__name__}, "
        f"q_half={m.kernel.q_half})")
    n_set = mm.counts()["launches"]
    m.run_steps(WARM_STEPS)
    n_warm = mm.counts()["launches"] - n_set
    q32, phi32, ke32 = m.q, m.phi, m.Ke
    t0 = time.perf_counter()
    m.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    ke_end = m.Ke
    wall = time.perf_counter() - t0
    main_sps = TIMED_STEPS / wall
    count = mm.counts()
    launches = count["launches"]
    n_timed = launches - n_set - n_warm
    log(f"main path: {TIMED_STEPS} steps in {wall:.3f} s = "
        f"{TIMED_STEPS / wall:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f} "
        f"ms/step); K1 launches: set_q/set_phi {n_set}, warm-up {n_warm}, "
        f"timed {n_timed} ({n_timed / TIMED_STEPS:.1f}/step)")
    check(count["cpu_calls"] == 0, "K1 ran its plain version")
    check(n_warm == K1_PER_STEP * WARM_STEPS
          and n_timed == K1_PER_STEP * TIMED_STEPS,
          f"expected {K1_PER_STEP} K1 launches per step")
    check(count["launches_tc"] == launches and count["launches_f32"] == 0,
          f"the main path's {launches} K1 launches did not all take the "
          f"tensor-core route ({count['launches_tc']} did, "
          f"{count['launches_f32']} took the f32-FMA route)")
    log(f"all {launches} K1 launches of the main path took the tensor-core "
        "route")
    q, phi = m.q, m.phi
    check(np.isfinite(q).all() and np.isfinite(phi).all()
          and math.isfinite(ke_end), "non-finite state after the main path")
    check(q.shape == (NX, NX) and phi.shape == (NX, NX), "bad state shape")
    rec["launches"] = launches + graph_check(
        torch, mm, GRAPH_LABEL["CoupledModel"], m, K1_PER_STEP, WAVE_FIELDS)
    del m
    torch.cuda.empty_cache()

    lap("4")

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
    refs["one-card f64 cuFFT"] = (q64, phi64, ke64)
    refs64 = {"CoupledModel": {"q": q64, "phi": phi64, "Ke": ke64,
                               "Pw": m64.Pw, "Kw": m64.Kw}}
    del m64
    torch.cuda.empty_cache()

    # the one-card reference of the sharded run: f32 on cuFFT, fast kernel,
    # with the full-spectrum q side the mesh runs (q_half=False), and with
    # the one-card default (q_half=True) for its steps per second
    for q_half in (False, True):
        torch.cuda.reset_peak_memory_stats()
        m32 = flagship(CoupledModel, ic, backend="native", dtype=np.float32,
                       fast=True, q_half=q_half, **GRAPH_RUN)
        m32.run_steps(WARM_STEPS)
        torch.cuda.synchronize()
        if not q_half:
            refs["one-card f32 cuFFT"] = (m32.q, m32.phi, m32.Ke)
        t0 = time.perf_counter()
        m32.run_steps(TIMED_STEPS)
        torch.cuda.synchronize()
        ke_end = m32.Ke
        wall = time.perf_counter() - t0
        log(f"one-card f32 cuFFT run, q_half={m32.kernel.q_half}: "
            f"{TIMED_STEPS} steps in {wall:.3f} s = "
            f"{TIMED_STEPS / wall:.3f} steps/s "
            f"({1e3 * wall / TIMED_STEPS:.1f} ms/step)")
        check(math.isfinite(ke_end), "non-finite Ke on the one-card f32 run")
        if q_half:
            graph_check(torch, mm, GRAPH_LABEL["q_half"], m32, None,
                        WAVE_FIELDS)
        del m32
        torch.cuda.empty_cache()

    lap("5")
    # the one-card references of phase 7's other models
    frefs = family_refs(torch)
    lap("7's one-card references")

    # -- 6. K2 against its plain version ---------------------------------------
    k2_recs, ncards = k2_phase(torch, a2a)
    lap("6")

    # -- 7. the sharded main path ------------------------------------------------
    launches, lib, k2_dev = sharded_phase(torch, refs, frefs)
    for i, name in enumerate(("all_to_all_fwd", "all_to_all_inv")):
        k2_recs[name]["launches"] = launches[i]
        k2_recs[name]["library_ms"] = lib[i]
        if ncards == NRANKS:
            # a card per rank: the kernel's time is the production layout's,
            # a process per rank (the bound is the same as phase 6's)
            k2_recs[name]["ms"] = k2_dev[i]

    lap("7")

    # -- 8. the model family ------------------------------------------------------
    n, frefs64 = family_phase(torch, mm)
    rec["launches"] += n
    refs64.update(frefs64)
    lap("8")

    # -- 9. output, run_with_snapshots and a checkpoint -----------------------
    rec["launches"] += io_phase(torch, mm, main_sps)
    lap("9")

    # -- 11. the matmul-DFT's options ---------------------------------------
    rec["launches"] += mxu_phase(torch, mm, refs64)
    lap("11")

    order = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")
    kernels = [dict(name="csplit_matmul", route="cuda",
                    source="niwqg_tpu_torch/csrc/csplit_mm.cu",
                    replaces="niwqg_tpu/ops/pallas_mm.py:63",
                    **{k: rec[k] for k in order})]
    for name, line in (("all_to_all_fwd", 151), ("all_to_all_inv", 174)):
        kernels.append(dict(name=name, route="cuda",
                            source="niwqg_tpu_torch/csrc/a2a.cu",
                            replaces=f"niwqg_tpu/parallel/pallas_a2a.py:{line}",
                            **{k: k2_recs[name][k] for k in order}))
    log(f"the sharded phases ran {NRANKS} ranks on {ncards} card(s)"
        + ("" if ncards == NRANKS else ": their times were taken with "
           "ranks sharing a card and are not multi-card times"))
    log("wall time by phase (4, 5, 8 and 11 with their phase-10 checks): "
        + ", ".join(laps))
    print(json.dumps({"kernels": kernels}))
    print(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
