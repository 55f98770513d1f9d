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
     path's shape (2048x2048 @ 2048x2048, the DFT matrix as B) and a ragged
     one, the f32-FMA kernel against the f32 plain version at a shape that
     takes that route, and a sum of 2048 equal terms (the mean mode); then
     the times at 2048³ of both kernels, both plain versions and one
     library call (complex64 ``torch.matmul``), with two bounds: the
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
     short last group of tasks, a complex128 one and two ragged ones (one
     on the 8-byte path), both directions, bit-exact; then forward and
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
     unchanged (they count in ``launches``);
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
     size and its save and load ms. K1's ``launches`` in the result line
     counts phases 4, 8 and 9.

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
SHARD_OPTS = {"pallas_a2a": True, "overlap_chunks": 2}
# sharded f32 run vs the one-card f32 cuFFT run after 2 steps: the same
# arithmetic with sums and transforms taken in another order
SHARD_RTOL = 1e-5
ROUTE_RTOL = 1e-6         # K2 route vs all_to_all_single route, same steps


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
    beta=1e-11 and plane-wave tracer."""
    m = QGModel.Model(L=2 * np.pi * 200e3, nx=nx, dt=157.0, tmax=157.0 * 100,
                      use_filter=True, nu4=7.5e9, U=-U0, beta=1e-11,
                      passive_scalar=True, **kw)
    k0 = 10 * (2 * np.pi / m.L)
    m.set_q(ic.LambDipole(m, U=U0, R=2 * np.pi / k0))
    m.set_c(np.real(ic.PlaneWave(m, k=k0, l=k0)) * 1e-2)
    return m


def zero_k1_counts(mm):
    for c in ("launches", "launches_tc", "launches_f32", "cpu_calls"):
        setattr(mm.csplit_matmul, c, 0)


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


def family_phase(torch, mm):
    """Phase 8: UnCoupled, QL and YBJ in the K1 configuration, QG (+scalar)
    in f32 on cuFFT, each against its f64 cuFFT run. Returns the K1
    launches of the three wave runs."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    def cross(name, a, b, keys, shown=()):
        """Hold ``keys`` at CROSS_RTOL; print ``shown`` beside them."""
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

    launches = 0
    for name, per_step in K1_PER_STEP_FAMILY.items():
        mod = getattr(pkg, name)
        fields = ("phi",) if name == "YBJModel" else ("q", "phi", "Ke")
        # the wave budgets are shown, not held: with K1's bf16 rounding Pw
        # ends step 1 about 2.5e-4 off its f64 run at 2048², in the
        # Coupled model too (tools/probe_wave_budgets.py, PERF.md). YBJ
        # integrates no budgets.
        shown = () if name == "YBJModel" else ("Pw", "Kw")
        count = mm.csplit_matmul
        zero_k1_counts(mm)
        t0 = time.perf_counter()
        m = flagship(mod, ic, packet=True, backend="mxu", dtype=np.float32,
                     precision="split", transform_opts=K1_TRANSFORM)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_set = count.launches
        s32, wall = timed_steps(torch, m, fields + shown)
        n = count.launches
        n_steps = n - n_set
        launches += n
        log(f"{name} (K1 configuration, {type(m.kernel).__name__}): built "
            f"and initialised in {t_build:.1f} s; {TIMED_STEPS} steps in "
            f"{wall:.3f} s = {TIMED_STEPS / wall:.3f} steps/s "
            f"({1e3 * wall / TIMED_STEPS:.1f} ms/step); K1 launches: "
            f"set_q/set_phi {n_set}, steps {n_steps} "
            f"({n_steps / (WARM_STEPS + TIMED_STEPS):.1f}/step), "
            f"{count.launches_tc} on the tensor-core route")
        check(count.cpu_calls == 0, f"{name}: K1 ran its plain version")
        check(n_steps == per_step * (WARM_STEPS + TIMED_STEPS),
              f"{name}: expected {per_step} K1 launches per step")
        check(count.launches_tc == n and count.launches_f32 == 0,
              f"{name}: K1 launches off the tensor-core route")
        q_end, phi_end = m.q, m.phi
        check(np.isfinite(q_end).all() and np.isfinite(phi_end).all()
              and q_end.shape == (NX, NX), f"{name}: bad state")
        if name == "YBJModel":
            # the flow is frozen: q is bitwise what set_q was given
            k0 = 10 * (2 * np.pi / m.L)
            q0 = ic.LambDipole(m, U=U0, R=2 * np.pi / k0).astype(np.float32)
            check(np.array_equal(q_end, q0), "YBJModel: q moved")
        del m
        torch.cuda.empty_cache()
        m64 = flagship(mod, ic, packet=True, backend="native",
                       dtype=np.float64)
        m64.run_steps(WARM_STEPS)
        cross(name, s32, {k: getattr(m64, k) for k in fields + shown},
              fields, shown)
        del m64
        torch.cuda.empty_cache()

    qg_fields = ("q", "c", "Ke", "cvar")
    zero_k1_counts(mm)
    t0 = time.perf_counter()
    m = qg_flagship(pkg.QGModel, ic, backend="native", dtype=np.float32)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s32, wall = timed_steps(torch, m, qg_fields)
    log(f"QGModel (passive scalar, f32 cuFFT): built and initialised in "
        f"{t_build:.1f} s; {TIMED_STEPS} steps in {wall:.3f} s = "
        f"{TIMED_STEPS / wall:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f} "
        f"ms/step)")
    check(np.isfinite(m.q).all() and np.isfinite(m.c).all()
          and math.isfinite(m.cvar), "QGModel: non-finite state")
    check(mm.csplit_matmul.launches == 0 and mm.csplit_matmul.cpu_calls == 0,
          "QGModel on cuFFT called K1")
    del m
    m64 = qg_flagship(pkg.QGModel, ic, backend="native", dtype=np.float64)
    m64.run_steps(WARM_STEPS)
    cross("QGModel", s32, {k: getattr(m64, k) for k in qg_fields}, qg_fields)
    del m64
    torch.cuda.empty_cache()
    return launches


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

    count = mm.csplit_matmul
    tmp = tempfile.mkdtemp(prefix="niwqg_io_")
    snapdir = os.path.join(tmp, "snapshots")
    try:
        zero_k1_counts(mm)
        t0 = time.perf_counter()
        m = flagship(CoupledModel, ic, backend="mxu", dtype=np.float32,
                     precision="split", transform_opts=K1_TRANSFORM,
                     tdiags=1, tsave_snapshots=IO_SNAP_EVERY,
                     tmax=IO_STEPS * DT)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_set = count.launches
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
            n0, t0 = count.launches, time.perf_counter()
            save_snapshot(model, fields)
            torch.cuda.synchronize()
            snap_ms.append(1e3 * (time.perf_counter() - t0))
            snap_launches += count.launches - n0

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
        n_pass1 = count.launches - n_set
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
        n0 = count.launches
        m.run()
        torch.cuda.synchronize()
        n_pass2 = count.launches - n0
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
        f"{count.launches_tc} of {count.launches} on the tensor-core route; "
        f"card {smi_name_power()}")
    check(snap_launches == 0, "phase 9: a snapshot launched K1")
    check(count.cpu_calls == 0, "phase 9: K1 ran its plain version")
    check(n_pass1 == per_step * IO_STEPS
          and n_pass2 == per_step * (IO_STEPS - 2),
          f"phase 9: expected {per_step} K1 launches per step "
          f"({K1_PER_STEP} a step, {K1_PER_DIAG} a diagnostics sample)")
    check(count.launches_tc == count.launches and count.launches_f32 == 0,
          "phase 9: K1 launches off the tensor-core route")
    return count.launches


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
    count = mm.csplit_matmul
    before = (count.launches, count.launches_tc, count.launches_f32)
    re, im = mm.csplit_matmul(*args)
    torch.cuda.synchronize()
    after = (count.launches, count.launches_tc, count.launches_f32)
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
    if rank == 0:
        np.savez(os.path.join(outdir, f"{route}.npz"), q=q, phi=phi, ke=ke,
                 wall=wall, t_build=t_build, n_set=n_set, n_warm=n_warm,
                 n_timed=n_timed, n_ckpt=n_ckpt, ckpt_equal=ckpt_equal,
                 ckpt_ms=ckpt_ms, paths=paths, finite=finite,
                 backend=backend, cpu_calls=fwd.cpu_calls + inv.cpu_calls,
                 k2_ms=k2_ms, k2_inv_ms=k2_inv_ms, lib_ms=lib_ms,
                 lib_inv_ms=lib_inv_ms, k2_dev=k2_dev, k2_inv_dev=k2_inv_dev,
                 lib_dev=lib_dev, lib_inv_dev=lib_inv_dev,
                 device=str(mesh.device))
    if tr._group is not None:
        tr._group.close()
    multihost.shutdown()


def has_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def sharded_checkpoint(torch, m):
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
    fields = ("q", "phi", "Ke", "Pw", "Kw")
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


def sharded_phase(torch, refs):
    """Phase 7: the sharded main path on both routes; ``refs`` maps a name
    to the (q, phi, Ke) of a one-card run after WARM_STEPS steps."""
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
    k2_dev = (float(a["k2_dev"][0]), float(a["k2_inv_dev"][0]))
    return launches, lib, k2_dev


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="3,4,5,6,7,8,9",
                    help="phases to run beyond the card report and the "
                         "build (default: all; a partial run is for "
                         "debugging and prints no result lines)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",") if x}
    full = phases >= {3, 4, 5, 6, 7, 8, 9}

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
    from niwqg_tpu_torch.parallel import a2a

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

    refs = {}
    if 6 in phases and not full:
        k2_phase(torch, a2a)
    if 7 in phases and not full:
        sharded_phase(torch, refs)
    if 8 in phases and not full:
        family_phase(torch, mm)
    if 9 in phases and not full:
        io_phase(torch, mm, None)
    if not full:
        log("partial run: no result lines")
        return 0

    # -- 3. K1 against its plain version -------------------------------------
    rec = k1_record(torch, mm, NX, NX, NX, seed=1, dft=True, reps=10)
    k1_record(torch, mm, 520, 384, 264, seed=2, dft=False, reps=0)  # ragged
    k1_record(torch, mm, 130, 17, 65, seed=3, dft=False, reps=0)  # f32 route
    k1_mean_mode(torch, mm)

    # -- 4. the main path ------------------------------------------------------
    zero_k1_counts(mm)
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
    main_sps = TIMED_STEPS / wall
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
    check(mm.csplit_matmul.launches_tc == launches
          and mm.csplit_matmul.launches_f32 == 0,
          f"the main path's {launches} K1 launches did not all take the "
          f"tensor-core route ({mm.csplit_matmul.launches_tc} did, "
          f"{mm.csplit_matmul.launches_f32} took the f32-FMA route)")
    log(f"all {launches} K1 launches of the main path took the tensor-core "
        "route")
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
    refs["one-card f64 cuFFT"] = (q64, phi64, ke64)
    del m64
    torch.cuda.empty_cache()

    # the one-card reference of the sharded run: f32 on cuFFT, fast kernel,
    # with the full-spectrum q side the mesh runs (q_half=False), and with
    # the one-card default (q_half=True) for its steps per second
    for q_half in (False, True):
        m32 = flagship(CoupledModel, ic, backend="native", dtype=np.float32,
                       fast=True, q_half=q_half)
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
        del m32
        torch.cuda.empty_cache()

    # -- 6. K2 against its plain version ---------------------------------------
    k2_recs, ncards = k2_phase(torch, a2a)

    # -- 7. the sharded main path ------------------------------------------------
    launches, lib, k2_dev = sharded_phase(torch, refs)
    for i, name in enumerate(("all_to_all_fwd", "all_to_all_inv")):
        k2_recs[name]["launches"] = launches[i]
        k2_recs[name]["library_ms"] = lib[i]
        if ncards == NRANKS:
            # a card per rank: the kernel's time is the production layout's,
            # a process per rank (the bound is the same as phase 6's)
            k2_recs[name]["ms"] = k2_dev[i]

    # -- 8. the model family ------------------------------------------------------
    rec["launches"] += family_phase(torch, mm)

    # -- 9. output, run_with_snapshots and a checkpoint -----------------------
    rec["launches"] += io_phase(torch, mm, main_sps)

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
    print(json.dumps({"kernels": kernels}))
    print(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
