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
     phase 11c), at a rank's x-pass on phase 12's mesh (512x2048 @
     2048x2048), at a chunk's y-pass on its default route (256x2048 @
     2048x2048), at phase 13's (4096x4096 @ 4096x4096, and a rank's
     x-pass on the matmul-DFT's mesh there, 1024x4096 @ 4096x4096) and a
     ragged one, the f32-FMA kernel against the f32 plain
     version at a shape that takes that route, and a sum of 2048 equal
     terms (the mean mode); then the times at the first six shapes
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
     the 8-byte path, timed too) and phase 13's blocks at 4096² (3 fields,
     R=1024, W=1024; QG's 4 fields, R=1024, W=513 on the 8-byte path,
     both timed), both directions, bit-exact; then forward and
     inverse 50 times back to back with no host synchronise; its time per
     launch on the device (CUDA events around calls enqueued behind a
     device-side sleep) and per call on the host, the old host-clock figure
     (back-to-back calls closed by a synchronise, the first design's), the
     plain version's time and the bound (bytes: each block read and
     written once in HBM, the share that changes cards over NVLink); then
     the mesh's other exchanges inside a step on the same kernel,
     ``a2a.all_reduce`` (its gather kind: sum and maximum of a float32
     vector) and ``a2a.reflect_exchange`` (the Hermitian reflection's
     uneven exchange at the flagship's (512, 2048) rows), each bit-exact
     against its plain version and timed;
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
     (``qg_flagship``), ``UnCoupledModel``, ``QLModel`` and ``YBJModel``
     (default quirks, fast kernel, the flagship's physics with the
     packet) at 2048² in f32 on the K2 route, each with K2's counts set
     to 0 just before it: steps/s over 2 warm-up and 3 timed steps, K2's
     launches per step against ``K2_PER_STEP_FAMILY`` (QG's all on the
     ragged path, the wave models' all aligned, no plain-version call),
     the gathered fields after 2 steps against the one-card f32 cuFFT run
     (``SHARD_RTOL``), QG's checkpoint round trip bitwise. Every model of
     the K2 route, the flagship first, also passes the mesh graph check
     (``mesh_graph_check``): ``run()`` and ``run_steps`` replay CUDA
     graphs on every rank, bitwise the eager mesh loop on every rank;
     K2's launches by kind (transposes, gathers for the step's sums and
     maxima, reflections) and K1's in one replay of A and of B against
     ``K2_GRAPH`` and ``K1_GRAPH``; replays with every collective of
     ``torch.distributed`` and every host sync refused; steps/s with
     graphs and eagerly. Then K2 alone at QG's block shape, each
     direction bit-exact against its plain version and timed on the
     device (with NCCL at the same blocks in the default route's spawn
     where every rank has its own card). Their launches count in the
     result line's ``launches`` too. On the default route, where every
     rank has its own card (NCCL), the flagship and then QG + scalar,
     UnCoupled, QL and YBJ (``DEFAULT_FAMILY_MESH_RUNS``: each K2 row with
     ``pallas_a2a`` off, the chunks kept) pass the same checks and the
     same mesh graph check, their graphs holding NCCL's collectives: the
     library's all_to_all_single, sums, maxima and reflections in one
     replay of A and of B against ``LIB_GRAPH`` (recorded at the capture,
     ``record_graph_collectives``), no K2 launch; NCCL's ``all_reduce``
     of K2's gather vector and the reflection's uneven
     ``all_to_all_single`` are timed there (``library_ms`` of K2's gather
     and reflect kinds). Where the ranks share a card the default route
     is gloo, which stages every payload through the host: the flagship
     calls its step directly, the log says so with the backend's name,
     and the other models run on the K2 route alone;
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
     complex128 ``torch.fft``;
 12. the matmul-DFT on the mesh (``backend='mxu'`` with ``mesh=``, the JAX
     package's GSPMD branch; ``niwqg_tpu_torch/parallel/mfft.py``): four
     ranks in four processes at 2048² in f32 with K2 as the transpose
     (``MXU_MESH_MODEL``), (a) the five models with JAX's default options
     as phase 11(a) builds them, then (k) phase 4's Coupled flagship in the
     K1 configuration (``K1_MESH_MODEL``), each with K1's and K2's counts
     set to 0 just before it is built: 2 warm-up and 3 timed steps,
     steps/s, K2's launches per step and rank against ``K2_PER_STEP_MXU``
     and K1's against ``K1_PER_STEP_MESH`` (none in (a); all tensor-core,
     no plain-version call), the gathered fields after 2 steps against the
     one-card run of the same options (phase 11(a)'s, phase 4's;
     ``SHARD_RTOL``), the Coupled model's checkpoint round trip bitwise,
     and each run through phase 7's mesh graph check. Then (a)'s Coupled
     model and (k) on the default route (``DEFAULT_MXU_MESH_RUNS``): the
     same steps, pins (no K2 launch; (k) ``K1_PER_STEP_MESH_DEFAULT`` K1
     launches a step, each y-pass once a chunk) and comparison with one
     card, and, on NCCL, the mesh graph check with ``LIB_GRAPH``; on a
     shared card (gloo) they call the step directly. Rank 0's launches
     count in the result line;
 13. the north star's grid, 4096² (``NX_BIG``): on one card the flagship
     in f64 on cuFFT (the reference, 2 steps), then in f32 on cuFFT
     (``q_half=False``, the mesh's reference), with the matmul-DFT's
     default options (resolved to ``MXU_RESOLVED_BIG``: the mirror-free
     real path over a (128, 32) four-step, printed and checked) and in
     the K1 configuration (40 K1 launches a step at 4096³, all on the
     tensor-core route, no plain-version call), each built with K1's
     counts set to 0: 2 eager steps, the same 2 from the same state
     through ``run_steps`` as replayed CUDA graphs (bitwise, GRAPH_RTOL
     where not), 3 timed steps, peak memory of both forms and the
     capture's ms, then held to the f64 run (``CROSS_RTOL``; Pw and Kw
     shown); QG + scalar in f32 on cuFFT (the mesh's reference); then four
     ranks in four processes (``BIG_MESH_RUNS``): the pencil flagship and
     QG + scalar on the K2 route (the ragged path), the matmul-DFT's mesh
     with (a) JAX's default options and (k) the K1 configuration (40 K1
     launches a step and rank at ``K1_MESH_BIG``, all on the tensor-core
     route), on NCCL also the flagship on the default route, each with
     its counts set to 0 just before it is built, its launches per step
     against the 2048² pins, within ``SHARD_RTOL`` of the one-card f32
     run of the same options, through phase 7's mesh graph check (every
     rank bitwise its eager loop, the launches of one replay against the
     2048² rows' graph pins) and the communication census of one eager
     step (``niwqg_tpu_torch/utils/census.py``: the fields of each
     transform, the transposes' bytes held to the census's model,
     ``transport_over_model`` 1.0, gathers and reflections apart, K1's
     calls by shape); then K2 alone at the phase's block shapes,
     bit-exact and timed (NCCL beside it where every rank has its own
     card), and K2's gather kind in that layout. Rank 0's launches count
     in the result line, and the K1 and K2 records carry the 4096 shapes
     under ``shapes`` (K1's (1024, 4096, 4096) with (k)'s launches); the
     phase's seconds are printed;
 14. the fast kernel's fused derive (``csrc/derive.cu``,
     ``niwqg_tpu_torch/ops/derive_fused.py``) on the flagship's half layout
     at 2048² on one card: each kernel and the whole derive against the
     plain chain on the same CUDA tensors, bit for bit (``derive_gaps``),
     then timed beside the plain chain and its bound (its bytes at
     ``PEAK_BYTES``). Phase 13 does the same on every rank of its 4096²
     pencil flagship and times rank 1's (4096, 1024) block
     (``mesh_derive``). The kernels count their launches on the card: the
     main path (phase 4) and every run of ``_runs_on_mesh`` (phases 7, 12
     and 13) are held to DERIVES_PER_STEP a step of each kernel their
     layout uses and set_q's one inversion on the half layout
     (``derive_report``). The records, with the launches of phase 4 and of
     rank 0 in phase 13, join the result line's ``kernels``. The same
     phase holds the fused stage epilogue (``csrc/stage.cu``,
     ``niwqg_tpu_torch/ops/stage_fused.py``): in each use ``Fn`` and
     ``Fnw`` bit for bit the plain chain and the budget partials within
     STAGE_PART_LIMIT of the float64 total of their terms
     (``stage_gaps``), timed beside the plain chain and its bound, its
     launches over STAGE_RUN_STEPS steps with diagnostics (one a stage,
     one sources-only a sample); phase 13 checks it on every rank of the
     pencil flagship and times rank 1's (``mesh_stage``); phase 4 and
     every ``_runs_on_mesh`` run hold its launches to ``stage_use`` a step
     (``stage_report``). Then the QG model's fused stage gaps
     (``csrc/qg_stage.cu``, ``niwqg_tpu_torch/ops/qg_fused.py``) on
     ``qg_flagship``'s half layout (``qg_phase``): every batch, right-hand
     side and ``ph`` of the pack, the products and stages 1-4, and two whole
     steps' fields, bit for bit the plain chain, the budget partials within
     STAGE_PART_LIMIT (``qg_gaps``); each use timed beside its bound and
     its plain chain, and a whole step fused and plain; the launches by use
     (QG_PER_STEP a step) and ``step.qg_fused`` in eager steps, captures and
     replays of graphs A and B. Phase 13 checks them on every rank of QG +
     scalar at 4096² and times rank 1's (4096, 513) block (``mesh_qg``);
     every ``_runs_on_mesh`` run holds their launches to ``qg_use`` a step
     (``qg_report``). Last, the YBJ model's fused stage gaps
     (``csrc/ybj_stage.cu``, ``niwqg_tpu_torch/ops/ybj_fused.py``) at
     NX² on one card (``ybj_phase``): every batch, right-hand side and
     ``phih`` of the pack, the products and stages 1-4, and two whole
     steps' YBJ_FIELDS, bit for bit the plain chain (``ybj_gaps``); each
     use timed beside its bound and its plain chain, and a whole step
     fused and plain; the launches by use (YBJ_PER_STEP a step) and
     ``step.ybj_fused`` beside ``step.ybj`` in eager steps, captures and
     replays of graphs A and B.

Every ``run_steps``, ``run`` and ``run_with_snapshots`` above replays
the step's CUDA graphs (``niwqg_tpu_torch/graphs.py``), on one card, on
the mesh's K2 route and on its default route where every rank has its
own card (NCCL's collectives inside the graphs); on a card shared by the
four ranks the default route (gloo) calls the step directly. K1 and K2
count their own launches on the card, so a replayed launch counts as any
other (``csplit_mm.counts``, ``a2a.counts``). K1's
``launches`` in the result line counts phases 4, 8, 9, 11, 12 (rank
0) and 13, each with its graph runs; K2's four wrappers (the two
transposes, ``all_reduce``, ``reflect_exchange``) count rank 0's in phases
7, 12 and 13.
The
ETDRK4 tables' disk cache lives in a directory of the run's own, removed
at its end, so models of one physics share their tables.

The line before the last holds the card's name and power limit; the one
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

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
REDUCE_LEN = 5            # phase 6: the float32 vector of K2's all_reduce
# K2's wrappers in the result line, by kind (fwd, inv, gather, reflect)
K2_RECORDS = ("all_to_all_fwd", "all_to_all_inv", "all_reduce",
              "reflect_exchange")
# 4 stages x (3 forward + 2 inverse) transposes of the fast kernel on the
# pencil mesh (see PERF.md)
K2_FWD_PER_STEP, K2_INV_PER_STEP = 12, 8
# K2 launches (forward, inverse) per step and rank of two more models on the
# pencil mesh, in their default quirk modes: QG's 4 stages x 1 forward and
# 4 + 1 inverses, all on the ragged path (nx/2+1+pad columns); UnCoupled's
# fast kernel with its physical-space sources; tests/test_torch_sharded_models.py
# holds this table to JAX's trace
K2_PER_STEP_FAMILY = {"QGModel": (4, 5), "UnCoupledModel": (8, 16),
                      "QLModel": (12, 12), "YBJModel": (4, 7)}
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
# phase 12: the matmul-DFT on the mesh (JAX's GSPMD branch), 4 ranks, JAX's
# default options and K2 as the transpose
MXU_MESH_MODEL = dict(MXU_MODEL, transform_opts=dict(SHARD_OPTS))
K1_MESH_MODEL = dict(K1_MODEL, transform_opts=dict(K1_TRANSFORM,
                                                   **SHARD_OPTS))
# K2 launches (forward, inverse) per step and rank there, each model as
# phase 11(a) builds it (QG with its scalar); the Coupled model's K1
# configuration makes the Coupled model's; tests/test_torch_mxu_mesh.py
# holds this table to the port's count on 4 gloo ranks
K2_PER_STEP_MXU = {"CoupledModel": (12, 8), "UnCoupledModel": (8, 16),
                   "QLModel": (12, 12), "YBJModel": (4, 7),
                   "QGModel": (4, 5)}
# K1 launches per step and rank of the Coupled flagship in the K1
# configuration on that mesh: both passes of each complex 2-D transform,
# products of nx/NRANKS rows at K = N = nx (the half-spectrum pencils,
# (nx/2+1+pad)/NRANKS columns, fail rows % 8, as 1025 rows do on one
# card). Not pinned to JAX's trace: under GSPMD JAX traces its Pallas call
# at the global shapes, which says nothing of the port's local blocks;
# tests/test_torch_mxu_mesh.py counts them by shape on 4 gloo ranks
K1_PER_STEP_MESH = {"CoupledModel": 40}
# phases 7 and 12, the mesh graph check (``mesh_graph_check``): steps of
# each run from one in-memory checkpoint, a status line every
# MESH_GRAPH_TWRITE (a chunk ends there), a diagnostics sample every step;
# the models of the K2 route are built with this cadence
MESH_GRAPH_STEPS, MESH_GRAPH_TWRITE = 4, 2
MESH_GRAPH_RUN = dict(tdiags=1, twrite=MESH_GRAPH_TWRITE,
                      tmax=(WARM_STEPS + TIMED_STEPS + MESH_GRAPH_STEPS) * DT)
# K2's launches in one replay of graph A (a step) and of graph B (a step
# with a diagnostics sample, the stale-gradient refresh after it), per rank
# on the K2 route, by kind: (forward, inverse, gather, reflect). The
# gathers are the step's domain sums and maxima (a2a.all_reduce), the
# reflections the Hermitian projections' exchanges (a2a.reflect_exchange);
# A's transposes are the tables above. tests/test_torch_mesh_graph.py holds
# this table to the port's count on 4 gloo ranks
K2_GRAPH = {
    "flagship": ((12, 8, 1, 4), (13, 14, 16, 4)),
    "qg": ((4, 5, 16, 0), (6, 5, 25, 0)),
    "unc": ((8, 16, 1, 4), (8, 26, 14, 4)),
    "ql": ((12, 12, 1, 4), (13, 15, 13, 5)),
    "ybj": ((4, 7, 0, 0), (4, 15, 12, 0)),
    "CoupledModel": ((12, 8, 1, 0), (13, 14, 16, 0)),
    "UnCoupledModel": ((8, 16, 1, 0), (8, 26, 14, 0)),
    "QLModel": ((12, 12, 1, 4), (13, 15, 13, 5)),
    "YBJModel": ((4, 7, 0, 0), (4, 15, 12, 0)),
    "QGModel": ((4, 5, 16, 0), (6, 5, 25, 0)),
    "k1": ((12, 8, 1, 0), (13, 14, 16, 0)),
}
# K1's launches a step and rank of that configuration on the mesh's
# default route (overlap_chunks=2): the transposes are the library's in two
# chunks, and each chunk takes its own y-pass (parallel/pfft.py), so the 20
# y-passes of a step become 40 at half the columns, (nx/8, nx, nx) products
# (K2 takes the chunks inside its kernel: one y-pass a transpose)
K1_PER_STEP_MESH_DEFAULT = 60
# K1's launches in one replay of A and of B of the K1 configuration on the
# mesh (K1_PER_STEP_MESH, and K1_PER_DIAG more a sample), on the K2 route
# and on the default route
K1_GRAPH = {"k1": (40, 48), "default_k1": (60, 72)}
# the mesh's default route (no pallas_a2a): the library's collectives in
# one replay of graph A and of B, per rank, by kind (LIB_KINDS): the
# transposes' all_to_all_single (overlap_chunks=2: two a full-spectrum
# transpose, one a half-spectrum one, whose 257 columns a rank do not
# split), the all_reduce of the domain sums and of the maxima, the
# reflection's uneven all_to_all_single. A K2 row's graphs hold none.
# tests/test_torch_mesh_graph.py holds this table to the port's count on 4
# gloo ranks
LIB_KINDS = ("all_to_all_single", "sum", "max", "reflect")
LIB_GRAPH = {
    "default_flagship": ((40, 1, 0, 4), (54, 16, 0, 4)),
    "default_qg": ((9, 16, 0, 0), (11, 25, 0, 0)),
    "default_unc": ((48, 1, 0, 4), (68, 14, 0, 4)),
    "default_ql": ((48, 1, 0, 4), (56, 13, 0, 5)),
    "default_ybj": ((22, 0, 0, 0), (38, 12, 0, 0)),
    "default_CoupledModel": ((28, 1, 0, 0), (38, 16, 0, 0)),
    "default_k1": ((28, 1, 0, 0), (38, 16, 0, 0)),
}

# phase 13: the north star's grid. Every one-card configuration of the
# flagship at NX_BIG, and the pencil mesh's flagship and QG + scalar; the
# matmul-DFT's defaults in f32 at nx >= 4096 take the mirror-free real
# path over a (128, 32) four-step (tests/test_torch_scale.py holds this to
# JAX's MXUTransform)
NX_BIG = 4096
MXU_RESOLVED_BIG = dict(MXU_RESOLVED, factors=(128, 32), half_factors=None,
                        realpath="mf")
# QG's half spectrum on the mesh there: 2049 columns padded to 2052, 513 a
# rank (complex64 row segments of 4104 bytes: K2's ragged path)
QG_WR_BIG = (NX_BIG // 2 + 1 + (-(NX_BIG // 2 + 1)) % NRANKS) // NRANKS
# K2's blocks there: the flagship's transposes (3 fields), QG's (4)
K2_BIG = (K2_LEAD, NX_BIG // NRANKS, NRANKS * (NX_BIG // NRANKS))
QG_K2_BIG = (QG_LEAD, NX_BIG // NRANKS, NRANKS * QG_WR_BIG)


@contextlib.contextmanager
def strict_replays(m):
    """Inside, every collective of ``torch.distributed`` raises, and so does
    every synchronising CUDA call (``torch.cuda.set_sync_debug_mode``);
    the diagnostics rows of the chunks are fetched after it. Holds that
    the model's runner captured nothing inside: every step a replay."""
    import torch
    import torch.distributed as dist

    names = [n for n in ("all_reduce", "all_gather", "all_gather_object",
                         "all_gather_into_tensor", "all_to_all",
                         "all_to_all_single", "barrier", "broadcast",
                         "broadcast_object_list", "gather", "irecv", "isend",
                         "recv", "reduce", "reduce_scatter",
                         "reduce_scatter_tensor", "scatter", "send")
             if hasattr(dist, n)]
    saved = {n: getattr(dist, n) for n in names}

    def refuse(*args, **kwargs):
        raise RuntimeError("torch.distributed was called inside a replayed "
                           "chunk")

    acc, fetched = m._diag_acc, []
    variants = m._runner.variants()
    mode = torch.cuda.get_sync_debug_mode()
    acc.append_rows = lambda *a: fetched.append(a)
    for n in names:
        setattr(dist, n, refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        for n, f in saved.items():
            setattr(dist, n, f)
        del acc.append_rows
    for a in fetched:
        acc.append_rows(*a)
    check(m._runner.variants() == variants,
          "a graph was captured inside the strict replays")


@contextlib.contextmanager
def count_collectives():
    """Inside, every collective a step asks of the library counts by kind
    (``LIB_KINDS``) in the dict it yields: ``parallel.mesh.Mesh``'s
    ``all_to_all_single`` (with uneven splits the reflection's) and
    ``all_reduce`` (a sum or a maximum), on a mesh of more than one rank."""
    import torch.distributed as dist

    from niwqg_tpu_torch.parallel.mesh import Mesh

    n = dict.fromkeys(LIB_KINDS, 0)
    a2a_single, all_reduce = Mesh.all_to_all_single, Mesh.all_reduce

    def counted_a2a(self, send, out_splits=None, in_splits=None,
                    async_op=False):
        kind = "all_to_all_single" if out_splits is None else "reflect"
        n[kind] += self.nP > 1
        return a2a_single(self, send, out_splits, in_splits, async_op)

    def counted_reduce(self, t, op=dist.ReduceOp.SUM):
        n["max" if op == dist.ReduceOp.MAX else "sum"] += self.nP > 1
        return all_reduce(self, t, op)

    Mesh.all_to_all_single, Mesh.all_reduce = counted_a2a, counted_reduce
    try:
        yield n
    finally:
        Mesh.all_to_all_single, Mesh.all_reduce = a2a_single, all_reduce


def record_graph_collectives():
    """For the rest of this process (a rank of phases 7 and 12), each graph
    a ``graphs.StepRunner`` captures records the library's collectives it
    holds (``count_collectives`` over the capture, which runs nothing) as
    ``runner.lib[sampled]``, A under False and B under True: what every
    replay of that graph launches."""
    from niwqg_tpu_torch.graphs import StepRunner

    capture = StepRunner._capture

    def counted(self, sampled, template):
        with count_collectives() as n:
            g = capture(self, sampled, template)
        self.__dict__.setdefault("lib", {})[sampled] = [n[k]
                                                        for k in LIB_KINDS]
        return g

    StepRunner._capture = counted


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


MODEL_NAMES = ("CoupledModel", "UnCoupledModel", "QLModel", "YBJModel",
               "QGModel")


class MeshRun(NamedTuple):
    """A model configuration that phases 7 and 12 drive on the mesh
    (``_runs_on_mesh``) and hold (``mesh_checks``)."""
    key: str                      # its entries' prefix in rank 0's record
    name: str                     # the model (``MODEL_NAMES``, ``build_model``)
    build: dict                   # build_model's keywords beside mesh=
    label: str                    # how the log names it
    k2: tuple                     # K2 launches (forward, inverse) a step
    k1: int = 0                   # K1 launches a step
    ckpt: bool = False            # the in-memory checkpoint round trip
    paths: Optional[str] = None   # K2's one path ("aligned", "ragged")
    opts: Optional[dict] = None   # the matmul-DFT's options as resolved
    base: Optional[str] = None    # the K2 row this one repeats on the
    #                               default route (its one-card reference)
    pins: Optional[str] = None    # the row whose graph pins (K2_GRAPH,
    #                               K1_GRAPH, LIB_GRAPH) this one shares
    census: bool = False          # the communication census of one step


# phase 7: the flagship (its own loop, ``_sharded_rank``), then QG +
# scalar, UnCoupled, QL and YBJ (default quirks, the wave models' fast
# kernel) on the pencil FFT's K2 route, in the flagship's spawn
_PENCIL = dict(backend="native", dtype=np.float32, transform_opts=SHARD_OPTS)
PENCIL_FLAGSHIP = MeshRun("flagship", "CoupledModel", dict(_PENCIL, fast=True),
                          "sharded CoupledModel on the K2 route",
                          (K2_FWD_PER_STEP, K2_INV_PER_STEP), ckpt=True,
                          paths="aligned")
FAMILY_MESH_RUNS = (
    MeshRun("qg", "QGModel", _PENCIL, "sharded QGModel on the K2 route",
            K2_PER_STEP_FAMILY["QGModel"], ckpt=True, paths="ragged"),
    MeshRun("unc", "UnCoupledModel", dict(_PENCIL, fast=True),
            "sharded UnCoupledModel on the K2 route",
            K2_PER_STEP_FAMILY["UnCoupledModel"], paths="aligned"),
    MeshRun("ql", "QLModel", dict(_PENCIL, fast=True),
            "sharded QLModel on the K2 route",
            K2_PER_STEP_FAMILY["QLModel"], paths="aligned"),
    MeshRun("ybj", "YBJModel", dict(_PENCIL, fast=True),
            "sharded YBJModel on the K2 route",
            K2_PER_STEP_FAMILY["YBJModel"], paths="aligned"),
)
# phase 12: (a) the five models with JAX's defaults, (k) the flagship in
# the K1 configuration, on the matmul-DFT's mesh
MXU_MESH_RUNS = tuple(
    MeshRun(name, name, MXU_MESH_MODEL, f"phase 12 (a) JAX's defaults, {name}",
            K2_PER_STEP_MXU[name], ckpt=name == "CoupledModel",
            opts=MXU_RESOLVED) for name in MODEL_NAMES) + (
    MeshRun("k1", "CoupledModel", K1_MESH_MODEL,
            "phase 12 (k) the K1 configuration, CoupledModel",
            K2_PER_STEP_MXU["CoupledModel"],
            k1=K1_PER_STEP_MESH["CoupledModel"]),)


def default_route(run: MeshRun, label: str) -> MeshRun:
    """``run`` on the mesh's default route: the library's
    ``all_to_all_single`` in place of K2 (``pallas_a2a`` off, the chunks
    kept), so no K2 launch; its pins under ``"default_" + run.key``."""
    build = dict(run.build)
    build["transform_opts"] = {k: v for k, v in
                               build["transform_opts"].items()
                               if k != "pallas_a2a"}
    return run._replace(key="default_" + run.key, build=build, label=label,
                        k2=(0, 0), ckpt=False, paths=None, base=run.key,
                        pins=run.pins and "default_" + run.pins)


# phase 7's default route: the flagship (its own loop), then, where every
# rank has its own card (NCCL), the other four models
DEFAULT_FLAGSHIP = default_route(
    PENCIL_FLAGSHIP, "sharded CoupledModel on the default route")
DEFAULT_FAMILY_MESH_RUNS = tuple(
    default_route(run, run.label.replace("K2 route", "default route"))
    for run in FAMILY_MESH_RUNS)
# phase 12's default route: (a) the Coupled model with JAX's defaults and
# (k) the K1 configuration
DEFAULT_MXU_MESH_RUNS = (
    default_route(MXU_MESH_RUNS[0], "phase 12 (a) JAX's defaults, "
                  "CoupledModel, default route"),
    default_route(MXU_MESH_RUNS[-1], "phase 12 (k) the K1 configuration, "
                  "CoupledModel, default route")._replace(
                      k1=K1_PER_STEP_MESH_DEFAULT))

# phase 13's mesh runs at NX_BIG: the pencil flagship and QG + scalar on
# the K2 route, then the matmul-DFT's mesh with (a) JAX's defaults and (k)
# the K1 configuration (40 K1 launches a step and rank at (NX_BIG/NRANKS,
# NX_BIG, NX_BIG)), the flagship on the default route where every rank has
# its own card; each with the mesh graph check and the census of one step.
# The pins are the 2048² rows' (the structure of a step does not depend on
# nx), the graph pins too (``pins``). After the census step the mesh graph
# check runs one step a form (phases 7 and 12 run MESH_GRAPH_STEPS): (k)
# takes ~1.5 s a step on a shared card, and the phase keeps to its time
BIG_MESH_BUILD = dict(nx=NX_BIG, tmax=(WARM_STEPS + TIMED_STEPS + 2) * DT)
BIG_MESH_RUNS = (
    PENCIL_FLAGSHIP._replace(
        key="big_flagship", build=dict(PENCIL_FLAGSHIP.build,
                                       **BIG_MESH_BUILD),
        label=f"phase 13: sharded CoupledModel at {NX_BIG}² on the K2 route",
        ckpt=False, pins="flagship", census=True),
    FAMILY_MESH_RUNS[0]._replace(
        key="big_qg", build=dict(FAMILY_MESH_RUNS[0].build,
                                 **BIG_MESH_BUILD),
        label=f"phase 13: sharded QGModel + scalar at {NX_BIG}² on the K2 "
              "route", ckpt=False, pins="qg", census=True),
    MXU_MESH_RUNS[0]._replace(
        key="big_a", build=dict(MXU_MESH_MODEL, **BIG_MESH_BUILD),
        label=f"phase 13 (a) JAX's defaults, CoupledModel at {NX_BIG}² on "
              "the K2 route", ckpt=False, opts=MXU_RESOLVED_BIG,
        pins="CoupledModel", census=True),
    MXU_MESH_RUNS[-1]._replace(
        key="big_k1", build=dict(K1_MESH_MODEL, **BIG_MESH_BUILD),
        label=f"phase 13 (k) the K1 configuration, CoupledModel at "
              f"{NX_BIG}² on the K2 route", pins="k1", census=True),
)
# K1's one shape in (k) at NX_BIG: a rank's x-pass, and under 'swap' its
# y-pass on a column block's NX_BIG/NRANKS columns
K1_MESH_BIG = (NX_BIG // NRANKS, NX_BIG, NX_BIG)
BIG_DEFAULT_RUNS = (default_route(
    BIG_MESH_RUNS[0], f"phase 13: sharded CoupledModel at {NX_BIG}² on the "
    "default route"),)


def build_model(pkg, ic, name, **kw):
    """Phase 11(a)'s model ``name`` (``MODEL_NAMES``): the flagship, the
    wave packet added on the three other wave models, QG with its scalar
    (``qg_flagship``)."""
    if name == "QGModel":
        return qg_flagship(pkg.QGModel, ic, **kw)
    return flagship(getattr(pkg, name), ic, packet=name != "CoupledModel",
                    **kw)


def mesh_fields(name):
    """What phase 12 holds a mesh run to its one-card run on."""
    return ("q", "c", "Ke") if name == "QGModel" else WAVE_FIELDS


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
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                shape=[M, K, N], fma_ms=0.5 * (f1 + f2),
                fma_bound_ms=1e3 * t_f32, plain_f32_ms=0.5 * (q1 + q2))


def k1_phase(torch, mm):
    """Phase 3: K1 at every shape the paths send it, against its plain
    versions, timed where the paths run it. Returns the main path's
    record and the records at phase 13's shapes."""
    rec = k1_record(torch, mm, NX, NX, NX, seed=1, dft=True, reps=10)
    # the even/odd configuration's half-length DFT (phase 11c)
    k1_record(torch, mm, NX, NX // 2, NX // 2, seed=4, dft=True, reps=10)
    # a rank's x-pass on phase 12's mesh in the K1 configuration, and a
    # chunk's y-pass there on the default route
    k1_record(torch, mm, NX // NRANKS, NX, NX, seed=5, dft=True, reps=10)
    k1_record(torch, mm, NX // NRANKS // 2, NX, NX, seed=6, dft=True,
              reps=10)
    # phase 13's K1 configuration at NX_BIG, and a rank's x-pass on the
    # matmul-DFT's mesh there
    shapes = [k1_record(torch, mm, NX_BIG, NX_BIG, NX_BIG, seed=7, dft=True,
                        reps=4),
              k1_record(torch, mm, NX_BIG // NRANKS, NX_BIG, NX_BIG, seed=8,
                        dft=True, reps=10)]
    k1_record(torch, mm, 520, 384, 264, seed=2, dft=False, reps=0)  # ragged
    k1_record(torch, mm, 130, 17, 65, seed=3, dft=False, reps=0)  # f32 route
    k1_mean_mode(torch, mm)
    return rec, shapes


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


def k2_bound_ms(nbytes_rank, cards, nranks=NRANKS):
    """Least time for one launch of all ``nranks`` ranks: every rank's
    block is read once and written once in HBM (ranks that share a card
    share its HBM), and what changes cards crosses NVLink, each card
    sending at PEAK_LINK."""
    per_card = nranks // cards
    t_hbm = per_card * 2.0 * nbytes_rank / PEAK_BYTES
    t_link = per_card * nbytes_rank * (nranks - per_card) / nranks / PEAK_LINK
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
    # phase 13's blocks at NX_BIG: the flagship's (100.7 MB a rank) and
    # QG's (513 columns a rank, the 8-byte path)
    exact(K2_BIG, torch.complex64, 2, seed=13)
    exact(QG_K2_BIG, torch.complex64, 1, seed=14)

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
    # phase 13's block shapes, device time only
    for shape, chunks in ((K2_BIG, 2), (QG_K2_BIG, 1)):
        nb = int(np.prod(shape)) * 8
        bound_big = k2_bound_ms(nb, ncards)[0]
        W = shape[-1] // NRANKS
        zb = blocks(shape, torch.complex64, seed=15)
        zbi = [o.clone() for o in a2a.all_to_all_fwd(zb, group,
                                                     chunks=chunks)]
        for name, fn, arg, shp in (
                ("all_to_all_fwd", a2a.all_to_all_fwd, zb, shape),
                ("all_to_all_inv", a2a.all_to_all_inv, zbi,
                 (shape[0], NRANKS * shape[1], W))):
            dev = k2_times(torch, lambda: fn(arg, group, chunks=chunks),
                           cards, K2_PAIRS)[0]
            path = a2a.path(W, chunks, 8)
            log(f"K2 {name} at {shp} complex64 ({path} path), {NRANKS} "
                f"ranks x {nb / 1e6:.1f} MB on {ncards} card(s) in one "
                f"process: device {dev:.4f} ms per launch; bound "
                f"{bound_big:.4f} ms, {100 * bound_big / dev:.1f}% of it "
                "reached")
            recs.setdefault("shapes", {}).setdefault(name, []).append(dict(
                shape=list(shp), path=path,
                layout=f"{NRANKS} ranks of one process on {ncards} card(s)",
                ms=dev, bound_ms=bound_big, bound_by="bytes",
                library_ms=None))
        del zb, zbi
        torch.cuda.empty_cache()
    recs.update(k2_step_exchanges(torch, a2a, group, devices, ncards,
                                  blocks, sync, timed))
    if ncards < NRANKS:
        log(f"K2 times above were taken with {NRANKS} ranks on {ncards} "
            "card(s): ranks that share a card share its HBM and SMs, so "
            "these are not multi-card times")
    return recs, ncards


def k2_step_exchanges(torch, a2a, group, devices, ncards, blocks, sync,
                      timed):
    """Phase 6 on the mesh's other exchanges inside a step, K2's gather and
    reflect kinds, four ranks in one process: ``a2a.all_reduce`` (sum and
    maximum of a float32 vector of REDUCE_LEN, a domain sum's size) and
    ``a2a.reflect_exchange`` at the flagship's reflection (a column
    block of ph, (nx/4, nx) complex64 rows), each bit-exact against its
    plain version on every rank, then timed as the transposes are."""
    rng = np.random.default_rng(11)
    cards = sorted(set(devices), key=str)
    recs = {}
    for op in ("sum", "max"):
        vs = [torch.as_tensor(rng.standard_normal(REDUCE_LEN),
                              dtype=torch.float32, device=d) for d in devices]
        got = a2a.all_reduce(vs, group, op)
        sync()
        want = a2a.all_reduce_ref([v.cpu() for v in vs], op)
        for r in range(NRANKS):
            check(torch.equal(got[r].cpu(), want), f"K2 all_reduce({op}) "
                  f"differs from its plain version on rank {r}")
    ws = blocks((K2_W, NX), torch.complex64, seed=12)
    got = a2a.reflect_exchange(ws, group)
    sync()
    want = a2a.reflect_exchange_ref([w.cpu() for w in ws])
    for r in range(NRANKS):
        check(torch.equal(got[r].cpu(), want[r]), "K2 reflect_exchange "
              f"differs from its plain version on rank {r}")
    log(f"K2 all_reduce (sum, max of {REDUCE_LEN} float32) and "
        f"reflect_exchange ({K2_W}, {NX}) complex64: bit-exact on all "
        f"{NRANKS} ranks")
    for name, kern, ref, arg, nbytes, what in (
            ("all_reduce", lambda x: a2a.all_reduce(x, group, "sum"),
             lambda x: [a2a.all_reduce_ref(x, "sum")] * NRANKS, vs,
             # each rank's padded vector, copied to every peer
             NRANKS * 8 * 4, "with its pad, copy and rank-order sum"),
            ("reflect_exchange", lambda x: a2a.reflect_exchange(x, group),
             a2a.reflect_exchange_ref, ws, K2_W * NX * 8, "one launch")):
        bound, t_hbm, t_link = k2_bound_ms(nbytes, ncards)
        p1 = timed(ref, arg, 10)
        dev, host, host_med = k2_times(torch, lambda: kern(arg), cards,
                                       K2_PAIRS)
        p2 = timed(ref, arg, 10)
        log(f"K2 {name}, {NRANKS} ranks on {ncards} card(s) in one process: "
            f"device {dev:.4f} ms per call of all ranks ({what}; CUDA "
            f"events, {K2_PAIRS} calls behind a sleep), host {host:.1f} µs "
            f"per call (median {host_med:.1f}); plain {p1:.4f}/{p2:.4f} ms "
            f"(host clock); bound {bound:.6f} ms (bytes: HBM {t_hbm:.6f}, "
            f"NVLink {t_link:.6f})")
        recs[name] = dict(max_abs_err=0.0, ms=dev, plain_ms=0.5 * (p1 + p2),
                          bound_ms=bound, bound_by="bytes", library_ms=None)
    return recs


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
    record_graph_collectives()
    import torch.distributed as dist

    backend = dist.get_backend()
    opts = dict(SHARD_OPTS) if route == "k2" else {"overlap_chunks": 2}
    fwd, inv = a2a.all_to_all_fwd, a2a.all_to_all_inv

    def count():
        c = a2a.counts()
        return c["fwd"], c["inv"]

    a2a.reset_counts()  # every K2 count to 0 just before the main path
    t0 = time.perf_counter()
    m = flagship(CoupledModel, ic, backend="native", dtype=np.float32,
                 fast=True, mesh=mesh, transform_opts=opts, **MESH_GRAPH_RUN)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_set = count()
    m.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    n_warm = (count()[0] - n_set[0], count()[1] - n_set[1])
    q, phi, ke = m.q, m.phi, m.Ke  # collectives: every rank takes part
    mesh.barrier()
    t0 = time.perf_counter()
    m.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    mesh.barrier()
    wall = time.perf_counter() - t0
    n_timed = (count()[0] - n_set[0] - n_warm[0],
               count()[1] - n_set[1] - n_warm[1])
    q_end, ke_end = m.q, m.Ke
    finite = bool(np.isfinite(q_end).all() and math.isfinite(ke_end))
    n_ckpt, ckpt_equal, ckpt_ms = (0, 0), True, (np.nan, np.nan)
    run = PENCIL_FLAGSHIP if route == "k2" else DEFAULT_FLAGSHIP
    graph_rec = {f"{run.key}_g_graphs": m._runner.graphs,
                 f"{run.key}_g_why_not": str(m._runner.why_not)}
    if m._runner.graphs:
        # the mesh graph check, its launches counted apart (none on the
        # default route)
        g0 = a2a.counts()
        graph_rec.update(mesh_graph_check(torch, mesh, m, run))
        g = {k: v - g0[k] for k, v in a2a.counts().items()}
        graph_rec[f"{run.key}_g_launches"] = ([g[k] for k in a2a.KINDS]
                                              + [0, 0])
    if route == "k2":
        c0 = count()
        _, ckpt_equal, ckpt_ms = sharded_checkpoint(torch, m)
        n_ckpt = tuple(x - y for x, y in zip(count(), c0))
    # the main path's counts: the graph check's (all aligned) apart
    c = a2a.counts()
    gl = graph_rec.get(f"{run.key}_g_launches", [0] * 6)
    paths = (c["fwd_aligned"] + c["inv_aligned"] - gl[0] - gl[1],
             c["fwd_ragged"] + c["inv_ragged"])
    k2_all = [c[k] - gl[i] for i, k in enumerate(a2a.KINDS)]

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

    if route == "k2":  # not the main path: its counts were read above
        kf = lambda: fwd(z, tr._group, chunks=2)
        ki = lambda: inv(zi, tr._group, chunks=2)
        k2_ms, k2_inv_ms = timed(kf), timed(ki)
        k2_dev = k2_times(torch, kf, cards, K2_PAIRS, mesh.barrier)
        k2_inv_dev = k2_times(torch, ki, cards, K2_PAIRS, mesh.barrier)
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
    cpu_calls = (a2a.FAMILY.plain_calls("fwd")
                 + a2a.FAMILY.plain_calls("inv"))
    if tr._group is not None:
        tr._group.close()
    del m, tr
    torch.cuda.empty_cache()
    if route == "default" and backend == "nccl":
        # the library's calls beside K2's other kinds: all_reduce of the
        # gather's float32 vector, the reflection's uneven all_to_all_single
        # at the flagship's (nx/4, nx) complex64 rows
        vec = torch.full((REDUCE_LEN,), float(rank), device=mesh.device)
        a, b = a2a.reflect_partners(NRANKS, rank)
        splits = [0] * NRANKS
        splits[a] += 1
        splits[b] += K2_W - 1
        rows = torch.full((K2_W, NX), float(rank), dtype=torch.complex64,
                          device=mesh.device)
        rows_out = torch.empty_like(rows)
        lib_gather_dev = k2_times(torch, lambda: dist.all_reduce(vec), cards,
                                  K2_PAIRS, mesh.barrier)
        lib_reflect_dev = k2_times(
            torch, lambda: dist.all_to_all_single(rows_out, rows, splits,
                                                  splits),
            cards, K2_PAIRS, mesh.barrier)
    else:
        lib_gather_dev = lib_reflect_dev = nan3

    extra = dict(graph_rec, k2_all=k2_all, lib_gather_dev=lib_gather_dev,
                 lib_reflect_dev=lib_reflect_dev)
    if route == "k2":
        # the other models on the K2 route, in this spawn; then K2 alone at
        # QG's block shape (the ragged path)
        extra.update(_runs_on_mesh(torch, mesh, FAMILY_MESH_RUNS, after={
            "qg": lambda group, m: _ragged_k2(torch, mesh, rank, group)}))
    elif backend == "nccl":
        # the other models on the default route, where it is captured
        extra.update(_runs_on_mesh(torch, mesh, DEFAULT_FAMILY_MESH_RUNS))
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


def _runs_on_mesh(torch, mesh, runs, after=None):
    """Drive each ``MeshRun`` of ``runs`` on the mesh, in this spawn: K1's
    and K2's counts set to 0 just before it is built, WARM_STEPS steps,
    the fields then (a collective), TIMED_STEPS between barriers, the mesh
    census of one eager step where the run asks for it (its launches
    count with the run's), the mesh graph check where the runner captures
    (not the default route on gloo), the checkpoint round trip where the
    run asks for it; then
    ``after[key](group, m)`` (K2 alone at a shape of its own, whose
    launches are not the main path's; the fused derive on the model's
    kernel). The fused derive's launches are counted at set-up, in the
    warm-up, the timed steps and the census. Returns what rank 0 saves,
    each entry prefixed by the run's key."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.ops import csplit_mm as mm
    from niwqg_tpu_torch.ops import derive_fused as dv
    from niwqg_tpu_torch.ops import qg_fused as qf
    from niwqg_tpu_torch.ops import stage_fused as sf
    from niwqg_tpu_torch.parallel import a2a

    def launches():
        """(K2 forward, K2 inverse, K1) launches on this rank so far."""
        c = a2a.counts()
        return np.array([c["fwd"], c["inv"], mm.counts()["launches"]])

    out = {}
    for run in runs:
        key, fields = run.key, mesh_fields(run.name)
        a2a.reset_counts()  # every count to 0 just before the path
        mm.reset_counts()
        dv.reset_counts()
        sf.reset_counts()
        qf.reset_counts()
        kw = {k: dict(v) if isinstance(v, dict) else v
              for k, v in run.build.items()}
        t0 = time.perf_counter()
        m = build_model(pkg, ic, run.name, mesh=mesh,
                        **{**MESH_GRAPH_RUN, **kw})
        torch.cuda.synchronize()
        out[f"{key}_t_build"] = time.perf_counter() - t0
        n_set, d_set, s_set = launches(), derive_counts(), stage_counts()
        q_set = qg_counts()
        m.run_steps(WARM_STEPS)
        torch.cuda.synchronize()
        n_warm, d_warm = launches() - n_set, derive_counts() - d_set
        s_warm, q_warm = stage_counts() - s_set, qg_counts() - q_set
        warm = {k: getattr(m, k) for k in fields}  # collectives
        mesh.barrier()
        t0 = time.perf_counter()
        m.run_steps(TIMED_STEPS)
        torch.cuda.synchronize()
        mesh.barrier()
        out[f"{key}_wall"] = time.perf_counter() - t0
        n_timed = launches() - n_set - n_warm
        d_timed = derive_counts() - d_set - d_warm
        s_timed = stage_counts() - s_set - s_warm
        q_timed = qg_counts() - q_set - q_warm
        end = {k: getattr(m, k) for k in fields}
        out[f"{key}_finite"] = all(np.isfinite(v).all() for v in end.values())
        n_census, d_census, s_census = n_timed * 0, d_timed * 0, s_timed * 0
        q_census = q_timed * 0
        if run.census:
            # one eager step with the communication census on (a step of
            # the run: its launches count)
            from niwqg_tpu_torch.utils.census import step_census

            before, d_before, s_before = (launches(), derive_counts(),
                                          stage_counts())
            q_before = qg_counts()
            census = step_census(m)
            n_census, d_census = launches() - before, derive_counts() - d_before
            s_census = stage_counts() - s_before
            q_census = qg_counts() - q_before
            del census["transposes"]
            out[f"{key}_census"] = json.dumps(census)
            out[f"{key}_census_ok"] = all(mesh.all_gather_object(
                census["launches_match"]))
        # the graph check's launches are counted apart; on gloo (ranks
        # that share a card) the default route is not captured
        g0 = (a2a.counts(), mm.counts())
        out[f"{key}_g_graphs"] = m._runner.graphs
        out[f"{key}_g_why_not"] = str(m._runner.why_not)
        if m._runner.graphs:
            out.update(mesh_graph_check(torch, mesh, m, run))
        g = [{k: v - c0[k] for k, v in c1.items()}
             for c0, c1 in zip(g0, (a2a.counts(), mm.counts()))]
        out[f"{key}_g_launches"] = ([g[0][k] for k in a2a.KINDS]
                                    + [g[1]["launches_tc"],
                                       g[1]["launches_f32"]])
        n_ckpt, equal, ms = n_timed * 0, True, (np.nan, np.nan)
        if run.ckpt:
            before = launches()
            _, equal, ms = sharded_checkpoint(torch, m, fields)
            n_ckpt = launches() - before
        k2 = {k: v - g[0][k] for k, v in a2a.counts().items()}
        count = {k: v - g[1][k] for k, v in mm.counts().items()}
        tr = m.kernel.tr
        out.update({f"{key}_{k}": v for k, v in warm.items()})
        out[f"{key}_derive"] = np.stack([d_set, d_warm, d_timed, d_census])
        out[f"{key}_derive_use"] = derive_use(m.kernel)
        out[f"{key}_derive_set_use"] = derive_set_use(m.kernel)
        out[f"{key}_stage"] = np.stack([s_set, s_warm, s_timed, s_census])
        out[f"{key}_stage_use"] = stage_use(m.kernel)
        out[f"{key}_qg"] = np.stack([q_set, q_warm, q_timed, q_census])
        out[f"{key}_qg_use"] = qg_use(m.kernel)
        out.update({
            f"{key}_n_set": n_set, f"{key}_n_warm": n_warm,
            f"{key}_n_timed": n_timed, f"{key}_n_ckpt": n_ckpt,
            f"{key}_n_census": n_census,
            f"{key}_ckpt_equal": equal, f"{key}_ckpt_ms": ms,
            f"{key}_k2_paths": (k2["fwd_aligned"] + k2["inv_aligned"],
                                k2["fwd_ragged"] + k2["inv_ragged"]),
            f"{key}_k2_cpu_calls": k2["cpu_calls"],
            f"{key}_k2_all": [k2[k] for k in a2a.KINDS],
            f"{key}_k1_tc": count["launches_tc"],
            f"{key}_k1_f32": count["launches_f32"],
            f"{key}_k1_cpu_calls": count["cpu_calls"],
            f"{key}_q_half": bool(getattr(m.kernel, "q_half", False)),
            f"{key}_opts": repr(resolved_options(tr.mm) if hasattr(tr, "mm")
                                else None),
            f"{key}_transform": type(tr).__name__})
        group = tr._group  # None on the default route
        if after and key in after:
            out.update(after[key](group, m))
        if group is not None:
            group.close()
        del m, tr, group
        torch.cuda.empty_cache()
    return out


def mesh_graph_check(torch, mesh, m, run):
    """Phases 7 and 12 on one model of the mesh whose runner captures (the
    K2 route; the default route on NCCL), in every rank's process, the
    model built with MESH_GRAPH_RUN's cadence and stepped by its phase:
    ``run()`` (a diagnostics sample every step, a status line every
    MESH_GRAPH_TWRITE) to tmax and ``run_steps`` over as many steps, as
    replayed CUDA graphs, each from one in-memory checkpoint as the eager
    mesh loop it is held to (``_step_forward``, ``kernel.step``), bit for
    bit on every rank: the rank's state and every series. Then K2's
    launches (by kind) and K1's in one replay of graph A and of B, counted
    on the card, and the library's collectives that each graph holds
    (recorded at its capture where ``record_graph_collectives`` is on); a
    chunk of A and one of B under ``strict_replays``; steps/s of each form
    (the graph forms' second runs). Returns what rank 0 saves, prefixed by
    the run's key."""
    import torch.distributed as dist  # noqa: F401 (strict_replays patches)

    from niwqg_tpu_torch import io as nio
    from niwqg_tpu_torch.diagnostics import SeriesAccumulator
    from niwqg_tpu_torch.graphs import _buffer_like, _leaves, _rebuild
    from niwqg_tpu_torch.ops import csplit_mm as mm
    from niwqg_tpu_torch.parallel import a2a

    key, runner = run.key, m._runner
    n = m._count_steps(m.params.tmax)
    start = nio.checkpoint_tree(m)  # a collective
    # every run starts from the checkpoint's values in the memory layout of
    # the state the phase's steps left (a reduction sums in the order its
    # input's layout gives; a state of another layout makes the runner
    # capture again)
    layout = m.state

    def reset():
        nio.restore_tree(m, start)
        m.state = _rebuild(layout, iter([
            _buffer_like(t).copy_(r)
            for t, r in zip(_leaves(layout), _leaves(m.state))]))
        m._diag_acc = SeriesAccumulator(m.registry)

    def timed(fn):
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        mesh.barrier()
        return time.perf_counter() - t0

    def local():
        return ([t.clone() for t in _leaves(m.state)],
                {k: v["value"].copy() for k, v in m.diagnostics.items()})

    def same(a, b):
        """True where the state's leaves and every series are equal, else
        what differs (leaf indices, series names)."""
        leaves = [i for i, (x, y) in enumerate(zip(a[0], b[0]))
                  if not torch.equal(x, y)]
        series = [k for k in b[1] if k not in a[1]
                  or not np.array_equal(a[1][k], b[1][k])]
        if not leaves and not series and len(a[0]) == len(b[0]):
            return True
        return f"leaves {leaves}, series {series}"

    def eager_steps():
        for _ in range(n):
            m.state = m.kernel.step(m.state)

    # the one-time costs (the status line's first reductions) first
    reset()
    m._step_forward()
    m._print_status()
    reset()
    t_eager_run = timed(lambda: [m._step_forward() for _ in range(n)])
    ref_run = local()
    reset()
    t_eager_steps = timed(eager_steps)
    ref_steps = local()
    # each form twice: the first run captures what the second replays
    # (B after the reset, the variants of K2's parities), and a graph's
    # first replay uploads it
    times, equal = [], []
    for fn, ref in ((m.run, ref_run), (m.run, ref_run),
                    (lambda: m.run_steps(n), ref_steps),
                    (lambda: m.run_steps(n), ref_steps)):
        reset()
        times.append(timed(fn))
        equal.append(same(local(), ref))
    # one replay of A, then one of B: K1's and K2's launches counted on the
    # card, the library's collectives the graph holds (record_graph_collectives;
    # -1 where they were not recorded)
    reset()
    per = []
    for diags in (False, True):
        r0 = runner.replays
        c0, k0 = a2a.counts(), mm.counts()["launches"]
        runner.advance(1, diags=diags)
        c1, k1 = a2a.counts(), mm.counts()["launches"]
        lib = getattr(runner, "lib", {}).get(diags, [-1] * len(LIB_KINDS))
        per.append([c1[k] - c0[k] for k in a2a.KINDS]
                   + [k1 - k0, runner.replays - r0] + list(lib))
    # a chunk of A and one of B with no torch.distributed and no host
    # sync; the same chunks twice first, so that every variant of K2's
    # parities the third pair meets is captured
    for strict in (False, False, True):
        with (strict_replays(m) if strict else contextlib.nullcontext()):
            runner.advance(1, diags=False)
            runner.advance(1, diags=True)
    ranks = mesh.all_gather_object((equal, per))
    return {f"{key}_g_equal": [r[0] for r in ranks],
            f"{key}_g_per": [r[1] for r in ranks],
            f"{key}_g_steps": n, f"{key}_g_graphs": runner.graphs,
            f"{key}_g_times": [t_eager_run, t_eager_steps] + times,
            f"{key}_g_variants": repr(runner.variants()),
            f"{key}_g_capture_ms": runner.capture_ms()}


def mesh_graph_report(r, run, layout):
    """Hold rank 0's record of ``mesh_graph_check``: graphs on, every
    rank's graph runs bitwise its eager loops, K2's and K1's launches in
    one replay of A and of B against ``K2_GRAPH`` and ``K1_GRAPH``; log
    steps/s of each form."""
    get = lambda k: r[f"{run.key}_g_{k}"]
    pins = run.pins or run.key
    check(bool(get("graphs")), f"{run.label}: no graphs on the mesh")
    eq = [[x is True for x in rank] for rank in get("equal").tolist()]
    check(np.all(eq), f"{run.label}: the graph runs (run() twice, "
          f"run_steps) differ from the eager mesh loop on some rank: "
          f"{get('equal').tolist()}")
    eq = np.asarray(eq)
    # rank, (A, B), K2's kinds + K1 + replays + the library's kinds
    per = np.asarray(get("per"))
    none = ((0, 0, 0, 0),) * 2  # no K2 launch, no library collective
    want = [list(k2) + [k1, 1] + list(lib) for k2, k1, lib in
            zip(K2_GRAPH.get(pins, none), K1_GRAPH.get(pins, (0, 0)),
                LIB_GRAPH.get(pins, none))]
    check((per == np.asarray(want)[None]).all(),
          f"{run.label}: launches (K2 forward, inverse, gather, reflect; "
          f"K1; replays; the library's {', '.join(LIB_KINDS)}) in one "
          f"replay of A and of B {per[0].tolist()}, expected {want}")
    n = int(get("steps"))
    te_run, te_steps, tg_first, tg_run, tg_steps_first, tg_steps = (
        float(x) for x in get("times"))
    sps = lambda t: f"{n / t:.3f}"
    log(f"  graphs on the mesh ({layout}): run() and run_steps over {n} steps "
        f"bitwise the eager mesh loop on all {len(eq)} ranks (state and "
        f"every series); one replay of A launches {per[0][0][:5].tolist()}, "
        f"of B {per[0][1][:5].tolist()} (K2 forward, inverse, gather, "
        f"reflect; K1), counted on the card, and holds the library's "
        f"{per[0][0][6:].tolist()}, B {per[0][1][6:].tolist()} "
        f"({', '.join(LIB_KINDS)}); strict replays (no torch.distributed "
        f"called, no host sync) held")
    log(f"  steps/s: run_steps {sps(tg_steps)} with graphs (first run, "
        f"with captures: {sps(tg_steps_first)}), {sps(te_steps)} eagerly; "
        f"run() {sps(tg_run)} with graphs (first run, with the eager step "
        f"and captures of B: {sps(tg_first)}), {sps(te_run)} eagerly; "
        f"graphs {get('variants')}, capture "
        f"{float(get('capture_ms')):.1f} ms (rank 0)")
    return n / tg_steps, n / te_steps


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
        launches = a2a.counts()[f"{key}_ragged"]
        got = fn(z, group, chunks=1).clone()
        check(a2a.counts()[f"{key}_ragged"] == launches + 1,
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
    then (d), ``transform_table``. Returns K1's launches in the phase and
    (a)'s states after WARM_STEPS steps by model (``mesh_fields``), which
    phase 12 holds its mesh runs to."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    runs = [("(a) JAX's defaults", name, MXU_MODEL, 0)
            for name in MODEL_NAMES]
    runs.append(("(b) realpath='mf'", "CoupledModel",
                 dict(MXU_MODEL, transform_opts={"realpath": "mf"}), 0))
    runs += [("(c) even/odd K1 configuration", name, K1_EVENODD_MODEL,
              K1_PER_STEP_EVENODD[name]) for name in ("CoupledModel",
                                                      "QGModel")]
    launches, refs_a = 0, {}
    for label, name, kw, per_step in runs:
        held, shown = model_fields(name)
        if name not in refs64:
            m64 = build_model(pkg, ic, name, backend="native",
                              dtype=np.float64)
            m64.run_steps(WARM_STEPS)
            refs64[name] = {k: getattr(m64, k) for k in held + shown}
            del m64
        graphs = label.startswith("(a)") and name == "CoupledModel"
        torch.cuda.empty_cache()
        mm.reset_counts()
        t0 = time.perf_counter()
        m = build_model(pkg, ic, name, **kw, **(GRAPH_RUN if graphs else {}))
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_set = mm.counts()["launches"]
        s32, wall = timed_steps(torch, m, tuple(dict.fromkeys(
            held + shown + mesh_fields(name))))
        if label.startswith("(a)"):
            refs_a[name] = {k: s32[k] for k in mesh_fields(name)}
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
    return launches, refs_a


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
    c = a2a.counts()
    return (c["fwd"], c["inv"]), equal, (1e3 * t_save, 1e3 * t_load)


def sharded_phase(torch, refs, family_refs):
    """Phase 7: the sharded main path on both routes; ``refs`` maps a name
    to the (q, phi, Ke) of a one-card run after WARM_STEPS steps, and
    ``family_refs`` a model's name to its one-card f32 cuFFT run's fields
    after WARM_STEPS steps (both routes' family rows are held to them).
    Returns K2's launches on the main paths on rank 0 (forward, inverse,
    gather, reflect; the graph checks included), the device ms of NCCL's
    call beside each of those kinds (None on a shared card) and K2's
    transposes' device ms."""
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
    # the library's call beside each of K2's kinds (K2_RECORDS' order)
    lib = tuple(float(b[k][0]) for k in ("lib_dev", "lib_inv_dev",
                                         "lib_gather_dev", "lib_reflect_dev"))
    if math.isnan(lib[0]):
        lib = (None,) * len(lib)
        log(f"library_ms is null: NCCL's all_to_all_single needs a card per "
            f"rank, and {NRANKS} ranks share {ncards} card(s) here (the "
            "default route ran on gloo through the host)")
    else:
        log(f"NCCL all_to_all_single at the same shape: forward's blocks "
            f"{lib[0]:.4f} ms, inverse's blocks {lib[1]:.4f} ms a call on "
            f"the device (CUDA events); host clock over 20 calls "
            f"{float(b['lib_ms']):.4f} and {float(b['lib_inv_ms']):.4f} ms; "
            f"NCCL all_reduce of {REDUCE_LEN} float32 (K2's gather) "
            f"{lib[2]:.4f} ms, the reflection's uneven all_to_all_single at "
            f"({K2_W}, {NX}) complex64 rows {lib[3]:.4f} ms a call on the "
            f"device")
    layout = (f"{NRANKS} processes on {ncards} card(s), {a['backend']} for "
              "the host's collectives")
    log(f"{PENCIL_FLAGSHIP.label}, graph check:")
    mesh_graph_report(a, PENCIL_FLAGSHIP, layout)
    g = [int(x) for x in a["flagship_g_launches"]]
    gather, reflect = (int(x) for x in a["k2_all"][2:])
    launches = [sum(int(a[key][i]) for key in
                    ("n_set", "n_warm", "n_timed", "n_ckpt")) + g[i]
                for i in range(2)] + [gather + g[2], reflect + g[3]]
    for run in FAMILY_MESH_RUNS:
        n, extra = mesh_checks(a, run, family_refs[run.name], layout)
        launches = [x + int(y) for x, y in
                    zip(launches, [n[0], n[1], extra[0], extra[1]])]
    # the default route: graphs on NCCL (the flagship, then the family,
    # no K2 launch), the step called directly on gloo
    run = DEFAULT_FLAGSHIP
    layout = (f"{NRANKS} processes on {ncards} card(s), {b['backend']} for "
              "every collective")
    captured = bool(b[f"{run.key}_g_graphs"])
    check(captured == (str(b["backend"]) == "nccl"), f"{run.label}: graphs "
          f"{captured} on {b['backend']}")
    if captured:
        log(f"{run.label}, graph check:")
        mesh_graph_report(b, run, layout)
        for run in DEFAULT_FAMILY_MESH_RUNS:
            mesh_checks(b, run, family_refs[run.name], layout)
    else:
        log(f"{run.label}: no graphs, the step is called directly on "
            f"{b['backend']} ({b[f'{run.key}_g_why_not']}); the other models "
            "run on the default route where every rank has its own card")
    ragged_report(a, b, ncards)
    k2_dev = (float(a["k2_dev"][0]), float(a["k2_inv_dev"][0]))
    return launches, lib, k2_dev


def mesh_checks(r, run, ref, layout):
    """Hold rank 0's record ``r`` of one ``MeshRun`` (``_runs_on_mesh``):
    steps/s; launches per step and rank against the run's pins, K1's all
    on the tensor-core route, no plain-version call; K2's paths; the
    matmul-DFT's options as resolved; the checkpoint round trip bitwise;
    the fields after WARM_STEPS steps against the one-card run ``ref``
    (``SHARD_RTOL``); the fused derive's launches on the card, DERIVES_PER_STEP
    a step of every kernel the layout uses and set_q's inversion at set-up
    (``derive_report``); the mesh graph check (``mesh_graph_report``) where
    the runner captures, else the reason it does not. Returns
    the run's launches, graph check included: (K2 forward, K2 inverse, K1)
    and (K2 gather, K2 reflect)."""
    key = run.key
    get = lambda k: r[f"{key}_{k}"]
    wall = float(get("wall"))
    n = {k: tuple(int(x) for x in get(k))
         for k in ("n_set", "n_warm", "n_timed", "n_ckpt", "n_census")}
    want = tuple(run.k2) + (run.k1,)
    per = ", ".join(f"{x / TIMED_STEPS:g}" for x in n["n_timed"])
    aligned, ragged = (int(x) for x in get("k2_paths"))
    log(f"{run.label} ({get('transform')}, q_half={bool(get('q_half'))}): "
        f"built in {float(get('t_build')):.1f} s; {TIMED_STEPS} steps in "
        f"{wall:.3f} s = {TIMED_STEPS / wall:.3f} steps/s; launches per "
        f"step and rank ({per}) (K2 forward, K2 inverse, K1; {want} "
        f"expected), at set-up {n['n_set']}; K2 paths on rank 0: {aligned} "
        f"aligned, {ragged} ragged; transform {get('opts')}")
    check(bool(get("finite")), f"{run.label}: non-finite state")
    check(int(get("k2_cpu_calls")) == 0 and int(get("k1_cpu_calls")) == 0,
          f"{run.label}: a kernel ran its plain version")
    for k, steps in (("n_warm", WARM_STEPS), ("n_timed", TIMED_STEPS)):
        check(n[k] == tuple(w * steps for w in want),
              f"{run.label}: expected {want} launches (K2 forward, K2 "
              f"inverse, K1) a step, counted {n[k]} in {steps}")
    total = np.sum([v for v in n.values()], axis=0)
    k2_all = int(total[0] + total[1])
    paths = {"aligned": (k2_all, 0), "ragged": (0, k2_all)}
    if run.paths is not None:
        check((aligned, ragged) == paths[run.paths],
              f"{run.label}: K2 launches expected all {run.paths}")
    check(aligned + ragged == k2_all, f"{run.label}: K2 launches off both "
          "paths")
    if run.opts is not None:
        check(str(get("opts")) == repr(run.opts), f"{run.label}: the "
              f"defaults resolved to {get('opts')}, not {run.opts}")
    check(int(get("k1_tc")) == total[2] and int(get("k1_f32")) == 0,
          f"{run.label}: K1 launches off the tensor-core route")
    if run.ckpt:
        save_ms, load_ms = (float(x) for x in get("ckpt_ms"))
        log(f"  checkpoint (in memory), 2 steps, load, the same 2 steps: "
            f"bitwise equal {bool(get('ckpt_equal'))}; save {save_ms:.1f} "
            f"ms, load {load_ms:.1f} ms (rank 0); launches {n['n_ckpt']} in "
            "the 4 steps")
        check(bool(get("ckpt_equal")), f"{run.label}: the run resumed from "
              "its checkpoint differs from the run it was taken from")
        check(n["n_ckpt"] == tuple(4 * w for w in want), f"{run.label}: "
              "the checkpoint round trip changed the launches per step")
    if run.census:
        census_report(r, run, want, n["n_census"])
    derive_report(run.label, *get("derive"), get("derive_use"),
                  get("derive_set_use"), census=run.census)
    stage_report(run.label, *get("stage"), int(get("stage_use")),
                 census=run.census)
    qg_report(run.label, *get("qg"), get("qg_use"), census=run.census)
    if ref is not None:
        d = {k: float(np.abs(np.asarray(get(k)) - v).max()
                      / np.abs(v).max()) for k, v in ref.items()}
        log(f"  vs the one-card run after {WARM_STEPS} steps: "
            + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
            + f" (relative; limit {SHARD_RTOL})")
        check(max(d.values()) <= SHARD_RTOL,
              f"{run.label}: the mesh run disagrees with its one-card run")
    g = [int(x) for x in get("g_launches")]  # K2 by kind, K1 tc, K1 f32
    check(g[5] == 0, f"{run.label}: K1 off the tensor-core route in the "
          "graph runs")
    # the K2 route captures on either backend, the default route on NCCL
    backend = str(r["backend"])
    captures = run.base is None or backend == "nccl"
    check(bool(get("g_graphs")) == captures, f"{run.label}: graphs "
          f"{bool(get('g_graphs'))} on {backend}, expected {captures}")
    if captures:
        mesh_graph_report(r, run, layout)
    else:
        log(f"  no graphs: the default route on {backend} calls the step "
            f"directly ({get('g_why_not')})")
    gather, reflect = (int(x) for x in get("k2_all")[2:])
    log(f"  K2 gathers (domain sums, maxima) {gather} and reflections "
        f"{reflect} on rank 0 outside the graph check; in it {g[2]} and "
        f"{g[3]}, with {g[0]} + {g[1]} transposes and {g[4]} K1 launches")
    return total + np.array([g[0], g[1], g[4]]), np.array(
        [gather + g[2], reflect + g[3]])


def census_report(r, run, want, n_census):
    """Hold rank 0's census of one step of ``run`` (``_runs_on_mesh``,
    ``niwqg_tpu_torch/utils/census.py``): the step's launches (K2 forward,
    K2 inverse, K1) its pins, every K2 call a launch of its kind on every
    rank (counted on the card), the transposes' bytes equal to the census's
    model (``transport_over_model`` 1.0, the JAX script's
    ``hlo_over_model``), K1's calls all at ``K1_MESH_BIG`` in (k); log the
    fields, the bytes and their NVLink bound, the gathers and reflections
    apart."""
    c = json.loads(str(r[f"{run.key}_census"]))
    calls = c["transport_calls"]
    moved = c["transport_ici_bytes_per_dev_per_step"]
    bound = k2_bound_ms(c["transpose_bytes_per_rank"], NRANKS)[0]
    log(f"  census of one step (rank 0): {c['transposed_fields_per_step']} "
        f"transposed fields {c['census']}, {moved / 1e9:.4f} GB a rank "
        f"across ranks ({c['itemsize']}-byte elements), transport/model "
        f"{c['transport_over_model']:.6f} (NVLink bound of the transposes "
        f"{bound:.3f} ms, a card per rank); gathers (sums, maxima) "
        f"{calls.get('gather', 0) + calls.get('sum', 0) + calls.get('max', 0)}"
        f", reflections {calls.get('reflect', 0) + calls.get('reflect_single', 0)}"
        f" ({c['transport_bytes']} bytes by kind); K1 calls by (M, K, N) "
        f"{c['k1_calls']}; K2 launches counted on the card "
        f"{c['k2_launches']}")
    check(n_census == tuple(want), f"{run.label}: the census step made "
          f"{n_census} launches (K2 forward, K2 inverse, K1), not {want}")
    check(bool(r[f"{run.key}_census_ok"]), f"{run.label}: K2's launches in "
          "the census step differ from its calls on some rank")
    check(c["transport_over_model"] == 1.0, f"{run.label}: the transposes "
          f"moved {c['transport_over_model']} of the census's model")
    if run.k1:
        check(c["k1_calls"] == [list(K1_MESH_BIG) + [run.k1]],
              f"{run.label}: K1's calls by shape {c['k1_calls']}, expected "
              f"{run.k1} at {K1_MESH_BIG}")


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


def _mxu_mesh_rank(rank, port, outdir):
    """One rank of phase 12 (a child process): ``MXU_MESH_RUNS``, then
    ``DEFAULT_MXU_MESH_RUNS``."""
    import torch

    sys.path.insert(0, ROOT)
    os.environ.setdefault("NIWQG_ETDRK4_WORKERS", "2")
    from niwqg_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", NRANKS, rank, timeout_s=300)
    mesh = multihost.global_mesh()
    record_graph_collectives()
    out = _runs_on_mesh(torch, mesh, MXU_MESH_RUNS + DEFAULT_MXU_MESH_RUNS)
    if rank == 0:
        np.savez(os.path.join(outdir, "mxu_mesh.npz"),
                 backend=torch.distributed.get_backend(),
                 device=str(mesh.device), **out)
    multihost.shutdown()


def mesh_refs(torch):
    """Phase 12's one-card references where phases 4 and 11 did not run
    (``--phases 12``): each model with JAX's defaults, and the Coupled
    flagship in the K1 configuration, after WARM_STEPS steps."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    refs = {}
    for key, name, kw in ([(n, n, MXU_MODEL) for n in MODEL_NAMES]
                          + [("k1", "CoupledModel", K1_MODEL)]):
        m = (flagship(pkg.CoupledModel, ic, **kw) if key == "k1"
             else build_model(pkg, ic, name, **kw))
        m.run_steps(WARM_STEPS)
        refs[key] = {k: getattr(m, k) for k in mesh_fields(name)}
        del m
        torch.cuda.empty_cache()
    return refs


def mxu_mesh_phase(torch, refs):
    """Phase 12: the matmul-DFT on the mesh (JAX's GSPMD branch), 4 ranks
    in 4 processes at 2048² in f32 with K2 as the transpose,
    ``MXU_MESH_RUNS``: (a) the five models with JAX's defaults, (k) the
    Coupled flagship in the K1 configuration; then (a)'s Coupled model and
    (k) on the default route (``DEFAULT_MXU_MESH_RUNS``); each held by
    ``mesh_checks`` to the one-card run of the same options (``refs``:
    phase 11(a)'s states, and phase 4's under "k1"). Returns rank 0's
    launches: (K2 forward, K2 inverse, K1, K2 gather, K2 reflect)."""
    import torch.multiprocessing as mp

    ncards = min(NRANKS, torch.cuda.device_count())
    outdir = tempfile.mkdtemp(prefix="niwqg_smoke_")
    try:
        with socket.socket() as sock:  # a free port for the rendezvous
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        mp.spawn(_mxu_mesh_rank, args=(port, outdir), nprocs=NRANKS,
                 join=True)  # raises if any rank fails
        with np.load(os.path.join(outdir, "mxu_mesh.npz")) as z:
            r = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    log(f"phase 12: the matmul-DFT on the mesh, {NRANKS} ranks in "
        f"{NRANKS} processes on {ncards} card(s) ({r['backend']} group, "
        f"rank 0 on {r['device']}), {NX}² f32, transform_opts "
        f"{MXU_MESH_MODEL['transform_opts']}")
    total, extra = np.zeros(3, dtype=np.int64), np.zeros(2, dtype=np.int64)
    for run in MXU_MESH_RUNS + DEFAULT_MXU_MESH_RUNS:
        layout = (f"{NRANKS} processes on {ncards} card(s), {r['backend']} "
                  "for " + ("every collective" if run.base else
                            "the host's collectives"))
        n, e = mesh_checks(r, run, refs[run.base or run.key], layout)
        total, extra = total + n, extra + e
    return tuple(int(x) for x in total) + tuple(int(x) for x in extra)


def big_run(torch, mm, label, m, fields, per_step=None):
    """Phase 13 on one freshly built model at NX_BIG: WARM_STEPS eager
    steps (``kernel.step``) from its initial state, then from the same
    state WARM_STEPS through ``run_steps`` as replayed CUDA graphs, held to
    the eager steps bit for bit (GRAPH_RTOL where not), then TIMED_STEPS
    more on the host clock closed by a synchronise. With ``per_step``,
    K1's launches a step in both forms (counted on the card), all on the
    tensor-core route, no plain-version call. Logs peak memory of each
    form and the capture's ms. Returns the fields after WARM_STEPS,
    steps/s and K1's launches."""
    from niwqg_tpu_torch import io as nio

    def k1():
        c = mm.counts()
        check(c["cpu_calls"] == 0, f"phase 13, {label}: K1 ran its plain "
              "version")
        check(c["launches_f32"] == 0 and c["launches_tc"] == c["launches"],
              f"phase 13, {label}: K1 launches off the tensor-core route")
        return c["launches"]

    start = nio.checkpoint_tree(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm.reset_counts()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        m.state = m.kernel.step(m.state)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    n_eager = k1()
    eager = {k: getattr(m, k) for k in fields}
    peak_eager = torch.cuda.max_memory_allocated()
    nio.restore_tree(m, start)
    del start
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm.reset_counts()
    t0 = time.perf_counter()
    m.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_warm = k1()
    warm = {k: getattr(m, k) for k in fields}
    exact = all(np.array_equal(warm[k], eager[k]) for k in fields)
    d = max(float(np.abs(np.asarray(warm[k]) - eager[k]).max()
                  / np.abs(eager[k]).max()) for k in fields)
    check(m._runner.graphs and d <= GRAPH_RTOL, f"phase 13, {label}: "
          f"run_steps with graphs is {d:.3e} off the eager steps (limit "
          f"{GRAPH_RTOL})")
    t0 = time.perf_counter()
    m.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_timed = k1() - n_warm
    peak_graph = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(np.asarray(getattr(m, k))).all() for k in fields),
          f"phase 13, {label}: non-finite state")
    if per_step is not None:
        check(n_eager == n_warm == per_step * WARM_STEPS
              and n_timed == per_step * TIMED_STEPS,
              f"phase 13, {label}: expected {per_step} K1 launches a step, "
              f"counted {n_eager} eagerly and {n_warm} with graphs in "
              f"{WARM_STEPS}, {n_timed} in {TIMED_STEPS}")
    sps = TIMED_STEPS / wall
    log(f"phase 13, {label}: {TIMED_STEPS} steps in {wall:.3f} s = "
        f"{sps:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f} ms/step, "
        f"graphs); run_steps({WARM_STEPS}) with graphs "
        f"{'bitwise' if exact else f'{d:.3e} off'} the eager steps "
        f"(first replays and capture {1e3 * t_first:.0f} ms, eager "
        f"{1e3 * t_eager:.0f} ms); capture {m._runner.capture_ms():.1f} ms; "
        f"peak memory eager {peak_eager / 2**30:.2f} GiB, with graphs "
        f"{peak_graph / 2**30:.2f} GiB"
        + (f"; K1 {n_timed // TIMED_STEPS} launches a step, all tensor-core"
           if per_step is not None else ""))
    return warm, sps, n_eager + k1()


def big_phase(torch, mm):
    """Phase 13 on one card: the flagship at NX_BIG in f64 on cuFFT (the
    reference, WARM_STEPS steps), then in f32 on cuFFT (``q_half=False``:
    the mesh's reference), with the matmul-DFT's defaults (resolved to
    ``MXU_RESOLVED_BIG``) and in the K1 configuration, each through
    ``big_run`` and held to the f64 run (CROSS_RTOL; Pw and Kw shown); then
    QG + scalar in f32 on cuFFT (the mesh's reference). Returns the mesh's
    one-card references by run key, K1's launches, and K1's launches at
    (NX_BIG, NX_BIG, NX_BIG)."""
    from niwqg_tpu_torch import CoupledModel, QGModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.utils.profiling import host_peak_gb

    nx = NX_BIG

    def built(label, t0):
        torch.cuda.synchronize()
        log(f"phase 13, {label}: built and initialised in "
            f"{time.perf_counter() - t0:.1f} s; host peak RSS "
            f"{host_peak_gb():.2f} GB; card "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    def free():
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    m = flagship(CoupledModel, ic, nx=nx, backend="native",
                 dtype=np.float64, fast=True, q_half=False)
    built("f64 cuFFT", t0)
    m.run_steps(WARM_STEPS)
    ref64 = {k: getattr(m, k) for k in WAVE_FIELDS + ("Pw", "Kw")}
    check(all(np.isfinite(np.asarray(v)).all() for v in ref64.values()),
          "phase 13: non-finite f64 state")
    del m
    free()

    refs, launches = {}, 0
    shown = ("Pw", "Kw")
    # each run's key among the mesh's references
    for key, label, kw, per_step in (
            ("big_flagship", "f32 cuFFT, q_half=False",
             dict(backend="native", dtype=np.float32, fast=True,
                  q_half=False), None),
            ("big_a", "JAX's default matmul-DFT", MXU_MODEL, None),
            ("big_k1", "K1 configuration", K1_MODEL, K1_PER_STEP)):
        t0 = time.perf_counter()
        mm.reset_counts()
        m = flagship(CoupledModel, ic, nx=nx, **kw)
        built(label, t0)
        n_set = mm.counts()["launches"]
        if kw is MXU_MODEL:
            opts = resolved_options(m.kernel.tr)
            log(f"phase 13, {label}: resolved {opts}")
            check(opts == MXU_RESOLVED_BIG, f"phase 13: the defaults "
                  f"resolved to {opts}, not {MXU_RESOLVED_BIG}")
        warm, sps, n = big_run(torch, mm, label, m, WAVE_FIELDS + shown,
                               per_step)
        if per_step is not None:
            launches += n_set + n
            k1_big = n_set + n  # every one at (NX_BIG, NX_BIG, NX_BIG)
        cross(f"phase 13, {label}", warm, ref64, WAVE_FIELDS, shown)
        # phi is uniform: its gradients, and so Pw, are rounding-sized
        # (tools/probe_wave_budgets.py puts a packet in phi)
        log(f"  Pw {warm['Pw']:.3e} (f64 {ref64['Pw']:.3e}), Kw "
            f"{warm['Kw']:.6e} (f64 {ref64['Kw']:.6e})")
        refs[key] = {k: warm[k] for k in WAVE_FIELDS}
        del m, warm
        free()

    t0 = time.perf_counter()
    g = qg_flagship(QGModel, ic, nx=nx, backend="native", dtype=np.float32)
    built("QGModel + scalar, f32 cuFFT", t0)
    state, wall = timed_steps(torch, g, mesh_fields("QGModel"))
    refs["big_qg"] = state
    log(f"phase 13, QGModel + scalar, f32 cuFFT: {TIMED_STEPS} steps in "
        f"{wall:.3f} s = {TIMED_STEPS / wall:.3f} steps/s")
    check(all(np.isfinite(np.asarray(getattr(g, k))).all()
              for k in mesh_fields("QGModel")), "phase 13: non-finite QG")
    del g
    free()
    return refs, launches, k1_big


def _big_k2(torch, mesh, rank, group):
    """K2 at phase 13's block shapes on the mesh (``K2_BIG``, aligned, and
    ``QG_K2_BIG``, ragged): each direction bit-exact against its plain
    version on seeded blocks, its device and host times as ``k2_times``
    takes them, and where the group is NCCL the library's
    ``all_to_all_single`` at the same blocks."""
    import torch.distributed as dist

    from niwqg_tpu_torch.parallel import a2a

    out = {}
    for name, (lead, R, PW), chunks in (("big", K2_BIG, 2),
                                        ("big_qg", QG_K2_BIG, 1)):
        W = PW // NRANKS
        path = a2a.path(W, chunks, 8)
        for key, fn, ref, shape in (
                ("fwd", a2a.all_to_all_fwd, a2a.all_to_all_fwd_ref,
                 (lead, R, PW)),
                ("inv", a2a.all_to_all_inv, a2a.all_to_all_inv_ref,
                 (lead, NRANKS * R, W))):
            rng = np.random.default_rng(200 + rank)
            z = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                                + 1j * rng.standard_normal(shape).astype(
                                    np.float32), device=mesh.device)
            before = a2a.counts()[f"{key}_{path}"]
            got = fn(z, group, chunks=chunks).clone()
            check(a2a.counts()[f"{key}_{path}"] == before + 1,
                  f"K2 {key} at {shape} did not launch on the {path} path")
            want = ref(mesh.all_gather(z))[rank]
            check(torch.equal(got, want), f"K2 {key} at {shape} differs "
                  f"from its plain version on rank {rank}")
            out[f"{name}_{key}_dev"] = k2_times(
                torch, lambda: fn(z, group, chunks=chunks), [mesh.device],
                K2_PAIRS, mesh.barrier)
            if mesh.backend == "nccl":
                if key == "fwd":
                    send = z.reshape(lead, R, NRANKS, W).movedim(-2, 0)
                else:
                    send = z.reshape(lead, NRANKS, R, W).movedim(-3, 0)
                send = send.contiguous()
                recv = torch.empty_like(send)
                out[f"{name}_{key}_lib"] = k2_times(
                    torch, lambda: dist.all_to_all_single(recv, send),
                    [mesh.device], K2_PAIRS, mesh.barrier)
            del z, got, want
        out[f"{name}_path"] = path
    # the gather kind (the step's sums) in this layout, a process a rank:
    # the mesh's own layout, and on four cards the multi-card time
    vec = torch.full((REDUCE_LEN,), float(rank), device=mesh.device)
    check(torch.equal(a2a.all_reduce(vec, group, "sum"),
                      torch.full_like(vec, float(sum(range(NRANKS))))),
          f"K2 all_reduce gives a wrong sum on rank {rank}")
    out["gather_dev"] = k2_times(
        torch, lambda: a2a.all_reduce(vec, group, "sum"), [mesh.device],
        K2_PAIRS, mesh.barrier)
    return out


def _big_mesh_rank(rank, port, outdir):
    """One rank of phase 13's mesh (a child process): ``BIG_MESH_RUNS``,
    K2 alone at the phase's block shapes, then ``BIG_DEFAULT_RUNS`` where
    the group is NCCL."""
    import torch

    sys.path.insert(0, ROOT)
    os.environ.setdefault("NIWQG_ETDRK4_WORKERS", "2")
    from niwqg_tpu_torch.parallel import multihost
    from niwqg_tpu_torch.utils.profiling import host_peak_gb

    multihost.initialize(f"localhost:{port}", NRANKS, rank, timeout_s=600)
    mesh = multihost.global_mesh()
    record_graph_collectives()
    runs = BIG_MESH_RUNS + (BIG_DEFAULT_RUNS if mesh.backend == "nccl"
                            else ())
    out = _runs_on_mesh(torch, mesh, runs, after={
        "big_flagship": lambda group, m: {
            **mesh_derive(torch, mesh, m, "big_flagship"),
            **mesh_stage(torch, mesh, m, "big_flagship")},
        "big_qg": lambda group, m: {
            **_big_k2(torch, mesh, rank, group),
            **mesh_qg(torch, mesh, m, "big_qg")}})
    rss = max(mesh.all_gather_object(host_peak_gb()))
    if rank == 0:
        np.savez(os.path.join(outdir, "big_mesh.npz"),
                 backend=mesh.backend, device=str(mesh.device),
                 peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                 rss_gb=rss, **out)
    multihost.shutdown()


def big_mesh_phase(torch, refs):
    """Phase 13 on the mesh: 4 ranks in 4 processes at NX_BIG
    (``BIG_MESH_RUNS``, and ``BIG_DEFAULT_RUNS`` on NCCL), each held by
    ``mesh_checks`` to its one-card f32 run of the same options (``refs``),
    through the mesh graph check and the census of one step, and K2 at the
    phase's block shapes; the fused derive on the pencil flagship's ranks
    (``mesh_derive``). Returns rank 0's launches (K2 forward, K2
    inverse, K1, K2 gather, K2 reflect) and K2's records at those shapes
    by wrapper name, with the fused derive's under ``"derive"`` (rank 1's
    kernel records, rank 0's launches)."""
    import torch.multiprocessing as mp

    ncards = min(NRANKS, torch.cuda.device_count())
    outdir = tempfile.mkdtemp(prefix="niwqg_smoke_")
    try:
        with socket.socket() as sock:  # a free port for the rendezvous
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        mp.spawn(_big_mesh_rank, args=(port, outdir), nprocs=NRANKS,
                 join=True)  # raises if any rank fails
        with np.load(os.path.join(outdir, "big_mesh.npz")) as z:
            r = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    log(f"phase 13: the pencil mesh at {NX_BIG}², {NRANKS} ranks in "
        f"{NRANKS} processes on {ncards} card(s) ({r['backend']} group, "
        f"rank 0 on {r['device']}); peak memory on rank 0 "
        f"{float(r['peak_gb']):.2f} GiB, the largest rank's host peak RSS "
        f"{float(r['rss_gb']):.2f} GB")
    total, extra = np.zeros(3, dtype=np.int64), np.zeros(2, dtype=np.int64)
    runs = BIG_MESH_RUNS + (BIG_DEFAULT_RUNS if str(r["backend"]) == "nccl"
                            else ())
    for run in runs:
        layout = (f"{NRANKS} processes on {ncards} card(s), {r['backend']} "
                  "for " + ("every collective" if run.base else
                            "the host's collectives"))
        n, e = mesh_checks(r, run, refs[run.base or run.key], layout)
        total, extra = total + n, extra + e
    if str(r["backend"]) != "nccl":
        log(f"phase 13: the default route runs where every rank has its "
            f"own card (NCCL); here the {NRANKS} ranks share {ncards}")
    worst = float(r["big_flagship_derive_ulps"])
    log(f"phase 13: the fused derive on every rank of the pencil flagship "
        f"at {NX_BIG}², each kernel and the whole derive against the plain "
        f"chain: largest gap {worst:g} ulps")
    check(worst == 0.0, "the fused derive is not bitwise its plain chain on "
          "the mesh")
    recs = {"derive": dict(
        recs=json.loads(str(r["big_flagship_derive_recs"])),
        launches=np.sum([r[f"{run.key}_derive"] for run in runs],
                        axis=(0, 1))[:4])}
    gaps = json.loads(str(r["big_flagship_stage_gaps"]))
    stage_held(gaps, f"phase 13: the fused stage epilogue on every rank of "
               f"the pencil flagship at {NX_BIG}² (the worst of each "
               "reading over the ranks)")
    recs["stage"] = dict(
        recs=json.loads(str(r["big_flagship_stage_recs"])),
        launches=int(sum(np.asarray(r[f"{run.key}_stage"])[:, :2].sum()
                         for run in runs)))
    qg_held(json.loads(str(r["big_qg_qg_gaps"])), f"phase 13: the fused QG "
            f"gaps on every rank of QG + scalar at {NX_BIG}² (the worst of "
            "each reading over the ranks)")
    recs["qg"] = dict(
        recs=json.loads(str(r["big_qg_qg_recs"])),
        launches=np.sum([np.asarray(r[f"{run.key}_qg"])[:, :3]
                         for run in runs], axis=(0, 1)))
    for name, shape in (("big", K2_BIG), ("big_qg", QG_K2_BIG)):
        nbytes = int(np.prod(shape)) * 8
        bound, t_hbm, t_link = k2_bound_ms(nbytes, ncards)
        path = str(r[f"{name}_path"])
        for key, wrapper in (("fwd", "all_to_all_fwd"),
                             ("inv", "all_to_all_inv")):
            dev, us, us_med = (float(x) for x in r[f"{name}_{key}_dev"])
            lib = (float(r[f"{name}_{key}_lib"][0])
                   if f"{name}_{key}_lib" in r else None)
            log(f"K2 {wrapper} at {shape} complex64 ({path} path), rank 0 "
                f"of {NRANKS} processes on {ncards} card(s): bit-exact vs "
                f"its plain version; device {dev:.4f} ms per launch (CUDA "
                f"events, {K2_PAIRS} behind a sleep), host {us:.1f} µs per "
                f"call (median {us_med:.1f}); bound {bound:.4f} ms "
                f"({nbytes / 1e6:.1f} MB a rank; HBM {t_hbm:.4f}, NVLink "
                f"{t_link:.4f}), {100 * bound / dev:.1f}% of it reached; "
                + (f"NCCL all_to_all_single at the same blocks {lib:.4f} ms"
                   if lib is not None else
                   "NCCL: none (the ranks share a card)"))
            recs.setdefault(wrapper, []).append(dict(
                shape=list(shape) if key == "fwd" else
                [shape[0], NRANKS * shape[1], shape[2] // NRANKS],
                path=path, layout=f"{NRANKS} processes on {ncards} card(s)",
                ms=dev, bound_ms=bound, bound_by="bytes", library_ms=lib))
    dev, us, us_med = (float(x) for x in r["gather_dev"])
    log(f"K2 all_reduce (gather kind, sum of {REDUCE_LEN} float32), rank 0 "
        f"of {NRANKS} processes on {ncards} card(s): device {dev:.4f} ms "
        f"per call (its pad, copy and rank-order sum; CUDA events, "
        f"{K2_PAIRS} behind a sleep), host {us:.1f} µs (median "
        f"{us_med:.1f})")
    recs["gather_ms"] = dev
    return tuple(int(x) for x in total) + tuple(int(x) for x in extra), recs


# phase 14: bytes each fused kernel must move, in complex values of the
# working type a field element (a real value is half of one): what it reads
# and writes once; the mirror partners' second reads are not counted
DERIVE_VALUES = {
    "derive_grad_pack": 1 + 3,
    "derive_wave_pv": 3 + 1,
    # fj (2), qh, the three tables (1.5); qwh, ph and the batch
    "derive_invert": {"mirror": 4.5 + 2 + 4, "raw": 4.5 + 2 + 2},
    "derive_project_pack": 2 + 1 + 2,
}
DERIVE_REPS = 50
# the fast kernel's derives a step (one an ETDRK4 stage), each one launch
# of every kernel its layout and physics use (``derive_use``)
DERIVES_PER_STEP = 4


def derive_use(K) -> np.ndarray:
    """The launches of each kernel of ``derive_fused.KERNELS`` in one derive
    of the kernel object ``K``: grad_pack and invert always, wave_pv with a
    wave PV, project_pack on the pencil mesh's unprojected ``ph``; none
    where the model has no fast kernel."""
    from niwqg_tpu_torch.ops import derive_fused as dv

    plan = getattr(K, "_plan", None)
    if plan is None:
        return np.zeros(len(dv.KERNELS), dtype=np.int64)
    return np.array([1, int(bool(plan.flags & dv.WAVE_PV)), 1,
                     int(plan.q.proj == dv.PROJ_RAW)], dtype=np.int64)


def derive_counts() -> np.ndarray:
    """The fused derive's launches on this process's cards so far, in
    ``derive_fused.KERNELS``' order, then its plain-chain calls."""
    from niwqg_tpu_torch.ops import derive_fused as dv

    c = dv.counts()
    return np.array([c[k] for k in dv.KERNELS + ("cpu_calls",)],
                    dtype=np.int64)


def derive_set_use(K) -> np.ndarray:
    """The launches of each kernel at a model's set-up: ``set_q``'s
    inversion with the carried wave fields on the half layout (the full
    layout's ``set_q`` inverts without the derive)."""
    use = derive_use(K)
    return use * np.array([0, 1, 1, 0]) if getattr(K, "q_half", False) \
        else use * 0


def derive_report(label, d_set, d_warm, d_timed, d_census, use, set_use,
                  census=False):
    """Hold a run's fused-derive launches, each an array in
    ``derive_fused.KERNELS``' order and then the plain-chain calls:
    DERIVES_PER_STEP launches a step of each kernel in ``use``, the census
    step's too, ``set_use`` at set-up, no plain chain on the card. Returns
    the launches of each kernel in all."""
    from niwqg_tpu_torch.ops import derive_fused as dv

    d_set, d_warm, d_timed, d_census, use, set_use = (
        np.asarray(x, dtype=np.int64)
        for x in (d_set, d_warm, d_timed, d_census, use, set_use))
    log(f"  fused derive launches ({', '.join(dv.KERNELS)}; counted on the "
        f"card): set-up {d_set[:4].tolist()}, {WARM_STEPS} warm-up steps "
        f"{d_warm[:4].tolist()}, {TIMED_STEPS} timed {d_timed[:4].tolist()}"
        + (f", census step {d_census[:4].tolist()}" if census else "")
        + f"; {DERIVES_PER_STEP} x {use.tolist()} a step expected")
    check(d_set[4] + d_warm[4] + d_timed[4] + d_census[4] == 0,
          f"{label}: a derive on the card took the plain chain")
    for what, got, steps in (("warm-up", d_warm, WARM_STEPS),
                             ("timed", d_timed, TIMED_STEPS),
                             ("census", d_census, int(census))):
        check(np.array_equal(got[:4], DERIVES_PER_STEP * steps * use),
              f"{label}: the fused derive launched {got[:4].tolist()} in "
              f"{steps} {what} steps, not {DERIVES_PER_STEP} x "
              f"{use.tolist()} a step")
    check(np.array_equal(d_set[:4], set_use), f"{label}: the fused derive "
          f"launched {d_set[:4].tolist()} at set-up, not set_q's "
          f"{set_use.tolist()}")
    return (d_set + d_warm + d_timed + d_census)[:4]


def derive_inputs(torch, K, seed):
    """Random spectra in the kernel object's layouts: the q side's block
    and the phi side's."""
    rng = np.random.default_rng(seed)

    def cx(shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z, dtype=K.cdtype, device=K.device)

    return cx(K.zero_state().qh.shape), cx(K.grid.spec_shape)


def ulps(torch, got, want) -> float:
    """The largest difference in units of the working type's epsilon at
    the reference's largest magnitude (0: bit for bit)."""
    if torch.equal(got, want):
        return 0.0
    eps = torch.finfo(want.real.dtype).eps
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (eps * scale)


def derive_gaps(torch, K, seed):
    """Each of the fused derive's kernels, and the whole derive, against
    the plain chain of the kernel object ``K`` on the same CUDA tensors:
    ``{what: ulps}``. On a mesh every rank calls it (the transforms and the
    reflection are collectives)."""
    qh, phih = derive_inputs(torch, K, seed)
    prev = K.derive(qh * 0.5, phih * 0.5, plain=True)
    gaps = {}
    bp = K._grad_pack(phih, True)
    gaps["grad_pack"] = ulps(torch, K._grad_pack(phih, False), bp)
    pg = K.tr.ifft2(bp)
    phix, phiy = pg[1], pg[2]
    if K.physics.stale_phi_gradients:
        phix, phiy = prev.phix, prev.phiy
    fj = None
    if K.physics.has_wave_pv:
        wp = K._wave_pv(pg[0], phix, phiy, True)
        gaps["wave_pv"] = ulps(torch, K._wave_pv(pg[0], phix, phiy, False),
                               wp)
        fj = K._fwd_real(wp)
    got = K._invert_pack(qh, fj, False)
    qwh, ph, specs = K._invert_pack(qh, fj, True)
    # the batch as the inverse takes it
    for what, a, c in zip(("qwh", "ph", "batch"), got,
                          (qwh, ph, K._inv_prepare(specs))):
        gaps[what] = ulps(torch, a, c)
    D = K.derive(qh, phih, prev)
    Dp = K.derive(qh, phih, prev, plain=True)
    for f in D._fields:
        a, c = getattr(D, f), getattr(Dp, f)
        gaps["D." + f] = (0.0 if a is None and c is None
                          else ulps(torch, a, c))
    return gaps


# the budget partials' limit in stage_gaps' units (the working type's
# epsilon times the sum of a sum's terms' magnitudes over M²): the float64
# total of the plain chain's own terms, rounded once, reads at most 0.5
STAGE_PART_LIMIT = 2.0
# phase 14: the bytes the fused stage epilogue must move, in complex values
# of the working type an element of each side, read once and written once:
# the wave side phih, Jh, Rh, three real tables and Fnw; the q side the two
# products' spectra, qh, ph, a real table and Fn
STAGE_VALUES = {"wave": 3 + 1.5 + 1, "q": 2 + 2 + 0.5 + 1}
# phase 14: steps of the flagship with diagnostics, for the launches
STAGE_RUN_STEPS = 20
STAGE_PARTS = ("ep_phi", "chi_phi", "ep_psi", "gamma1", "gamma2", "xi1",
               "xi2", "phih00_re", "phih00_im", "rh00_re", "rh00_im")


def stage_use(K) -> int:
    """The fused stage epilogue's launches with right-hand sides in one
    step of the kernel object ``K``: one an ETDRK4 stage, two where QL
    re-evaluates the wave right-hand side on the updated ``qh``; none
    where the model has no fast kernel."""
    if getattr(K, "_stage_plan", None) is None:
        return 0
    return 4 * (2 if K.physics.jac_reads_updated_qh else 1)


def stage_counts() -> np.ndarray:
    """The fused stage epilogue's launches on this process's cards so far:
    with right-hand sides, sources alone, then its plain-chain calls."""
    from niwqg_tpu_torch.ops import stage_fused as sf

    c = sf.counts()
    return np.array([c[k] for k in sf.USES + ("cpu_calls",)],
                    dtype=np.int64)


def stage_report(label, s_set, s_warm, s_timed, s_census, use, census=False):
    """Hold a run's fused stage epilogue launches (``stage_counts``
    arrays): ``use`` a step with right-hand sides, none at set-up, no
    sources alone (``run_steps`` samples no diagnostics), no plain chain
    on the card. Returns the launches in all."""
    s_set, s_warm, s_timed, s_census = (
        np.asarray(x, dtype=np.int64)
        for x in (s_set, s_warm, s_timed, s_census))
    log(f"  fused stage epilogue launches (with RHS, sources alone; counted "
        f"on the card): set-up {s_set[:2].tolist()}, {WARM_STEPS} warm-up "
        f"steps {s_warm[:2].tolist()}, {TIMED_STEPS} timed "
        f"{s_timed[:2].tolist()}"
        + (f", census step {s_census[:2].tolist()}" if census else "")
        + f"; {use} a step expected")
    check(int(sum(x[2] for x in (s_set, s_warm, s_timed, s_census))) == 0,
          f"{label}: a stage epilogue on the card took the plain chain")
    for what, got, steps in (("set-up", s_set, 0),
                             ("warm-up", s_warm, WARM_STEPS),
                             ("timed", s_timed, TIMED_STEPS),
                             ("census", s_census, int(census))):
        check(got[:2].tolist() == [use * steps, 0],
              f"{label}: the fused stage epilogue launched "
              f"{got[:2].tolist()} in {steps} {what} steps, not "
              f"[{use * steps}, 0]")
    return int(sum(x[:2].sum() for x in (s_set, s_warm, s_timed, s_census)))


def stage_gaps(torch, K, seed):
    """The fused stage epilogue against the plain chain of the kernel
    object ``K`` on the same CUDA tensors, in each of its uses (``rhs``:
    the right-hand sides alone; with spectral budgets also ``stage``, both,
    and ``sources``, the partials alone): ``{what: gap}``. ``Fn`` and
    ``Fnw`` in ulps (0: bit for bit); ``again.*``, a second launch against
    the first (0: bit for bit); each budget partial (``part.*``) in units
    of the working type's epsilon times the sum of its terms' magnitudes
    over M², against the float64 total of the plain chain's own terms (the
    mean modes against the plain chain, 0: bit for bit); ``plain.*``, the
    plain chain's own sums so measured (reported, not held). On a mesh
    every rank calls it (the transforms are collectives)."""
    qh, phih = derive_inputs(torch, K, seed)
    D = K.derive(qh, phih, plain=True)
    jadv, refrh, jh = K._wave_products(qh, D)
    uvqh = K._q_products(D)
    uses = {"rhs": dict(jadv=jadv, uvqh=uvqh, sources=False)}
    terms = None
    if K._spectral_src:
        uses["stage"] = dict(jadv=jadv, uvqh=uvqh, jh=jh)
        uses["sources"] = dict(jh=jh)
        ph = D.ph if K.physics.hermitian_ph else K._project_ph(D.ph)
        terms = list(K._source_terms(qh, phih, ph, refrh, jh))
    eps = torch.finfo(K.rdtype).eps
    m2 = 1.0 / float(K.grid.M) ** 2
    gaps = {}
    for use, kw in uses.items():
        got = K._epilogue(qh, phih, D, refrh, plain=False, **kw)
        again = K._epilogue(qh, phih, D, refrh, plain=False, **kw)
        want = K._epilogue(qh, phih, D, refrh, plain=True, **kw)
        for what, a, b, c in zip(("Fn", "Fnw", "parts"), got, again, want):
            if c is None:
                continue
            gaps[f"{use}.again.{what}"] = 0.0 if torch.equal(a, b) else 1.0
            if what != "parts":
                gaps[f"{use}.{what}"] = ulps(torch, a, c)
                continue
            for j, name in enumerate(STAGE_PARTS):
                if j >= len(terms):  # a mean-mode entry: the chain's bits
                    gaps[f"{use}.part.{name}"] = (
                        0.0 if torch.equal(a[j], c[j]) else float("inf"))
                    continue
                t = terms[j].double()
                ref, scale = t.sum().item() * m2, t.abs().sum().item() * m2
                for key, v in ((f"{use}.part.{name}", a[j]),
                               (f"plain.{use}.part.{name}", c[j])):
                    err = abs(float(v) - ref)
                    gaps[key] = err / (eps * scale) if scale else err
    return gaps


def stage_inputs(torch, K, seed):
    """A stage's epilogue inputs from random spectra: ``(qh, phih, D,
    refrh, kw)``, ``kw`` the transforms' outputs ``_epilogue`` takes with
    the right-hand sides and the partials (on a mesh every rank calls it:
    the transforms are collectives)."""
    qh, phih = derive_inputs(torch, K, seed)
    D = K.derive(qh, phih, plain=True)
    jadv, refrh, jh = K._wave_products(qh, D)
    return qh, phih, D, refrh, dict(jadv=jadv, uvqh=K._q_products(D), jh=jh)


def stage_record(torch, K, layout, inputs, reps=DERIVE_REPS):
    """The fused stage epilogue of ``K`` on ``inputs`` (``stage_inputs``)
    with its partials (a stage with budgets), ``reps`` launches queued
    behind a sleep (``k2_times``), beside its bound (STAGE_VALUES of
    complex values an element at PEAK_BYTES) and the plain chain on the
    same tensors."""
    qh, phih, D, refrh, kw = inputs
    card = [qh.device]
    ms, us, _ = k2_times(torch, lambda: K._epilogue(
        qh, phih, D, refrh, plain=False, **kw), card, reps)
    pms = k2_times(torch, lambda: K._epilogue(
        qh, phih, D, refrh, plain=True, **kw), card, reps)[0]
    size = qh.element_size() // 8  # complex64: 1, complex128: 2
    nbytes = 8 * size * (STAGE_VALUES["wave"] * phih.numel()
                         + STAGE_VALUES["q"] * qh.numel())
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"  stage_epilogue {layout} wave {tuple(phih.shape)}, q "
        f"{tuple(qh.shape)}: {ms:.4f} ms (bound {bound:.4f}, "
        f"{100 * bound / ms:.1f}%; {nbytes / 1e6:.1f} MB; host {us:.1f} µs "
        f"a call), plain chain {pms:.4f} ms")
    return dict(layout=layout, shape=[list(phih.shape), list(qh.shape)],
                ms=round(ms, 4), bound_ms=round(bound, 4),
                plain_ms=round(pms, 4))


def stage_held(gaps, label, what="Fn, Fnw",
               reported="the plain chain's own sums"):
    """Check ``stage_gaps``' (or ``qg_gaps``') readings: ``what`` and a
    second launch bit for bit, each partial (``.part.``) within
    STAGE_PART_LIMIT; the ``plain.`` readings, ``reported``, logged."""
    held = {k: v for k, v in gaps.items() if not k.startswith("plain.")}
    worst = max((v for k, v in held.items() if ".part." in k), default=0.0)
    exact = {k: v for k, v in held.items() if ".part." not in k}
    plain = max((v for k, v in gaps.items() if k.startswith("plain.")),
                default=0.0)
    log(f"  {label}: {what} largest gap {max(exact.values()):g} ulps, "
        f"partials {worst:.3f} (limit {STAGE_PART_LIMIT}; {reported} "
        f"{plain:.3f}), {len(held)} readings")
    check(not any(exact.values()), f"{label}: the fused kernels are not "
          f"bitwise their plain chain: "
          f"{ {k: v for k, v in exact.items() if v} }")
    check(worst <= STAGE_PART_LIMIT, f"{label}: a budget partial is "
          f"{worst:.3f} from the float64 total of its terms")
    return worst


def derive_phase(torch):
    """Phase 14: the fused derive's kernels and the fused stage epilogue on
    the flagship's half layout at NX² on one card, held to the plain chain
    (``derive_gaps``, ``stage_gaps``) and timed beside it and their bounds;
    the epilogue's launches in steps with diagnostics. (A rank's block of
    the NX_BIG² pencil mesh: phase 13, ``mesh_derive``, ``mesh_stage``.)"""
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.ops import derive_fused as dv
    from niwqg_tpu_torch.ops import stage_fused as sf

    recs = {k: [] for k in dv.KERNELS}
    m = flagship(CoupledModel, ic, fast=True, backend="native",
                 dtype=np.float32)
    K = m.kernel
    gaps = derive_gaps(torch, K, seed=14)
    check(not any(gaps.values()), f"fused derive not bitwise: {gaps}")
    log(f"phase 14: fused derive bitwise the plain chain at {NX}² "
        f"(q_half={K.q_half}): {sorted(gaps)}")
    s = m.state
    qh, phih = s.qh, s.phih
    pg = K.tr.ifft2(K._grad_pack(phih, True))
    fj = K._fwd_real(K._wave_pv(pg[0], pg[1], pg[2], True))
    log(f"phase 14: {NX}² one card, half layout {tuple(qh.shape)}")
    fused = {
        "derive_grad_pack": (phih, lambda: K._grad_pack(phih, False),
                             lambda: K._grad_pack(phih, True), "one card"),
        "derive_wave_pv": (pg[0], lambda: K._wave_pv(*pg, False),
                           lambda: K._wave_pv(*pg, True), "one card"),
        "derive_invert": (
            qh, lambda: K._invert_pack(qh, fj, False),
            lambda: K._inv_prepare(K._invert_pack(qh, fj, True)[2]),
            "mirror")}
    for name, (field, fn, plain, how) in fused.items():
        values = DERIVE_VALUES[name]
        recs[name].append(derive_record(
            torch, name, "one card", field, fn, plain,
            values[how] if isinstance(values, dict) else values))
    card = [qh.device]
    whole = k2_times(torch, lambda: K.derive(qh, phih, s.d), card,
                     DERIVE_REPS)[0]
    whole_p = k2_times(torch, lambda: K.derive(qh, phih, s.d, plain=True),
                       card, DERIVE_REPS)[0]
    log(f"  the whole derive, transforms included: {whole:.4f} ms fused, "
        f"{whole_p:.4f} ms plain ({4 * (whole_p - whole):.3f} ms a step "
        "saved at 4 a step)")
    del pg, fj
    # the fused stage epilogue on the same half layout: every use bitwise
    # (the partials within their limit), timed beside its bound and the
    # plain chain; then its launches in steps with diagnostics
    stage_held(stage_gaps(torch, K, seed=15), f"phase 14: the fused stage "
               f"epilogue at {NX}² (q_half={K.q_half})")
    inputs = stage_inputs(torch, K, 16)
    recs["stage_epilogue"] = [stage_record(torch, K, "one card", inputs)]
    qh_, phih_, D_, refrh_, kw_ = inputs
    whole = k2_times(torch, lambda: K.stage_terms(qh_, phih_, D_, True),
                     card, DERIVE_REPS)[0]
    whole_p = k2_times(torch, lambda: K.stage_terms(qh_, phih_, D_, True,
                                                    plain=True),
                       card, DERIVE_REPS)[0]
    log(f"  a stage's terms, transforms included: {whole:.4f} ms fused, "
        f"{whole_p:.4f} ms plain ({4 * (whole_p - whole):.3f} ms a step "
        "saved at 4 a step)")
    del inputs, qh_, phih_, D_, refrh_, kw_
    sf.reset_counts()
    tc0, n = m.state.tc, STAGE_RUN_STEPS
    samples = sum((tc0 + i) % m.params.tdiags == 0 for i in range(n))
    m._runner.advance(n, diags=True)
    got = stage_counts()
    log(f"  {n} steps with {samples} diagnostics samples (graphs "
        f"{m._runner.graphs}): stage epilogue launches {got.tolist()} "
        f"(with RHS, sources alone, plain chain)")
    check(got.tolist() == [stage_use(K) * n, samples, 0], "phase 14: the "
          f"fused stage epilogue launched {got.tolist()}, not "
          f"[{stage_use(K) * n}, {samples}, 0]")
    del m, K
    torch.cuda.empty_cache()
    return recs


def derive_record(torch, name, layout, field, fused, plain, values):
    """``fused`` and ``plain`` (may be None) on ``field``'s card, each
    DERIVE_REPS calls queued behind a sleep (``k2_times``: device ms a
    call by CUDA events, host µs a call), beside the bound of ``values``
    complex values of 8 bytes an element of ``field``."""
    shape, n, card = field.shape, field.numel(), [field.device]
    ms, us, _ = k2_times(torch, fused, card, DERIVE_REPS)
    pms = (None if plain is None
           else k2_times(torch, plain, card, DERIVE_REPS)[0])
    bound = values * n * 8 / PEAK_BYTES * 1e3
    log(f"  {name} {layout} {tuple(shape)}: {ms:.4f} ms (bound {bound:.4f},"
        f" {100 * bound / ms:.1f}%; host {us:.1f} µs a call), plain chain "
        + ("not timed alone" if pms is None else f"{pms:.4f} ms"))
    return dict(layout=layout, shape=list(shape), ms=round(ms, 4),
                bound_ms=round(bound, 4),
                plain_ms=None if pms is None else round(pms, 4))


def mesh_derive(torch, mesh, m, key, seed=13):
    """Phase 13 on a pencil mesh rank of the NX_BIG² flagship (every rank
    calls it): the fused derive bitwise its plain chain on every rank
    (``derive_gaps``); then rank 1's kernels alone timed while the others
    wait (the reflection made beforehand), beside their bounds and the
    plain chain's grad and wave-PV packs; and the inversion with its
    reflection exchange, fused and plain, on every rank at once (rank 1's
    time). Returns rank 0's entries, prefixed by ``key``: ``derive_ulps``
    (the largest over ranks) and ``derive_recs`` (rank 1's, JSON)."""
    from niwqg_tpu_torch.ops import derive_fused as dv
    from niwqg_tpu_torch.parallel.mesh import reflect_spectrum

    K = m.kernel
    gaps = derive_gaps(torch, K, seed)
    worst = max(max(g.values()) for g in mesh.all_gather_object(gaps))
    qh, phih = derive_inputs(torch, K, seed + 1)
    pg = K.tr.ifft2(K._grad_pack(phih, True))
    fj = K._fwd_real(K._wave_pv(*pg, True))
    qwh, ph, batch = dv.invert(qh, fj, K.qtab.wv2, K.qtab.wv2i,
                               K.qtab.filtr, K._plan)
    refl = reflect_spectrum(ph, mesh).contiguous()
    recs = {k: [] for k in dv.KERNELS}
    layout = f"mesh rank 1 of {mesh.nP}"
    mesh.barrier()
    if mesh.rank == 1:
        for name, field, fn, plain, values in (
                ("derive_grad_pack", phih,
                 lambda: K._grad_pack(phih, False),
                 lambda: K._grad_pack(phih, True),
                 DERIVE_VALUES["derive_grad_pack"]),
                ("derive_wave_pv", pg[0], lambda: K._wave_pv(*pg, False),
                 lambda: K._wave_pv(*pg, True),
                 DERIVE_VALUES["derive_wave_pv"]),
                ("derive_invert", qh,
                 lambda: dv.invert(qh, fj, K.qtab.wv2, K.qtab.wv2i,
                                   K.qtab.filtr, K._plan), None,
                 DERIVE_VALUES["derive_invert"]["raw"]),
                ("derive_project_pack", qh,
                 lambda: dv.project_pack(ph, refl, batch, K._plan), None,
                 DERIVE_VALUES["derive_project_pack"])):
            recs[name].append(derive_record(torch, name, layout, field, fn,
                                            plain, values))
    mesh.barrier()
    # the inversion with the reflection exchange, every rank at once
    card = [mesh.device]
    with_x = k2_times(torch, lambda: K._invert_pack(qh, fj, False), card,
                      DERIVE_REPS, mesh.barrier)[0]
    with_x_plain = k2_times(torch, lambda: K._invert_pack(qh, fj, True),
                            card, DERIVE_REPS, mesh.barrier)[0]
    if mesh.rank == 1:
        recs["derive_invert"][0].update(
            with_exchange_ms=round(with_x, 4),
            plain_with_exchange_ms=round(with_x_plain, 4))
        log(f"  derive_invert + reflection + derive_project_pack, every "
            f"rank at once: {with_x:.4f} ms; the plain chain with its "
            f"reflection {with_x_plain:.4f} ms (rank 1; {mesh.nP} ranks on "
            f"{torch.cuda.device_count()} card(s))")
    every = mesh.all_gather_object(recs)
    del qh, phih, pg, fj, qwh, ph, batch, refl
    return {f"{key}_derive_ulps": worst,
            f"{key}_derive_recs": json.dumps(every[1])}


def mesh_stage(torch, mesh, m, key, seed=17):
    """Phase 13 on a pencil mesh rank of the NX_BIG² flagship (every rank
    calls it): the fused stage epilogue against its plain chain on every
    rank (``stage_gaps``, each reading's worst over the ranks); then rank
    1's kernel alone timed while the others wait (``stage_record``: its
    fields in the layouts the transforms hand over). Returns rank 0's
    entries, prefixed by ``key``: ``stage_gaps`` and ``stage_recs`` (JSON)."""
    K = m.kernel
    gaps = stage_gaps(torch, K, seed)
    every = mesh.all_gather_object(gaps)
    worst = {k: max(g[k] for g in every) for k in gaps}
    inputs = stage_inputs(torch, K, seed + 1)  # every rank: collectives
    recs = []
    mesh.barrier()
    if mesh.rank == 1:
        recs.append(stage_record(torch, K, f"mesh rank 1 of {mesh.nP}",
                                 inputs))
    mesh.barrier()
    every = mesh.all_gather_object(recs)
    return {f"{key}_stage_gaps": json.dumps(worst),
            f"{key}_stage_recs": json.dumps(every[1])}


# -- the QG model's fused stage gaps (csrc/qg_stage.cu, ops/qg_fused.py) ------

# QG's launches a step on the card, by use (qg_fused.USES): one pack, and a
# products and a stage launch each ETDRK4 stage
QG_PER_STEP = (1, 4, 4)
# phase 14: steps of each kind the QG launches are pinned over
QG_RUN_STEPS = 6


def qg_use(K) -> np.ndarray:
    """The fused QG gaps' launches by use in one step of the kernel object
    ``K``: QG_PER_STEP where it is a QG kernel on the card, else none."""
    plan = getattr(K, "_qg_plan", None)
    on_card = plan is not None and plan.blocks > 0
    return np.array(QG_PER_STEP if on_card else (0, 0, 0), dtype=np.int64)


def qg_counts() -> np.ndarray:
    """The fused QG gaps' launches on this process's cards so far, by use,
    then the plain step's stages on host tensors."""
    from niwqg_tpu_torch.ops import qg_fused as qf

    c = qf.counts()
    return np.array([c[k] for k in qf.USES + ("cpu_calls",)],
                    dtype=np.int64)


def qg_report(label, q_set, q_warm, q_timed, q_census, use, census=False):
    """Hold a run's fused QG launches (``qg_counts`` arrays): ``use`` a
    step, none at set-up, no plain chain on the card. Returns the launches
    by use in all."""
    q_set, q_warm, q_timed, q_census, use = (
        np.asarray(x, dtype=np.int64)
        for x in (q_set, q_warm, q_timed, q_census, use))
    log(f"  fused QG gaps' launches (pack, products, stage; counted on the "
        f"card): set-up {q_set[:3].tolist()}, {WARM_STEPS} warm-up steps "
        f"{q_warm[:3].tolist()}, {TIMED_STEPS} timed {q_timed[:3].tolist()}"
        + (f", census step {q_census[:3].tolist()}" if census else "")
        + f"; {use.tolist()} a step expected")
    check(int(sum(x[3] for x in (q_set, q_warm, q_timed, q_census))) == 0,
          f"{label}: a QG stage on the card took the plain chain")
    for what, got, steps in (("set-up", q_set, 0),
                             ("warm-up", q_warm, WARM_STEPS),
                             ("timed", q_timed, TIMED_STEPS),
                             ("census", q_census, int(census))):
        check(np.array_equal(got[:3], steps * use),
              f"{label}: the fused QG gaps launched {got[:3].tolist()} in "
              f"{steps} {what} steps, not {steps} x {use.tolist()}")
    return (q_set + q_warm + q_timed + q_census)[:3]


def qg_inputs(torch, K, seed, transposed=None):
    """Random inputs of the QG gaps in the kernel object's layout: ``(ph,
    qh, ch, gbs, fjs)``, the state's spectra (``ch`` None without the
    scalar), and each stage's inverse batch (physical) and forward output.
    ``transposed=None`` takes the forward outputs from the kernel object's
    transform (on a mesh a collective: every rank calls it), so that they
    come in its layout; ``True``/``False`` makes them column-led/row-major
    without a transform."""
    rng = np.random.default_rng(seed)
    g, P = K.grid, K._qg_plan
    ns = 2 if P.cc is not None else 1
    (ny, wq), (rows, nx) = g.spec_shape, g.phys_shape

    def real(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=K.rdtype,
                               device=K.device)

    def spec(n, cols_led=False):
        shape = (n, wq, ny) if cols_led else (n, ny, wq)
        z = torch.complex(real(*shape), real(*shape))
        return z.transpose(-1, -2) if cols_led else z

    gbs = [real(2 + ns, rows, nx) for _ in range(4)]
    if transposed is None:
        fjs = [K._fwd(real(2 * ns, rows, nx)) for _ in range(4)]
        st = K._fwd(real(2 + ns, rows, nx))
    else:
        fjs = [spec(2 * ns, transposed) for _ in range(4)]
        st = spec(2 + ns, transposed)
    return st[0], st[1], st[2] if ns == 2 else None, gbs, fjs


def qg_gaps(torch, K, seed, transposed=None):
    """The fused QG gaps against their plain chain on the same CUDA
    tensors: ``{what: gap}``. Every batch, right-hand side and ``ph`` in
    ulps (0: bit for bit), ``again.*`` a second launch against the first
    (0: bit for bit), each budget partial (``part.*``) in units of the
    working type's epsilon times the sum of its terms' magnitudes over M²
    against the float64 total of its terms. With the kernel object's
    transform (``transposed=None``; on a mesh every rank calls it) also two
    whole steps, fused against ``step(plain=True)`` (``step.*``: every
    field bit for bit; ``plain.step.*``, Ke and cvar in units of epsilon
    of their value, reported)."""
    from niwqg_tpu_torch.ops import qg_fused as qf

    P = K._qg_plan
    ph, qh, ch, gbs, fjs = qg_inputs(torch, K, seed, transposed)
    eps = torch.finfo(K.rdtype).eps
    gaps = {}

    def held(what, fused, plain):
        a, b = fused(), fused()
        gaps[f"again.{what}"] = 0.0 if torch.equal(a, b) else 1.0
        gaps[what] = ulps(torch, a, plain())
        return a

    held("pack", lambda: qf.pack(P, ph, qh, ch),
         lambda: qf.pack_plain(P, ph, qh, ch))
    for n, gb in enumerate(gbs, 1):
        held(f"products{n}", lambda: qf.products(P, gb),
             lambda: qf.products_plain(P, gb))
    fns, base1 = [], None
    for n, fj in enumerate(fjs, 1):
        kw = dict(base=base1 if n == 3 else (qh, ch),
                  qh_q=qh if n == 3 else None,
                  fns=((fns[0], fns[1]) if n == 3 else (fns[0], fns[2])
                       if n == 4 else (None, None)), ph=True)
        got = qf.stage(P, n, fj, **kw)
        again = qf.stage(P, n, fj, **kw)
        want = qf.stage_plain(P, n, fj, **kw)
        for what, a, b, c in zip(("batch", "fn", "parts", "ph"), got, again,
                                 want):
            if c is None:
                continue
            gaps[f"stage{n}.again.{what}"] = (0.0 if torch.equal(a, b)
                                              else 1.0)
            if what != "parts":
                gaps[f"stage{n}.{what}"] = ulps(torch, a, c)
        if P.sums:
            bw, fresh = want[0], 1 if n == 4 else 2
            pair = qh if n < 3 else kw["qh_q"] if n == 3 else bw[fresh]
            terms = qf.part_terms(P, pair, bw[fresh], want[3],
                                  bw[-1] if ch is not None else None)
            for j, (name, t) in enumerate(zip(qf.PARTS, terms)):
                if t is None:
                    continue
                ref = t.sum().item() * P.inv_m2
                scale = t.abs().sum().item() * P.inv_m2
                err = abs(float(got[2][j]) - ref)
                gaps[f"stage{n}.part.{name}"] = (err / (eps * scale)
                                                 if scale else err)
        fns.append(got[1])
        if n == 1:
            base1 = (got[0][2], got[0][3] if ch is not None else None)
    if transposed is None:
        s = K.zero_state()
        rng = np.random.default_rng(seed + 1)
        s = K.apply_set_q(s, rng.standard_normal((K.grid.nx,) * 2) * 1e-5)
        if ch is not None:
            s = K.apply_set_c(s, rng.standard_normal((K.grid.nx,) * 2))
        for i in range(2):
            a, b = K.step(s), K.step(s, plain=True)
            for f in ("qh", "ch", "ph", "p", "q", "c", "u", "v"):
                gaps[f"step{i}.{f}"] = ulps(torch, getattr(a, f),
                                            getattr(b, f))
            for f in ("Ke", "cvar"):
                x, y = float(getattr(a, f)), float(getattr(b, f))
                gaps[f"plain.step{i}.{f}"] = abs(x - y) / (eps * abs(y)
                                                          or 1.0)
            s = a
    return gaps


def qg_held(gaps, label):
    """``stage_held`` on ``qg_gaps``' readings."""
    return stage_held(gaps, label, what="every field and batch",
                      reported="whole steps' Ke and cvar, eps of their value")


def qg_values(K, n) -> float:
    """Complex values of the working type each element of a spectral field
    that QG's stage ``n`` must read and write once (0: the pack; a real
    table is half of one): a side's two forward spectra, its start, its
    tables and the right-hand sides it reads, the q side's qh_q at stage
    3, the filter and wv2i; the batch and the right-hand sides it keeps."""
    P = K._qg_plan
    ns = 2 if P.cc is not None else 1
    if n == 0:
        return (1 + ns) + (2 + ns)  # ph, qh (, ch); the batch
    reads = ns * (2 + 1 + (4 if n == 4 else 2) + (2 if n >= 3 else 0))
    reads += (n == 3) + 0.5 * (P.filtr is not None) + 0.5
    writes = (3 if n == 4 else 4) - (ns == 1) + (ns if n < 4 else 0)
    return reads + writes


def qg_record(torch, K, layout, inputs, reps=DERIVE_REPS, whole=True):
    """Each fused QG gap of ``K`` on ``inputs`` (``qg_inputs``), ``reps``
    launches queued behind a sleep
    (``k2_times``) on the working stream, beside its bound (its bytes at
    PEAK_BYTES) and its plain chain without the budget sums; where
    ``whole``, a step fused and plain. Returns ``{kernel: [record]}``."""
    from niwqg_tpu_torch.ops import qg_fused as qf

    P = K._qg_plan
    nosum = P._replace(sums=False)
    ph, qh, ch, gbs, fjs = inputs
    card = [qh.device]
    st = qf.stage(P, 1, fjs[0], (qh, ch))
    st2 = qf.stage(P, 2, fjs[1], (qh, ch))
    st3 = qf.stage(P, 3, fjs[2], (st[0][2], st[0][-1] if ch is not None
                                  else None), qh_q=qh, fns=(st[1], st2[1]))
    args = {1: dict(base=(qh, ch)), 2: dict(base=(qh, ch)),
            3: dict(base=(st[0][2], st[0][-1] if ch is not None else None),
                    qh_q=qh, fns=(st[1], st2[1])),
            4: dict(base=(qh, ch), fns=(st[1], st3[1]))}
    size = qh.element_size()
    gb = gbs[0]
    # (kernel, use, fused, plain, bytes, the shape of a field it reads)
    calls = [("qg_stage", "pack", lambda: qf.pack(P, ph, qh, ch),
              lambda: qf.pack_plain(P, ph, qh, ch),
              qg_values(K, 0) * qh.numel() * size, qh.shape),
             ("qg_products", "products", lambda: qf.products(P, gb),
              lambda: qf.products_plain(P, gb),
              (3 * gb.shape[0] - 4) * gb[0].numel() * gb.element_size(),
              gb[0].shape)]
    for n in (1, 2, 3, 4):
        calls.append(("qg_stage", f"stage {n}",
                      lambda n=n: qf.stage(P, n, fjs[n - 1], **args[n]),
                      lambda n=n: qf.stage_plain(nosum, n, fjs[n - 1],
                                                 **args[n]),
                      qg_values(K, n) * qh.numel() * size, qh.shape))
    recs = {k: [] for k in qf.KERNELS}
    for name, what, fused, plain, nbytes, shape in calls:
        ms, us, _ = k2_times(torch, fused, card, reps)
        pms = k2_times(torch, plain, card, reps)[0]
        bound = nbytes / PEAK_BYTES * 1e3
        log(f"  {name} ({what}) {layout} {tuple(shape)}: {ms:.4f} ms "
            f"(bound {bound:.4f}, {100 * bound / ms:.1f}%; "
            f"{nbytes / 1e6:.1f} MB; host {us:.1f} µs a call), plain chain "
            f"{pms:.4f} ms (without the budget sums)")
        recs[name].append(dict(use=what, layout=layout,
                               shape=list(shape), ms=round(ms, 4),
                               bound_ms=round(bound, 4),
                               plain_ms=round(pms, 4)))
    if whole:
        s = K.apply_set_q(K.zero_state(),
                          np.random.default_rng(7).standard_normal(
                              (K.grid.nx,) * 2) * 1e-5)
        fused = k2_times(torch, lambda: K.step(s), card, 10)[0]
        plain = k2_times(torch, lambda: K.step(s, plain=True), card, 10)[0]
        log(f"  a whole QG step, transforms included: {fused:.4f} ms fused, "
            f"{plain:.4f} ms plain")
        recs["step_ms"] = dict(fused=round(fused, 4), plain=round(plain, 4))
    return recs


def qg_phase(torch):
    """Phase 14, QG: the fused stage gaps on ``qg_flagship``'s half layout
    (f32 cuFFT, with its scalar) at NX² on one card: every kernel and two
    whole steps against the plain chain (``qg_gaps``), each kernel timed
    beside its bound and its plain chain; then the launches by use in
    eager steps, captures and replays of graphs A and B, and the host
    counter ``step.qg_fused`` (one an eager step or a capture). Returns
    ``({kernel: [record]}, launches by use)``. (A rank's block of the
    NX_BIG² pencil mesh: phase 13, ``mesh_qg``.)"""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.ops import qg_fused as qf
    from niwqg_tpu_torch.utils import profiling

    m = qg_flagship(pkg.QGModel, ic, backend="native", dtype=np.float32,
                    tdiags=1)
    K = m.kernel
    qg_held(qg_gaps(torch, K, seed=22), f"phase 14: the fused QG gaps at "
            f"{NX}² on one card")
    recs = qg_record(torch, K, "one card", qg_inputs(torch, K, 23))
    use = qg_use(K)
    check(use.tolist() == list(QG_PER_STEP), "phase 14: the QG kernel "
          "object on the card has no plan of its fused gaps")
    total = np.zeros(3, dtype=np.int64)
    r = m._runner
    for label, n, diags, captures in (
            ("graph A, its first step eager", QG_RUN_STEPS, False, 1),
            ("one replay of A", 1, False, 0),
            ("graph B (a sample every step), its first step eager",
             QG_RUN_STEPS, True, 1),
            ("one replay of B", 1, True, 0)):
        qf.reset_counts()
        c0 = profiling.counters().get("step.qg_fused", 0)
        r.advance(n, diags=diags)
        got = qg_counts()
        hosted = profiling.counters().get("step.qg_fused", 0) - c0
        log(f"  {label}: {n} steps, launches {got[:3].tolist()} (pack, "
            f"products, stage), plain {got[3]}, step.qg_fused +{hosted}")
        check(got.tolist() == (n * use).tolist() + [0], f"phase 14: QG's "
              f"fused gaps launched {got.tolist()} in {n} steps ({label})")
        check(hosted == (captures * 2 if n > 1 else 0), f"phase 14: "
              f"step.qg_fused counted {hosted} host steps ({label})")
        total += got[:3]
    check(r.graphs, "phase 14: QG's runner did not capture")
    del m, K
    torch.cuda.empty_cache()
    return recs, total


def mesh_qg(torch, mesh, m, key, seed=19):
    """Phase 13 on a pencil mesh rank of QG + scalar at NX_BIG² (every rank
    calls it): the fused QG gaps against their plain chain on every rank,
    the forward outputs in the pencil's layout (``qg_gaps``, each reading's
    worst over the ranks); then rank 1's kernels alone timed while the
    others wait (``qg_record``). Returns rank 0's entries, prefixed by
    ``key``: ``qg_gaps`` and ``qg_recs`` (JSON)."""
    K = m.kernel
    gaps = qg_gaps(torch, K, seed)
    every = mesh.all_gather_object(gaps)
    worst = {k: max(g[k] for g in every) for k in gaps}
    recs = {}
    mesh.barrier()
    # the inputs are made with the transform on every rank; only rank 1
    # then times its kernels
    inputs = qg_inputs(torch, K, seed + 1)
    if mesh.rank == 1:
        recs = qg_record(torch, K, f"mesh rank 1 of {mesh.nP}", inputs,
                         whole=False)
    mesh.barrier()
    every = mesh.all_gather_object(recs)
    return {f"{key}_qg_gaps": json.dumps(worst),
            f"{key}_qg_recs": json.dumps(every[1])}


# -- the YBJ model's fused stage gaps (csrc/ybj_stage.cu, ops/ybj_fused.py) ---

# YBJ's launches a step on one card, by use (ybj_fused.USES): one pack, and
# a products and a stage launch each ETDRK4 stage
YBJ_PER_STEP = (1, 4, 4)
# phase 14: steps of each kind the YBJ launches are pinned over
YBJ_RUN_STEPS = 6
# the whole step's fields a fused step is held to, bit for bit
YBJ_FIELDS = ("phih", "phi", "phix", "phiy")


def ybj_use(K) -> np.ndarray:
    """The fused YBJ gaps' launches by use in one step of the kernel
    object ``K``: YBJ_PER_STEP where it is a YBJ kernel of one card, else
    none."""
    from niwqg_tpu_torch.ops import ybj_fused as yf

    on = (getattr(K, "_ybj_plan", None) is not None
          and yf.engages(K.device, K.mesh))
    return np.array(YBJ_PER_STEP if on else (0, 0, 0), dtype=np.int64)


def ybj_counts() -> np.ndarray:
    """The fused YBJ gaps' launches on this process's cards so far, by
    use, then the plain step's stages on host tensors."""
    from niwqg_tpu_torch.ops import ybj_fused as yf

    c = yf.counts()
    return np.array([c[k] for k in yf.USES + ("cpu_calls",)],
                    dtype=np.int64)


def ybj_inputs(torch, K, seed):
    """Random inputs of the YBJ gaps in the kernel object's layout:
    ``(phih, flow, gbs, nls)``, the state's spectrum, the frozen flow
    ``(phi, u, v, q_psi)`` (``phi`` the step-start's), each stage's inverse
    batch (``[phix, phiy]``, or ``[phi, phix, phiy]`` where the refraction
    reads the stage's own phi) and forward output ``(2, ny, nx)``."""
    rng = np.random.default_rng(seed)
    shape = K.grid.spec_shape

    def real(*s):
        return torch.as_tensor(rng.standard_normal(s), dtype=K.rdtype,
                               device=K.device)

    def cplx(*s):
        return torch.complex(real(*s), real(*s))

    width = 2 if K.faithful_quirks else 3
    flow = (cplx(*shape), real(*shape), real(*shape), real(*shape))
    gbs = [cplx(width, *shape) for _ in range(4)]
    nls = [cplx(2, *shape) for _ in range(4)]
    return cplx(*shape), flow, gbs, nls


def _ybj_stage_args(n, phih, fns, phih1):
    """Stage ``n``'s base and right-hand sides as ``_step_fused`` chains
    them."""
    return dict(base=phih1 if n == 3 else phih,
                fns=((fns[0], fns[1]) if n == 3 else (fns[0], fns[2])
                     if n == 4 else (None, None)))


def ybj_gaps(torch, K, seed):
    """The fused YBJ gaps against their plain chain on the same CUDA
    tensors: ``{what: gap}`` in ulps (0: bit for bit). Every batch,
    right-hand side and ``phih`` of the pack, the products and stages 1-4,
    ``again.*`` a second launch against the first; then two whole steps,
    fused against ``step(plain=True)`` (``step*.``: YBJ_FIELDS)."""
    from niwqg_tpu_torch.ops import ybj_fused as yf

    P = K._ybj_plan
    phih, (phi, u, v, q), gbs, nls = ybj_inputs(torch, K, seed)
    gaps = {}

    def held(what, fused, plain):
        a, b = fused(), fused()
        gaps[f"again.{what}"] = 0.0 if torch.equal(a, b) else 1.0
        gaps[what] = ulps(torch, a, plain())

    held("pack", lambda: yf.pack(P, phih), lambda: yf.pack_plain(P, phih))
    for n, gb in enumerate(gbs, 1):
        f = gb[0] if gb.shape[0] == 3 else phi
        args = (gb[-2], gb[-1], f, u, v, q)
        held(f"products{n}", lambda: yf.products(P, *args),
             lambda: yf.products_plain(P, *args))
    fns, phih1 = [], None
    for n, nl in enumerate(nls, 1):
        kw = _ybj_stage_args(n, phih, fns, phih1)
        got = yf.stage(P, n, nl, **kw)
        again = yf.stage(P, n, nl, **kw)
        want = yf.stage_plain(P, n, nl, **kw)
        for what, a, b, c in zip(("batch", "fn", "phih"), got, again, want):
            if c is None:
                continue
            gaps[f"stage{n}.again.{what}"] = 0.0 if torch.equal(a, b) else 1.0
            gaps[f"stage{n}.{what}"] = ulps(torch, a, c)
        fns.append(got[1])
        if n == 1:
            phih1 = got[2]
    s = K.zero_state()
    rng = np.random.default_rng(seed + 1)
    nx = K.grid.nx
    s = K.apply_set_q(s, rng.standard_normal((nx, nx)) * 1e-5)
    s = K.apply_set_phi(s, rng.standard_normal((nx, nx))
                        + 1j * rng.standard_normal((nx, nx)))
    for i in range(2):
        a, b = K.step(s), K.step(s, plain=True)
        for f in YBJ_FIELDS:
            x, y = ((getattr(z, f) if f == "phih" else getattr(z.d, f))
                    for z in (a, b))
            gaps[f"step{i}.{f}"] = ulps(torch, x, y)
        s = a
    return gaps


def ybj_held(gaps, label):
    """``ybj_gaps``' readings: every one 0 (bit for bit)."""
    return stage_held(gaps, label, what="every field and batch",
                      reported="nothing")


def ybj_values(K, n) -> float:
    """Complex values of the working type each element of a field that
    YBJ's stage ``n`` must read and write once (0: the pack; -1: the
    products; a real field is half of one): the two forward spectra, the
    start, the tables and the right-hand sides it reads, the filter; the
    batch, the right-hand side it keeps and stage 1's phih."""
    P = K._ybj_plan
    full = 3 if not P.faithful else 2
    if n == -1:
        return 3 + 1.5 + 2      # phix, phiy, phi, u, v, q_psi; the batch
    if n == 0:
        return 1 + full
    reads = 2 + 1 + (4 if n == 4 else 2) + (2 if n >= 3 else 0)
    reads += 0.5 * (P.filtr is not None)
    writes = (3 if n == 4 else full) + (n <= 3) + (n == 1 and P.faithful)
    return reads + writes


def ybj_record(torch, K, inputs, reps=DERIVE_REPS):
    """Each fused YBJ gap of ``K`` on ``inputs`` (``ybj_inputs``), ``reps``
    launches queued behind a sleep (``k2_times``) on the working stream,
    beside its bound (its bytes at PEAK_BYTES) and its plain chain; then a
    whole step fused and plain. Returns ``{kernel: [record]}`` and
    ``step_ms``."""
    from niwqg_tpu_torch.ops import ybj_fused as yf

    P = K._ybj_plan
    phih, (phi, u, v, q), gbs, nls = inputs
    card = [phih.device]
    fns, phih1, args = [], None, {}
    for n, nl in enumerate(nls, 1):
        args[n] = _ybj_stage_args(n, phih, fns, phih1)
        _, fn, ph = yf.stage(P, n, nl, **args[n])
        fns.append(fn)
        if n == 1:
            phih1 = ph
    size = phih.element_size()
    gb = gbs[0]
    f = gb[0] if gb.shape[0] == 3 else phi
    pargs = (gb[-2], gb[-1], f, u, v, q)
    # (kernel, use, fused, plain, values an element)
    calls = [("ybj_stage", "pack", lambda: yf.pack(P, phih),
              lambda: yf.pack_plain(P, phih), ybj_values(K, 0)),
             ("ybj_products", "products", lambda: yf.products(P, *pargs),
              lambda: yf.products_plain(P, *pargs), ybj_values(K, -1))]
    for n in (1, 2, 3, 4):
        calls.append(("ybj_stage", f"stage {n}",
                      lambda n=n: yf.stage(P, n, nls[n - 1], **args[n]),
                      lambda n=n: yf.stage_plain(P, n, nls[n - 1], **args[n]),
                      ybj_values(K, n)))
    recs = {k: [] for k in yf.KERNELS}
    for name, what, fused, plain, values in calls:
        nbytes = values * phih.numel() * size
        ms, us, _ = k2_times(torch, fused, card, reps)
        pms = k2_times(torch, plain, card, reps)[0]
        bound = nbytes / PEAK_BYTES * 1e3
        log(f"  {name} ({what}) {tuple(phih.shape)}: {ms:.4f} ms (bound "
            f"{bound:.4f}, {100 * bound / ms:.1f}%; {nbytes / 1e6:.1f} MB; "
            f"host {us:.1f} µs a call), plain chain {pms:.4f} ms")
        recs[name].append(dict(use=what, layout="one card",
                               shape=list(phih.shape), ms=round(ms, 4),
                               bound_ms=round(bound, 4),
                               plain_ms=round(pms, 4)))
    s = K.apply_set_q(K.zero_state(), np.random.default_rng(7)
                      .standard_normal((K.grid.nx,) * 2) * 1e-5)
    fused = k2_times(torch, lambda: K.step(s), card, 10)[0]
    plain = k2_times(torch, lambda: K.step(s, plain=True), card, 10)[0]
    log(f"  a whole YBJ step, transforms included: {fused:.4f} ms fused, "
        f"{plain:.4f} ms plain")
    recs["step_ms"] = dict(fused=round(fused, 4), plain=round(plain, 4))
    return recs


def ybj_phase(torch):
    """Phase 14, YBJ: the fused stage gaps of the YBJ model (the flagship's
    physics with its wave packet, f32 cuFFT, ``faithful_quirks``) at NX² on
    one card: every kernel and two whole steps against the plain chain
    (``ybj_gaps``), each kernel timed beside its bound and its plain chain;
    then the launches by use in eager steps, captures and replays of graphs
    A and B, and the host counters ``step.ybj_fused`` and ``step.ybj`` (one
    each an eager step or a capture). Returns ``({kernel: [record]},
    launches by use)``."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.ops import ybj_fused as yf
    from niwqg_tpu_torch.utils import profiling

    m = build_model(pkg, ic, "YBJModel", backend="native", dtype=np.float32,
                    tdiags=1)
    K = m.kernel
    check(K.faithful_quirks, "phase 14: YBJ's default is faithful_quirks")
    ybj_held(ybj_gaps(torch, K, seed=24), f"phase 14: the fused YBJ gaps at "
             f"{NX}² on one card")
    recs = ybj_record(torch, K, ybj_inputs(torch, K, 25))
    use = ybj_use(K)
    check(use.tolist() == list(YBJ_PER_STEP), "phase 14: the YBJ kernel "
          "object on one card does not take its fused gaps")
    d = m.state.d
    check(d.u.is_contiguous() and d.v.is_contiguous()
          and d.q_psi.is_contiguous(), "phase 14: YBJ's frozen flow is not "
          "row-major: the fused products would copy it every stage")
    total = np.zeros(3, dtype=np.int64)
    r = m._runner
    for label, n, diags, captures in (
            ("graph A, its first step eager", YBJ_RUN_STEPS, False, 1),
            ("one replay of A", 1, False, 0),
            ("graph B (a sample every step), its first step eager",
             YBJ_RUN_STEPS, True, 1),
            ("one replay of B", 1, True, 0)):
        yf.reset_counts()
        c0 = {k: profiling.counters().get(k, 0)
              for k in ("step.ybj_fused", "step.ybj")}
        r.advance(n, diags=diags)
        got = ybj_counts()
        hosted = {k: profiling.counters().get(k, 0) - v
                  for k, v in c0.items()}
        log(f"  {label}: {n} steps, launches {got[:3].tolist()} (pack, "
            f"products, stage), plain {got[3]}, host counters {hosted}")
        check(got.tolist() == (n * use).tolist() + [0], f"phase 14: YBJ's "
              f"fused gaps launched {got.tolist()} in {n} steps ({label})")
        want = captures * 2 if n > 1 else 0
        check(hosted == {"step.ybj_fused": want, "step.ybj": want},
              f"phase 14: the host counted {hosted} YBJ steps ({label})")
        total += got[:3]
    check(r.graphs, "phase 14: YBJ's runner did not capture")
    del m, K
    torch.cuda.empty_cache()
    return recs, total


def family_refs(torch):
    """The one-card f32 cuFFT runs phase 7's QG, UnCoupled, QL and YBJ are
    held to: their fields after WARM_STEPS steps (UnCoupled and QL with
    the full-spectrum q side a pencil mesh keeps, ``q_half=False``), by
    model name."""
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic

    out = {}
    for name, kw in (("QGModel", {}),
                     ("UnCoupledModel", dict(fast=True, q_half=False)),
                     ("QLModel", dict(fast=True, q_half=False)),
                     ("YBJModel", dict(fast=True))):
        m = build_model(pkg, ic, name, backend="native", dtype=np.float32,
                        **kw)
        m.run_steps(WARM_STEPS)
        out[name] = {k: getattr(m, k) for k in mesh_fields(name)}
        del m
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="3,4,5,6,7,8,9,10,11,12,13,14",
                    help="phases to run beyond the card report and the "
                         "build (default: all; a partial run is for "
                         "debugging and prints no result lines)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",") if x}
    full = phases >= set(range(3, 15))

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
    from niwqg_tpu_torch.ops import derive_fused as dv
    from niwqg_tpu_torch.ops import stage_fused as sf
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
    if 3 in phases and not full:
        k1_phase(torch, mm)
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
    if 12 in phases and not full:
        mxu_mesh_phase(torch, mesh_refs(torch))
    if 14 in phases and not full:
        derive_phase(torch)
        qg_phase(torch)
        ybj_phase(torch)
    if 13 in phases and not full:
        t13 = time.perf_counter()
        big_refs, _, _ = big_phase(torch, mm)
        lap("13 (one card)")
        big_mesh_phase(torch, big_refs)
        lap("13 (mesh)")
        log(f"phase 13 took {t_lap - t13:.0f} s (one card and mesh)")
        log("wall time by phase: " + ", ".join(laps))
    if not full:
        log("partial run: no result lines")
        return 0

    # -- 3. K1 against its plain version -------------------------------------
    rec, k1_shapes = k1_phase(torch, mm)
    lap("3")

    # -- 4. the main path ------------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mm.reset_counts()
    dv.reset_counts()
    sf.reset_counts()
    t0 = time.perf_counter()
    m = flagship(CoupledModel, ic, **K1_MODEL, **GRAPH_RUN)
    torch.cuda.synchronize()
    log(f"flagship f32 K1 model built and initialised in "
        f"{time.perf_counter() - t0:.1f} s ({type(m.kernel).__name__}, "
        f"q_half={m.kernel.q_half})")
    n_set, d_set = mm.counts()["launches"], derive_counts()
    s_set = stage_counts()
    m.run_steps(WARM_STEPS)
    n_warm, d_warm = mm.counts()["launches"] - n_set, derive_counts() - d_set
    s_warm = stage_counts() - s_set
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
    d_timed = derive_counts() - d_set - d_warm
    s_timed = stage_counts() - s_set - s_warm
    log(f"main path: {TIMED_STEPS} steps in {wall:.3f} s = "
        f"{TIMED_STEPS / wall:.3f} steps/s ({1e3 * wall / TIMED_STEPS:.1f} "
        f"ms/step); K1 launches: set_q/set_phi {n_set}, warm-up {n_warm}, "
        f"timed {n_timed} ({n_timed / TIMED_STEPS:.1f}/step)")
    derive_main = derive_report("the main path", d_set, d_warm, d_timed,
                                d_timed * 0, derive_use(m.kernel),
                                derive_set_use(m.kernel))
    stage_main = stage_report("the main path", s_set, s_warm, s_timed,
                              s_timed * 0, stage_use(m.kernel))
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
    for name, n, lib_ms in zip(K2_RECORDS, launches, lib):
        k2_recs[name]["launches"] = n
        k2_recs[name]["library_ms"] = lib_ms
    for i, name in enumerate(("all_to_all_fwd", "all_to_all_inv")):
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
    n, mesh_refs_ = mxu_phase(torch, mm, refs64)
    rec["launches"] += n
    lap("11")

    # -- 12. the matmul-DFT on the mesh ----------------------------------------
    mesh_refs_["k1"] = {"q": q32, "phi": phi32, "Ke": ke32}  # phase 4's
    n_fwd, n_inv, n_k1, n_gather, n_reflect = mxu_mesh_phase(torch,
                                                             mesh_refs_)
    rec["launches"] += n_k1
    for name, n in zip(K2_RECORDS, (n_fwd, n_inv, n_gather, n_reflect)):
        k2_recs[name]["launches"] += n
    lap("12")

    # -- 13. the north star's grid -------------------------------------------
    t13 = time.perf_counter()
    big_refs, n, k1_big = big_phase(torch, mm)
    rec["launches"] += n
    lap("13 (one card)")
    launches13, k2_big = big_mesh_phase(torch, big_refs)
    derive_mesh = k2_big.pop("derive")
    stage_mesh = k2_big.pop("stage")
    qg_mesh = k2_big.pop("qg")
    for name, n in zip(K2_RECORDS, launches13[:2] + launches13[3:]):
        k2_recs[name]["launches"] += n
    rec["launches"] += launches13[2]  # (k)'s, rank 0
    lap("13 (mesh)")
    log(f"phase 13 took {t_lap - t13:.0f} s (one card and mesh)")

    # -- 14. the fused derive ------------------------------------------------
    derive_recs = derive_phase(torch)
    stage_recs = derive_recs.pop("stage_epilogue") + stage_mesh["recs"]
    for name, shapes in derive_mesh["recs"].items():
        derive_recs[name] += shapes
    qg_recs, qg_launches = qg_phase(torch)
    qg_recs.pop("step_ms", None)
    qg_launches = qg_launches + qg_mesh["launches"]
    for name, shapes in qg_mesh["recs"].items():
        if name in qg_recs:
            qg_recs[name] += shapes
    ybj_recs, ybj_launches = ybj_phase(torch)
    ybj_recs.pop("step_ms", None)
    lap("14")

    order = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")
    # the shapes beyond the main path's that phases 3, 6 and 13 hold, with
    # their launches in phase 13 (K1 at NX_BIG³ in its K1 configuration)
    shape_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms", "fma_ms", "fma_bound_ms")
    k1_shapes[0]["launches"] = k1_big
    k1_shapes[1]["launches"] = launches13[2]  # (k) on the mesh, rank 0
    kernels = [dict(name="csplit_matmul", route="cuda",
                    source="niwqg_tpu_torch/csrc/csplit_mm.cu",
                    replaces="niwqg_tpu/ops/pallas_mm.py:63",
                    **{k: rec[k] for k in order},
                    shapes=[{k: r[k] for k in shape_keys + ("launches",)}
                            for r in k1_shapes])]
    # K2's wrappers: the transposes (the TPU kernel's two entry points) and
    # the mesh's in-step gather and reflection, which launch the same
    # kernel (the TPU's `_call`) with tables of their own; the transposes
    # also at phase 13's block shapes (the mesh's times where every rank
    # has its own card, else phase 6's)
    k2_shapes = k2_recs.pop("shapes")
    if ncards == NRANKS:
        # the gather's time in the production layout, a process a rank on
        # its own card (phase 6's is four ranks of one process)
        k2_recs["all_reduce"]["ms"] = k2_big.pop("gather_ms")
    for name, line in zip(K2_RECORDS, (151, 174, 122, 122)):
        extra = {}
        if name in k2_shapes:
            extra["shapes"] = (k2_big[name] if ncards == NRANKS
                               else k2_shapes[name])
        kernels.append(dict(name=name, route="cuda",
                            source="niwqg_tpu_torch/csrc/a2a.cu",
                            replaces=f"niwqg_tpu/parallel/pallas_a2a.py:{line}",
                            **{k: k2_recs[name][k] for k in order}, **extra))
    # the fused derive: its launches on the main path (phase 4) and on rank
    # 0 of phase 13's mesh runs, counted on the card
    derive_launches = derive_main + np.asarray(derive_mesh["launches"])
    for i, (name, shapes) in enumerate(derive_recs.items()):
        kernels.append(dict(name=name, route="cuda",
                            source="niwqg_tpu_torch/csrc/derive.cu",
                            replaces=None,
                            launches=int(derive_launches[i]),
                            shapes=shapes))
    # the fused stage epilogue: its launches on the main path and on rank 0
    # of phase 13's mesh runs
    kernels.append(dict(name="stage_epilogue", route="cuda",
                        source="niwqg_tpu_torch/csrc/stage.cu",
                        replaces=None,
                        launches=stage_main + stage_mesh["launches"],
                        shapes=stage_recs))
    # the fused QG gaps: their launches in phase 14's runs and on rank 0 of
    # phase 13's mesh runs, by use (pack, products, stage)
    for name, uses in (("qg_products", (1,)), ("qg_stage", (0, 2))):
        kernels.append(dict(name=name, route="cuda",
                            source="niwqg_tpu_torch/csrc/qg_stage.cu",
                            replaces=None,
                            launches=int(sum(qg_launches[i] for i in uses)),
                            shapes=qg_recs[name]))
    # the fused YBJ gaps: their launches in phase 14's runs, by use (pack,
    # products, stage)
    for name, uses in (("ybj_products", (1,)), ("ybj_stage", (0, 2))):
        kernels.append(dict(name=name, route="cuda",
                            source="niwqg_tpu_torch/csrc/ybj_stage.cu",
                            replaces=None,
                            launches=int(sum(ybj_launches[i] for i in uses)),
                            shapes=ybj_recs[name]))
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
