#!/usr/bin/env python3
"""Probe K2, the all-to-all transpose, on the card: right first, then where
its time goes.

At the sharded flagship's block (3 fields, R=512, W=512 per rank,
complex64, ``chunks=2``, 25.2 MB per rank) and four ranks, in every layout
the machine offers:

  procs   a process per rank, rank r on card r (four cards and more);
  local   the four ranks in this process on ``min(4, device_count)`` cards
          (``PeerGroup.local``);
  shared  the four ranks in this process on card 0 (more than one card).

For each layout and direction it checks the kernel bit-exact against its
plain version, then times ``--reps`` calls enqueued behind a device-side
sleep (so the device runs them back to back whatever the host's pace):

  - device time per launch: CUDA events on each rank's current stream
    around every call, mean of the intervals after the first;
  - host time per call: ``time.perf_counter_ns`` around the wrapper, no
    synchronise, mean and median;
  - the split of the device time (a probe build with ``-DA2A_STAMPS``:
    ``%globaltimer`` stamps into a scratch buffer), mean over the launches
    after the first, in µs: [first block's start to the last block's start
    of copying (the first design: past its entry barrier), copy and
    publish, completion wait, whole span].

With ``--copy`` it also holds two bare copy kernels against each other
(no flags, no barrier; built from the source in this file): bulk
asynchronous copies (``cp.async.bulk`` through a ring of shared-memory
stages, stores straight to the peer's address) and a warp copy with eight
16-byte loads in flight per thread. That shows whether bulk stores reach
peer memory (peer access in one process, CUDA IPC mappings between
processes) and which is faster.

    python3 tools/probe_a2a.py --copy
    python3 tools/probe_a2a.py --root DIR   # another checkout's K2, same probe

Results go to stdout, one JSON line per layout, and to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import k2_times  # noqa: E402
NRANKS = 4
SHAPE = (3, 512, NRANKS * 512)  # the sharded flagship's forward block
CHUNKS = 2
SLOTS = 256                     # stamp records per direction
SLEEP_CYCLES = 50_000_000       # the bare copies' device-side sleep

# The two bare copies of --copy: rank `me` writes its forward block into
# every rank's output, as K2 does, with no flags. Tasks run (chunk, row
# group, field, destination) with the destination innermost, so that
# neighbouring blocks start on different links.
COPY_CU = r"""
#include <cuda_runtime.h>
#include <cstring>
namespace {
constexpr int MAXP = 16, STAGES = 4, STAGE = 32768;
struct Dsts { char* p[MAXP]; };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

struct Task { const char* src; char* dst; int rows; };

__device__ __forceinline__ Task task(long long t, const char* in,
                                     const Dsts& out, int me, int P,
                                     long long lead, long long R,
                                     long long W, int chunks, int es, int k) {
  const long long ngroups = (R + k - 1) / k;
  const int j = (int)(t % P); t /= P;
  const long long b = t % lead; t /= lead;
  const long long g = t % ngroups; const long long c = t / ngroups;
  const int d = (me + j) % P;
  const long long cw = W / chunks, r0 = g * k;
  Task x;
  x.rows = (int)(R - r0 < k ? R - r0 : k);
  x.src = in + ((b * R + r0) * P * W + d * W + c * cw) * es;
  x.dst = out.p[d] + ((b * P * R + me * R + r0) * W + c * cw) * es;
  return x;
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  long long t0 = clock64();
  while (true) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 8000000000LL) __trap();
  }
}

__global__ void __launch_bounds__(32)
copy_bulk(const char* in, Dsts out, int me, int P, long long lead,
          long long R, long long W, int chunks, int es) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) unsigned long long bars[STAGES];
  if (threadIdx.x != 0) return;
  const int seg = (int)(W / chunks * es);
  const int k = STAGE / seg;
  const long long ntasks = chunks * ((R + k - 1) / k) * lead * P;
  const long long in_pitch = P * W * es, out_pitch = W * es;
  const long long n = ntasks > blockIdx.x
      ? (ntasks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int s = 0; s < STAGES; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&bars[s])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto load = [&](long long i) {
    const int s = (int)(i % STAGES);
    Task x = task(blockIdx.x + i * gridDim.x, in, out, me, P, lead, R, W,
                  chunks, es, k);
    const unsigned bar = smem_addr(&bars[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(x.rows * seg) : "memory");
    for (int r = 0; r < x.rows; ++r) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(smem + s * STAGE + r * seg)),
             "l"(x.src + r * in_pitch), "r"(seg), "r"(bar) : "memory");
    }
  };
  for (long long i = 0; i < n && i < STAGES; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int s = (int)(i % STAGES);
    mbar_wait(smem_addr(&bars[s]), (unsigned)((i / STAGES) & 1));
    Task x = task(blockIdx.x + i * gridDim.x, in, out, me, P, lead, R, W,
                  chunks, es, k);
    for (int r = 0; r < x.rows; ++r) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                   " [%0], [%1], %2;\n"
                   :: "l"(x.dst + r * out_pitch),
                      "r"(smem_addr(smem + s * STAGE + r * seg)), "r"(seg)
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage of the store before this one, once it has read it
    if (i >= 1 && i - 1 + STAGES < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(256)
copy_warp(const char* in, Dsts out, int me, int P, long long lead,
          long long R, long long W, int chunks, int es) {
  const int seg = (int)(W / chunks * es);
  const int k = STAGE / seg;
  const long long ntasks = chunks * ((R + k - 1) / k) * lead * P;
  const long long in_pitch = P * W * es, out_pitch = W * es;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units = seg / 16;
  for (long long t = blockIdx.x; t < ntasks; t += gridDim.x) {
    Task x = task(t, in, out, me, P, lead, R, W, chunks, es, k);
    for (int r = 2 * warp; r < x.rows; r += 16) {
      for (int u0 = 0; u0 < units; u0 += 128) {
        uint4 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = r + (q >> 2), u = u0 + lane + 32 * (q & 3);
          if (row < x.rows && u < units)
            v[q] = *reinterpret_cast<const uint4*>(x.src + row * in_pitch
                                                   + u * 16);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = r + (q >> 2), u = u0 + lane + 32 * (q & 3);
          if (row < x.rows && u < units)
            *reinterpret_cast<uint4*>(x.dst + row * out_pitch + u * 16) = v[q];
        }
      }
    }
  }
}
}  // namespace

extern "C" int probe_copy(int bulk, const void* in, const void* const* outs,
                          int me, int P, long long lead, long long R,
                          long long W, int chunks, int es, int blocks,
                          void* stream) {
  Dsts d;
  std::memset(&d, 0, sizeof(d));
  for (int p = 0; p < P; ++p) d.p[p] = (char*)outs[p];
  if (bulk) {
    const int smem = STAGES * STAGE;
    cudaFuncSetAttribute(copy_bulk,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    copy_bulk<<<blocks, 32, smem, (cudaStream_t)stream>>>(
        (const char*)in, d, me, P, lead, R, W, chunks, es);
  } else {
    copy_warp<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const char*)in, d, me, P, lead, R, W, chunks, es);
  }
  return (int)cudaGetLastError();
}
"""


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def copy_library(cuda_build):
    """Build the bare copies of --copy beside the package's libraries."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tag = hashlib.sha256(COPY_CU.encode()).hexdigest()[:16]
    path = os.path.join(cuda_build.BUILD_DIR, f"libprobe_copy-{tag}.so")
    if not os.path.exists(path):
        src = path[:-3] + ".cu"
        with open(src, "w") as fh:
            fh.write(COPY_CU)
        out = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                              "-o", path, src], capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(out.stdout + out.stderr)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line:
                log("  probe_copy: " + line.strip()[:160])
    lib = ctypes.CDLL(path)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_copy.argtypes = [i, vp, vp, i, i, ll, ll, ll, i, i, i, vp]
    return lib


def load_a2a(stamps: bool):
    """The package's K2 module, its library built with stamps where the
    tree has them; returns (module, stamps on)."""
    from niwqg_tpu_torch import cuda_build
    from niwqg_tpu_torch.parallel import a2a

    if stamps:
        try:
            lib = cuda_build.load("a2a", ("A2A_STAMPS",))
            stamps = hasattr(lib, "a2a_set_stamps")
        except TypeError:  # a checkout whose cuda_build.load takes no macros
            stamps = False
        if stamps:
            # every later load("a2a") in this process gets the probe build
            cuda_build._loaded[("a2a", ())] = lib
    a2a._library()
    return a2a, stamps


class Stamps:
    """The probe build's stamp ring on one card."""

    def __init__(self, torch, lib, device):
        self.buf = torch.zeros((2, SLOTS, 4), dtype=torch.int64, device=device)
        lib.a2a_set_stamps.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int]
        err = lib.a2a_set_stamps(device.index, self.buf.data_ptr(), SLOTS)
        if err:
            raise RuntimeError(f"a2a_set_stamps: error {err}")
        self.reset()

    def reset(self):
        self.buf.zero_()
        self.buf[..., 0] = -1  # all ones: the start is a minimum

    def split(self, inverse, epochs):
        """Mean (entry, copy, completion, total) in microseconds over the
        launches of ``epochs`` (1-based) of one direction."""
        s = self.buf[inverse].cpu().numpy().view(np.uint64).astype(np.float64)
        rows = np.array([s[(e - 1) % SLOTS] for e in epochs])
        d = np.stack([rows[:, 1] - rows[:, 0], rows[:, 2] - rows[:, 1],
                      rows[:, 3] - rows[:, 2], rows[:, 3] - rows[:, 0]], 1)
        return [float(x) for x in d.mean(0) / 1e3]


def measure(torch, a2a, fn, blocks, group, devices, reps, stamps, barrier):
    """Device ms per launch, host µs per call (``chip_smoke.k2_times``)
    and the stamp split of ``reps`` calls of ``fn``."""
    arg = blocks if len(blocks) > 1 else blocks[0]
    cards = sorted(set(devices), key=str)
    inverse = int(fn is a2a.all_to_all_inv)
    if stamps:
        for s in stamps.values():
            s.reset()
    dev, host, host_med = k2_times(
        torch, lambda: fn(arg, group, chunks=CHUNKS), cards, reps, barrier)
    out = dict(dev_ms=dev, host_us_mean=host, host_us_median=host_med)
    if stamps:
        last = group._epoch[inverse]
        epochs = range(last - reps + 2, last + 1)  # the timed calls but one
        out["split_us"] = {str(d): s.split(inverse, epochs)
                           for d, s in stamps.items()}
    return out


def run_layout(torch, a2a, group, devices, blocks, reps, stamps, barrier,
               gather_ref):
    """Both directions at the flagship block: bit-exact, then timed."""
    res = {}
    inv_blocks = None
    for name, fn, ref in (("fwd", a2a.all_to_all_fwd, a2a.all_to_all_fwd_ref),
                          ("inv", a2a.all_to_all_inv, a2a.all_to_all_inv_ref)):
        zs = blocks if name == "fwd" else inv_blocks
        arg = zs if len(zs) > 1 else zs[0]
        got = fn(arg, group, chunks=CHUNKS)
        got = got if isinstance(got, list) else [got]
        for d in set(devices):
            torch.cuda.synchronize(d)
        want = gather_ref(ref, zs)
        exact = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        if name == "fwd":
            inv_blocks = [g.clone() for g in got]
        res[name] = dict(exact=exact)
        res[name].update(measure(torch, a2a, fn, zs, group, devices, reps,
                                 stamps, barrier))
    return res


def copy_proof(torch, copy_lib, blocks, outs, out_ptrs, devices, me_list,
               reps, barrier, gather_ref, a2a):
    """The two bare copies (forward layout): exact, then device ms per
    launch of all ranks, in turns bulk, warp, warp, bulk."""
    P = NRANKS
    lead, R, W = SHAPE[0], SHAPE[1], SHAPE[2] // P
    sms = torch.cuda.get_device_properties(devices[0]).multi_processor_count
    per_card = len(me_list) // len(set(devices))
    blocks_of = {1: max(1, sms // per_card), 0: 2 * max(1, sms // per_card)}
    arr = (ctypes.c_void_p * P)(*out_ptrs)
    cards = sorted(set(devices), key=str)

    barrier = barrier or (lambda: None)

    def launch(bulk):
        for me, z, d in zip(me_list, blocks, devices):
            with torch.cuda.device(d):
                err = copy_lib.probe_copy(
                    bulk, z.data_ptr(), arr, me, P, lead, R, W, CHUNKS, 8,
                    blocks_of[bulk], torch.cuda.current_stream(d).cuda_stream)
            if err:
                raise RuntimeError(f"probe_copy: error {err}")

    res = {}
    want = gather_ref(a2a.all_to_all_fwd_ref, blocks)
    for bulk in (1, 0):
        for o in outs:
            o.zero_()
        for d in cards:
            torch.cuda.synchronize(d)
        barrier()
        launch(bulk)
        for d in cards:
            torch.cuda.synchronize(d)
        barrier()
        res["bulk" if bulk else "warp"] = dict(exact=all(
            torch.equal(o.cpu(), w) for o, w in zip(outs, want)))

    def timed(bulk):
        for d in cards:
            torch.cuda.synchronize(d)
        barrier()
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda._sleep(SLEEP_CYCLES)
        st = {d: torch.cuda.Event(enable_timing=True) for d in cards}
        en = {d: torch.cuda.Event(enable_timing=True) for d in cards}
        for d in cards:
            with torch.cuda.device(d):
                st[d].record()
        for _ in range(reps):
            launch(bulk)
        for d in cards:
            with torch.cuda.device(d):
                en[d].record()
        for d in cards:
            torch.cuda.synchronize(d)
        return max(st[d].elapsed_time(en[d]) / reps for d in cards)

    t = [timed(b) for b in (1, 0, 0, 1)]
    res["bulk"]["dev_ms"] = 0.5 * (t[0] + t[3])
    res["warp"]["dev_ms"] = 0.5 * (t[1] + t[2])
    res["blocks"] = blocks_of
    return res


def seeded_blocks(torch, devices, ranks, shape):
    out = []
    for r, d in zip(ranks, devices):
        rng = np.random.default_rng(100 + r)
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        out.append(torch.as_tensor(z.astype(np.complex64), device=d))
    return out


def local_layout(torch, name, devices, args):
    from niwqg_tpu_torch import cuda_build

    a2a, stamps_on = load_a2a(args.stamps)
    group = a2a.PeerGroup.local(devices)
    stamps = ({d: Stamps(torch, a2a._library(), d)
               for d in sorted(set(devices), key=str)} if stamps_on else None)
    blocks = seeded_blocks(torch, devices, range(NRANKS), SHAPE)

    def gather_ref(ref, zs):
        return ref([z.cpu() for z in zs])

    res = dict(layout=name, devices=[str(d) for d in devices],
               stamps=stamps_on)
    res.update(run_layout(torch, a2a, group, devices, blocks, args.reps,
                          stamps, None, gather_ref))
    if args.copy and name == "local":
        lib = copy_library(cuda_build)
        outs = [torch.empty((SHAPE[0], NRANKS * SHAPE[1],
                             SHAPE[2] // NRANKS), dtype=torch.complex64,
                            device=d) for d in devices]
        res["copy"] = copy_proof(torch, lib, blocks, outs,
                                 [o.data_ptr() for o in outs], devices,
                                 list(range(NRANKS)), args.reps,
                                 None, gather_ref, a2a)
    return res


def _proc_rank(rank, port, args, outdir):
    import torch

    sys.path.insert(0, args.root)
    from niwqg_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", NRANKS, rank, timeout_s=300)
    mesh = multihost.global_mesh()
    a2a, stamps_on = load_a2a(args.stamps)
    group = a2a.PeerGroup(mesh)
    dev = mesh.device
    stamps = {dev: Stamps(torch, a2a._library(), dev)} if stamps_on else None
    blocks = seeded_blocks(torch, [dev], [rank], SHAPE)

    def gather_ref(ref, zs):
        return [ref([z.cpu() for z in mesh.all_gather(zs[0])])[rank]]

    res = dict(layout="procs", devices=[str(dev)], stamps=stamps_on,
               backend=str(torch.distributed.get_backend()))
    res.update(run_layout(torch, a2a, group, [dev], blocks, args.reps, stamps,
                          mesh.barrier, gather_ref))
    if args.copy:
        from niwqg_tpu_torch import cuda_build

        lib = copy_library(cuda_build)
        nbytes = SHAPE[0] * SHAPE[1] * SHAPE[2] * 8
        own, ptrs = group._shared_alloc(a2a._library(), nbytes)
        out = torch.as_tensor(a2a._DeviceBytes(own, nbytes), device=dev)
        out = out.view(torch.complex64).view(
            SHAPE[0], NRANKS * SHAPE[1], SHAPE[2] // NRANKS)
        res["copy"] = copy_proof(torch, lib, blocks, [out], ptrs, [dev],
                                 [rank], args.reps, mesh.barrier, gather_ref,
                                 a2a)
    every = mesh.all_gather_object(res)
    if rank == 0:
        with open(os.path.join(outdir, "procs.json"), "w") as fh:
            json.dump(every, fh)
    group.close()
    multihost.shutdown()


def procs_layout(torch, args):
    import torch.multiprocessing as mp

    outdir = tempfile.mkdtemp(prefix="probe_a2a_")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_proc_rank, args=(port, args, outdir), nprocs=NRANKS, join=True)
    with open(os.path.join(outdir, "procs.json")) as fh:
        every = json.load(fh)
    res = every[0]
    for d in ("fwd", "inv"):  # the slowest rank's device time
        res[d]["dev_ms_all_ranks"] = [e[d]["dev_ms"] for e in every]
        res[d]["exact"] = all(e[d]["exact"] for e in every)
    if "copy" in res:
        for k in ("bulk", "warp"):
            res["copy"][k]["exact"] = all(e["copy"][k]["exact"]
                                          for e in every)
            res["copy"][k]["dev_ms_all_ranks"] = [e["copy"][k]["dev_ms"]
                                                  for e in every]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose niwqg_tpu_torch is probed")
    ap.add_argument("--layouts", default="procs,local,shared")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--copy", action="store_true",
                    help="also hold the bare bulk and warp copies")
    ap.add_argument("--no-stamps", dest="stamps", action="store_false")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    args.root = os.path.abspath(args.root)
    sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        print("probe_a2a: no CUDA device available", file=sys.stderr)
        return 1
    ncards = torch.cuda.device_count()
    log(f"card: {smi().splitlines()[0]}; {ncards} card(s); torch "
        f"{torch.__version__}; tree {args.root}")
    results = []
    for layout in args.layouts.split(","):
        if layout == "procs":
            if ncards < NRANKS:
                log("procs: skipped, needs a card per rank")
                continue
            r = procs_layout(torch, args)
        elif layout == "local":
            r = local_layout(torch, "local", [
                torch.device("cuda", i % min(NRANKS, ncards))
                for i in range(NRANKS)], args)
        elif layout == "shared":
            if ncards < 2:
                log("shared: skipped, the local layout is on one card")
                continue
            r = local_layout(torch, "shared",
                             [torch.device("cuda", 0)] * NRANKS, args)
        else:
            raise SystemExit(f"unknown layout {layout!r}")
        results.append(r)
        log(json.dumps(r))
    bad = [(r["layout"], d) for r in results for d in ("fwd", "inv")
           if not r[d]["exact"]]
    bad += [(r["layout"], k) for r in results if "copy" in r
            for k in ("bulk", "warp") if not r["copy"][k]["exact"]]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi(), results=results), fh, indent=1)
    log("FAILED: not bit-exact " + str(bad) if bad else "all checks passed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
