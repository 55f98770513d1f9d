// Direct-exchange all-to-all transpose of the pencil FFT, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of niwqg_tpu/parallel/pallas_a2a.py
// (_fwd_kernel, _inv_kernel and _entry_barrier, launched by _call). Same
// function, for a mesh of P ranks and a local block with `lead` leading
// fields:
//
//   forward: (lead, R, P*W) row block    -> (lead, P*R, W) column pencil
//   inverse: (lead, P*R, W) column pencil -> (lead, R, P*W) row block
//
// Rank `me` writes the block it holds for rank `dst` straight into dst's
// output, rows [me*R, (me+1)*R) forward, columns [me*W, (me+1)*W) inverse:
// what lax.all_to_all(tiled=True) computes. Elements are native complex
// values of 8 or 16 bytes (the TPU kernel moved two real planes).
//
// Bound on an H100 SXM: bytes. Each rank reads its block once and writes it
// once; (P-1)/P of it crosses NVLink at 450 GB/s each way and the rest
// stays in HBM at 3.35 TB/s: 0.0419 ms for the sharded flagship's block
// (3 x 512 x 2048 complex64, 25.2 MB a rank) with a card per rank, 0.0601
// ms of HBM traffic when four ranks share a card. The first design moved
// its bytes one 16-byte load in flight a thread, with five 64-bit divisions
// a unit, and spent 67 of its 78 us copying (PERF.md, tools/probe_a2a.py).
// What this design does about it:
//
// Tasks. The host cuts a launch into tasks (parallel/a2a.py:task_table),
// once per direction, shape, type and chunk count: a task is `rows` row
// segments of `units` units (16 bytes on the aligned path, 8 on the ragged
// one) of one (field, destination, column chunk), between the two pitches
// of the launch. Each segment is contiguous on both sides. The table lives
// in device memory, two copies that differ in their destination addresses
// (one per exchange buffer, below); it is Pallas's scalar prefetch. Block b
// of a persistent grid (one block per SM, SMs/P a rank where P ranks share
// a card in one process) takes tasks b, b+G, ...; neighbouring tasks go to
// neighbouring destinations, so the links load evenly. The kernel divides
// nothing per unit: a thread finds its eight (row, unit) slots once per
// task and then only advances pointers.
//
// Copy. A warp copies whole row segments: each thread holds eight
// independent 16-byte loads in flight (a warp covers min(256, units) units
// of one row, or several short rows at once) and then stores them straight
// to the destination rank's address: the peer-access pointer in one
// process, the CUDA IPC mapping between processes. Bulk asynchronous
// copies (cp.async.bulk through shared memory) reach peer memory too, but
// were 4% slower than this copy on four H100s (PERF.md).
//
// Completion per peer. After its last task a block fences its stores once
// at system scope and adds, with one red.release.sys per destination, the
// number of tasks it wrote there to that destination's arrival count for
// this rank. Block 0 of the receiving rank ends when the count of every
// peer has reached `target`: the tasks that peer has sent this rank over
// the life of the group, in this direction, counted by the host. Counts
// only grow, so nothing is ever reset and no reset can race. The forward
// and the inverse direction own separate counts, as the TPU kernels own
// separate collective ids. A wait that lasts 30 s of wall clock
// (%globaltimer) traps: a lost peer is an error, never a hang.
//
// No entry barrier. The first design made every rank wait, at entry, until
// every peer had entered the same epoch, so that it never overwrote an
// output its peer was still reading (3.7 us a launch). Instead each output
// shape has two exchange buffers, used in turn (the host picks the parity
// by the count of calls with that shape). Why a peer can no longer be
// reading the buffer that call n writes: that buffer was last written by
// call n-2. Its reader on rank d (the consumer of d's call n-2 output, the
// y-FFT) is enqueued on d's stream before d's call n-1, as the wrapper's
// contract asks (an output is valid until the next call with the same
// shape). Rank s starts call n only after its call n-1 has ended, and that
// ended only when the tasks of rank d's call n-1 had landed in s, so d's
// call n-1 had started, so its stream had passed that reader. The same
// holds for s == d. Arrivals of s's call n+1 cannot be taken for call n:
// s's kernel of call n has completed, its adds performed, before its call
// n+1 starts.
//
// Ranks of separate processes that share one card are time-sliced by the
// card; block 0's wait makes progress one time slice at a time (PERF.md
// has the cost). That layout is a check, not a production one.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int MAXP = 16;              // ranks in a mesh, at most
constexpr int NT = 512;               // threads per block: 16 warps
constexpr int DEPTH = 8;              // loads in flight per thread
constexpr int MAX_UNITS = 32 * DEPTH; // units of one segment of a task

struct Task {
  long long src;  // byte offset of the first row in the input
  char* dst;      // address of the first row in the destination's output
  int rows, units, peer, pad;
};
static_assert(sizeof(Task) == 32, "the host's record is 32 bytes");

// Python's task record (parallel/a2a.py:TASK_DTYPE): dst is an offset
struct HostTask {
  long long src, dst;
  int rows, units, peer, pad;
};

// Everything of one rank's launch that the call does not change.
struct Plan {
  Task* tasks;                 // device: two tables of ntasks, by parity
  unsigned long long** flags;  // device: the P ranks' flag words
  int ntasks, me, P, inverse, vec16, blocks, device;
  long long in_pitch, out_pitch;
  unsigned long long timeout_ns;
  cudaEvent_t ev_in, ev_out;   // the hand-off to a rank's own stream
};

struct Args {
  const Task* tasks;
  const char* in;
  unsigned long long* const* flags;
  int ntasks, me, P, inverse;
  long long in_pitch, out_pitch;
  unsigned long long target, timeout_ns, epoch;
};

__device__ __forceinline__ void red_release_sys_add(unsigned long long* p,
                                                    unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#ifdef A2A_STAMPS
// Probe build only (tools/probe_a2a.py): four %globaltimer stamps per
// launch, in a ring of `g_slots` records per direction: [0] the first
// block's start (min over blocks), [1] the last block to start copying,
// [2] the last block done copying and publishing, [3] the last block's end
// (max).
__device__ unsigned long long* g_stamps;
__device__ int g_slots;

__device__ void stamp(int k, int inverse, unsigned long long epoch) {
  if (threadIdx.x != 0 || g_stamps == nullptr) return;
  unsigned long long* s =
      g_stamps + 4 * (inverse * g_slots + (epoch - 1) % g_slots) + k;
  if (k == 0) {
    atomicMin(s, now_ns());
  } else {
    atomicMax(s, now_ns());
  }
}
#define STAMP(k) stamp(k, a.inverse, a.epoch)
#else
#define STAMP(k)
#endif

// Wait until *p reaches `target`; trap after `timeout_ns` of wall clock.
__device__ void wait_count(const unsigned long long* p,
                           unsigned long long target,
                           unsigned long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire_sys(p) < target) {
    if (now_ns() - t0 > timeout_ns) __trap();
    __nanosleep(64);
  }
}

// One task: `rows` segments of `units` units. The warp's tile is `rpw`
// rows of `units` units (rpw = MAX_UNITS / units, at least 1); slot q of a
// lane is unit f = lane + 32 q of it. The block's 16 warps take 16 tiles a
// trip; a trip only advances the slots' pointers.
template <typename Unit>
__device__ __forceinline__ void copy_task(const char* __restrict__ src,
                                          char* __restrict__ dst, int rows,
                                          int units, long long in_pitch,
                                          long long out_pitch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = units >= MAX_UNITS ? 1 : MAX_UNITS / units;
  const Unit* s[DEPTH];
  Unit* d[DEPTH];
  int row[DEPTH];
#pragma unroll
  for (int q = 0; q < DEPTH; ++q) {
    const int f = lane + 32 * q;
    const int r = f / units;
    // a slot past the tile's rows is never valid: its row is `rows`
    row[q] = r < rpw ? warp * rpw + r : rows;
    const int u = f - r * units;
    s[q] = reinterpret_cast<const Unit*>(src + row[q] * in_pitch) + u;
    d[q] = reinterpret_cast<Unit*>(dst + row[q] * out_pitch) + u;
  }
  const int step = (NT / 32) * rpw;  // rows a trip of the block
  const long long s_step = step * in_pitch, d_step = step * out_pitch;
  for (int left = rows; left > 0; left -= step) {
    Unit v[DEPTH];
#pragma unroll
    for (int q = 0; q < DEPTH; ++q) {
      if (row[q] < left) v[q] = __ldg(s[q]);
    }
#pragma unroll
    for (int q = 0; q < DEPTH; ++q) {
      if (row[q] < left) *d[q] = v[q];
      s[q] = reinterpret_cast<const Unit*>(
          reinterpret_cast<const char*>(s[q]) + s_step);
      d[q] = reinterpret_cast<Unit*>(reinterpret_cast<char*>(d[q]) + d_step);
    }
  }
}

template <typename Unit>
__global__ void __launch_bounds__(NT, 1) a2a_kernel(const Args a) {
  __shared__ unsigned long long sent[MAXP];  // tasks written, by destination
  if (threadIdx.x < MAXP) sent[threadIdx.x] = 0;
  STAMP(0);
  __syncthreads();
  STAMP(1);

  for (int t = blockIdx.x; t < a.ntasks; t += gridDim.x) {
    const Task x = a.tasks[t];
    copy_task<Unit>(a.in + x.src, x.dst, x.rows, x.units, a.in_pitch,
                    a.out_pitch);
    if (threadIdx.x == 0) sent[x.peer] += 1;
  }

  // publish: one system-scope fence for the block's stores, then one
  // release add per destination it wrote to
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int p = 0; p < a.P; ++p) {
      if (p != a.me && sent[p] != 0) {
        red_release_sys_add(a.flags[p] + a.inverse * MAXP + a.me, sent[p]);
      }
    }
  }
  STAMP(2);

  // completion: block 0 ends once every peer's tasks for this rank landed
  if (blockIdx.x == 0 && threadIdx.x < a.P && threadIdx.x != a.me) {
    wait_count(a.flags[a.me] + a.inverse * MAXP + threadIdx.x, a.target,
               a.timeout_ns);
  }
#ifdef A2A_STAMPS
  __syncthreads();
  STAMP(3);
#endif
}

int launch_one(const Plan* pl, const void* in, int parity,
               unsigned long long target, unsigned long long epoch,
               cudaStream_t stream) {
  Args a;
  a.tasks = pl->tasks + (parity ? pl->ntasks : 0);
  a.in = static_cast<const char*>(in);
  a.flags = pl->flags;
  a.ntasks = pl->ntasks;
  a.me = pl->me;
  a.P = pl->P;
  a.inverse = pl->inverse;
  a.in_pitch = pl->in_pitch;
  a.out_pitch = pl->out_pitch;
  a.target = target;
  a.timeout_ns = pl->timeout_ns;
  a.epoch = epoch;
  if (pl->vec16) {
    a2a_kernel<uint4><<<pl->blocks, NT, 0, stream>>>(a);
  } else {
    a2a_kernel<uint2><<<pl->blocks, NT, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Run `body` with `device` current, then restore the caller's device.
template <typename F>
int on_device(int device, F body) {
  int old = -1;
  cudaError_t err = cudaGetDevice(&old);
  if (err != cudaSuccess) return (int)err;
  if (old != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return (int)err;
  }
  const int res = body();
  if (old != device) cudaSetDevice(old);
  return res;
}

}  // namespace

extern "C" {

// Words of flag memory a rank must provide, zeroed, for both directions.
int a2a_flag_words() { return 2 * MAXP; }

int a2a_max_ranks() { return MAXP; }

// One rank's plan on `device`: checks the host's task table and copies it
// there twice, with destination addresses into the buffers of parity 0
// (`outs0`, P pointers) and parity 1 (`outs1`); `flags` are the P ranks'
// flag words. Returns a cudaError_t; the plan in *plan.
int a2a_plan_create(const void* host_tasks, int ntasks,
                    const void* const* outs0, const void* const* outs1,
                    const void* const* flags, int me, int P, int inverse,
                    int vec16, long long in_pitch, long long out_pitch,
                    int blocks, int device, unsigned long long timeout_ns,
                    void** plan) {
  if (P < 1 || P > MAXP || me < 0 || me >= P || ntasks < 1 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long align = vec16 ? 16 : 8;
  if (in_pitch % align || out_pitch % align) {
    return (int)cudaErrorInvalidValue;
  }
  const HostTask* ht = static_cast<const HostTask*>(host_tasks);
  Task* tab = new Task[2 * (size_t)ntasks];
  for (int t = 0; t < ntasks; ++t) {
    const HostTask& h = ht[t];
    if (h.rows < 1 || h.units < 1 || h.units > MAX_UNITS || h.peer < 0 ||
        h.peer >= P || h.src < 0 || h.dst < 0 || h.src % align ||
        h.dst % align) {
      delete[] tab;
      return (int)cudaErrorInvalidValue;
    }
    for (int parity = 0; parity < 2; ++parity) {
      Task& x = tab[parity * (size_t)ntasks + t];
      const void* const* outs = parity ? outs1 : outs0;
      x.src = h.src;
      x.dst = static_cast<char*>(const_cast<void*>(outs[h.peer])) + h.dst;
      x.rows = h.rows;
      x.units = h.units;
      x.peer = h.peer;
      x.pad = 0;
    }
  }
  Plan* pl = new Plan();
  pl->ntasks = ntasks;
  pl->me = me;
  pl->P = P;
  pl->inverse = inverse;
  pl->vec16 = vec16;
  pl->blocks = blocks;
  pl->device = device;
  pl->in_pitch = in_pitch;
  pl->out_pitch = out_pitch;
  pl->timeout_ns = timeout_ns;
  const int err = on_device(device, [&]() -> int {
    const size_t tbytes = 2 * (size_t)ntasks * sizeof(Task);
    cudaError_t e = cudaMalloc(&pl->tasks, tbytes + MAXP * sizeof(void*));
    if (e != cudaSuccess) return (int)e;
    pl->flags = reinterpret_cast<unsigned long long**>(
        reinterpret_cast<char*>(pl->tasks) + tbytes);
    void* fl[MAXP] = {};
    for (int p = 0; p < P; ++p) fl[p] = const_cast<void*>(flags[p]);
    e = cudaMemcpy(pl->tasks, tab, tbytes, cudaMemcpyHostToDevice);
    if (e == cudaSuccess) {
      e = cudaMemcpy(pl->flags, fl, sizeof(fl), cudaMemcpyHostToDevice);
    }
    if (e == cudaSuccess) {
      e = cudaEventCreateWithFlags(&pl->ev_in, cudaEventDisableTiming);
    }
    if (e == cudaSuccess) {
      e = cudaEventCreateWithFlags(&pl->ev_out, cudaEventDisableTiming);
    }
    return (int)e;
  });
  delete[] tab;
  if (err != 0) {
    delete pl;
    return err;
  }
  *plan = pl;
  return 0;
}

int a2a_plan_free(void* plan) {
  Plan* pl = static_cast<Plan*>(plan);
  const int err = on_device(pl->device, [&]() -> int {
    cudaEventDestroy(pl->ev_in);
    cudaEventDestroy(pl->ev_out);
    return (int)cudaFree(pl->tasks);
  });
  delete pl;
  return err;
}

// The launches of the `n` ranks this process holds (one on a mesh), rank
// i's plan plans[i], its input ins[i], on streams[i]: the exchange buffer
// of `parity`, `target` arrivals from every peer (cumulative, this
// direction), `epoch` the launch's number (the probe build's stamps).
// Where `waits` is given, rank i runs on a stream of its own (ranks that
// share a card run together): streams[i] first waits for waits[i], the
// caller's stream, and waits[i] waits for the launch once all n are
// enqueued (were it to wait at once, rank i+1 would queue behind rank i,
// which waits for it). Returns a cudaError_t.
int a2a_launch_many(int n, void* const* plans, const void* const* ins,
                    int parity, unsigned long long target,
                    unsigned long long epoch, void* const* streams,
                    void* const* waits) {
  for (int i = 0; i < n; ++i) {
    const Plan* pl = static_cast<const Plan*>(plans[i]);
    const int err = on_device(pl->device, [&]() -> int {
      cudaStream_t s = static_cast<cudaStream_t>(streams[i]);
      if (waits != nullptr) {
        cudaError_t e = cudaEventRecord(
            pl->ev_in, static_cast<cudaStream_t>(waits[i]));
        if (e == cudaSuccess) e = cudaStreamWaitEvent(s, pl->ev_in, 0);
        if (e != cudaSuccess) return (int)e;
      }
      return launch_one(pl, ins[i], parity, target, epoch, s);
    });
    if (err != 0) return err;
  }
  for (int i = 0; waits != nullptr && i < n; ++i) {
    const Plan* pl = static_cast<const Plan*>(plans[i]);
    const int err = on_device(pl->device, [&]() -> int {
      cudaError_t e = cudaEventRecord(
          pl->ev_out, static_cast<cudaStream_t>(streams[i]));
      if (e == cudaSuccess) {
        e = cudaStreamWaitEvent(static_cast<cudaStream_t>(waits[i]),
                                pl->ev_out, 0);
      }
      return (int)e;
    });
    if (err != 0) return err;
  }
  return 0;
}

// Device memory on the current device, zeroed, for exchange buffers and
// flags: cudaMalloc'd here (not by PyTorch's caching allocator) so that the
// whole allocation can be handed to other processes as one IPC handle.
int a2a_malloc(size_t bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

int a2a_free(void* ptr) { return (int)cudaFree(ptr); }

int a2a_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

int a2a_ipc_get(void* ptr, void* handle_out) {
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle_out, &h, sizeof(h));
  return (int)err;
}

int a2a_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int a2a_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// Let kernels on the current device store into `peer`'s memory.
int a2a_enable_peer_access(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free error state
    err = cudaSuccess;
  }
  return (int)err;
}

#ifdef A2A_STAMPS
// Point the probe build's stamps at `ptr` (4 * 2 * slots words on `device`,
// [0] of each record set to all ones by the caller, the rest to 0).
int a2a_set_stamps(int device, void* ptr, int slots) {
  return on_device(device, [&]() -> int {
    cudaError_t err = cudaMemcpyToSymbol(g_stamps, &ptr, sizeof(ptr));
    if (err == cudaSuccess) {
      err = cudaMemcpyToSymbol(g_slots, &slots, sizeof(slots));
    }
    return (int)err;
  });
}
#endif

const char* a2a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
