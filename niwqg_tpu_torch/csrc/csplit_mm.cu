// Complex-split matrix product of the matmul-DFT, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel niwqg_tpu/ops/pallas_mm.py:_kernel (called
// through csplit_matmul). Same function:
//
//   out_re + i*out_im = (ar + i*ai) @ (B_re + i*B_im)
//
// where each B plane arrives pre-split into hi (the top 16 bits of the f32,
// exactly representable in bf16) and lo = b - hi, A is split the same way,
// and each real product is formed as x@y_lo + x_lo@y_hi + x_hi@y_hi: twelve
// real products per complex product, 24*M*N*K flop. The TPU kernel forms
// them on its matrix unit, which takes operands in bf16 and sums in f32;
// that rounding of x, x_lo and y_lo (2^-17 to 2^-16 of a term) is the
// function's accuracy, about 1e-5 of the largest output.
//
// Two kernels live here, chosen by shape alone in the Python wrapper.
//
// 1. csplit_matmul_tc: the tensor-core route, for the shapes of the main
//    path (K >= 256, N >= 256, M, N, K multiples of 8).
//
//    Bound on an H100 SXM: 24*M*N*K flop at the 989 TFLOP/s bf16 tensor-core
//    peak, 0.208 ms at M = N = K = 2048; the bytes the function must move,
//    (2*M*K + 4*K*N + 2*M*N)*4 = 134 MB, take 0.040 ms at 3.35 TB/s. It is
//    bound by operations, and only the tensor cores can come near the bound:
//    the same products as f32 FMAs need 3.08 ms.
//
//    Design:
//    - Each block owns a 128x64 tile of both output planes. One producer
//      thread keeps TMA loads in flight into a ring of four shared-memory
//      stages (a 32-deep slice of A's two f32 planes and of B's four bf16
//      planes each, 48 KB), guarded by a full and an empty mbarrier per
//      stage. B's planes are constants of the transform and arrive already
//      in bf16; A's change with every call and are read as they are.
//    - Two consumer warpgroups take 64 rows each. A thread reads its share
//      of the 64x16 A operand from shared memory as f32, splits it in
//      registers (x rounded, x_lo rounded, x_hi exact; nearest even) and
//      feeds the six bf16 fragments to wgmma as the register operand, so no
//      split plane of A ever exists in memory. Per 16 of K a warpgroup
//      issues the twelve wgmma.mma_async m64n64k16 products into two f32
//      accumulators (re, im). The subtraction in re is the instruction's
//      negate flag on A.
//    - B is (K, N) row-major, that is MN-major for wgmma: bf16 wgmma reads
//      it through the descriptor's transpose flag, so no table is
//      transposed. TMA writes every tile in the 128-byte swizzle that the
//      descriptors and the fragment reads name, and fills ragged edges with
//      zeros; the stores mask them.
//    - Summation over K: the tensor cores add into their f32 accumulator by
//      truncation, so a sum drifts towards zero by about half an ulp per
//      instruction: on an H100 a running sum over K = 2048 (768
//      instructions) was off by 1.7e-5 of the largest output, and by 1.5e-5
//      on K equal terms (the mean mode of a near-uniform field). Each stage's twelve-by-two
//      products therefore start a fresh accumulator, which is then added to
//      a second register sum with a rounded f32 add, as the TPU kernel sums
//      each K tile on its matrix unit before adding it in. The second sum
//      is what narrows the tile to 64 columns: four 32-register arrays a
//      thread.
//    - What holds it from the bound: each warpgroup closes its accumulator
//      every stage (a drained wgmma pipeline and 64 adds a thread) and
//      converts its fragments before it issues. The two warpgroups run in
//      step, and that is the better of two evils: kept out of step, one
//      warpgroup's two accumulator chains do not fill the tensor cores.
//      See PERF.md for the times.
//
// 2. csplit_matmul_f32: the first design, plain f32 FMAs outside the tensor
//    cores, for every other shape (any M, N, K >= 1). Each block owns a
//    BM x BN tile of both output planes, stages BK-deep slices in shared
//    memory with masked loads, splits A in registers and does 12 FMAs per
//    output element per k; each stage sums into fresh registers that are
//    then folded into the running sum. Every product is exact before one
//    rounding, so it is held to the full-f32 plain version.
//
// Each kernel counts its own launches: thread 0 of block (0, 0) adds one to
// a counter in device memory that the caller passes. So a launch replayed
// from a CUDA graph counts as one launched from the host does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 16;          // depth of one shared-memory stage
constexpr int TM = 8;           // output rows per thread
constexpr int TN = 4;           // output columns per thread
constexpr int NTX = BN / TN;    // 16 threads along N
constexpr int NTY = BM / TM;    // 16 threads along M
constexpr int NT = NTX * NTY;   // 256 threads per block
constexpr int APAD = 4;         // row padding of the k-major A tiles

static_assert((BM * BK) % NT == 0, "A tile must split evenly over threads");
static_assert((BK * BN) % NT == 0, "B tile must split evenly over threads");
static_assert(TM % 4 == 0 && TN == 4, "float4 shared-memory reads");

__device__ __forceinline__ float hi_part(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// One 16-byte shared-memory read into four registers (src 16-byte aligned).
__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__global__ void __launch_bounds__(NT)
csplit_mm_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ brh, const float* __restrict__ brl,
                 const float* __restrict__ bih, const float* __restrict__ bil,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 int M, int N, int K, unsigned long long* launches) {
  __shared__ __align__(16) float s_ar[BK][BM + APAD];
  __shared__ __align__(16) float s_ai[BK][BM + APAD];
  __shared__ __align__(16) float s_brh[BK][BN];
  __shared__ __align__(16) float s_brl[BK][BN];
  __shared__ __align__(16) float s_bih[BK][BN];
  __shared__ __align__(16) float s_bil[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) {
    atomicAdd(launches, 1ull);
  }

  float acc_r[TM][TN];
  float acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A planes: BM x BK, consecutive threads along k (coalesced rows),
    // stored transposed so the compute loop reads rows as float4.
#pragma unroll
    for (int r = 0; r < (BM * BK) / NT; ++r) {
      const int idx = tid + r * NT;
      const int kk = idx % BK;
      const int mm = idx / BK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      const size_t off = static_cast<size_t>(gm) * K + gk;
      s_ar[kk][mm] = ok ? ar[off] : 0.f;
      s_ai[kk][mm] = ok ? ai[off] : 0.f;
    }
    // B planes: BK x BN, consecutive threads along n.
#pragma unroll
    for (int r = 0; r < (BK * BN) / NT; ++r) {
      const int idx = tid + r * NT;
      const int nn = idx % BN;
      const int kk = idx / BN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      const size_t off = static_cast<size_t>(gk) * N + gn;
      s_brh[kk][nn] = ok ? brh[off] : 0.f;
      s_brl[kk][nn] = ok ? brl[off] : 0.f;
      s_bih[kk][nn] = ok ? bih[off] : 0.f;
      s_bil[kk][nn] = ok ? bil[off] : 0.f;
    }
    __syncthreads();

    float part_r[TM][TN];
    float part_i[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        part_r[i][j] = 0.f;
        part_i[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_r[TM], a_i[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        load4(&s_ar[kk][ty * TM + i], &a_r[i]);
        load4(&s_ai[kk][ty * TM + i], &a_i[i]);
      }
      float b_rh[TN], b_rl[TN], b_ih[TN], b_il[TN];
      load4(&s_brh[kk][tx * TN], b_rh);
      load4(&s_brl[kk][tx * TN], b_rl);
      load4(&s_bih[kk][tx * TN], b_ih);
      load4(&s_bil[kk][tx * TN], b_il);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xr = a_r[i];
        const float xrh = hi_part(xr);
        const float xrl = xr - xrh;
        const float xi = a_i[i];
        const float xih = hi_part(xi);
        const float xil = xi - xih;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          // re += ar*b_re - ai*b_im, each as its three split products
          float re = part_r[i][j];
          re = fmaf(xr, b_rl[j], re);
          re = fmaf(xrl, b_rh[j], re);
          re = fmaf(xrh, b_rh[j], re);
          re = fmaf(-xi, b_il[j], re);
          re = fmaf(-xil, b_ih[j], re);
          re = fmaf(-xih, b_ih[j], re);
          part_r[i][j] = re;
          // im += ar*b_im + ai*b_re
          float im = part_i[i][j];
          im = fmaf(xr, b_il[j], im);
          im = fmaf(xrl, b_ih[j], im);
          im = fmaf(xrh, b_ih[j], im);
          im = fmaf(xi, b_rl[j], im);
          im = fmaf(xil, b_rh[j], im);
          im = fmaf(xih, b_rh[j], im);
          part_i[i][j] = im;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc_r[i][j] += part_r[i][j];
        acc_i[i][j] += part_i[i][j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) {
        const size_t off = static_cast<size_t>(gm) * N + gn;
        out_re[off] = acc_r[i][j];
        out_im[off] = acc_i[i][j];
      }
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes. All pointers are device pointers to
// contiguous row-major f32 arrays: ar, ai (M, K); brh, brl, bih, bil (K, N);
// out_re, out_im (M, N); launches, the kernel's launch counter (one
// unsigned 64-bit integer). Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int csplit_matmul_f32(const float* ar, const float* ai,
                                 const float* brh, const float* brl,
                                 const float* bih, const float* bil,
                                 float* out_re, float* out_im, int M, int N,
                                 int K, unsigned long long* launches,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  csplit_mm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ar, ai, brh, brl, bih, bil, out_re, out_im, M, N, K, launches);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core route.
// ---------------------------------------------------------------------------
namespace {

constexpr int TC_BM = 128;          // output rows per block (64 per warpgroup)
constexpr int TC_BN = 64;           // output columns per block
constexpr int TC_BK = 32;           // depth of one stage: 128-byte rows of f32
constexpr int TC_STAGES = 4;        // ring of shared-memory stages
constexpr int TC_CONSUMERS = 2;     // consumer warpgroups
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);
constexpr int TC_A_FRAGS = 6;       // x, x_lo, x_hi of re; the same of im
constexpr int TC_B_PLANES = 4;      // re_hi, re_lo, im_hi, im_lo
constexpr int TC_ACC = TC_BN / 2;   // f32 registers of one 64 x BN accumulator
// A stage: the re and im f32 tiles of A, [row][k], then B's four bf16 tiles,
// [plane][k][column]; every row is 128 bytes, swizzled over that width.
constexpr int TC_A_TILE = TC_BM * TC_BK * 4;
constexpr int TC_B_TILE = TC_BK * TC_BN * 2;
constexpr int TC_STAGE = 2 * TC_A_TILE + TC_B_PLANES * TC_B_TILE;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE + 1024;  // room to align
static_assert(TC_BK * 4 == 128 && TC_BN * 2 == 128, "128-byte swizzled rows");
static_assert(TC_STAGE % 1024 == 0, "stages keep the swizzle's alignment");
static_assert(TC_SMEM <= 232448, "more shared memory than a block can have");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds is a fault of the pipeline: trap instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 8000000000LL) {
      __trap();
    }
  }
}

// One TMA load of a (planes, rows, columns) box; it reports its bytes to
// `bar`, and fills what lies outside the array with zeros.
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int col, int row,
                                            int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(col),
      "r"(row), "r"(plane)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma for a 128B-swizzled tile: start
// address, leading and stride byte offsets in 16-byte units, swizzle mode 1.
__device__ __forceinline__ unsigned long long make_desc(unsigned addr, int lbo,
                                                        int sbo) {
  return static_cast<unsigned long long>((addr & 0x3FFFFu) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = (keep ? d : 0) + ScaleA * A @ B: A a 64x16 bf16 operand as register
// fragments, B 16x64 bf16 in shared memory, MN-major (the transpose flag),
// f32 sum. ScaleA is +1 or -1, the instruction's own flag.
template <int ScaleA>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[TC_ACC],
                                                const unsigned (&a)[4],
                                                unsigned long long desc_b,
                                                int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep),
        "n"(ScaleA));
}

// Two neighbouring f32 values into packed bf16 pairs: the value rounded,
// its lo part rounded (nearest even), its hi part (exact). The lower column
// sits in the lower half.
__device__ __forceinline__ void split_pair(float2 v, unsigned& full,
                                           unsigned& lo, unsigned& hi) {
  const unsigned b0 = __float_as_uint(v.x);
  const unsigned b1 = __float_as_uint(v.y);
  hi = __byte_perm(b0, b1, 0x7632);
  __nv_bfloat162 f = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hi_part(v.x),
                                           v.y - hi_part(v.y));
  full = *reinterpret_cast<unsigned*>(&f);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// One warpgroup's 64 x BN sum to its output plane. Thread t of the
// warpgroup holds, for j = 0..BN/8-1, rows (t/32)*16 + (t%32)/4 and that
// + 8, columns 8*j + 2*(t%4) and the next.
__device__ __forceinline__ void store_acc(const float (&acc)[TC_ACC],
                                          float* __restrict__ out, int row0,
                                          int col0, int M, int N) {
  const int t = threadIdx.x % 128;
  const int r = row0 + (t / 32) * 16 + (t % 32) / 4;
  const int c = col0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int cc = c + 8 * j;
    if (cc >= N) continue;  // N is even, so cc + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= M) continue;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(rr) * N + cc) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// A fragments: 0 x_re, 1 lo(x_re), 2 hi(x_re), 3 x_im, 4 lo(x_im),
// 5 hi(x_im). B planes: 0 re_hi, 1 re_lo, 2 im_hi, 3 im_lo.
__global__ void __launch_bounds__(TC_THREADS, 1)
csplit_mm_tc_kernel(const __grid_constant__ CUtensorMap map_ar,
                    const __grid_constant__ CUtensorMap map_ai,
                    const __grid_constant__ CUtensorMap map_b,
                    float* __restrict__ out_re, float* __restrict__ out_im,
                    int M, int N, int K, unsigned long long* launches) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned long long bar_full[TC_STAGES];
  __shared__ unsigned long long bar_empty[TC_STAGES];

  const unsigned ring_pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  const unsigned ring = smem_addr(smem_raw) + ring_pad;
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int nk = (K + TC_BK - 1) / TC_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(smem_addr(&bar_full[s]), 1);
      mbar_init(smem_addr(&bar_empty[s]), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x == 0 && blockIdx.y == 0) atomicAdd(launches, 1ull);
  }
  __syncthreads();

  // The two roles never meet again: no block-wide barrier below this line.
  const int wg = threadIdx.x / 128;
  if (wg == TC_CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == TC_CONSUMERS * 128) {
      int stage = 0;
      unsigned phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(smem_addr(&bar_empty[stage]), phase ^ 1u);
        const unsigned full = smem_addr(&bar_full[stage]);
        const unsigned base = ring + stage * TC_STAGE;
        mbar_expect_tx(full, TC_STAGE);
        tma_load_3d(base, &map_ar, full, kt * TC_BK, m0, 0);
        tma_load_3d(base + TC_A_TILE, &map_ai, full, kt * TC_BK, m0, 0);
        tma_load_3d(base + 2 * TC_A_TILE, &map_b, full, n0, kt * TC_BK, 0);
        if (++stage == TC_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // The tensor cores add into their accumulator by truncation, so a long
    // sum drifts towards zero. Each stage's products go into a fresh
    // accumulator (part_*), which is then added to the running sum (sum_*)
    // with a rounded f32 add.
    float part_re[TC_ACC], part_im[TC_ACC], sum_re[TC_ACC], sum_im[TC_ACC];
#pragma unroll
    for (int i = 0; i < TC_ACC; ++i) {
      part_re[i] = 0.f;
      part_im[i] = 0.f;
      sum_re[i] = 0.f;
      sum_im[i] = 0.f;
    }
    // This thread's share of the 64x16 A operand: rows `row` and row + 8,
    // columns 2*(t%4) + {0, 1} and those + 8 of each 16 of K. The tile's
    // rows are 128 bytes, their 16-byte chunks XOR-swizzled by row % 8.
    const int t = threadIdx.x % 128;
    const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const unsigned swz = row & 7;           // the same for row + 8
    const unsigned chunk0 = (t % 4) / 2;    // chunk of column 2*(t%4)
    const unsigned in_chunk = (t % 2) * 8;  // bytes into that chunk
    const bool elected = t == 0;
    int stage = 0;
    unsigned phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(smem_addr(&bar_full[stage]), phase);
      const unsigned char* tile = smem_raw + ring_pad + stage * TC_STAGE;
      unsigned fa[TC_BK / 16][TC_A_FRAGS][4];
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {               // re tile, im tile
#pragma unroll
          for (int half = 0; half < 2; ++half) {    // columns + 8
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {        // rows + 8
              const unsigned off =
                  c * TC_A_TILE + (row + 8 * rh) * 128 +
                  (((4 * kk + chunk0 + 2 * half) ^ swz) << 4) + in_chunk;
              const float2 v = *reinterpret_cast<const float2*>(tile + off);
              // registers of the operand: (r, c), (r+8, c), (r, c+8),
              // (r+8, c+8)
              const int q = 2 * half + rh;
              split_pair(v, fa[kk][3 * c][q], fa[kk][3 * c + 1][q],
                         fa[kk][3 * c + 2][q]);
            }
          }
        }
      }
      // B tiles: one swizzle atom along N, eight k rows every 1,024 bytes
      const unsigned long long db0 = make_desc(
          ring + stage * TC_STAGE + 2 * TC_A_TILE, TC_B_TILE, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        unsigned long long db[TC_B_PLANES];
#pragma unroll
        for (int q = 0; q < TC_B_PLANES; ++q) {
          // start addresses move in 16-byte units: sixteen 128-byte rows
          db[q] = db0 + ((q * TC_B_TILE + kk * 2048) >> 4);
        }
        const int keep = kk > 0;  // the stage's first product starts the sum
        // re = x_r@b_rl + lo(x_r)@b_rh + hi(x_r)@b_rh
        //    - x_i@b_il - lo(x_i)@b_ih - hi(x_i)@b_ih
        // im = the same of x_r with the im planes, + x_i with the re planes
        wgmma_m64n64k16<1>(part_re, fa[kk][0], db[1], keep);
        wgmma_m64n64k16<1>(part_im, fa[kk][0], db[3], keep);
        wgmma_m64n64k16<1>(part_re, fa[kk][1], db[0], 1);
        wgmma_m64n64k16<1>(part_im, fa[kk][1], db[2], 1);
        wgmma_m64n64k16<1>(part_re, fa[kk][2], db[0], 1);
        wgmma_m64n64k16<1>(part_im, fa[kk][2], db[2], 1);
        wgmma_m64n64k16<-1>(part_re, fa[kk][3], db[3], 1);
        wgmma_m64n64k16<1>(part_im, fa[kk][3], db[1], 1);
        wgmma_m64n64k16<-1>(part_re, fa[kk][4], db[2], 1);
        wgmma_m64n64k16<1>(part_im, fa[kk][4], db[0], 1);
        wgmma_m64n64k16<-1>(part_re, fa[kk][5], db[2], 1);
        wgmma_m64n64k16<1>(part_im, fa[kk][5], db[0], 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      if (elected) mbar_arrive(smem_addr(&bar_empty[stage]));
#pragma unroll
      for (int i = 0; i < TC_ACC; ++i) {
        sum_re[i] += part_re[i];
        sum_im[i] += part_im[i];
      }
      if (++stage == TC_STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    store_acc(sum_re, out_re, m0 + wg * 64, n0, M, N);
    store_acc(sum_im, out_im, m0 + wg * 64, n0, M, N);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links
// against libcuda by name.
EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A row-major array (planes, rows, cols) of f32 or bf16 as a 3-D tensor map
// whose box is (planes, box_rows, box_cols), rows of 128 bytes, swizzled.
int encode_planes(CUtensorMap* map, const void* ptr, bool f32, int planes,
                  int rows, int cols, int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return -1;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * esize,
      static_cast<cuuint64_t>(cols) * static_cast<cuuint64_t>(rows) * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(planes)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -2 - static_cast<int>(res);
}

}  // namespace

// The tensor-core route. ar, ai: (M, K) f32. b_planes: (4, K, N) bf16, the
// planes re_hi, re_lo, im_hi, im_lo. out_re, out_im: (M, N) f32. M, N, K
// are multiples of 8 (16-byte rows for the bulk loads). launches: the
// kernel's launch counter. Launches on `stream`; returns 0, a cudaError_t,
// or a negative code where the tensor maps could not be made (see
// csplit_error_string).
extern "C" int csplit_matmul_tc(const float* ar, const float* ai,
                                const void* b_planes, float* out_re,
                                float* out_im, int M, int N, int K,
                                unsigned long long* launches, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 8 || N % 8 || K % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  alignas(64) CUtensorMap map_ar;
  alignas(64) CUtensorMap map_ai;
  alignas(64) CUtensorMap map_b;
  int err = encode_planes(&map_ar, ar, true, 1, M, K, TC_BM, TC_BK);
  if (err != 0) return err;
  err = encode_planes(&map_ai, ai, true, 1, M, K, TC_BM, TC_BK);
  if (err != 0) return err;
  err = encode_planes(&map_b, b_planes, false, TC_B_PLANES, K, N, TC_BK, TC_BN);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      csplit_mm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  csplit_mm_tc_kernel<<<grid, TC_THREADS, TC_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      map_ar, map_ai, map_b, out_re, out_im, M, N, K, launches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csplit_error_string(int code) {
  if (code == -1) return "cuTensorMapEncodeTiled not found in libcuda";
  if (code < 0) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
