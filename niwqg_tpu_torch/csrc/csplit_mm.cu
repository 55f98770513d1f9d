// Complex-split matrix product of the matmul-DFT, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel niwqg_tpu/ops/pallas_mm.py:_kernel (called
// through csplit_matmul). Same function:
//
//   out_re + i*out_im = (ar + i*ai) @ (B_re + i*B_im)
//
// where each B plane arrives pre-split into hi (the top 16 bits of the f32,
// exactly representable in bf16) and lo = b - hi, and A is split the same
// way, by the 0xFFFF0000 mask, in registers. Each real product is
// x@y_lo + x_lo@y_hi + x_hi@y_hi, so this design does 12 real products per
// complex product: 24*M*N*K flop.
//
// Bound on an H100 SXM: the split loses nothing in exact arithmetic
// (x_hi + x_lo = x, y_hi + y_lo = y, and the three products sum to x@y), so
// the function is one complex (M,K)@(K,N) product, 4 real products or
// 8*M*N*K flop. At the f32 peak outside the tensor cores (67 TFLOP/s) that
// is 1.03 ms at M = N = K = 2048. The bytes it must move,
// (2*M*K + 4*K*N + 2*M*N)*4 = 134 MB, take 40 us at 3.35 TB/s, so the
// function is bound by operations, by a factor of about 25. This version's
// own 24*M*N*K flop need 3.08 ms at that peak: it cannot come within 3x of
// the bound (see ROADMAP.md for a 4-FMA version).
//
// Why f32 FMAs first: the split exists so that a later version can feed the
// hi and lo planes to the bf16 tensor cores (wgmma), three passes per real
// product. On f32 FMAs every product is formed exactly before one rounding,
// so this version is at least as accurate as the split design it prepares
// for, and it is the simplest kernel that computes the function right.
//
// Design (first version): a plain tiled product. Each block owns a BM x BN
// tile of both output planes; a loop over K inside the block takes the
// place of the TPU kernel's sequential K grid axis. Each step stages a
// BK-deep slice of both A planes (stored k-major) and of the four B planes
// in shared memory; each thread keeps a TM x TN tile of both accumulators
// in registers and does 12 FMAs per output element per k. Loads are masked
// at the ragged edges, so no dimension has to divide the tile.
//
// Summation over K is two-level: each BK-deep stage sums into fresh
// registers, which are then added to the running sum (the TPU kernel, too,
// sums each K tile on the MXU before adding it to its accumulator). One
// running f32 sum over K = 2048 same-sign terms — the mean mode of a
// near-uniform field — loses ~8.6e-6 per pass; the two-level sum ~8.4e-7.
// It costs 2*TM*TN adds per stage against 12*BK*TM*TN FMAs.

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
                 int M, int N, int K) {
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
// out_re, out_im (M, N). Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int csplit_matmul_f32(const float* ar, const float* ai,
                                 const float* brh, const float* brl,
                                 const float* bih, const float* bil,
                                 float* out_re, float* out_im, int M, int N,
                                 int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  csplit_mm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ar, ai, brh, brl, bih, bil, out_re, out_im, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csplit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
