// The fast wave kernel's stage epilogue, fused: the gap between a stage's
// forward transforms and its ETDRK4 update (niwqg_tpu_torch/models/
// fast_kernel.py, FastWaveKernel._epilogue; the launcher is
// niwqg_tpu_torch/ops/stage_fused.py).
//
// It replaces no TPU kernel: on the TPU, XLA fuses this chain by itself. As
// PyTorch operations the gap is some 60 small kernels a stage (the RHS in a
// dozen passes, two clones of each spectrum to zero its mean mode, seven
// weighted Parseval sums of several full-field temporaries each), ~8 GB a
// step at 2048² on one card. One launch here reads each input once and
// writes what leaves the gap:
//
//   wave side (ny, w):  Fnw = -Jadv' - 0.5i Rh, Jadv' with its mean mode
//                       zeroed where the physics asks; the sums ep_phi,
//                       chi_phi, gamma1, gamma2, xi1, xi2 of phih, Jh, Rh
//   q side (ny, wq):    Fn = -zero_mean(ik (uq)^ + il_dy (vq)^); the sum
//                       ep_psi of qh and ph
//   the 11 budget partials: the seven sums over M², then the mean modes of
//                       phih and Rh over M (the owner of (0,0); zeros
//                       elsewhere)
//
// Either part may be left out: a stage without budgets writes only Fn and
// Fnw (RHS), the diagnostics' sources only the partials (SRC).
//
// Bound on an H100 SXM: bytes (a few flops a byte). The blocks walk a
// combined list of 32x32 tiles, the wave side's then the q side's, 32x8
// threads a tile, four rows a thread, each thread's loads of a tile all
// issued before its arithmetic. An input whose rows are contiguous is
// read straight, a warp along a row; one whose columns are (the pencil
// mesh's y-FFT hands its output over so) is read a warp down a column and
// turned through shared memory, so that each field is read once, coalesced,
// in its own strides. Tables and outputs are row-major.
//
// Rounding: Fn and Fnw are the chain's operations in the chain's order,
// each rounded once (the _rn intrinsics: no contraction), so they are the
// chain's bit for bit. A sum's terms are the chain's own terms, each
// rounded as the chain rounds it; they are added in double, in a fixed
// order (a thread's tiles in turn, a warp's shuffle tree, the block's warps
// in turn, then the blocks in index order), and the total times 1/M² is
// rounded once. No floating-point atomics: every launch of a shape gives the
// same bits. The blocks' partials go to a workspace; the last block to
// arrive (an integer counter, reset by that block) adds them up.
//
// The kernel counts its launches on the card: thread 0 of block 0 adds one
// to the caller's counter, so a launch replayed from a CUDA graph counts.
// The launch goes on the caller's stream; the function returns the launch's
// cudaError_t (0 when queued).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // a tile: kTile x kTile elements
constexpr int kRows = 8;                  // thread rows of a block
constexpr int kPer = kTile / kRows;       // elements of a tile a thread
constexpr int kThreads = kTile * kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 7;                  // ep_phi chi_phi ep_psi g1 g2 x1 x2
// blocks an SM holds at least: the registers a thread may take (80 at 3;
// at 2048² on one card 3 read 79% of the bound, 1 (up to 142 registers)
// 69%, 4 (64, spilling) 59%)
constexpr int kMinBlocks = 3;

template <typename R> struct Cx;
template <> struct Cx<float> { using T = float2; };
template <> struct Cx<double> { using T = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename C, typename R>
__device__ __forceinline__ C cx(R re, R im) { C z; z.x = re; z.y = im; return z; }

// a field read in its own strides (elements): row r, column c at r*sr + c*sc
template <typename C>
struct Field {
  const C* p;
  long long sr, sc;
};

// what the kernel reads and writes; one struct, passed by value
template <typename R>
struct EpilogueArgs {
  using C = typename Cx<R>::T;
  // wave side, (ny, w)
  Field<C> phih, jadv, jh, rh;  // jadv: Fnw's Jacobian; jh: the sums' (QL: two)
  const R* w_d;                 // (ny, w) tables
  const R* w_chi;
  const R* wv2;
  C* fnw;                       // (ny, w) out
  // q side, (ny, wq)
  Field<C> uq, vq, qh, ph;      // the products' spectra; qh and projected ph
  const R* w_eppsi;             // (ny, wq)
  const R* kq;                  // (wq,) k of this block's columns
  const R* lq;                  // (ny,) l by row
  C* fn;                        // (ny, wq) out
  int ny, w, wq, col0, nx, nreal;
  int nyq;                      // l_dy on the Nyquist row (derive.cu's l_dy)
  int zero_jac;                 // zero Fnw's Jacobian at the mean mode
  int owner;                    // this rank holds the (0,0) mode
  int tiles_w, tiles_wc, tiles_qc, tiles;  // the tile list
  R inv_m, inv_m2;              // 1/M and 1/M², rounded as the chain's
  double* partials;             // (gridDim.x, kSums) workspace
  unsigned int* arrivals;       // blocks done; 0 between launches
  R* sums;                      // (kSums + 4,) out
  unsigned long long* count;    // this kernel's launches
};

// l_dy at (row, global column): the l table, zero on padded columns and,
// by `nyq`, on part of the Nyquist row (as csrc/derive.cu's l_dy)
template <typename R>
__device__ __forceinline__ R l_dy(const R* lq, int row, int cg, int ny, int nx,
                                  int nreal, int nyq) {
  if (cg >= nreal) return R(0);
  if (row == ny / 2) {
    if (nyq == 1 && cg >= 1 && cg < nx / 2) return R(0);
    if (nyq == 2 && cg != 0 && cg != nx / 2) return R(0);
  }
  return lq[row];
}

// a thread's kPer elements of tile (r0, c0) of field f: element i at row
// r0 + threadIdx.y + i*kRows, column c0 + threadIdx.x. Column-led fields
// go through `buf`. Block-uniform: every thread of the block calls it.
template <typename C>
__device__ __forceinline__ void load(const Field<C>& f, int r0, int c0, int ny,
                                     int w, C (&v)[kPer],
                                     C (*buf)[kTile + 1]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (f.sr == 1 && f.sc != 1) {
    __syncthreads();  // the buffer's last reads are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = c0 + ty + i * kRows, r = r0 + tx;
      if (r < ny && c < w) buf[ty + i * kRows][tx] = f.p[c * f.sc + r];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = buf[tx][ty + i * kRows];
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + ty + i * kRows, c = c0 + tx;
    if (r < ny && c < w) v[i] = f.p[r * f.sr + c * f.sc];
  }
}

// a thread's kPer elements of tile (r0, c0) of a row-major table
template <typename R>
__device__ __forceinline__ void load_table(const R* t, int r0, int c0, int ny,
                                           int w, R (&v)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + threadIdx.y + i * kRows, c = c0 + threadIdx.x;
    if (r < ny && c < w) v[i] = t[(long long)r * w + c];
  }
}

template <typename R, bool RHS, bool SRC>
__device__ __forceinline__ void wave_tile(const EpilogueArgs<R>& a, int r0,
                                          int c0, double (&acc)[kSums],
                                          typename Cx<R>::T (*buf)[kTile + 1]) {
  using C = typename Cx<R>::T;
  // every load of the tile first, then the arithmetic and the stores
  C rv[kPer], jv[kPer], av[kPer], pv[kPer];
  R wd[kPer], wc[kPer], w2[kPer];
  load(a.rh, r0, c0, a.ny, a.w, rv, buf);
  if (SRC) {
    load(a.jh, r0, c0, a.ny, a.w, jv, buf);
    load(a.phih, r0, c0, a.ny, a.w, pv, buf);
    load_table(a.w_d, r0, c0, a.ny, a.w, wd);
    load_table(a.w_chi, r0, c0, a.ny, a.w, wc);
    load_table(a.wv2, r0, c0, a.ny, a.w, w2);
  }
  const bool same = SRC && a.jadv.p == a.jh.p;
  if (RHS && !same) load(a.jadv, r0, c0, a.ny, a.w, av, buf);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + threadIdx.y + i * kRows, c = c0 + threadIdx.x;
    if (r >= a.ny || c >= a.w) continue;
    const C rh = rv[i];
    if (RHS) {
      // -Jadv' - jmul(Rh, 0.5): the negated Jacobian less (-0.5 Im, 0.5 Re)
      C j = same ? jv[i] : av[i];
      if (a.zero_jac && a.owner && r == 0 && c == 0) j = cx<C, R>(R(0), R(0));
      a.fnw[(long long)r * a.w + c] = cx<C, R>(sub(-j.x, mul(R(-0.5), rh.y)),
                                             sub(-j.y, mul(R(0.5), rh.x)));
    }
    if (SRC) {
      const R pr = pv[i].x, pi = pv[i].y, jr = jv[i].x, ji = jv[i].y;
      const R mw2 = -w2[i];
      const R aphi2 = add(mul(pr, pr), mul(pi, pi));
      acc[0] += (double)mul(wd[i], aphi2);
      acc[1] += (double)mul(wc[i], aphi2);
      acc[3] += (double)mul(mw2, sub(mul(rh.x, pi), mul(rh.y, pr)));
      acc[4] += (double)mul(mw2, add(mul(pr, jr), mul(pi, ji)));
      acc[5] += (double)mul(wd[i], sub(mul(pi, jr), mul(pr, ji)));
      acc[6] += (double)mul(wd[i], add(mul(pr, rh.x), mul(pi, rh.y)));
    }
  }
}

template <typename R, bool RHS, bool SRC>
__device__ __forceinline__ void q_tile(const EpilogueArgs<R>& a, int r0,
                                       int c0, double (&acc)[kSums],
                                       typename Cx<R>::T (*buf)[kTile + 1]) {
  using C = typename Cx<R>::T;
  C uv[kPer], vv[kPer], qv[kPer], hv[kPer];
  R we[kPer];
  if (RHS) {
    load(a.uq, r0, c0, a.ny, a.wq, uv, buf);
    load(a.vq, r0, c0, a.ny, a.wq, vv, buf);
  }
  if (SRC) {
    load(a.qh, r0, c0, a.ny, a.wq, qv, buf);
    load(a.ph, r0, c0, a.ny, a.wq, hv, buf);
    load_table(a.w_eppsi, r0, c0, a.ny, a.wq, we);
  }
  const int c = c0 + threadIdx.x, cg = a.col0 + c;
  const R k = c < a.wq ? a.kq[c] : R(0);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + threadIdx.y + i * kRows;
    if (r >= a.ny || c >= a.wq) continue;
    if (RHS) {
      // mul_i(uqh, k) + mul_i(vqh, l_dy), mean mode zeroed, negated
      const R ly = l_dy(a.lq, r, cg, a.ny, a.nx, a.nreal, a.nyq);
      R re = add(mul(-k, uv[i].y), mul(-ly, vv[i].y));
      R im = add(mul(k, uv[i].x), mul(ly, vv[i].x));
      if (a.owner && r == 0 && cg == 0) re = im = R(0);
      a.fn[(long long)r * a.wq + c] = cx<C, R>(-re, -im);
    }
    if (SRC) {
      // Re(conj(qh) ph), weighted
      const C q = qv[i], p = hv[i];
      acc[2] += (double)mul(we[i], add(mul(q.x, p.x), mul(q.y, p.y)));
    }
  }
}

// the block's total of each sum, in a fixed order, on thread 0
__device__ __forceinline__ void block_sums(double (&acc)[kSums],
                                           double (*red)[kWarps]) {
  const int t = threadIdx.y * kTile + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    double v = acc[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((t & 31) == 0) red[s][t >> 5] = v;
  }
  __syncthreads();
  if (t < kSums) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += red[t][k];
    acc[0] = v;  // thread t holds sum t
  }
  __syncthreads();
}

template <typename R, bool RHS, bool SRC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stage_epilogue_kernel(const EpilogueArgs<R> a) {
  using C = typename Cx<R>::T;
  __shared__ C buf[kTile][kTile + 1];
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (blockIdx.x == 0 && t == 0) atomicAdd(a.count, 1ULL);
  double acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0;

  for (int k = blockIdx.x; k < a.tiles; k += gridDim.x) {
    if (k < a.tiles_w) {
      wave_tile<R, RHS, SRC>(a, (k / a.tiles_wc) * kTile,
                             (k % a.tiles_wc) * kTile, acc, buf);
    } else {
      const int kq = k - a.tiles_w;
      q_tile<R, RHS, SRC>(a, (kq / a.tiles_qc) * kTile,
                          (kq % a.tiles_qc) * kTile, acc, buf);
    }
  }
  if (!SRC) return;

  __shared__ double red[kSums][kWarps];
  __shared__ bool last;
  block_sums(acc, red);
  if (t < kSums) a.partials[(long long)blockIdx.x * kSums + t] = acc[0];
  __threadfence();  // the partials are visible before this block arrives
  __syncthreads();
  if (t == 0) last = atomicAdd(a.arrivals, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: every block's partials, in index order of the blocks
  __threadfence();
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    double v = 0.0;
    for (int b = t; b < (int)gridDim.x; b += kThreads)
      v += __ldcg(a.partials + (long long)b * kSums + s);
    acc[s] = v;
  }
  block_sums(acc, red);
  if (t < kSums) a.sums[t] = (R)(acc[0] * (double)a.inv_m2);
  if (t == 0) {
    const C p = a.phih.p[0], rh = a.rh.p[0];
    const bool own = a.owner;
    a.sums[kSums + 0] = own ? mul(p.x, a.inv_m) : R(0);
    a.sums[kSums + 1] = own ? mul(p.y, a.inv_m) : R(0);
    a.sums[kSums + 2] = own ? mul(rh.x, a.inv_m) : R(0);
    a.sums[kSums + 3] = own ? mul(rh.y, a.inv_m) : R(0);
    *a.arrivals = 0u;  // ready for the next launch
  }
}

inline int tiles_of(int n) { return (n + kTile - 1) / kTile; }

template <typename C>
Field<C> field(const long long* f, int i) {
  Field<C> x;
  x.p = reinterpret_cast<const C*>(f[3 * i]);
  x.sr = f[3 * i + 1];
  x.sc = f[3 * i + 2];
  return x;
}

template <typename R, bool RHS, bool SRC>
int launch_as(EpilogueArgs<R>& a, int max_blocks, cudaStream_t st) {
  auto kern = stage_epilogue_kernel<R, RHS, SRC>;
  // the blocks an SM holds at once, asked at the first launch (eager: a
  // capture follows an eager step), the same on every card of a kind
  static int per_sm = 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the card at once, at most the workspace's
  int blocks = per_sm * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > a.tiles) blocks = a.tiles;
  if (blocks < 1) blocks = 1;
  kern<<<blocks, dim3(kTile, kRows), 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename R>
int epilogue(const long long* fields, const void* w_d, const void* w_chi,
             const void* wv2, const void* w_eppsi, const void* kq,
             const void* lq, void* fnw, void* fn, void* sums, void* partials,
             void* arrivals, int max_blocks, int ny, int w, int wq, int col0,
             int nx, int nreal, int nyq, int zero_jac, int owner, double inv_m,
             double inv_m2, int rhs, int src, void* count, cudaStream_t st) {
  using C = typename Cx<R>::T;
  EpilogueArgs<R> a;
  a.phih = field<C>(fields, 0);
  a.jadv = field<C>(fields, 1);
  a.jh = field<C>(fields, 2);
  a.rh = field<C>(fields, 3);
  a.uq = field<C>(fields, 4);
  a.vq = field<C>(fields, 5);
  a.qh = field<C>(fields, 6);
  a.ph = field<C>(fields, 7);
  a.w_d = static_cast<const R*>(w_d);
  a.w_chi = static_cast<const R*>(w_chi);
  a.wv2 = static_cast<const R*>(wv2);
  a.w_eppsi = static_cast<const R*>(w_eppsi);
  a.kq = static_cast<const R*>(kq);
  a.lq = static_cast<const R*>(lq);
  a.fnw = static_cast<C*>(fnw);
  a.fn = static_cast<C*>(fn);
  a.sums = static_cast<R*>(sums);
  a.partials = static_cast<double*>(partials);
  a.arrivals = static_cast<unsigned int*>(arrivals);
  a.count = static_cast<unsigned long long*>(count);
  a.ny = ny; a.w = w; a.wq = wq; a.col0 = col0; a.nx = nx; a.nreal = nreal;
  a.nyq = nyq; a.zero_jac = zero_jac; a.owner = owner;
  a.inv_m = static_cast<R>(inv_m);
  a.inv_m2 = static_cast<R>(inv_m2);
  a.tiles_wc = tiles_of(w);
  a.tiles_qc = tiles_of(wq);
  a.tiles_w = tiles_of(ny) * a.tiles_wc;
  a.tiles = a.tiles_w + tiles_of(ny) * a.tiles_qc;
  if (rhs && src) return launch_as<R, true, true>(a, max_blocks, st);
  if (rhs) return launch_as<R, true, false>(a, max_blocks, st);
  if (src) return launch_as<R, false, true>(a, max_blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fields: 8 x (address, row stride, column stride), in the order phih,
// jadv, jh, rh, uq, vq, qh, ph (address 0 where the call reads none)
extern "C" int stage_epilogue(const long long* fields, const void* w_d,
                              const void* w_chi, const void* wv2,
                              const void* w_eppsi, const void* kq,
                              const void* lq, void* fnw, void* fn, void* sums,
                              void* partials, void* arrivals, int max_blocks,
                              int ny, int w, int wq, int col0, int nx,
                              int nreal, int nyq, int zero_jac, int owner,
                              double inv_m, double inv_m2, int rhs, int src,
                              int f64, void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64)
    return epilogue<double>(fields, w_d, w_chi, wv2, w_eppsi, kq, lq, fnw, fn,
                            sums, partials, arrivals, max_blocks, ny, w, wq,
                            col0, nx, nreal, nyq, zero_jac, owner, inv_m,
                            inv_m2, rhs, src, count, st);
  return epilogue<float>(fields, w_d, w_chi, wv2, w_eppsi, kq, lq, fnw, fn,
                         sums, partials, arrivals, max_blocks, ny, w, wq, col0,
                         nx, nreal, nyq, zero_jac, owner, inv_m, inv_m2, rhs,
                         src, count, st);
}

extern "C" const char* stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
