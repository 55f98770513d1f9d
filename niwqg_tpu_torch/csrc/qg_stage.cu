// The QG model's stage gaps, fused (niwqg_tpu_torch/models/qg.py,
// QGKernel._step_fused; the launchers are niwqg_tpu_torch/ops/qg_fused.py).
//
// It replaces no TPU kernel: on the TPU, XLA fuses the step of
// niwqg_tpu/models/qg.py by itself. As PyTorch operations a QG stage is some
// 40 small kernels between its two batched transforms (the stacks that feed
// each transform, complex-by-real products that promote a table, the
// Jacobian in four passes, the ETDRK4 update in five, the inversion, three
// Parseval sums of full-field temporaries). Here each gap is one launch:
//
//   qg_products  after a stage's batched inverse: from u, v, q (and c), the
//                forward's batch [u q, v q (, u c, v c)]
//   qg_stage     after a stage's batched forward, from its spectra fj:
//                Fn = -(ik fj0 + il fj1) (no mean-mode zeroing; the scalar
//                the same from fj2, fj3), the stage's ETDRK4 update with
//                the filter, the inversion ph = -qh wv2i, this rank's
//                Parseval budget partials, and the next inverse's batch
//                [-il ph, ik ph, qh (, ch)] (stage 4: [ph, qh (, ch)]), the
//                right-hand sides later stages read (stage 3: Fna + Fnb).
//                Stage 0 packs stage 1's batch from the state's ph, qh, ch.
//
// Bound on an H100 SXM: bytes (a few flops a byte). qg_stage's blocks walk
// a list of pieces of work, the q side's then the scalar's, 256 threads a
// piece, four elements a thread, each thread's loads of a piece all issued
// before its arithmetic. Where every field is row-major (one card) a piece
// is a run of 1024 elements of the block, read as one stream (at 2048² 70-77%
// of the bound against 68-71% in tiles); else it is a 32x32 tile, 32x8
// threads, four rows a thread: an input whose rows are contiguous is read
// a warp along a row, one whose columns are (a pencil mesh's y-FFT hands its
// output over so) a warp down a column and turned through shared memory, so
// that every field is read once, coalesced, in its own strides. Tables and
// outputs are row-major. qg_products reads and writes 16 bytes a thread
// where the rows allow it.
//
// Rounding: every field is the chain's operations in the chain's order,
// each rounded once as PyTorch's kernel rounds it (the _rn intrinsics: no
// contraction; a complex product as PyTorch's CUDA kernel forms it, one
// fused multiply-add a part), so qh, ch, ph and every batch are the
// chain's bit for bit. The budget partials are weighted sums of the fresh
// fields, their weights made in double from the wavenumbers: the terms and
// their sums in double, in a fixed order (a thread's tiles in turn, a
// warp's shuffle tree, the block's warps in turn, then the blocks in index
// order), the total times 1/M² rounded once. No floating-point atomics:
// every launch of a shape gives the same bits. The blocks' partials go to a
// workspace; the last block to arrive (an integer counter, reset by that
// block) adds them up.
//
// The kernels count their launches on the card: thread 0 of block 0 adds
// one to the caller's counter, so a launch replayed from a CUDA graph
// counts. Each launch goes on the caller's stream; each function returns
// the launch's cudaError_t (0 when queued).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // a tile: kTile x kTile elements
constexpr int kRows = 8;                  // thread rows of a block
constexpr int kPer = kTile / kRows;       // elements of a tile a thread
constexpr int kThreads = kTile * kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 5;                  // C2 gradC2 lapc2 psi psi_nu
constexpr int kProductThreads = 256;
// blocks an SM holds at least: the registers a thread may take (float:
// 128 at 2; at 2048² on one card 2 read 70-77% of the bound, 3 (80, with
// spills at stages 3-4) 47-77%; double: 1)
template <typename R>
constexpr int min_blocks() { return sizeof(R) == 4 ? 2 : 1; }

template <typename R> struct Cx;
template <> struct Cx<float> { using T = float2; };
template <> struct Cx<double> { using T = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename C, typename R>
__device__ __forceinline__ C cx(R re, R im) { C z; z.x = re; z.y = im; return z; }

// a * b as PyTorch's CUDA kernel rounds a complex product:
// re = fma(a.re, b.re, -(a.im b.im)), im = fma(a.re, b.im, a.im b.re)
template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  C z;
  z.x = fma_rn(a.x, b.x, -mul(a.y, b.y));
  z.y = fma_rn(a.x, b.y, mul(a.y, b.x));
  return z;
}
template <typename C>
__device__ __forceinline__ C cadd(C a, C b) { C z; z.x = add(a.x, b.x); z.y = add(a.y, b.y); return z; }

// a field read in its own strides (elements): row r, column c at r*sr + c*sc
template <typename T>
struct Field {
  const T* p;
  long long sr, sc;
};

// what qg_stage reads and writes; one struct, passed by value. Sides: 0 the
// vorticity (q), 1 the scalar (c)
template <typename R>
struct QgStageArgs {
  using C = typename Cx<R>::T;
  Field<C> fj[4];            // the forward's spectra: u q, v q, u c, v c
  Field<C> base[2];          // the update's start (stage 0: the state's qh, ch)
  Field<C> qhq;              // stage 3: ep_psi's pairing, the step's qh
  Field<C> ph;               // stage 0: the state's ph
  const C* tab[2][4];        // [side] expch_h, Qh (stage 4: expch, f0, fab, fc)
  const C* fn_in[2][2];      // [which][side]: stage 3 Fn0, Fna; stage 4 Fn0, Fna+Fnb
  C* fn_out[2];              // [side]: stages 1-2 Fn, stage 3 Fna + Fnb
  C* o_mly;                  // -il ph (stages 0-3)
  C* o_kx;                   // ik ph (stages 0-3)
  C* o_ph;                   // ph (stage 4: the batch's; else optional)
  C* o_side[2];              // the batch's qh, ch
  const R* filt;             // (ny, wq) the filter, or null
  const R* wv2i;             // (ny, wq)
  const R* k;                // (wq,) k of this block's columns
  const R* l;                // (ny,) l by row
  const double* kd;          // the same in double, for the budgets' weights
  const double* ld;
  int ny, wq, col0, nx, nreal;
  int owner;                 // this rank holds the (0,0) mode
  int sums, nu_on;           // the budget partials; psi_nu among them
  int tiles_c, tiles_side, tiles;  // the pieces of work: a side's, all
  double nu4, mu, inv_m2;
  double* partials;          // (gridDim.x, kSums) workspace
  unsigned int* arrivals;    // blocks done; 0 between launches
  R* out_sums;               // (kSums,) out
  unsigned long long* count; // this kernel's launches
};

// the elements a thread takes of a piece of work: a 32x32 tile (r0, c0),
// element i at row r0 + threadIdx.y + i*kRows, column c0 + threadIdx.x;
// or (FLAT, every field row-major) a run of kPer*kThreads elements of the
// row-major (ny, w) block from `e0`, element i at e0 + i*kThreads + t
template <bool FLAT>
struct Where {
  int r[kPer], c[kPer];
  bool ok[kPer];
  int r0, c0;  // the tile's corner (tiles only)
  __device__ __forceinline__ Where(int piece, int tiles_c, int ny, int w) {
    const int t = threadIdx.y * kTile + threadIdx.x;
    if (FLAT) {
      // (a block of fewer than 2^31 elements)
      const unsigned e0 = (unsigned)piece * kPer * kThreads + t;
      r0 = c0 = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const unsigned e = e0 + i * kThreads;
        r[i] = (int)(e / (unsigned)w);
        c[i] = (int)(e - (unsigned)r[i] * w);
        ok[i] = r[i] < ny;
      }
    } else {
      r0 = (piece / tiles_c) * kTile;
      c0 = (piece % tiles_c) * kTile;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        r[i] = r0 + threadIdx.y + i * kRows;
        c[i] = c0 + threadIdx.x;
        ok[i] = r[i] < ny && c[i] < w;
      }
    }
  }
};

// a thread's kPer elements of field f. A column-led field (tiles only) is
// read a warp down each column and turned through `buf`: block-uniform,
// every thread of the block calls it.
template <bool FLAT, typename C>
__device__ __forceinline__ void load(const Field<C>& f, const Where<FLAT>& at,
                                     int ny, int w, C (&v)[kPer],
                                     C (*buf)[kTile + 1]) {
  if (!FLAT && f.sr == 1 && f.sc != 1) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    __syncthreads();  // the buffer's last reads are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = at.c0 + ty + i * kRows, r = at.r0 + tx;
      if (r < ny && c < w) buf[ty + i * kRows][tx] = f.p[c * f.sc + r];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = buf[tx][ty + i * kRows];
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (at.ok[i]) v[i] = f.p[at.r[i] * f.sr + at.c[i] * f.sc];
}

// a thread's kPer elements of a row-major (ny, w) table
template <bool FLAT, typename T>
__device__ __forceinline__ void load_table(const T* t, const Where<FLAT>& at,
                                           int w, T (&v)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (at.ok[i]) v[i] = t[(long long)at.r[i] * w + at.c[i]];
}

// one side's piece of work at stage S (0: the pack)
template <typename R, int S, int SIDE, bool FLAT>
__device__ __forceinline__ void side_piece(const QgStageArgs<R>& a,
                                           const Where<FLAT>& at,
                                           double (&acc)[kSums],
                                           typename Cx<R>::T (*buf)[kTile + 1]) {
  using C = typename Cx<R>::T;
  constexpr bool kQ = SIDE == 0;
  constexpr int kTabs = S == 4 ? 4 : 2;
  const int ny = a.ny, w = a.wq;
  // every load of the piece first, then the arithmetic and the stores
  C j0[kPer], j1[kPer], b[kPer], h[kPer], t[kTabs][kPer], n0[kPer], n1[kPer];
  R fl[kPer], wi[kPer];
  load(a.base[SIDE], at, ny, w, b, buf);
  if (S == 0) {
    if (kQ) load(a.ph, at, ny, w, j0, buf);
  } else {
    load(a.fj[2 * SIDE], at, ny, w, j0, buf);
    load(a.fj[2 * SIDE + 1], at, ny, w, j1, buf);
    if (kQ && S == 3 && a.sums) load(a.qhq, at, ny, w, h, buf);
#pragma unroll
    for (int j = 0; j < kTabs; ++j) load_table(a.tab[SIDE][j], at, w, t[j]);
    if (S >= 3) {
      load_table(a.fn_in[0][SIDE], at, w, n0);
      load_table(a.fn_in[1][SIDE], at, w, n1);
    }
    if (a.filt) load_table(a.filt, at, w, fl);
    if (kQ) load_table(a.wv2i, at, w, wi);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!at.ok[i]) continue;
    const int r = at.r[i], c = at.c[i], cg = a.col0 + c;
    const long long o = (long long)r * w + c;
    const R kc = a.k[c], lr = a.l[r];
    if constexpr (S == 0) {
      if (kQ) {
        const C p = j0[i];
        a.o_mly[o] = cx<C, R>(mul(lr, p.y), mul(-lr, p.x));
        a.o_kx[o] = cx<C, R>(mul(-kc, p.y), mul(kc, p.x));
      }
      a.o_side[SIDE][o] = b[i];
      continue;
    }
    // Fn = -(mul_i(fj0, k) + mul_i(fj1, l))
    const C fn = cx<C, R>(-add(mul(-kc, j0[i].y), mul(-lr, j1[i].y)),
                          -add(mul(kc, j0[i].x), mul(lr, j1[i].x)));
    C x;
    if constexpr (S <= 2) {
      // expch_h base + Fn Qh
      x = cadd(cmul(t[0][i], b[i]), cmul(fn, t[1][i]));
      a.fn_out[SIDE][o] = fn;
    } else if constexpr (S == 3) {
      // expch_h qh1 + (2 Fnb - Fn0) Qh; Fna + Fnb kept for stage 4
      const C d = cx<C, R>(sub(mul(R(2), fn.x), n0[i].x),
                           sub(mul(R(2), fn.y), n0[i].y));
      x = cadd(cmul(t[0][i], b[i]), cmul(d, t[1][i]));
      a.fn_out[SIDE][o] = cadd(n1[i], fn);
    } else {
      // expch qh0 + Fn0 f0 + 2 (Fna + Fnb) fab + Fnc fc
      const C s2 = cx<C, R>(mul(R(2), n1[i].x), mul(R(2), n1[i].y));
      x = cadd(cadd(cadd(cmul(t[0][i], b[i]), cmul(n0[i], t[1][i])),
                    cmul(s2, t[2][i])),
               cmul(fn, t[3][i]));
    }
    if (a.filt) x = cx<C, R>(mul(x.x, fl[i]), mul(x.y, fl[i]));
    a.o_side[SIDE][o] = x;
    // the half spectrum's weights: the self-mirror columns k = 0, nx/2
    // once, the others twice (their mirrors are not stored), padding not
    // at all
    const double deg = cg >= a.nreal ? 0.0
                       : (cg == 0 || cg == a.nx / 2) ? 1.0 : 2.0;
    const double kd = a.kd[c], ld = a.ld[r];
    const double wv2 = kd * kd + ld * ld, wv4 = wv2 * wv2;
    if (kQ) {
      const C p = cx<C, R>(-mul(x.x, wi[i]), -mul(x.y, wi[i]));
      if (S < 4) {
        a.o_mly[o] = cx<C, R>(mul(lr, p.y), mul(-lr, p.x));
        a.o_kx[o] = cx<C, R>(mul(-kc, p.y), mul(kc, p.x));
      }
      if (a.o_ph) a.o_ph[o] = p;
      if (a.sums) {
        // ep_psi: Re(conj(qh_q) ph) by (nu4 wv4 + mu), qh_q the step's qh
        // at stages 1-3 and the fresh one at stage 4; psi_nu: the fresh
        // qh's by wv2
        const C q = S == 3 ? h[i] : S == 4 ? x : b[i];
        const double px = p.x, py = p.y;
        acc[3] += deg * (a.nu4 * wv4 + a.mu) * ((double)q.x * px + (double)q.y * py);
        if (a.nu_on) acc[4] += deg * wv2 * ((double)x.x * px + (double)x.y * py);
      }
    } else if (a.sums) {
      // spec_var of ch, ch wv and ch wv2; the first without the mean mode
      const double m2 = (double)x.x * x.x + (double)x.y * x.y;
      acc[0] += (a.owner && r == 0 && cg == 0) ? 0.0 : deg * m2;
      acc[1] += deg * wv2 * m2;
      acc[2] += deg * wv4 * m2;
    }
  }
}

// the block's total of each sum, in a fixed order, on thread t < kSums
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

template <typename R, int S, bool FLAT>
__global__ void __launch_bounds__(kThreads, min_blocks<R>())
qg_stage_kernel(const QgStageArgs<R> a) {
  using C = typename Cx<R>::T;
  __shared__ C buf[kTile][kTile + 1];
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (blockIdx.x == 0 && t == 0) atomicAdd(a.count, 1ULL);
  double acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0;

  for (int k = blockIdx.x; k < a.tiles; k += gridDim.x) {
    const int side = k / a.tiles_side;
    const Where<FLAT> at(k % a.tiles_side, a.tiles_c, a.ny, a.wq);
    if (side == 0) side_piece<R, S, 0, FLAT>(a, at, acc, buf);
    else side_piece<R, S, 1, FLAT>(a, at, acc, buf);
  }
  if (S == 0 || !a.sums) return;

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
  if (t < kSums) a.out_sums[t] = (R)(acc[0] * a.inv_m2);
  if (t == 0) *a.arrivals = 0u;  // ready for the next launch
}

// the forward's batch of products: out[j] = x_j y_j over (rows, nx), read
// and written V values at a time
template <typename R>
struct QgProductsArgs {
  Field<R> in[4];            // u, v, q, c (c: null without the scalar)
  R* out;                    // (nout, rows, nx), contiguous
  int nout, rows, nx;
  unsigned long long* count;
};

template <typename R, int V> struct Vec;
template <> struct Vec<float, 4> { using T = float4; };
template <> struct Vec<double, 2> { using T = double2; };

template <typename R, int V>
__device__ __forceinline__ void prod_vec(const QgProductsArgs<R>& a, int r,
                                         int c, long long plane) {
  using T = typename Vec<R, V>::T;
  R x[4][V];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= 3 && a.nout == 2) break;
    const T v = *reinterpret_cast<const T*>(a.in[j].p + r * a.in[j].sr + c);
    const R* e = reinterpret_cast<const R*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) x[j][i] = e[i];
  }
  const long long o = (long long)r * a.nx + c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= a.nout) break;
    T v;
    R* e = reinterpret_cast<R*>(&v);
#pragma unroll
    // the factors as the chain pairs them: (u, q), (v, q), (u, c), (v, c)
    for (int i = 0; i < V; ++i) e[i] = mul(x[j & 1][i], x[2 + (j >> 1)][i]);
    *reinterpret_cast<T*>(a.out + j * plane + o) = v;
  }
}

template <typename R, int V>
__global__ void __launch_bounds__(kProductThreads)
qg_products_kernel(const QgProductsArgs<R> a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.count, 1ULL);
  const long long plane = (long long)a.rows * a.nx;
  const int per_row = a.nx / (V > 1 ? V : 1);
  const long long n = (long long)a.rows * per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / per_row), c = (int)(i % per_row);
    if constexpr (V > 1) {
      prod_vec<R, V>(a, r, c * V, plane);
    } else {
      // any strides: one value of each factor
      R x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = j < 3 || a.nout == 4
                   ? a.in[j].p[r * a.in[j].sr + c * a.in[j].sc] : R(0);
      const long long o = (long long)r * a.nx + c;
      a.out[o] = mul(x[0], x[2]);
      a.out[plane + o] = mul(x[1], x[2]);
      if (a.nout == 4) {
        a.out[2 * plane + o] = mul(x[0], x[3]);
        a.out[3 * plane + o] = mul(x[1], x[3]);
      }
    }
  }
}

inline int tiles_of(int n) { return (n + kTile - 1) / kTile; }

template <typename T>
Field<T> field(const long long* f, int i) {
  Field<T> x;
  x.p = reinterpret_cast<const T*>(f[3 * i]);
  x.sr = f[3 * i + 1];
  x.sc = f[3 * i + 2];
  return x;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <typename R, int S, bool FLAT>
int launch_stage(QgStageArgs<R>& a, int max_blocks, cudaStream_t st) {
  auto kern = qg_stage_kernel<R, S, FLAT>;
  // the blocks an SM holds at once, asked at the first launch (eager: a
  // capture follows an eager step), the same on every card of a kind
  static int per_sm = 0;
  int sms = 0;
  int err = sm_count(&sms);
  if (err == 0 && per_sm == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                             kThreads, 0);
  if (err != 0) return err;
  // as many blocks as fit on the card at once, at most the workspace's
  int blocks = per_sm * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > a.tiles) blocks = a.tiles;
  if (blocks < 1) blocks = 1;
  kern<<<blocks, dim3(kTile, kRows), 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename R, bool FLAT>
int launch_as(QgStageArgs<R>& a, int s, int max_blocks, cudaStream_t st) {
  switch (s) {
    case 0: return launch_stage<R, 0, FLAT>(a, max_blocks, st);
    case 1: return launch_stage<R, 1, FLAT>(a, max_blocks, st);
    case 2: return launch_stage<R, 2, FLAT>(a, max_blocks, st);
    case 3: return launch_stage<R, 3, FLAT>(a, max_blocks, st);
    case 4: return launch_stage<R, 4, FLAT>(a, max_blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename R>
int stage(const long long* fields, const long long* ptrs, void* sums,
          void* partials, void* arrivals, int max_blocks, int s, int ny,
          int wq, int col0, int nx, int nreal, int owner, int scalar,
          int flags, double nu4, double mu, double inv_m2, void* count,
          cudaStream_t st) {
  using C = typename Cx<R>::T;
  QgStageArgs<R> a;
  for (int j = 0; j < 4; ++j) a.fj[j] = field<C>(fields, j);
  a.base[0] = field<C>(fields, 4);
  a.base[1] = field<C>(fields, 5);
  a.qhq = field<C>(fields, 6);
  a.ph = field<C>(fields, 7);
  for (int side = 0; side < 2; ++side) {
    for (int j = 0; j < 4; ++j)
      a.tab[side][j] = reinterpret_cast<const C*>(ptrs[4 * side + j]);
    a.fn_in[0][side] = reinterpret_cast<const C*>(ptrs[8 + side]);
    a.fn_in[1][side] = reinterpret_cast<const C*>(ptrs[10 + side]);
    a.fn_out[side] = reinterpret_cast<C*>(ptrs[12 + side]);
    a.o_side[side] = reinterpret_cast<C*>(ptrs[17 + side]);
  }
  a.o_mly = reinterpret_cast<C*>(ptrs[14]);
  a.o_kx = reinterpret_cast<C*>(ptrs[15]);
  a.o_ph = reinterpret_cast<C*>(ptrs[16]);
  a.filt = reinterpret_cast<const R*>(ptrs[19]);
  a.wv2i = reinterpret_cast<const R*>(ptrs[20]);
  a.k = reinterpret_cast<const R*>(ptrs[21]);
  a.l = reinterpret_cast<const R*>(ptrs[22]);
  a.kd = reinterpret_cast<const double*>(ptrs[23]);
  a.ld = reinterpret_cast<const double*>(ptrs[24]);
  a.ny = ny; a.wq = wq; a.col0 = col0; a.nx = nx; a.nreal = nreal;
  a.owner = owner;
  a.sums = flags & 1;
  a.nu_on = (flags >> 1) & 1;
  a.nu4 = nu4; a.mu = mu; a.inv_m2 = inv_m2;
  a.partials = static_cast<double*>(partials);
  a.arrivals = static_cast<unsigned int*>(arrivals);
  a.out_sums = static_cast<R*>(sums);
  a.count = static_cast<unsigned long long*>(count);
  // every field row-major with rows of wq: the block is walked as one
  // stream, else in tiles
  bool flat = true;
  for (int j = 0; j < 8; ++j)
    flat = flat && (fields[3 * j] == 0 ||
                    (fields[3 * j + 1] == wq && fields[3 * j + 2] == 1));
  a.tiles_c = tiles_of(wq);
  a.tiles_side = flat ? (int)(((long long)ny * wq + kPer * kThreads - 1) /
                              (kPer * kThreads))
                      : tiles_of(ny) * a.tiles_c;
  a.tiles = a.tiles_side * (scalar ? 2 : 1);
  if (flat) return launch_as<R, true>(a, s, max_blocks, st);
  return launch_as<R, false>(a, s, max_blocks, st);
}

template <typename R>
int products(const long long* fields, void* out, int nout, int rows, int nx,
             void* count, cudaStream_t st) {
  constexpr int V = 16 / sizeof(R);
  QgProductsArgs<R> a;
  for (int j = 0; j < 4; ++j) a.in[j] = field<R>(fields, j);
  a.out = static_cast<R*>(out);
  a.nout = nout; a.rows = rows; a.nx = nx;
  a.count = static_cast<unsigned long long*>(count);
  // 16 bytes a thread where every factor's rows are contiguous and aligned
  bool vec = nx % V == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0;
  for (int j = 0; j < (nout == 4 ? 4 : 3); ++j)
    vec = vec && a.in[j].sc == 1 && a.in[j].sr % V == 0 &&
          reinterpret_cast<unsigned long long>(a.in[j].p) % 16 == 0;
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  const long long n = (long long)rows * (vec ? nx / V : nx);
  long long blocks = (long long)sms * (2048 / kProductThreads);
  const long long need = (n + kProductThreads - 1) / kProductThreads;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  if (vec)
    qg_products_kernel<R, V><<<(int)blocks, kProductThreads, 0, st>>>(a);
  else
    qg_products_kernel<R, 1><<<(int)blocks, kProductThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// fields: 8 x (address, row stride, column stride), in the order fj0, fj1,
// fj2, fj3, base_q, base_c, qh_q, ph (address 0 where the call reads none);
// ptrs: 25 addresses, in the order of ops/qg_fused.py's _PTRS (0: none);
// flags: 1 the budget partials, 2 psi_nu among them
extern "C" int qg_stage(const long long* fields, const long long* ptrs,
                        void* sums, void* partials, void* arrivals,
                        int max_blocks, int stage_, int ny, int wq, int col0,
                        int nx, int nreal, int owner, int scalar, int flags,
                        double nu4, double mu, double inv_m2, int f64,
                        void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (stage_ < 0 || stage_ > 4) return (int)cudaErrorInvalidValue;
  if (f64)
    return stage<double>(fields, ptrs, sums, partials, arrivals, max_blocks,
                         stage_, ny, wq, col0, nx, nreal, owner, scalar,
                         flags, nu4, mu, inv_m2, count, st);
  return stage<float>(fields, ptrs, sums, partials, arrivals, max_blocks,
                      stage_, ny, wq, col0, nx, nreal, owner, scalar, flags,
                      nu4, mu, inv_m2, count, st);
}

// fields: 4 x (address, row stride, column stride) of u, v, q, c (c's
// address 0 where nout is 2)
extern "C" int qg_products(const long long* fields, void* out, int nout,
                           int rows, int nx, int f64, void* count,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (nout != 2 && nout != 4) return (int)cudaErrorInvalidValue;
  if (f64) return products<double>(fields, out, nout, rows, nx, count, st);
  return products<float>(fields, out, nout, rows, nx, count, st);
}

extern "C" const char* qg_stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
