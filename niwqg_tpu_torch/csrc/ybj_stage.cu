// The YBJ model's stage gaps, fused (niwqg_tpu_torch/models/ybj.py,
// YBJKernel._step_fused; the launchers are niwqg_tpu_torch/ops/ybj_fused.py).
//
// It replaces no TPU kernel: on the TPU, XLA fuses the step of
// niwqg_tpu/models/ybj.py by itself. As PyTorch operations a YBJ stage is some
// 20 kernels on full complex fields between its two batched transforms (the
// stacks that feed each transform, mul_i's and jmul's torch.complex, the
// complex-by-real products with the frozen flow, the right-hand side, the
// ETDRK4 update in five passes, the filter). Here each gap is one launch:
//
//   ybj_products  after a stage's batched inverse: from phix, phiy, phi and
//                 the frozen real u, v, q_psi, the forward's batch
//                 [phix u + phiy v, phi q_psi]
//   ybj_stage     after a stage's batched forward, from its spectra nl:
//                 Fn = -nl0 - (i/2) nl1 (no mean-mode zeroing), the stage's
//                 ETDRK4 update with the filter, the right-hand side later
//                 stages read (stage 1 Fn0, stage 2 Fna, stage 3 Fna + Fnb),
//                 the fresh phih where it is needed (stage 1: stage 3's
//                 start) and the next inverse's batch [ik phih, il phih]
//                 (under faithful_quirks=False, and at stage 4 for the
//                 step's end, [phih, ik phih, il phih]). Stage 0 packs stage
//                 1's batch from the state's phih.
//
// Bound on an H100 SXM: bytes (a few flops a byte). The fields are one
// card's and row-major, so each block walks a run of kRun elements of the
// (ny, nx) field as one stream: 256 threads, each two pairs of neighbours
// (2t, 2t + 1 and kRun/2 + 2t, kRun/2 + 2t + 1), so that a warp loads a
// complex64 pair as 16 bytes a thread over 512 contiguous bytes; every load
// of a piece comes before its arithmetic. The fields' size is even (the
// grid's nx is) and every address 16-byte aligned (a launch refuses
// another), so a pair is whole or out.
//
// Rounding: every field is the chain's operations in the chain's order,
// each rounded once as PyTorch's kernel rounds it (the _rn intrinsics: no
// contraction; a complex product as PyTorch's CUDA kernel forms it, one
// fused multiply-add a part, as csrc/qg_stage.cu). A complex field times a
// real one is, in PyTorch, a complex product with the real factor promoted
// to (x, 0): each part then rounds as the real product of x and that part
// alone, which is what is formed here (a zero's sign aside). So phih, the
// right-hand sides and every batch are the chain's bit for bit. No sums:
// YBJ integrates no budgets.
//
// The kernels count their launches on the card: thread 0 of block 0 adds
// one to the caller's counter, so a launch replayed from a CUDA graph
// counts. Each launch goes on the caller's stream; each function returns
// the launch's cudaError_t (0 when queued).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // elements a thread: two pairs
constexpr int kRun = kPer * kThreads;    // elements a block
// blocks an SM holds at least: the registers a thread may take (float: 128
// at 2, as qg_stage; double: 1)
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
// a complex z times a real x (PyTorch's promoted product, each part x z.part)
template <typename C, typename R>
__device__ __forceinline__ C rmul(C z, R x) { return cx<C, R>(mul(z.x, x), mul(z.y, x)); }

// the elements a thread takes: element i at pair i/2, member i%2, of the run
// of block b (fewer than 2^31 elements in all)
struct Walk {
  unsigned e[kPer];
  bool ok[kPer];
  __device__ __forceinline__ explicit Walk(unsigned n) {
    const unsigned e0 = blockIdx.x * (unsigned)kRun + 2u * threadIdx.x;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      e[i] = e0 + (i >> 1) * (kRun / 2) + (i & 1);
      ok[i] = e[i] < n;
    }
  }
};

// two neighbours p[e], p[e + 1] as one access (e even, p 16-byte aligned)
__device__ __forceinline__ void ld2(const float2* p, unsigned e, float2& a, float2& b) {
  const float4 t = *reinterpret_cast<const float4*>(p + e);
  a = make_float2(t.x, t.y);
  b = make_float2(t.z, t.w);
}
__device__ __forceinline__ void ld2(const double2* p, unsigned e, double2& a, double2& b) {
  a = p[e];
  b = p[e + 1];
}
__device__ __forceinline__ void ld2(const float* p, unsigned e, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p + e);
  a = t.x;
  b = t.y;
}
__device__ __forceinline__ void ld2(const double* p, unsigned e, double& a, double& b) {
  const double2 t = *reinterpret_cast<const double2*>(p + e);
  a = t.x;
  b = t.y;
}
__device__ __forceinline__ void st2(float2* p, unsigned e, float2 a, float2 b) {
  *reinterpret_cast<float4*>(p + e) = make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st2(double2* p, unsigned e, double2 a, double2 b) {
  p[e] = a;
  p[e + 1] = b;
}

// a thread's kPer elements of a row-major field, a pair an access
template <typename T>
__device__ __forceinline__ void load(const T* p, const Walk& w, T (&v)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; i += 2)
    if (w.ok[i]) ld2(p, w.e[i], v[i], v[i + 1]);
}
template <typename T>
__device__ __forceinline__ void store(T* p, const Walk& w, const T (&v)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; i += 2)
    if (w.ok[i]) st2(p, w.e[i], v[i], v[i + 1]);
}

// what ybj_stage reads and writes; one struct, passed by value
template <typename R>
struct YbjStageArgs {
  using C = typename Cx<R>::T;
  const C* nl[2];            // the forward's spectra: phix u + phiy v, phi q_psi
  const C* base;             // the update's start (stage 0: the state's phih)
  const C* tab[4];           // expch_h, Qh (stage 4: expch, f0, fab, fc)
  const C* fn_in[2];         // stage 3: Fn0, Fna; stage 4: Fn0, Fna + Fnb
  C* fn_out;                 // stages 1-2: Fn; stage 3: Fna + Fnb
  C* o_phih;                 // the fresh phih, or null
  C* o_kx;                   // ik phih
  C* o_ly;                   // il phih
  const R* filt;             // (ny, nx) the filter, or null (folded)
  const R* k;                // (nx,) k by column
  const R* l;                // (ny,) l by row
  unsigned n;                // ny nx
  unsigned nx;
  unsigned long long* count; // this kernel's launches
};

template <typename R, int S>
__global__ void __launch_bounds__(kThreads, min_blocks<R>())
ybj_stage_kernel(const YbjStageArgs<R> a) {
  using C = typename Cx<R>::T;
  constexpr int kTabs = S == 4 ? 4 : 2;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.count, 1ULL);
  const Walk w(a.n);
  // every load of the piece first, then the arithmetic and the stores
  C b[kPer], j0[kPer], j1[kPer], t[kTabs][kPer], n0[kPer], n1[kPer];
  R fl[kPer];
  load(a.base, w, b);
  if (S > 0) {
    load(a.nl[0], w, j0);
    load(a.nl[1], w, j1);
#pragma unroll
    for (int j = 0; j < kTabs; ++j) load(a.tab[j], w, t[j]);
    if (S >= 3) {
      load(a.fn_in[0], w, n0);
      load(a.fn_in[1], w, n1);
    }
    if (a.filt) load(a.filt, w, fl);
  }
  C x[kPer], kept[kPer], kx[kPer], ly[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!w.ok[i]) continue;
    const unsigned r = w.e[i] / a.nx, c = w.e[i] - r * a.nx;
    const R kc = a.k[c], lr = a.l[r];
    C p = b[i];
    if constexpr (S > 0) {
      // Fn = -nl0 - jmul(nl1, 0.5), jmul(z, s) = (-s z.im, s z.re)
      const C fn = cx<C, R>(sub(-j0[i].x, mul(R(-0.5), j1[i].y)),
                            sub(-j0[i].y, mul(R(0.5), j1[i].x)));
      if constexpr (S <= 2) {
        // expch_h phih0 + Fn Qh
        p = cadd(cmul(t[0][i], b[i]), cmul(fn, t[1][i]));
        kept[i] = fn;
      } else if constexpr (S == 3) {
        // expch_h phih1 + (2 Fnb - Fn0) Qh; Fna + Fnb kept for stage 4
        const C d = cx<C, R>(sub(mul(R(2), fn.x), n0[i].x),
                             sub(mul(R(2), fn.y), n0[i].y));
        p = cadd(cmul(t[0][i], b[i]), cmul(d, t[1][i]));
        kept[i] = cadd(n1[i], fn);
      } else {
        // expch phih0 + Fn0 f0 + 2 (Fna + Fnb) fab + Fnc fc
        const C s2 = cx<C, R>(mul(R(2), n1[i].x), mul(R(2), n1[i].y));
        p = cadd(cadd(cadd(cmul(t[0][i], b[i]), cmul(n0[i], t[1][i])),
                      cmul(s2, t[2][i])),
                 cmul(fn, t[3][i]));
      }
      if (a.filt) p = rmul<C, R>(p, fl[i]);
    }
    x[i] = p;
    // mul_i(phih, k) = (-k phih.im, k phih.re); the same with l
    kx[i] = cx<C, R>(mul(-kc, p.y), mul(kc, p.x));
    ly[i] = cx<C, R>(mul(-lr, p.y), mul(lr, p.x));
  }
  if (S >= 1 && S <= 3) store(a.fn_out, w, kept);
  if (a.o_phih) store(a.o_phih, w, x);
  store(a.o_kx, w, kx);
  store(a.o_ly, w, ly);
}

// the forward's batch: [phix u + phiy v, phi q_psi]
template <typename R>
struct YbjProductsArgs {
  using C = typename Cx<R>::T;
  const C* phix;
  const C* phiy;
  const C* phi;
  const R* u;
  const R* v;
  const R* q;                // q_psi
  C* out[2];
  unsigned n;
  unsigned long long* count;
};

template <typename R>
__global__ void __launch_bounds__(kThreads, min_blocks<R>())
ybj_products_kernel(const YbjProductsArgs<R> a) {
  using C = typename Cx<R>::T;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.count, 1ULL);
  const Walk w(a.n);
  C gx[kPer], gy[kPer], ph[kPer];
  R u[kPer], v[kPer], q[kPer];
  load(a.phix, w, gx);
  load(a.phiy, w, gy);
  load(a.phi, w, ph);
  load(a.u, w, u);
  load(a.v, w, v);
  load(a.q, w, q);
  C o0[kPer], o1[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!w.ok[i]) continue;
    o0[i] = cadd(rmul<C, R>(gx[i], u[i]), rmul<C, R>(gy[i], v[i]));
    o1[i] = rmul<C, R>(ph[i], q[i]);
  }
  store(a.out[0], w, o0);
  store(a.out[1], w, o1);
}

// whether every address allows 16 bytes an access
bool aligned(const long long* ptrs, int count) {
  for (int j = 0; j < count; ++j)
    if (ptrs[j] % 16) return false;
  return true;
}

unsigned blocks_of(unsigned n) { return (n + kRun - 1) / kRun; }

template <typename R, int S>
int launch_stage(const YbjStageArgs<R>& a, cudaStream_t st) {
  ybj_stage_kernel<R, S><<<blocks_of(a.n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename R>
int stage(const long long* ptrs, int s, unsigned n, unsigned nx, void* count,
          cudaStream_t st) {
  using C = typename Cx<R>::T;
  YbjStageArgs<R> a;
  a.nl[0] = reinterpret_cast<const C*>(ptrs[0]);
  a.nl[1] = reinterpret_cast<const C*>(ptrs[1]);
  a.base = reinterpret_cast<const C*>(ptrs[2]);
  for (int j = 0; j < 4; ++j) a.tab[j] = reinterpret_cast<const C*>(ptrs[3 + j]);
  a.fn_in[0] = reinterpret_cast<const C*>(ptrs[7]);
  a.fn_in[1] = reinterpret_cast<const C*>(ptrs[8]);
  a.fn_out = reinterpret_cast<C*>(ptrs[9]);
  a.o_phih = reinterpret_cast<C*>(ptrs[10]);
  a.o_kx = reinterpret_cast<C*>(ptrs[11]);
  a.o_ly = reinterpret_cast<C*>(ptrs[12]);
  a.filt = reinterpret_cast<const R*>(ptrs[13]);
  a.k = reinterpret_cast<const R*>(ptrs[14]);
  a.l = reinterpret_cast<const R*>(ptrs[15]);
  a.n = n;
  a.nx = nx;
  a.count = static_cast<unsigned long long*>(count);
  // the fields (not k, l) are read and written 16 bytes an access
  if (!aligned(ptrs, 14)) return (int)cudaErrorMisalignedAddress;
  switch (s) {
    case 0: return launch_stage<R, 0>(a, st);
    case 1: return launch_stage<R, 1>(a, st);
    case 2: return launch_stage<R, 2>(a, st);
    case 3: return launch_stage<R, 3>(a, st);
    case 4: return launch_stage<R, 4>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename R>
int products(const long long* ptrs, unsigned n, void* count, cudaStream_t st) {
  using C = typename Cx<R>::T;
  YbjProductsArgs<R> a;
  a.phix = reinterpret_cast<const C*>(ptrs[0]);
  a.phiy = reinterpret_cast<const C*>(ptrs[1]);
  a.phi = reinterpret_cast<const C*>(ptrs[2]);
  a.u = reinterpret_cast<const R*>(ptrs[3]);
  a.v = reinterpret_cast<const R*>(ptrs[4]);
  a.q = reinterpret_cast<const R*>(ptrs[5]);
  a.out[0] = reinterpret_cast<C*>(ptrs[6]);
  a.out[1] = reinterpret_cast<C*>(ptrs[7]);
  a.n = n;
  a.count = static_cast<unsigned long long*>(count);
  if (!aligned(ptrs, 8)) return (int)cudaErrorMisalignedAddress;
  ybj_products_kernel<R><<<blocks_of(n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// a field of ny x nx elements: an even count, fewer than 2^31
bool size_ok(int ny, int nx) {
  const long long n = (long long)ny * nx;
  return ny > 0 && nx > 0 && n % 2 == 0 && n < (1LL << 31) - kRun;
}

}  // namespace

// ptrs: 16 addresses, in the order of ops/ybj_fused.py's _STAGE_PTRS (0:
// none); every field row-major (ny, nx)
extern "C" int ybj_stage(const long long* ptrs, int stage_, int ny, int nx,
                         int f64, void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (stage_ < 0 || stage_ > 4 || !size_ok(ny, nx))
    return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)ny * (unsigned)nx;
  if (f64) return stage<double>(ptrs, stage_, n, (unsigned)nx, count, st);
  return stage<float>(ptrs, stage_, n, (unsigned)nx, count, st);
}

// ptrs: 8 addresses, in the order of ops/ybj_fused.py's _PRODUCT_PTRS;
// every field row-major (ny, nx)
extern "C" int ybj_products(const long long* ptrs, int ny, int nx, int f64,
                            void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (!size_ok(ny, nx)) return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)ny * (unsigned)nx;
  if (f64) return products<double>(ptrs, n, count, st);
  return products<float>(ptrs, n, count, st);
}

extern "C" const char* ybj_stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
