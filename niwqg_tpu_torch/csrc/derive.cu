// The fast wave kernel's derive, fused: one kernel for each gap between its
// transforms (niwqg_tpu_torch/models/fast_kernel.py, FastWaveKernel.derive;
// the launchers are niwqg_tpu_torch/ops/derive_fused.py).
//
// It replaces no TPU kernel: on the TPU, XLA fuses these chains by itself.
// As PyTorch operations the chain is some 78 small kernels a derive, with
// stacks, clones, flips and rolls between them, ~9.6 GB a step at 2048² on
// one card. Each kernel here reads its inputs once and writes only what the
// next transform takes and what Derived keeps:
//
//   derive_grad_pack     phih -> [phih, ik phih, il phih], the ifft2's batch
//   derive_wave_pv       phi, phix, phiy -> [|phi|^2, Re(i z)], the forward
//                        real transform's batch, z = phix* phiy - phiy* phix
//   derive_invert        fj, qh -> qwh, ph and the inverse real transform's
//                        batch [ph?, -il_dy ph, ik ph, qh, qh - qwh?], with
//                        the Hermitian projection of ph and, on the half
//                        layout, of the batch's self-mirror columns
//   derive_project_pack  on the pencil mesh, after the reflection exchange:
//                        ph and its reflection -> projected ph and the
//                        batch's ph-dependent entries
//
// Bound on an H100 SXM: bytes (a few flops a byte). One thread a complex
// element of the flat contiguous field, so the half layout's odd width does
// not matter; k and l come from 1-D vectors and the element's row and
// column, wv2, wv2i and the filter from the q side's tables, as the chain
// reads them. A thread on a self-mirror column (k = 0, nx/2) also reads its
// (-l, k) partner; on the full spectrum of one rank every thread reads its
// (-l, -k) partner.
//
// Rounding: the chain's operations in the chain's order, each rounded once
// (the _rn intrinsics: no contraction), so that the result is the chain's
// bit for bit. Where PyTorch's own kernel contracts, so does this one: the
// imaginary part of a complex product (see cmul_im). A division by f is a
// product with the reciprocal the host rounded, as PyTorch's CUDA division
// by a scalar computes it.
//
// Each kernel counts its launches on the card: thread 0 of block 0 adds one
// to the caller's counter, so a launch replayed from a CUDA graph counts.
// Every function launches on the caller's stream and returns the launch's
// cudaError_t (0 when queued).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename R> struct Cx;
template <> struct Cx<float> { using T = float2; };
template <> struct Cx<double> { using T = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename C, typename R>
__device__ __forceinline__ C cx(R re, R im) { C z; z.x = re; z.y = im; return z; }

// Im((a + ib)(c + id)) = a d + b c as c10::complex's product computes it
// in PyTorch's CUDA kernels, where nvcc contracts the sum into one fma.
template <typename R>
__device__ __forceinline__ R cmul_im(R a, R b, R c, R d) {
  return fma_(a, d, mul(b, c));
}

// (z + conj(z'))/2 on the planes: the Hermitian projection of z against
// its mirror partner z', as spectral.hermitian_project writes it
template <typename C>
__device__ __forceinline__ C proj(C z, C zp) {
  using R = decltype(z.x);
  return cx<C, R>(mul(R(0.5), add(z.x, zp.x)), mul(R(0.5), sub(z.y, zp.y)));
}

// (i k) z for a real k (spectral.mul_i)
template <typename C, typename R>
__device__ __forceinline__ C mul_i(C z, R k) {
  return cx<C, R>(mul(-k, z.y), mul(k, z.x));
}

template <typename R>
__global__ void derive_grad_pack_kernel(const typename Cx<R>::T* __restrict__ phih,
                                        typename Cx<R>::T* __restrict__ out,
                                        const R* __restrict__ kv,
                                        const R* __restrict__ lv, int ny, int w,
                                        unsigned long long* count) {
  const long long n = (long long)ny * w;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(count, 1ULL);
  if (e >= n) return;
  const int row = (int)((unsigned)e / (unsigned)w);  // n < 2^31: 32-bit division
  const int col = (int)e - row * w;
  const auto z = phih[e];
  out[e] = z;
  out[n + e] = mul_i(z, kv[col]);
  out[2 * n + e] = mul_i(z, lv[row]);
}

template <typename R>
__global__ void derive_wave_pv_kernel(const typename Cx<R>::T* __restrict__ phi,
                                      const typename Cx<R>::T* __restrict__ phix,
                                      const typename Cx<R>::T* __restrict__ phiy,
                                      R* __restrict__ out, long long n,
                                      unsigned long long* count) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(count, 1ULL);
  if (e >= n) return;
  const auto p = phi[e];
  const auto a = phix[e];
  const auto b = phiy[e];
  // Im(z), z = conj(a) b - conj(b) a, each product from the conjugate
  // PyTorch materialises
  const R im1 = cmul_im(a.x, -a.y, b.x, b.y);
  const R im2 = cmul_im(b.x, -b.y, a.x, a.y);
  out[e] = add(mul(p.x, p.x), mul(p.y, p.y));
  out[n + e] = -sub(im1, im2);
}

// what derive_invert reads and writes; one struct, passed by value
template <typename R>
struct InvertArgs {
  using C = typename Cx<R>::T;
  const C* fj;     // (2, ny, w): fft(|phi|^2), fft(Re(i z)); null without wave PV
  const C* qh;     // (ny, w)
  C* qwh;          // (ny, w) out; null without wave PV (the caller's zeros)
  C* ph;           // (ny, w) out
  C* batch;        // (slots, ny, w) out
  const R* wv2;    // (ny, w) tables of the q side
  const R* wv2i;
  const R* filtr;
  const R* kq;     // (w,) this block's k
  const R* lq;     // (ny,) l by row
  R inv_f;         // the host's rounding of 1/f
  int ny, w, col0, nx, nreal;
  int flags;       // kWavePV | kImagJac | kOwnsMean
  int nyq;         // l_dy on the Nyquist row: 0 l, 1 zero on global columns
                   // 1..nx/2-1 (half layout), 2 zero but on columns 0 and
                   // nx/2 (pair_inverse)
  int proj;        // kProjNone, kProjMirror, kProjReflect, kProjRaw
  int s_ph, s_u, s_v, s_q, s_qpsi;  // batch slots, -1 where absent
  unsigned long long* count;        // this kernel's launches
};

constexpr int kWavePV = 1, kImagJac = 2, kOwnsMean = 4;
constexpr int kProjNone = 0;     // ph kept as it is (QL)
constexpr int kProjMirror = 1;   // columns k = 0, nx/2 of ph and of the batch
constexpr int kProjReflect = 2;  // ph against its (-l, -k) partner, one rank
constexpr int kProjRaw = 3;      // ph unprojected; the mesh's reflection and
                                 // derive_project_pack follow

// l_dy at (row, global column): the l table, zero on padded columns and,
// by `nyq`, on part of the Nyquist row
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

// qwh at flat index e (row 0, global column 0 for the mean mode)
template <typename R>
__device__ __forceinline__ typename Cx<R>::T qwh_at(const InvertArgs<R>& a,
                                                    long long e, bool mean) {
  using C = typename Cx<R>::T;
  const long long n = (long long)a.ny * a.w;
  const C f0 = a.fj[e];
  C jach = a.fj[n + e];
  const R mw2 = -a.wv2[e];
  if (mean) jach = cx<C, R>(R(0), R(0));
  if (a.flags & kImagJac) jach = cx<C, R>(-jach.y, jach.x);
  // ((0.5 * gphi2h + jach) * 0.5 / f) * filtr, gphi2h = fj[0] * (-wv2)
  R re = add(mul(R(0.5), mul(f0.x, mw2)), jach.x);
  R im = add(mul(R(0.5), mul(f0.y, mw2)), jach.y);
  re = mul(mul(re, R(0.5)), a.inv_f);
  im = mul(mul(im, R(0.5)), a.inv_f);
  const R flt = a.filtr[e];
  return cx<C, R>(mul(re, flt), mul(im, flt));
}

template <typename R>
__global__ void derive_invert_kernel(const InvertArgs<R> a) {
  using C = typename Cx<R>::T;
  const long long n = (long long)a.ny * a.w;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(a.count, 1ULL);
  if (e >= n) return;
  const int row = (int)((unsigned)e / (unsigned)a.w);
  const int col = (int)e - row * a.w;
  const int cg = a.col0 + col;
  const bool wpv = a.flags & kWavePV;
  const bool mean_here = (a.flags & kOwnsMean) && row == 0 && cg == 0;

  // the value at e, and (projected modes) at its mirror partner ep
  const C q = a.qh[e];
  const C w = wpv ? qwh_at(a, e, mean_here) : cx<C, R>(R(0), R(0));
  const C d = cx<C, R>(sub(q.x, w.x), sub(q.y, w.y));  // qh - qwh
  const R wi = a.wv2i[e];
  const C ph_raw = cx<C, R>(-mul(d.x, wi), -mul(d.y, wi));
  if (wpv) a.qwh[e] = w;

  const int rowp = row == 0 ? 0 : a.ny - row;
  const bool mirror_col = cg == 0 || cg == a.nx / 2;
  const bool mirror = a.proj == kProjMirror && mirror_col;
  const bool reflect = a.proj == kProjReflect;
  C qp, dp, php_raw;
  long long ep = e;
  if (mirror || reflect) {
    const int colp = reflect ? (col == 0 ? 0 : a.w - col) : col;
    ep = (long long)rowp * a.w + colp;
    const bool mean_p = (a.flags & kOwnsMean) && rowp == 0 && a.col0 + colp == 0;
    qp = a.qh[ep];
    const C wp = wpv ? qwh_at(a, ep, mean_p) : cx<C, R>(R(0), R(0));
    dp = cx<C, R>(sub(qp.x, wp.x), sub(qp.y, wp.y));
    const R wip = a.wv2i[ep];
    php_raw = cx<C, R>(-mul(dp.x, wip), -mul(dp.y, wip));
  }
  const C ph = (mirror || reflect) ? proj(ph_raw, php_raw) : ph_raw;
  a.ph[e] = ph;

  C* const out = a.batch + e;
  if (a.proj == kProjRaw) {  // the ph-dependent slots wait for the reflection
    if (a.s_q >= 0) out[a.s_q * n] = q;
    if (a.s_qpsi >= 0) out[a.s_qpsi * n] = d;
    return;
  }
  const R k = a.kq[col];
  const R ly = l_dy(a.lq, row, cg, a.ny, a.nx, a.nreal, a.nyq);
  if (!mirror) {
    if (a.s_ph >= 0) out[a.s_ph * n] = ph;
    out[a.s_u * n] = mul_i(ph, -ly);
    out[a.s_v * n] = mul_i(ph, k);
    out[a.s_q * n] = q;
    if (a.s_qpsi >= 0) out[a.s_qpsi * n] = d;
    return;
  }
  // a self-mirror column of a projected batch: each entry against its
  // partner's, the partner's entries made from the partner's projected ph
  const C php = proj(php_raw, ph_raw);
  const R lyp = l_dy(a.lq, rowp, cg, a.ny, a.nx, a.nreal, a.nyq);
  if (a.s_ph >= 0) out[a.s_ph * n] = proj(ph, php);
  out[a.s_u * n] = proj(mul_i(ph, -ly), mul_i(php, -lyp));
  out[a.s_v * n] = proj(mul_i(ph, k), mul_i(php, k));
  out[a.s_q * n] = proj(q, qp);
  if (a.s_qpsi >= 0) out[a.s_qpsi * n] = proj(d, dp);
}

template <typename R>
__global__ void derive_project_pack_kernel(typename Cx<R>::T* __restrict__ ph,
                                           const typename Cx<R>::T* __restrict__ refl,
                                           typename Cx<R>::T* __restrict__ batch,
                                           const R* __restrict__ kq,
                                           const R* __restrict__ lq, int ny, int w,
                                           int col0, int nx, int nreal, int nyq,
                                           int s_ph, int s_u, int s_v,
                                           unsigned long long* count) {
  const long long n = (long long)ny * w;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(count, 1ULL);
  if (e >= n) return;
  const int row = (int)((unsigned)e / (unsigned)w);  // n < 2^31: 32-bit division
  const int col = (int)e - row * w;
  const auto p = proj(ph[e], refl[e]);
  ph[e] = p;
  const R ly = l_dy(lq, row, col0 + col, ny, nx, nreal, nyq);
  typename Cx<R>::T* const out = batch + e;
  if (s_ph >= 0) out[s_ph * n] = p;
  out[s_u * n] = mul_i(p, -ly);
  out[s_v * n] = mul_i(p, kq[col]);
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename R>
int invert_launch(const void* fj, const void* qh, void* qwh, void* ph,
                  void* batch, const void* wv2, const void* wv2i,
                  const void* filtr, const void* kq, const void* lq,
                  double inv_f, int ny, int w, int col0, int nx, int nreal,
                  int flags, int nyq, int proj, int s_ph, int s_u, int s_v,
                  int s_q, int s_qpsi, void* count, cudaStream_t st) {
  using C = typename Cx<R>::T;
  InvertArgs<R> a;
  a.fj = static_cast<const C*>(fj);
  a.qh = static_cast<const C*>(qh);
  a.qwh = static_cast<C*>(qwh);
  a.ph = static_cast<C*>(ph);
  a.batch = static_cast<C*>(batch);
  a.wv2 = static_cast<const R*>(wv2);
  a.wv2i = static_cast<const R*>(wv2i);
  a.filtr = static_cast<const R*>(filtr);
  a.kq = static_cast<const R*>(kq);
  a.lq = static_cast<const R*>(lq);
  a.inv_f = static_cast<R>(inv_f);
  a.ny = ny; a.w = w; a.col0 = col0; a.nx = nx; a.nreal = nreal;
  a.flags = flags; a.nyq = nyq; a.proj = proj;
  a.s_ph = s_ph; a.s_u = s_u; a.s_v = s_v; a.s_q = s_q; a.s_qpsi = s_qpsi;
  a.count = static_cast<unsigned long long*>(count);
  derive_invert_kernel<R><<<blocks((long long)ny * w), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int derive_grad_pack(const void* phih, void* out, const void* kv,
                                const void* lv, int ny, int w, int f64,
                                void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<unsigned long long*>(count);
  const unsigned g = blocks((long long)ny * w);
  if (f64)
    derive_grad_pack_kernel<double><<<g, kThreads, 0, st>>>(
        static_cast<const double2*>(phih), static_cast<double2*>(out),
        static_cast<const double*>(kv), static_cast<const double*>(lv), ny, w,
        c);
  else
    derive_grad_pack_kernel<float><<<g, kThreads, 0, st>>>(
        static_cast<const float2*>(phih), static_cast<float2*>(out),
        static_cast<const float*>(kv), static_cast<const float*>(lv), ny, w,
        c);
  return (int)cudaGetLastError();
}

extern "C" int derive_wave_pv(const void* phi, const void* phix,
                              const void* phiy, void* out, long long n,
                              int f64, void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<unsigned long long*>(count);
  if (f64)
    derive_wave_pv_kernel<double><<<blocks(n), kThreads, 0, st>>>(
        static_cast<const double2*>(phi), static_cast<const double2*>(phix),
        static_cast<const double2*>(phiy), static_cast<double*>(out), n, c);
  else
    derive_wave_pv_kernel<float><<<blocks(n), kThreads, 0, st>>>(
        static_cast<const float2*>(phi), static_cast<const float2*>(phix),
        static_cast<const float2*>(phiy), static_cast<float*>(out), n, c);
  return (int)cudaGetLastError();
}

extern "C" int derive_invert(const void* fj, const void* qh, void* qwh,
                             void* ph, void* batch, const void* wv2,
                             const void* wv2i, const void* filtr,
                             const void* kq, const void* lq, double inv_f,
                             int ny, int w, int col0, int nx, int nreal,
                             int flags, int nyq, int proj, int s_ph, int s_u,
                             int s_v, int s_q, int s_qpsi, int f64,
                             void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64)
    return invert_launch<double>(fj, qh, qwh, ph, batch, wv2, wv2i, filtr, kq,
                                 lq, inv_f, ny, w, col0, nx, nreal, flags, nyq,
                                 proj, s_ph, s_u, s_v, s_q, s_qpsi, count, st);
  return invert_launch<float>(fj, qh, qwh, ph, batch, wv2, wv2i, filtr, kq, lq,
                              inv_f, ny, w, col0, nx, nreal, flags, nyq, proj,
                              s_ph, s_u, s_v, s_q, s_qpsi, count, st);
}

extern "C" int derive_project_pack(void* ph, const void* refl, void* batch,
                                   const void* kq, const void* lq, int ny,
                                   int w, int col0, int nx, int nreal, int nyq,
                                   int s_ph, int s_u, int s_v, int f64,
                                   void* count, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<unsigned long long*>(count);
  const unsigned g = blocks((long long)ny * w);
  if (f64)
    derive_project_pack_kernel<double><<<g, kThreads, 0, st>>>(
        static_cast<double2*>(ph), static_cast<const double2*>(refl),
        static_cast<double2*>(batch), static_cast<const double*>(kq),
        static_cast<const double*>(lq), ny, w, col0, nx, nreal, nyq, s_ph, s_u,
        s_v, c);
  else
    derive_project_pack_kernel<float><<<g, kThreads, 0, st>>>(
        static_cast<float2*>(ph), static_cast<const float2*>(refl),
        static_cast<float2*>(batch), static_cast<const float*>(kq),
        static_cast<const float*>(lq), ny, w, col0, nx, nreal, nyq, s_ph, s_u,
        s_v, c);
  return (int)cudaGetLastError();
}

extern "C" const char* derive_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
