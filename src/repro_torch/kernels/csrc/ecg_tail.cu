// Fused tail of one ECG iteration for Hopper (sm_90a):
//   X' = X + P·c,   R' = R − AP·c,   Z' = AP − P·d − P_old·d_old
//
// Replaces src/repro/kernels/block_update/kernel.py::ecg_tail_pallas.
//
// The same file carries the two-output update of that module's
// block_update_pallas, X' = X + P·c and R' = R − AP·c (four (n, t) reads,
// two writes: ~336 MB, ~0.100 ms at the full-scale shape).  No solve path
// calls it, in the reference or here; it shares the tail's row loop.
//
// Layout: X, R, P, AP, P_old are (n, t) row-major inputs; c, d, d_old are
// (t, t) row-major; X', R', Z' are (n, t) row-major outputs in buffers
// separate from the inputs.  The solver's breakdown guard keeps the previous
// iterate when the new residual norm is not finite, so the tail must not
// update X or R in place.
//
// What bounds it on the H100: bytes.  Five (n, t) reads and three (n, t)
// writes against 8·n·t² flops (t ≤ 32); at Example 2.1's full scale
// (n = 1 310 720, t = 8, f64) that is ~671 MB, ~0.20 ms at 3.35 TB/s;
// 0.501 ms at t = 20, 0.801 ms at t = 32.
//
// Design, t < kTiledMinT (17): row-parallel, one thread per output element
// (row, j), consecutive threads on consecutive elements so the row-major
// loads and stores of a warp coalesce.  The t values of P, AP and P_old on a
// thread's row are shared by the t threads of that row and come from L1;
// c, d and d_old (3·t² values, at most 24.6 KB at t = 32) sit in dynamic
// shared memory.  Each output element reads 3·t row values from L1 and 3·t
// coefficients from shared memory: above t = 16 that on-chip traffic, not
// the bytes, bounds it (on the H100 1.15 ms at t = 20 and 2.29 ms at t = 32
// against bounds of 0.50 and 0.80).
//
// Design, t >= kTiledMinT (register-tiled): a thread owns kRR rows and the
// kJ columns j = s + i·S (i < kJ) of its strip s (S = cdiv(t, kJ) strips a
// row, so the S threads of a row write consecutive columns).  Per m it
// loads kRR values of each of P, AP, P_old and kJ coefficients of each of
// c, d, d_old (rows padded with zeros to kJ·S columns, so the inner loop has
// no mask), and does 4·kRR·kJ multiply-adds with them: each loaded value
// serves kJ or kRR outputs instead of one (0.93 ms at t = 20, 1.72 ms at
// t = 32 with kJ = 2, kRR = 4; of the tilings tried, 4 x 2 and 8 x 1 were
// no better over t = 20..32, and at t ≤ 16 none beat the one-element design
// by more than 4%, at t = 12 each was slower).
//
// Both designs sum over m = 0..t-1 in order and finish each output the same
// way, so they give the same bits, from call to call.

#include <algorithm>

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads) ecg_tail_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ ap, const T* __restrict__ po,
    const T* __restrict__ c, const T* __restrict__ d,
    const T* __restrict__ d_old, T* __restrict__ xo, T* __restrict__ ro,
    T* __restrict__ zo, long long n, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);
  T* sd = sc + t * t;
  T* sdo = sd + t * t;
  for (int i = threadIdx.x; i < t * t; i += blockDim.x) {
    sc[i] = c[i];
    sd[i] = d[i];
    sdo[i] = d_old[i];
  }
  __syncthreads();

  const long long total = n * t;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long row = e / t;
    const int j = static_cast<int>(e - row * t);
    const T* prow = p + row * t;
    const T* aprow = ap + row * t;
    const T* porow = po + row * t;
    T pc = T(0), apc = T(0), pd = T(0), pod = T(0);
    for (int m = 0; m < t; ++m) {
      const T pm = prow[m];
      const T apm = aprow[m];
      const T cm = sc[m * t + j];
      pc += pm * cm;
      apc += apm * cm;
      pd += pm * sd[m * t + j];
      pod += porow[m] * sdo[m * t + j];
    }
    xo[e] = x[e] + pc;
    ro[e] = r[e] - apc;
    zo[e] = (ap[e] - pd) - pod;
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads) block_update_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ ap, const T* __restrict__ c, T* __restrict__ xo,
    T* __restrict__ ro, long long n, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < t * t; i += blockDim.x) sc[i] = c[i];
  __syncthreads();

  const long long total = n * t;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long row = e / t;
    const int j = static_cast<int>(e - row * t);
    const T* prow = p + row * t;
    const T* aprow = ap + row * t;
    T pc = T(0), apc = T(0);
    for (int m = 0; m < t; ++m) {
      const T cm = sc[m * t + j];
      pc += prow[m] * cm;
      apc += aprow[m] * cm;
    }
    xo[e] = x[e] + pc;
    ro[e] = r[e] - apc;
  }
}

constexpr int kTiledMinT = 17;  // widths that take the register-tiled kernel
constexpr int kJ = 2;           // columns a thread owns in the tiled kernel
constexpr int kRR = 4;          // rows a thread owns in the tiled kernel

template <typename T>
__global__ void __launch_bounds__(repro::kThreads) ecg_tail_tiled_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ ap, const T* __restrict__ po,
    const T* __restrict__ c, const T* __restrict__ d,
    const T* __restrict__ d_old, T* __restrict__ xo, T* __restrict__ ro,
    T* __restrict__ zo, long long n, int t) {
  const int S = (t + kJ - 1) / kJ;  // strips a row
  const int ts = kJ * S;            // padded coefficient row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);
  T* sd = sc + t * ts;
  T* sdo = sd + t * ts;
  for (int i = threadIdx.x; i < t * ts; i += blockDim.x) {
    const int m = i / ts, j = i - m * ts;
    const bool in = j < t;
    sc[i] = in ? c[m * t + j] : T(0);
    sd[i] = in ? d[m * t + j] : T(0);
    sdo[i] = in ? d_old[m * t + j] : T(0);
  }
  __syncthreads();

  const int groups = blockDim.x / S;  // row groups a CTA; the threads past them idle
  const int s = threadIdx.x % S, grp = threadIdx.x / S;
  if (grp >= groups) return;
  const long long pass = static_cast<long long>(groups) * kRR;  // rows a CTA takes at once
  for (long long base = static_cast<long long>(blockIdx.x) * pass; base < n;
       base += static_cast<long long>(gridDim.x) * pass) {
    long long row[kRR];
#pragma unroll
    for (int k = 0; k < kRR; ++k) row[k] = base + grp + static_cast<long long>(k) * groups;
    T pc[kRR][kJ] = {}, apc[kRR][kJ] = {}, pd[kRR][kJ] = {}, pod[kRR][kJ] = {};
    for (int m = 0; m < t; ++m) {
      T pm[kRR], apm[kRR], pom[kRR];
#pragma unroll
      for (int k = 0; k < kRR; ++k) {
        const bool ok = row[k] < n;
        pm[k] = ok ? p[row[k] * t + m] : T(0);
        apm[k] = ok ? ap[row[k] * t + m] : T(0);
        pom[k] = ok ? po[row[k] * t + m] : T(0);
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int at = m * ts + s + jj * S;
        const T cm = sc[at], dm = sd[at], dom = sdo[at];
#pragma unroll
        for (int k = 0; k < kRR; ++k) {
          pc[k][jj] += pm[k] * cm;
          apc[k][jj] += apm[k] * cm;
          pd[k][jj] += pm[k] * dm;
          pod[k][jj] += pom[k] * dom;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRR; ++k) {
      if (row[k] >= n) continue;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = s + jj * S;
        if (j >= t) continue;
        const long long e = row[k] * t + j;
        xo[e] = x[e] + pc[k][jj];
        ro[e] = r[e] - apc[k][jj];
        zo[e] = (ap[e] - pd[k][jj]) - pod[k][jj];
      }
    }
  }
}

unsigned row_grid(long long n, int t) {
  const long long blocks = repro::cdiv(n * t, repro::kThreads);
  return static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

template <typename T>
int launch_update(const void* x, const void* r, const void* p, const void* ap,
                  const void* c, void* xo, void* ro, long long n, int t,
                  void* stream) {
  const size_t smem = static_cast<size_t>(t) * t * sizeof(T);
  block_update_kernel<T><<<row_grid(n, t), repro::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(ap),
      static_cast<const T*>(c), static_cast<T*>(xo), static_cast<T*>(ro), n, t);
  return repro::launch_status();
}

template <typename T>
int launch(const void* x, const void* r, const void* p, const void* ap,
           const void* po, const void* c, const void* d, const void* d_old,
           void* xo, void* ro, void* zo, long long n, int t, void* stream) {
  if (t >= kTiledMinT) {
    // one wave of CTAs walking the rows with a grid stride, so each CTA
    // stages the coefficients once; the CTAs an SM holds at the widest
    // coefficients (t = 32), asked once
    auto kernel = ecg_tail_tiled_kernel<T>;
    static const int per_sm = [&] {
      int b = 0;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &b, kernel, repro::kThreads, 3 * 32 * 32 * sizeof(T)) == cudaSuccess && b > 0
                 ? b
                 : 1;
    }();
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int S = (t + kJ - 1) / kJ;
    const size_t smem = 3 * static_cast<size_t>(t) * kJ * S * sizeof(T);
    const long long pass = static_cast<long long>(repro::kThreads / S) * kRR;
    const long long grid = std::min(repro::cdiv(n, pass), static_cast<long long>(sms) * per_sm);
    kernel<<<static_cast<unsigned>(grid), repro::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(p), static_cast<const T*>(ap),
        static_cast<const T*>(po), static_cast<const T*>(c),
        static_cast<const T*>(d), static_cast<const T*>(d_old),
        static_cast<T*>(xo), static_cast<T*>(ro), static_cast<T*>(zo), n, t);
    return repro::launch_status();
  }
  const size_t smem = 3 * static_cast<size_t>(t) * t * sizeof(T);
  ecg_tail_kernel<T><<<row_grid(n, t), repro::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(ap),
      static_cast<const T*>(po), static_cast<const T*>(c),
      static_cast<const T*>(d), static_cast<const T*>(d_old),
      static_cast<T*>(xo), static_cast<T*>(ro), static_cast<T*>(zo), n, t);
  return repro::launch_status();
}

}  // namespace

REPRO_EXPORT int ecg_tail_f32(const void* x, const void* r, const void* p,
                              const void* ap, const void* po, const void* c,
                              const void* d, const void* d_old, void* xo,
                              void* ro, void* zo, long long n, int t,
                              void* stream) {
  return launch<float>(x, r, p, ap, po, c, d, d_old, xo, ro, zo, n, t, stream);
}

REPRO_EXPORT int ecg_tail_f64(const void* x, const void* r, const void* p,
                              const void* ap, const void* po, const void* c,
                              const void* d, const void* d_old, void* xo,
                              void* ro, void* zo, long long n, int t,
                              void* stream) {
  return launch<double>(x, r, p, ap, po, c, d, d_old, xo, ro, zo, n, t, stream);
}

REPRO_EXPORT int block_update_f32(const void* x, const void* r, const void* p,
                                  const void* ap, const void* c, void* xo,
                                  void* ro, long long n, int t, void* stream) {
  return launch_update<float>(x, r, p, ap, c, xo, ro, n, t, stream);
}

REPRO_EXPORT int block_update_f64(const void* x, const void* r, const void* p,
                                  const void* ap, const void* c, void* xo,
                                  void* ro, long long n, int t, void* stream) {
  return launch_update<double>(x, r, p, ap, c, xo, ro, n, t, stream);
}

REPRO_ERROR_STRING(ecg_tail)
