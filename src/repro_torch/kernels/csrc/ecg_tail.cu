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
// writes against 8·n·t² flops (t ≤ 16); at Example 2.1's full scale
// (n = 1 310 720, t = 8, f64) that is ~671 MB, ~0.20 ms at 3.35 TB/s.
//
// Design: row-parallel, one thread per output element (row, j), consecutive
// threads on consecutive elements so the row-major loads and stores of a
// warp coalesce.  The t values of P, AP and P_old on a thread's row are
// shared by the t threads of that row and come from L1; c, d and d_old
// (3·t² values, at most 6 KB) sit in shared memory.  Each sum runs over
// m = 0..t-1 in order, so the result is deterministic.

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
