// Apply the inverse of ECG's t×t Cholesky factor to row blocks, for Hopper
// (sm_90a): given the upper factor C of G = CᵀC and one or two (rows, t)
// row-major blocks M, write Y with Y·C = M for each (P = Z·C⁻¹ and
// AP = AZ·C⁻¹ of one iteration, in one launch).
//
// Replaces no Pallas kernel: the reference leaves this step to XLA, two
// triangular solves in src/repro/core/methods/base.py::_chol_inv_apply
// (``solve_triangular(c.T, m.T, lower=True).T``).  Per row r that is one
// forward substitution, y_j = (m_j − Σ_{i<j} y_i·C_ij) / C_jj, which this
// kernel performs as written: the sum over i in ascending order, then the
// division, so the result is deterministic.  A C that holds NaNs (the
// caller's substitute for a G that is not positive definite) gives NaN
// rows; nothing is skipped, because the solver's breakdown guard reads them.
//
// What bounds it on the H100: bytes.  Two (n, t) reads and two writes
// against ~t² flops per row: at Example 2.1's full scale (n = 1 310 720,
// t = 8, float64) 335 MB, ~0.100 ms at 3.35 TB/s.
//
// Design: C (t² ≤ 256 values) is staged once per CTA in shared memory,
// where every thread of a warp reads the same entry (a broadcast).  A warp
// takes 32 consecutive rows of one block (Z's tiles, then AZ's: both blocks
// in one launch), one thread per row.  The tile is one contiguous range of
// 32·t values: the warp moves it between device memory and shared memory
// lane after lane on consecutive addresses, and each thread then reads its
// row from shared memory (rows padded to an odd length: no bank conflict).
// (A thread loading its own row straight from device memory instead makes
// requests that each touch 32 rows and use a part of every sector.)  The
// row's t values stay in registers (t is a template parameter, so every
// index is a constant).  The grid is one wave of the CTAs that fit on the
// card, walking the tiles with a grid stride; no atomics.

#include <algorithm>

#include "common.cuh"

namespace {

// One warp's tile, 32 consecutive rows of one block: one contiguous range of
// 32·TT values, moved value by value with consecutive lanes on consecutive
// addresses, into rows of kStride values in shared memory, and back.
template <typename T, int TT, int kStride>
__device__ __forceinline__ void tile_in(T* __restrict__ b, const T* __restrict__ src, int n,
                                        int lane) {
  for (int e = lane; e < n * TT; e += 32) b[(e / TT) * kStride + e % TT] = __ldcs(src + e);
}

template <typename T, int TT, int kStride>
__device__ __forceinline__ void tile_out(T* __restrict__ dst, const T* __restrict__ b, int n,
                                         int lane) {
  for (int e = lane; e < n * TT; e += 32) dst[e] = b[(e / TT) * kStride + e % TT];
}

template <typename T, int TT>
__global__ void __launch_bounds__(repro::kThreads) chol_apply_kernel(
    const T* __restrict__ c, const T* __restrict__ m0, T* __restrict__ y0,
    const T* __restrict__ m1, T* __restrict__ y1, long long rows, int nmat) {
  constexpr int kStride = TT % 2 ? TT : TT + 1;  // odd: a lane's row meets no bank conflict
  __shared__ T sc[TT * TT];
  __shared__ T buf[repro::kThreads / 32][32 * kStride];
  for (int i = threadIdx.x; i < TT * TT; i += blockDim.x) sc[i] = c[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  T* b = buf[threadIdx.x >> 5];
  const long long per = (rows + 31) / 32;  // warp tiles per block
  const long long tiles = nmat * per;
  const long long wstride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long tile = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       tile < tiles; tile += wstride) {
    const bool second = tile >= per;
    const long long r0 = (second ? tile - per : tile) * 32;
    const int n = static_cast<int>(min(32LL, rows - r0));
    tile_in<T, TT, kStride>(b, (second ? m1 : m0) + r0 * TT, n, lane);
    __syncwarp();
    // forward substitution y·C = m on this lane's row, column by column
    T v[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) v[j] = b[lane * kStride + j];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      T acc = v[j];
#pragma unroll
      for (int i = 0; i < j; ++i) acc -= v[i] * sc[i * TT + j];
      v[j] = acc / sc[j * TT + j];
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) b[lane * kStride + j] = v[j];
    __syncwarp();
    tile_out<T, TT, kStride>((second ? y1 : y0) + r0 * TT, b, n, lane);
    __syncwarp();  // the tile is read out before the next one lands
  }
}

template <typename T, int TT>
int launch_t(const void* c, const void* m0, void* y0, const void* m1, void* y1,
             long long rows, void* stream) {
  auto kernel = chol_apply_kernel<T, TT>;
  // resident CTAs per SM for this instance, asked once
  static const int per_sm = [&] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, repro::kThreads, 0) ==
                   cudaSuccess && n > 0
               ? n
               : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nmat = m1 ? 2 : 1;
  const long long warps = nmat * repro::cdiv(rows, 32);
  const long long grid = std::min(repro::cdiv(warps, repro::kThreads / 32),
                                  static_cast<long long>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(grid), repro::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(m0), static_cast<T*>(y0),
      static_cast<const T*>(m1), static_cast<T*>(y1), rows, nmat);
  return repro::launch_status();
}

template <typename T>
int launch(const void* c, const void* m0, void* y0, const void* m1, void* y1,
           long long rows, int t, void* stream) {
  if (rows < 0 || (m1 == nullptr) != (y1 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  switch (t) {
#define REPRO_CHOL_T(TT) \
  case TT: return launch_t<T, TT>(c, m0, y0, m1, y1, rows, stream);
    REPRO_CHOL_T(1) REPRO_CHOL_T(2) REPRO_CHOL_T(3) REPRO_CHOL_T(4)
    REPRO_CHOL_T(5) REPRO_CHOL_T(6) REPRO_CHOL_T(7) REPRO_CHOL_T(8)
    REPRO_CHOL_T(9) REPRO_CHOL_T(10) REPRO_CHOL_T(11) REPRO_CHOL_T(12)
    REPRO_CHOL_T(13) REPRO_CHOL_T(14) REPRO_CHOL_T(15) REPRO_CHOL_T(16)
#undef REPRO_CHOL_T
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// c: (t, t) upper factor; m0, y0 and (when m1 is not null) m1, y1: (rows, t)
// row-major; 1 <= t <= 16.
REPRO_EXPORT int chol_apply_f32(const void* c, const void* m0, void* y0, const void* m1,
                                void* y1, long long rows, int t, void* stream) {
  return launch<float>(c, m0, y0, m1, y1, rows, t, stream);
}

REPRO_EXPORT int chol_apply_f64(const void* c, const void* m0, void* y0, const void* m1,
                                void* y1, long long rows, int t, void* stream) {
  return launch<double>(c, m0, y0, m1, y1, rows, t, stream);
}

REPRO_ERROR_STRING(chol_apply)
