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

// Two more kernel functions serve the adaptive solver (a ReductionPolicy):
//
// rank_apply — the rank-revealing apply of src/repro/adaptive/rankrev.py
// (``rank_revealing_apply``, no Pallas kernel: XLA ops there), for t <= 32:
// the classic and pipelined schemes call it at t (under a policy), the
// s-step scheme on every block at s·t (16 and 32 at t = 8, s = 2 and 4).
// Every CTA first factors the t×t G with diagonal pivoting in shared
// memory, one warp,
// in the order of the plain version (``adaptive/rankrev.py``
// ``pivoted_cholesky``): the largest remaining diagonal as pivot (a NaN
// first, ties to the lower index, as ``jnp.argmax``), a swap by
// transposition, ``pivot > thresh`` with thresh = rtol·max(max diag G, 0),
// the column, then the full rank-1 Schur update, each product and
// difference rounded on its own (no fused multiply-add), so the pivot order
// and the rank equal the plain version's.  The other warps stage their first
// tile meanwhile.  Then the row pass of chol_apply: each row's values are
// read in pivot order from the staged tile, solved against L with dead
// pivots set to 1 on the diagonal, and written as y_j·(j < rank).  CTA 0
// writes rank and perm.  Bytes and grid are chol_apply's; a G holding NaN
// gives thresh = NaN, rank 0 and zero blocks, as the reference.  Its shared
// memory is dynamic (76 KB a CTA at t = 32 in float64, see RankSmem); the
// factorization's t pivot steps (a butterfly and a t-column update each)
// grow as t², the row pass's substitution as t²/2 multiply-adds a row.
//
// drop_mask — the flexible-ECG stagnation drop of src/repro/adaptive/
// reduce.py (``stagnation_mask``, no Pallas kernel either) on the (t, k)
// step coefficients c (k = t for classic and pipelined, s·t for s-step's
// transposed coefficient block) and the live directions (the first rank, or
// a given mask): one warp, a lane per direction, writes the column mask and
// [rank, active count] for the iteration's one host copy.

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


namespace {

constexpr unsigned kFull = 0xffffffffu;

// Products and differences rounded on their own, as the plain versions'
// separate torch ops: no contraction into a fused multiply-add.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T inf() {
  return static_cast<T>(__longlong_as_double(0x7ff0000000000000LL));
}

// (a, ia) comes first in jnp.argmax's order: a NaN, else the larger value,
// else the lower index.
template <typename T>
__device__ __forceinline__ bool argmax_first(T a, int ia, T b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// a sorts before b in an ascending sort with NaN last (jnp.argsort's order)
template <typename T>
__device__ __forceinline__ bool sorts_before(T a, T b) {
  return a < b || (isnan(b) && !isnan(a));
}

// Diagonally pivoted Cholesky of the t×t G by one warp (see the head of the
// file).  sa: the Schur complement, sl: L (row-major), both with row stride
// kS (odd, so a lane per row meets no bank conflict), sperm: the pivot
// order, all in shared memory.  Returns the rank.
template <typename T, int TT, int kS>
__device__ int pivoted_factor(const T* __restrict__ g, T rtol, T* sa, T* sl, int* sperm, int lane) {
  for (int e = lane; e < TT * TT; e += 32) {
    sa[(e / TT) * kS + e % TT] = g[e];
    sl[(e / TT) * kS + e % TT] = T(0);
  }
  if (lane < TT) sperm[lane] = lane;
  __syncwarp();
  // thresh = rtol · max(max diag G, 0); a NaN on the diagonal makes it NaN
  T m = lane < TT ? sa[lane * kS + lane] : -inf<T>();
  for (int off = 16; off; off >>= 1) {
    const T o = __shfl_xor_sync(kFull, m, off);
    m = isnan(m) ? m : (isnan(o) || o > m ? o : m);
  }
  const T thresh = mul_rn(rtol, (m > T(0) || isnan(m)) ? m : T(0));
  int rank = 0;
#pragma unroll 1
  for (int k = 0; k < TT; ++k) {
    // pivot: the largest remaining diagonal entry (rows/columns >= k)
    T d = (lane < TT && lane >= k) ? sa[lane * kS + lane] : -inf<T>();
    int j = lane;
    for (int off = 16; off; off >>= 1) {
      const T od = __shfl_xor_sync(kFull, d, off);
      const int oj = __shfl_xor_sync(kFull, j, off);
      if (argmax_first(od, oj, d, j)) {
        d = od;
        j = oj;
      }
    }
    if (j != k) {  // the transposition k <-> j of G's rows and columns, L's rows, perm
      if (lane < TT) {
        const T x = sa[lane * kS + k];
        sa[lane * kS + k] = sa[lane * kS + j];
        sa[lane * kS + j] = x;
      }
      __syncwarp();
      if (lane < TT) {
        const T x = sa[k * kS + lane];
        sa[k * kS + lane] = sa[j * kS + lane];
        sa[j * kS + lane] = x;
        const T y = sl[k * kS + lane];
        sl[k * kS + lane] = sl[j * kS + lane];
        sl[j * kS + lane] = y;
      }
      if (lane == 0) {
        const int p = sperm[k];
        sperm[k] = sperm[j];
        sperm[j] = p;
      }
      __syncwarp();
    }
    const T pivot = sa[k * kS + k];
    const bool ok = pivot > thresh;
    const T root = sqrt(ok ? pivot : T(1));
    T col = T(0);  // a dependent direction: a zero column
    if (ok && lane < TT) col = lane > k ? sa[lane * kS + k] / root : (lane == k ? root : T(0));
    __syncwarp();  // column k is read before the update overwrites it
    if (lane < TT) sl[lane * kS + k] = col;
#pragma unroll
    for (int c = 0; c < TT; ++c) {  // the Schur complement update
      const T cc = __shfl_sync(kFull, col, c);
      if (lane < TT) sa[lane * kS + c] = sub_rn(sa[lane * kS + c], mul_rn(col, cc));
    }
    rank += ok;
    __syncwarp();
  }
  return rank;
}

// rank_apply's shared memory, all of it dynamic: each warp's tile buffer
// (32 rows of kStride values), L (TT rows of kStride values), the column mask
// and the pivot order.  The Schur complement of the factorization lives in
// warp 0's tile buffer (TT·kStride <= 32·kStride values), which warp 0 does
// not fill before the factorization ends.  At TT = 32 in float64 that is
// 76 416 bytes a CTA, above the 48 KB a launch gets without opting in.
template <typename T, int TT>
struct RankSmem {
  static constexpr int kStride = TT % 2 ? TT : TT + 1;  // odd: no bank conflict on rows
  static constexpr int kWarps = repro::kThreads / 32;
  static constexpr int kTile = 32 * kStride;
  static constexpr size_t kBytes =
      (static_cast<size_t>(kWarps) * kTile + TT * kStride + TT) * sizeof(T) + TT * sizeof(int);
};

template <typename T, int TT>
__global__ void __launch_bounds__(repro::kThreads) rank_apply_kernel(
    const T* __restrict__ g, const T* __restrict__ m0, T* __restrict__ y0,
    const T* __restrict__ m1, T* __restrict__ y1, long long rows, int nmat, T rtol,
    int* __restrict__ rank_out, int* __restrict__ perm_out) {
  using S = RankSmem<T, TT>;
  constexpr int kStride = S::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const bufs = reinterpret_cast<T*>(smem_raw);
  T* const sl = bufs + S::kWarps * S::kTile;
  T* const smask = sl + TT * kStride;
  int* const sperm = reinterpret_cast<int*>(smask + TT);
  T* const sa = bufs;  // warp 0's tile buffer, free until the factorization ends

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* b = bufs + warp * S::kTile;
  const long long per = (rows + 31) / 32;  // warp tiles per block
  const long long tiles = nmat * per;
  const long long wstride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  long long tile = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  bool staged = false;
  if (warp != 0 && tile < tiles) {  // the other warps stage a tile while warp 0 factors
    const bool second = tile >= per;
    const long long r0 = (second ? tile - per : tile) * 32;
    tile_in<T, TT, kStride>(b, (second ? m1 : m0) + r0 * TT,
                            static_cast<int>(min(32LL, rows - r0)), lane);
    staged = true;
  }
  if (warp == 0) {
    const int rank = pivoted_factor<T, TT, kStride>(g, rtol, sa, sl, sperm, lane);
    if (lane < TT) {
      smask[lane] = lane < rank ? T(1) : T(0);
      if (lane >= rank) sl[lane * kStride + lane] += T(1);  // unit-ized dead pivots
      if (blockIdx.x == 0) perm_out[lane] = sperm[lane];
    }
    if (blockIdx.x == 0 && lane == 0) *rank_out = rank;
  }
  __syncthreads();

  for (; tile < tiles; tile += wstride) {
    const bool second = tile >= per;
    const long long r0 = (second ? tile - per : tile) * 32;
    const int n = static_cast<int>(min(32LL, rows - r0));
    if (!staged) tile_in<T, TT, kStride>(b, (second ? m1 : m0) + r0 * TT, n, lane);
    staged = false;
    __syncwarp();
    // forward substitution L·y = m[perm] on this lane's row
    T v[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) v[j] = b[lane * kStride + sperm[j]];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      T acc = v[j];
#pragma unroll
      for (int i = 0; i < j; ++i) acc -= v[i] * sl[j * kStride + i];
      v[j] = acc / sl[j * kStride + j];
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) b[lane * kStride + j] = v[j] * smask[j];
    __syncwarp();
    tile_out<T, TT, kStride>((second ? y1 : y0) + r0 * TT, b, n, lane);
    __syncwarp();  // the tile is read out before the next one lands
  }
}

// One warp, a lane per direction (row of c): t <= 32 directions scored over
// k <= 32 coefficients each.  The live directions are live[0..t) when the
// caller passes that mask (s-step's carried seed mask, which may have
// holes), else the first rank (the pivoted factorization's, whose dead
// directions are the trailing ones).
template <typename T>
__global__ void __launch_bounds__(32) drop_mask_kernel(
    const T* __restrict__ c, long long ldc, int k, int t, const int* __restrict__ rank,
    const unsigned char* __restrict__ live_in, T rn, T tau, int min_t, T* __restrict__ mask,
    T* __restrict__ counts) {
  const int lane = threadIdx.x;
  const int r = *rank;
  const bool live = lane < t && (live_in ? live_in[lane] != 0 : lane < r);
  bool keep = live;
  if (tau != T(0)) {
    // direction i's share of the A-norm error drop, ‖c_{i,:}‖², against τ²·rn²
    T score = T(0);
    if (lane < t) {
      for (int j = 0; j < k; ++j) {
        const T x = c[lane * ldc + j];
        score = add_rn(score, mul_rn(x, x));
      }
    }
    const bool stagnant = score <= mul_rn(mul_rn(mul_rn(tau, tau), rn), rn);
    const int max_drops = max(__popc(__ballot_sync(kFull, live)) - min_t, 0);
    // the direction's place in a stable ascending sort of the live scores
    const T key = live ? score : inf<T>();
    int pos = 0;
    for (int j = 0; j < t; ++j) {
      const T kj = __shfl_sync(kFull, key, j);
      pos += j != lane && (sorts_before(kj, key) || (!sorts_before(key, kj) && j < lane));
    }
    keep = live && !(stagnant && pos < max_drops);
  }
  const int n_active = __popc(__ballot_sync(kFull, keep));
  if (lane < t) mask[lane] = keep ? T(1) : T(0);
  if (lane == 0) {
    counts[0] = static_cast<T>(r);
    counts[1] = static_cast<T>(n_active);
  }
}

template <typename T, int TT>
int launch_rank_t(const void* g, const void* m0, void* y0, const void* m1, void* y1,
                  long long rows, double rtol, void* rank, void* perm, void* stream) {
  auto kernel = rank_apply_kernel<T, TT>;
  constexpr size_t smem = RankSmem<T, TT>::kBytes;
  // opt in to the dynamic shared memory above 48 KB, then ask for the
  // resident CTAs per SM at that size; both once per instance
  static const cudaError_t opt_in =
      smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(smem))
                       : cudaSuccess;
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  static const int per_sm = [&] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, repro::kThreads, smem) ==
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
  // at least one CTA: it writes rank and perm even for an empty block
  const long long grid = std::max(1LL, std::min(repro::cdiv(warps, repro::kThreads / 32),
                                                static_cast<long long>(sms) * per_sm));
  kernel<<<static_cast<unsigned>(grid), repro::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(m0), static_cast<T*>(y0),
      static_cast<const T*>(m1), static_cast<T*>(y1), rows, nmat, static_cast<T>(rtol),
      static_cast<int*>(rank), static_cast<int*>(perm));
  return repro::launch_status();
}

template <typename T>
int launch_rank(const void* g, const void* m0, void* y0, const void* m1, void* y1, long long rows,
                int t, double rtol, void* rank, void* perm, void* stream) {
  if (rows < 0 || (m1 == nullptr) != (y1 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  switch (t) {
#define REPRO_RANK_T(TT) \
  case TT: return launch_rank_t<T, TT>(g, m0, y0, m1, y1, rows, rtol, rank, perm, stream);
    REPRO_RANK_T(1) REPRO_RANK_T(2) REPRO_RANK_T(3) REPRO_RANK_T(4)
    REPRO_RANK_T(5) REPRO_RANK_T(6) REPRO_RANK_T(7) REPRO_RANK_T(8)
    REPRO_RANK_T(9) REPRO_RANK_T(10) REPRO_RANK_T(11) REPRO_RANK_T(12)
    REPRO_RANK_T(13) REPRO_RANK_T(14) REPRO_RANK_T(15) REPRO_RANK_T(16)
    REPRO_RANK_T(17) REPRO_RANK_T(18) REPRO_RANK_T(19) REPRO_RANK_T(20)
    REPRO_RANK_T(21) REPRO_RANK_T(22) REPRO_RANK_T(23) REPRO_RANK_T(24)
    REPRO_RANK_T(25) REPRO_RANK_T(26) REPRO_RANK_T(27) REPRO_RANK_T(28)
    REPRO_RANK_T(29) REPRO_RANK_T(30) REPRO_RANK_T(31) REPRO_RANK_T(32)
#undef REPRO_RANK_T
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_drop(const void* c, long long ldc, int k, const void* rank, const void* live, double rn,
                double tau, int min_t, int t, void* mask, void* counts, void* stream) {
  if (t < 1 || t > 32 || k < 1 || k > 32 || ldc < k) return static_cast<int>(cudaErrorInvalidValue);
  drop_mask_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), ldc, k, t, static_cast<const int*>(rank),
      static_cast<const unsigned char*>(live), static_cast<T>(rn), static_cast<T>(tau), min_t,
      static_cast<T*>(mask), static_cast<T*>(counts));
  return repro::launch_status();
}

}  // namespace

// g: (t, t) Gram matrix; m0, y0 and (when m1 is not null) m1, y1: (rows, t)
// row-major; rank: one int32, perm: t int32 (written by CTA 0); 1 <= t <= 32.
REPRO_EXPORT int rank_apply_f32(const void* g, const void* m0, void* y0, const void* m1, void* y1,
                                long long rows, int t, double rtol, void* rank, void* perm,
                                void* stream) {
  return launch_rank<float>(g, m0, y0, m1, y1, rows, t, rtol, rank, perm, stream);
}

REPRO_EXPORT int rank_apply_f64(const void* g, const void* m0, void* y0, const void* m1, void* y1,
                                long long rows, int t, double rtol, void* rank, void* perm,
                                void* stream) {
  return launch_rank<double>(g, m0, y0, m1, y1, rows, t, rtol, rank, perm, stream);
}

// c: (t, k) with row stride ldc; rank: one int32 (rank_apply's); live: t
// bytes (nonzero = live) or null for the first rank; mask: t values,
// counts: [rank, active count]; 1 <= t, k <= 32.
REPRO_EXPORT int drop_mask_f32(const void* c, long long ldc, int k, const void* rank,
                               const void* live, double rn, double tau, int min_t, int t,
                               void* mask, void* counts, void* stream) {
  return launch_drop<float>(c, ldc, k, rank, live, rn, tau, min_t, t, mask, counts, stream);
}

REPRO_EXPORT int drop_mask_f64(const void* c, long long ldc, int k, const void* rank,
                               const void* live, double rn, double tau, int min_t, int t,
                               void* mask, void* counts, void* stream) {
  return launch_drop<double>(c, ldc, k, rank, live, rn, tau, min_t, t, mask, counts, stream);
}

REPRO_ERROR_STRING(chol_apply)
