// Block-ELL sparse matrix times block vector, W = A·V, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bsr_spmbv/kernel.py::bsr_spmbv_pallas.
//
// Layout: blocks (nbr, kmax, br, bc) dense tiles, indices (nbr, kmax) int32
// block-column ids (padding tiles are zero and carry column 0), V (n_v, t)
// row-major, W (n_w, t) row-major.  W[i·br + r, j] = Σ_k Σ_c
// blocks[i, k, r, c] · V[indices[i, k]·bc + c, j].  Rows of V at or past n_v
// read as zero, so the caller never builds a padded copy of V; rows of W at or
// past n_w are neither computed nor written.
//
// What bounds it on the H100: bytes.  At Example 2.1's full scale (nbr =
// 163 840, kmax = 10, 8x8 f64 tiles, t = 8) the tiles alone are 839 MB
// against 2·t·nnz_stored ≈ 1.7 GFLOP, far below the f64 tensor-core line, so
// the floor is one pass over the tiles plus V and W (~1.0 GB, ~0.30 ms at
// 3.35 TB/s).  What keeps a kernel from that floor is too few bytes in
// flight, barriers between load rounds, and on-chip traffic: a design that
// stages tiles in shared memory and reads two shared values per multiply-add
// moves an order of magnitude more bytes through shared memory than it
// reads from HBM.
//
// Design.  The TPU kernel walks a sequential (nbr, kmax) grid with the output
// tile resident in VMEM.  Here a persistent grid of 4-warp CTAs walks the
// block rows by a stride, one warp per block row, with no shared memory and
// no barrier.  Two paths, chosen by the wrapper from the shape
// (``kernels/bsr_spmbv/ops.py`` ``spmbv_plan``):
//
// * mma (float64, br ∈ {8, 16}, bc ∈ {4, 8, 16}, t ≤ 32, 16-byte aligned
//   tiles): the product runs on the f64 tensor cores,
//   mma.sync.m8n8k4 (A = an 8x4 slice of a tile, B = a 4x8 slice of V).
//   The depth index is permuted so that lane q's S = bc/4 depth values are
//   contiguous in the tile row: lane (g, q) of m-tile m loads
//   tile[8m + g][q·S .. q·S + S) as one 16-byte vector (S = 2; a warp reads
//   the whole 512-byte 8x8 tile in one instruction) and the matching V
//   values V[col·bc + q·S + s][8n + g].  The warp loads the row's column
//   ids once (one lane each, then __shfl_sync) and issues every tile and V
//   load of up to KU slots (all 10 at Example 2.1) before the first mma, so
//   ~40 independent loads per lane are in flight (KU falls as the NT =
//   cdiv(t, 8) column tiles grow, so that a lane holds ~40 loaded values:
//   KU = 10, 5 and 4 slots at NT = 1, 3 and 4 on 8x8 tiles).  Tiles are
//   read once and are loaded streaming (ld.global.cs), so that V, which
//   neighbouring block rows gather again, stays in L2.  Each lane ends with
//   two outputs per (m, n) tile, stored as one 16-byte write when t is even.
// * fma (float32, and shapes the mma tiling does not take): one thread per
//   output row, all t (≤ 32) sums in registers; each tile value is loaded
//   once into a register and used for t multiply-adds, and the br threads of
//   a block row share the V row through L1.
//
// Each output sums over k, then over the tile's columns, in a fixed order;
// there are no atomics, so the result is bit-identical from call to call.

#include "common.cuh"

namespace {

constexpr int kMmaWarps = 4;  // warps (block rows in flight) per CTA
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kFmaThreads = 256;

template <int S>
__device__ __forceinline__ void load_streaming(double (&dst)[S], const double* src) {
  if constexpr (S == 1) {
    dst[0] = __ldcs(src);
  } else {
#pragma unroll
    for (int i = 0; i < S; i += 2) {
      const double2 x = __ldcs(reinterpret_cast<const double2*>(src + i));
      dst[i] = x.x;
      dst[i + 1] = x.y;
    }
  }
}

// br = 8·MT, bc = 4·S, t ≤ 8·NT; KU tile slots are loaded before their mmas.
template <int MT, int S, int NT>
__global__ void __launch_bounds__(kMmaThreads, 4) bsr_spmbv_mma(
    const double* __restrict__ blocks, const int* __restrict__ indices,
    const double* __restrict__ v, double* __restrict__ w, long long nbr, int kmax,
    int t, long long n_v, long long n_w) {
  constexpr int BR = 8 * MT, BC = 4 * S;
  // values a lane loads before its mmas: 40, or 32 where the accumulators
  // take 16 (MT·NT = 8; at 40 the 16x8 tile's instance spilled)
  constexpr int kLoads = MT * NT >= 8 ? 32 : 40;
  constexpr int KU = (MT + NT) * S > kLoads ? 1 : kLoads / ((MT + NT) * S);
  static_assert(KU <= 32, "one lane loads each column id of a chunk");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long rows = min(nbr, repro::cdiv(n_w, BR));  // block rows with an output
  const long long warps = static_cast<long long>(gridDim.x) * kMmaWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kMmaWarps + (threadIdx.x >> 5);
       row < rows; row += warps) {
    double acc[MT][NT][2] = {};
    for (int kb = 0; kb < kmax; kb += KU) {
      const int kn = min(KU, kmax - kb);
      const int my_col = lane < kn ? __ldg(indices + row * kmax + kb + lane) : 0;
      double a[KU][MT][S], b[KU][NT][S];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const long long vrow0 = static_cast<long long>(__shfl_sync(0xffffffffu, my_col, u)) * BC + q * S;
        if (u < kn) {  // the same for every lane of the warp
          const double* tile = blocks + (row * kmax + kb + u) * (BR * BC);
#pragma unroll
          for (int m = 0; m < MT; ++m) load_streaming<S>(a[u][m], tile + (8 * m + g) * BC + q * S);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int j = 8 * nt + g;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const long long vr = vrow0 + s;
              b[u][nt][s] = (vr < n_v && j < t) ? __ldg(v + vr * t + j) : 0.0;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (u < kn) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int s = 0; s < S; ++s) repro::mma_f64(acc[m][nt], a[u][m][s], b[u][nt][s]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const long long orow = row * BR + 8 * m + g;
      if (orow >= n_w) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = 8 * nt + 2 * q;
        double* dst = w + orow * t + j;
        if ((t & 1) == 0 && j + 1 < t) {
          *reinterpret_cast<double2*>(dst) = make_double2(acc[m][nt][0], acc[m][nt][1]);
        } else {
          if (j < t) dst[0] = acc[m][nt][0];
          if (j + 1 < t) dst[1] = acc[m][nt][1];
        }
      }
    }
  }
}

// one thread per output row o = i·br + r, its t ≤ TM sums in registers
template <typename T, int TM>
__global__ void __launch_bounds__(kFmaThreads) bsr_spmbv_fma(
    const T* __restrict__ blocks, const int* __restrict__ indices,
    const T* __restrict__ v, T* __restrict__ w, long long nbr, int kmax, int br,
    int bc, int t, long long n_v, long long n_w) {
  const long long total = min(nbr * br, n_w);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const long long row = o / br;
    const int r = static_cast<int>(o - row * br);
    T acc[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[j] = T(0);
    for (int k = 0; k < kmax; ++k) {
      const long long v0 = static_cast<long long>(__ldg(indices + row * kmax + k)) * bc;
      const T* a = blocks + ((row * kmax + k) * br + r) * bc;
      const int cn = static_cast<int>(max(0LL, min(static_cast<long long>(bc), n_v - v0)));
      for (int c = 0; c < cn; ++c) {  // rows of V at or past n_v are zero
        const T av = __ldcs(a + c);
        const T* x = v + (v0 + c) * t;
#pragma unroll
        for (int j = 0; j < TM; ++j)
          if (j < t) acc[j] += av * __ldg(x + j);
      }
    }
#pragma unroll
    for (int j = 0; j < TM; ++j)
      if (j < t) w[o * t + j] = acc[j];
  }
}

struct Args {
  const void* blocks;
  const void* indices;
  const void* v;
  void* w;
  long long nbr;
  int kmax, br, bc, t;
  long long n_v, n_w;
  int grid;
  cudaStream_t stream;
};

template <int MT, int S, int NT>
int launch_mma(const Args& a) {
  bsr_spmbv_mma<MT, S, NT><<<a.grid, kMmaThreads, 0, a.stream>>>(
      static_cast<const double*>(a.blocks), static_cast<const int*>(a.indices),
      static_cast<const double*>(a.v), static_cast<double*>(a.w), a.nbr, a.kmax, a.t,
      a.n_v, a.n_w);
  return repro::launch_status();
}

// NT = cdiv(t, 8) column tiles of 8
template <int MT, int S>
int launch_mma_nt(const Args& a) {
  switch ((a.t + 7) / 8) {
    case 1: return launch_mma<MT, S, 1>(a);
    case 2: return launch_mma<MT, S, 2>(a);
    case 3: return launch_mma<MT, S, 3>(a);
    default: return launch_mma<MT, S, 4>(a);
  }
}

template <int MT>
int launch_mma_s(const Args& a) {
  switch (a.bc) {
    case 4: return launch_mma_nt<MT, 1>(a);
    case 8: return launch_mma_nt<MT, 2>(a);
    case 16: return launch_mma_nt<MT, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_fma(const Args& a) {
  auto* kernel = a.t <= 8 ? bsr_spmbv_fma<T, 8> : a.t <= 16 ? bsr_spmbv_fma<T, 16>
                                                           : bsr_spmbv_fma<T, 32>;
  kernel<<<a.grid, kFmaThreads, 0, a.stream>>>(
      static_cast<const T*>(a.blocks), static_cast<const int*>(a.indices),
      static_cast<const T*>(a.v), static_cast<T*>(a.w), a.nbr, a.kmax, a.br, a.bc,
      a.t, a.n_v, a.n_w);
  return repro::launch_status();
}

}  // namespace

// use_mma selects the tensor-core path (float64 only); grid is the number of
// CTAs (kMmaThreads or kFmaThreads threads each), both from the wrapper's plan.
REPRO_EXPORT int bsr_spmbv_f32(const void* blocks, const void* indices,
                               const void* v, void* w, long long nbr, int kmax,
                               int br, int bc, int t, long long n_v,
                               long long n_w, int use_mma, int grid, void* stream) {
  if (use_mma || t < 1 || t > 32) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{blocks, indices, v, w, nbr, kmax, br, bc, t, n_v, n_w, grid,
               static_cast<cudaStream_t>(stream)};
  return launch_fma<float>(a);
}

REPRO_EXPORT int bsr_spmbv_f64(const void* blocks, const void* indices,
                               const void* v, void* w, long long nbr, int kmax,
                               int br, int bc, int t, long long n_v,
                               long long n_w, int use_mma, int grid, void* stream) {
  if (t < 1 || t > 32) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{blocks, indices, v, w, nbr, kmax, br, bc, t, n_v, n_w, grid,
               static_cast<cudaStream_t>(stream)};
  if (!use_mma) return launch_fma<double>(a);
  switch (br) {
    case 8: return launch_mma_s<1>(a);
    case 16: return launch_mma_s<2>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_ERROR_STRING(bsr_spmbv)
