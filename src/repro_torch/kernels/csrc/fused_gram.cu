// Fused ECG block inner products for Hopper (sm_90a):
// out = [PᵀR | APᵀAP | AP_oldᵀAP], a (t, 3t) matrix, in one pass over the rows,
// for each of ``ranks`` stacked row blocks at once.
//
// Replaces src/repro/kernels/fused_gram/kernel.py::fused_gram_pallas.
//
// Layout: P, R, AP, AP_old are (ranks, n, t) row-major; out is (ranks, t, 3t)
// row-major, out[k, a, s·t + b] = Σ_rows X_s[k, row, a] · Y_s[k, row, b] with
// (X_0, Y_0) = (P, R), (X_1, Y_1) = (AP, AP), (X_2, Y_2) = (AP_old, AP).
// ranks = 1 is the single-device product; ranks = p gives the local halves
// of the distributed solver's gram2 for every rank of a virtual mesh, which
// the mesh then sums (one psum, as the reference's shard_map does).
//
// What bounds it on the H100: bytes.  It reads 4·n·t values and does
// 6·n·t² flops (t ≤ 32), far below the compute line; at Example 2.1's full
// scale (n = 1 310 720, t = 8, f64) the floor is the 336 MB read, ~0.10 ms
// (0.250 ms at t = 20, 0.401 ms at t = 32).
// A kernel reaches it only with enough loads in flight and no on-chip
// traffic per multiply-add; a design that stages rows in shared memory
// behind barriers and reads two shared values per multiply-add does not.
//
// Design: the Pallas kernel carries the (t, 3t) sum across its sequential
// grid in VMEM.  Hopper's CTAs run in no order, so the sum is split in two
// launches, both in a fixed order and without atomics, so the result is
// bit-identical from call to call.  Pass 1 is a (parts, ranks) grid of
// CTAs, about four per SM in all (``kernels/fused_gram/ops.py``
// ``gram_plan``); CTA (x, y) owns a contiguous row range of rank y, whose
// values start at element y·n·t of each operand (an offset of the base
// pointers, once per CTA: there is no separate single-rank kernel).
//
// * mma path (float64): the products run on the f64 tensor cores,
//   mma.sync.m8n8k4, with the rows as the depth.  For XᵀY over four rows
//   lane (g = lane/4, q = lane%4) holds A = Xᵀ[g][q] = X[row + q][g] and
//   B = Y[row + q][g]: the same address, a coalesced 256-byte warp-load at
//   t = 8.  So per four rows a lane loads one value each of P, R, AP and
//   AP_old and issues three mmas (PᵀR, APᵀAP with one register as A and B,
//   AP_oldᵀAP); t ≤ 8·MT takes an MT x MT set of 8x8 tiles per product
//   (MT = cdiv(t, 8) ≤ 4) and the columns past t load zeros.  Each warp of
//   a 4-warp CTA holds all 3·MT² tiles, loads U four-row steps before their
//   mmas and walks the CTA's rows by 4 warps·4U: U = 8, 4, 2 at MT = 1, 2,
//   3, and 1 at MT = 4, where the 96 accumulator pairs and one step's 16
//   loads take 250 registers a lane.  (Splitting the MT = 4 tiles among the
//   warps, each then reading R and AP again from L1, ran at 44-61% of the
//   bound on the H100; this at 78%.)
// * fma path (float32, since the f32 tensor-core mma would round to TF32):
//   each thread owns a 4x4 tile of one product, loads 4 + 4 row values into
//   registers per row and does 16 multiply-adds with them; groups of
//   threads take the rows in turn.  It accumulates in float64 (the f64
//   multiply-adds cost nothing against the bytes), so its long per-thread
//   sums stay within the plain float32 product's accuracy.
//
// Each CTA sums its warps' (or groups') accumulators in a fixed order
// (for the mma path warp after warp into one shared buffer, between
// barriers, so the buffer is one warp's 3·MT²·2 values a lane) and writes
// one float64 partial per output.  Pass 2
// sums each output's `parts` partials (one per pass-1 CTA of the rank,
// stored contiguously): one warp per output, lanes over the partials in
// order, then a fixed warp-shuffle tree.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kFmaThreads = 256;
constexpr int kReduceWarps = 8;

// partial of output o of CTA (part, rank): partials[(rank·n_out + o)·parts + part]
__device__ __forceinline__ long long partial_at(int o, int n_out) {
  return (static_cast<long long>(blockIdx.y) * n_out + o) * gridDim.x + blockIdx.x;
}

// MT = cdiv(t, 8): an MT x MT set of 8x8 tiles per product
template <int MT>
__global__ void __launch_bounds__(kMmaThreads) fused_gram_mma(
    const double* __restrict__ p, const double* __restrict__ r,
    const double* __restrict__ ap, const double* __restrict__ apo,
    double* __restrict__ partials, long long n, int t, long long rows_per_part) {
  constexpr int U = MT < 4 ? 8 / MT : 1;  // four-row steps loaded before their mmas
  constexpr int E = 3 * MT * MT * 2;      // accumulator values per lane
  __shared__ double red[E][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long first = static_cast<long long>(blockIdx.y) * n * t;
  p += first;
  r += first;
  ap += first;
  apo += first;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long end = min(n, begin + rows_per_part);

  double acc[3][MT][MT][2] = {};
  for (long long base = begin + warp * 4 * U; base < end; base += kMmaWarps * 4 * U) {
    double xp[U][MT], xr[U][MT], xa[U][MT], xo[U][MT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + 4 * u + q;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int col = 8 * m + g;
        const bool ok = row < end && col < t;
        const long long i = row * t + col;
        xp[u][m] = ok ? __ldg(p + i) : 0.0;
        xr[u][m] = ok ? __ldg(r + i) : 0.0;
        xa[u][m] = ok ? __ldg(ap + i) : 0.0;
        xo[u][m] = ok ? __ldg(apo + i) : 0.0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < MT; ++ni) {
          repro::mma_f64(acc[0][mi][ni], xp[u][mi], xr[u][ni]);
          repro::mma_f64(acc[1][mi][ni], xa[u][mi], xa[u][ni]);
          repro::mma_f64(acc[2][mi][ni], xo[u][mi], xa[u][ni]);
        }
  }

  // the CTA's partial: the warps' fragments summed in warp order, each warp
  // in turn between barriers
#pragma unroll 1
  for (int w = 0; w < kMmaWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < MT; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              double& slot = red[((s * MT + mi) * MT + ni) * 2 + h][lane];
              slot = w == 0 ? acc[s][mi][ni][h] : slot + acc[s][mi][ni][h];
            }
    }
    __syncthreads();
  }
  const int n_out = 3 * t * t;
  for (int i = threadIdx.x; i < E * 32; i += kMmaThreads) {
    const int e = i >> 5, l = i & 31;
    const int h = e & 1, ni = (e >> 1) % MT, mi = (e >> 1) / MT % MT, s = (e >> 1) / (MT * MT);
    const int a = 8 * mi + (l >> 2), b = 8 * ni + 2 * (l & 3) + h;
    if (a < t && b < t) partials[partial_at(a * 3 * t + s * t + b, n_out)] = red[e][l];
  }
}

template <typename T>
__global__ void __launch_bounds__(kFmaThreads) fused_gram_fma(
    const T* __restrict__ p, const T* __restrict__ r, const T* __restrict__ ap,
    const T* __restrict__ apo, double* __restrict__ partials, long long n, int t,
    long long rows_per_part) {
  constexpr int kRows = 4;  // rows loaded before their multiply-adds
  __shared__ double red[kFmaThreads][16];
  const int ta = (t + 3) / 4, tiles = 3 * ta * ta, groups = kFmaThreads / tiles;
  const int grp = threadIdx.x / tiles, tile = threadIdx.x % tiles;
  const int s = tile / (ta * ta), a0 = tile / ta % ta * 4, b0 = tile % ta * 4;
  const long long first = static_cast<long long>(blockIdx.y) * n * t;
  const T* x = (s == 0 ? p : (s == 1 ? ap : apo)) + first;
  const T* y = (s == 0 ? r : ap) + first;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long end = min(n, begin + rows_per_part);

  double acc[4][4] = {};
  if (grp < groups) {
    for (long long row0 = begin + grp; row0 < end; row0 += kRows * groups) {
      T xv[kRows][4], yv[kRows][4];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const long long row = row0 + k * groups;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[k][i] = row < end && a0 + i < t ? __ldg(x + row * t + a0 + i) : T(0);
          yv[k][i] = row < end && b0 + i < t ? __ldg(y + row * t + b0 + i) : T(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += static_cast<double>(xv[k][i]) * static_cast<double>(yv[k][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[threadIdx.x][i * 4 + j] = acc[i][j];
  __syncthreads();
  // the CTA's partial: the groups' tiles summed in group order
  const int n_out = 3 * t * t;
  for (int o = threadIdx.x; o < n_out; o += kFmaThreads) {
    const int a = o / (3 * t), so = o % (3 * t) / t, b = o % t;
    const int tl = (so * ta + a / 4) * ta + b / 4, e = (a % 4) * 4 + b % 4;
    double sum = red[tl][e];
    for (int gi = 1; gi < groups; ++gi) sum += red[gi * tiles + tl][e];
    partials[partial_at(o, n_out)] = sum;
  }
}

// out[rank, o] = Σ_part partials[rank, o, part], one warp per output
template <typename T>
__global__ void __launch_bounds__(32 * kReduceWarps) fused_gram_reduce(
    const double* __restrict__ partials, T* __restrict__ out, int parts, int n_out) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kReduceWarps + (threadIdx.x >> 5);
  if (o >= n_out) return;  // the whole warp
  const long long at = static_cast<long long>(blockIdx.y) * n_out + o;
  const double* src = partials + at * parts;
  double sum = 0.0;
  for (int k = lane; k < parts; k += 32) sum += src[k];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
  if (lane == 0) out[at] = static_cast<T>(sum);
}

// float64 takes the mma pass 1, float32 the fma one
template <typename T>
int launch(const void* p, const void* r, const void* ap, const void* apo, void* partials,
           void* out, int ranks, long long n, int t, int parts, long long rows_per_part,
           void* stream) {
  if (t < 1 || t > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(parts, ranks);
  const T *tp = static_cast<const T*>(p), *tr = static_cast<const T*>(r);
  const T *tap = static_cast<const T*>(ap), *tapo = static_cast<const T*>(apo);
  double* part = static_cast<double*>(partials);
  if constexpr (std::is_same_v<T, double>) {
    auto* kernel = t <= 8    ? fused_gram_mma<1>
                   : t <= 16 ? fused_gram_mma<2>
                   : t <= 24 ? fused_gram_mma<3>
                             : fused_gram_mma<4>;
    kernel<<<grid, kMmaThreads, 0, s>>>(tp, tr, tap, tapo, part, n, t, rows_per_part);
  } else {
    fused_gram_fma<T><<<grid, kFmaThreads, 0, s>>>(tp, tr, tap, tapo, part, n, t, rows_per_part);
  }
  const int status = repro::launch_status();
  if (status != 0) return status;
  const int n_out = 3 * t * t;
  fused_gram_reduce<T><<<dim3(repro::cdiv(n_out, kReduceWarps), ranks), 32 * kReduceWarps, 0, s>>>(
      part, static_cast<T*>(out), parts, n_out);
  return repro::launch_status();
}

}  // namespace

// parts pass-1 CTAs per rank, each owning rows_per_part rows; partials holds
// ranks·3t²·parts float64 values.  Both from the wrapper's plan.
REPRO_EXPORT int fused_gram_f32(const void* p, const void* r, const void* ap,
                                const void* apo, void* partials, void* out,
                                int ranks, long long n, int t, int parts,
                                long long rows_per_part, void* stream) {
  return launch<float>(p, r, ap, apo, partials, out, ranks, n, t, parts,
                       rows_per_part, stream);
}

REPRO_EXPORT int fused_gram_f64(const void* p, const void* r, const void* ap,
                                const void* apo, void* partials, void* out,
                                int ranks, long long n, int t, int parts,
                                long long rows_per_part, void* stream) {
  return launch<double>(p, r, ap, apo, partials, out, ranks, n, t, parts,
                        rows_per_part, stream);
}

REPRO_ERROR_STRING(fused_gram)
