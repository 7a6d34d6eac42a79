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
// 0.401 ms at t = 16, 0.501 ms at t = 20, 0.801 ms at t = 32.  The flops,
// 5.4e9 multiply-adds at t = 32, take ~0.16 ms on the f64 tensor cores.
//
// Design, float64 at t >= kMmaMinT (the mma kernel): the work is three
// tall-skinny products over row tiles, P·c, AP·c and [P | P_old]·[d ; d_old].
// A persistent grid (one wave of CTAs) walks tiles of kTileRows rows with a
// grid stride.  A tile of a row-major (n, t) block is one contiguous span,
// which the CTA copies into shared memory with cp.async (16 bytes a copy
// where t is even and every block 16-byte aligned, else 8), kStages tiles in
// flight: the copy of tile i + kStages − 1 is issued before tile i is
// computed.  Staged rows are ls = tail_ls(t) values long, ls ≡ 4 (mod 8),
// and the columns past t are zero: an mma A fragment (8 rows × 4 columns)
// then touches 16 distinct bank pairs in each half-warp, and the k loop
// needs no mask.  c, d and d_old are staged once a CTA in the mma's B
// fragment order (zero past t), so a lane reads its B value with one
// conflict-free load.  Each warp owns 8-row m-tiles and all cdiv(t, 8)
// n-tiles of the three outputs, with three accumulators per n-tile (P·c,
// AP·c, and P·d then P_old·d_old into the same one), and runs
// repro::mma_f64 (m8n8k4) over k = 0, 4, 8, ....  A lane's D fragment is
// two consecutive columns of one row: it loads X and R with one 16-byte
// load per n-tile before the k loop, takes AP for Z' from the staged tile
// (AP is read from device memory once), and stores 16 bytes per n-tile and
// output.
//
// The constants are the fastest of the variants of tools/kernel_variants.py
// timed on the H100 (PERF.md §6 has the times).  All eight warps issue the
// copies and the first kTileRows / 8 compute: the 8-byte copies of odd
// widths want the issue rate of eight.  Four stages beat two only at 32
// columns, where the tiles leave room for one CTA an SM.  X and R staged
// with the tile, and CUDA-core FMAs in place of the tensor cores, were
// slower at every width from 9.  At t <= 8 one thread an element is faster,
// so kMmaMinT = 9.
//
// Design, float64 at t < kMmaMinT and float32 at every width (the element
// kernel): row-parallel, one thread per output element (row, j),
// consecutive threads on consecutive elements so the row-major loads and
// stores of a warp coalesce; the t values of P, AP and P_old on a row come
// from L1, c, d and d_old from shared memory.  Above t = 8 that on-chip
// traffic, not the bytes, bounds it; in float32 it still beats a
// register-tiled kernel (a thread owning 4 rows × 2 columns) at every width
// from 17 to 32 (PERF.md §6).
//
// Order of sums: both kernels sum in a fixed order without atomics, so
// two calls on the same inputs give the same bits.  The element kernel
// sums over m = 0..t-1 in order, as the plain version's products do, and
// once matched it bit for bit; the mma kernel's sums run in the
// tensor cores' order (and Z's two products into one accumulator), so it
// no longer equals the plain version to the last bit.  It is held to the
// forward error bound of a (2t + 1)-term sum, 2·(2t + 1)·eps·Σ|terms|.

#include <algorithm>
#include <cstdint>
#include <type_traits>

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

constexpr int kMmaMinT = 9;     // float64 widths that take the mma kernel
constexpr int kTileRows = 32;   // rows of one staged tile (a multiple of 8)
constexpr int kStages = 4;      // tiles a CTA has in flight
constexpr int kMmaWarps = 8;    // warps a CTA of the mma kernel (all copy; kTileRows / 8 compute)
constexpr int kMmaThreads = 32 * kMmaWarps;

// Values in one staged row: the least ls >= 4·cdiv(t, 4) with ls ≡ 4 (mod 8),
// so the 4 rows of an A fragment's half-warp start 4 bank pairs apart.
__host__ __device__ constexpr int tail_ls(int t) { return (t + 3) / 8 * 8 + 4; }

// Dynamic shared memory of ecg_tail_mma_kernel<TT>: c, d and d_old in B
// fragment order (kFrag values each), then kStages stages of the P, AP and
// P_old tiles (kMat values each).
template <int TT>
struct TailSmem {
  static constexpr int KS = (TT + 3) / 4;  // k-steps of 4
  static constexpr int NT = (TT + 7) / 8;  // n-tiles of 8 columns
  static constexpr int LS = tail_ls(TT);
  static constexpr int kFrag = KS * NT * 32;
  static constexpr int kMat = kTileRows * LS;
  static constexpr int kStage = 3 * kMat;
  static constexpr size_t kBytes =
      (3 * static_cast<size_t>(kFrag) + kStages * static_cast<size_t>(kStage)) * sizeof(double);
};

// Issue the copies of tile ``tile`` of P, AP and P_old into ``dst`` (rows
// of LS values) and commit them as one group; a
// tile past the end commits an empty group, so every thread counts the same
// groups.
template <int TT>
__device__ __forceinline__ void stage_tile(double* dst, const double* __restrict__ p,
                                           const double* __restrict__ ap,
                                           const double* __restrict__ po, long long tile,
                                           long long tiles, long long n, bool vec) {
  using S = TailSmem<TT>;
  if (tile < tiles) {
    const long long row0 = tile * kTileRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kTileRows), n - row0));
    const double* src[3] = {p + row0 * TT, ap + row0 * TT, po + row0 * TT};
    if (TT % 2 == 0 && vec) {
      constexpr int per_row = TT / 2 > 0 ? TT / 2 : 1;  // 16-byte chunks a row
      const int chunks = rows * per_row;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        for (int i = threadIdx.x; i < chunks; i += kMmaThreads) {
          const int row = i / per_row, chunk = i - row * per_row;
          repro::cp_async<16>(dst + m * S::kMat + row * S::LS + 2 * chunk, src[m] + 2 * i);
        }
      }
    } else {
      const int elems = rows * TT;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        for (int i = threadIdx.x; i < elems; i += kMmaThreads) {
          const int row = i / TT, col = i - row * TT;
          repro::cp_async<8>(dst + m * S::kMat + row * S::LS + col, src[m] + i);
        }
      }
    }
  }
  repro::cp_async_commit();
}

// Two consecutive values of one row (columns col, col + 1), zero past t or
// for a row past n; one 16-byte load where ``vec``.
template <int TT>
__device__ __forceinline__ void load_pair(double (&v)[2], const double* __restrict__ a,
                                          long long row, int col, bool live, bool vec) {
  v[0] = v[1] = 0.0;
  if (!live || col >= TT) return;
  const double* src = a + row * TT + col;
  if (TT % 2 == 0 && vec) {
    const double2 w = *reinterpret_cast<const double2*>(src);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = src[0];
    if (col + 1 < TT) v[1] = src[1];
  }
}

template <int TT>
__global__ void __launch_bounds__(kMmaThreads) ecg_tail_mma_kernel(
    const double* __restrict__ x, const double* __restrict__ r, const double* __restrict__ p,
    const double* __restrict__ ap, const double* __restrict__ po,
    const double* __restrict__ c, const double* __restrict__ d,
    const double* __restrict__ d_old, double* __restrict__ xo, double* __restrict__ ro,
    double* __restrict__ zo, long long n, bool vec) {
  using S = TailSmem<TT>;
  constexpr int KS = S::KS, NT = S::NT, LS = S::LS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* frag = reinterpret_cast<double*>(smem_raw);  // c, d, d_old, kFrag values each
  double* stages = frag + 3 * S::kFrag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;

  // B fragments: value (k·NT + nt)·32 + l of a matrix is B[4k + l % 4][8nt + l / 4]
  for (int i = tid; i < 3 * S::kFrag; i += kMmaThreads) {
    const int mat = i / S::kFrag, f = i - mat * S::kFrag;
    const int kn = f / 32, l = f % 32;
    const int k = kn / NT, nt = kn - k * NT;
    const int row = 4 * k + (l & 3), col = 8 * nt + (l >> 2);
    const double* src = mat == 0 ? c : mat == 1 ? d : d_old;
    frag[i] = row < TT && col < TT ? src[row * TT + col] : 0.0;
  }
  // the staged rows' columns past t: zero once, the copies never write them
  if constexpr (LS > TT) {
    for (int i = tid; i < kStages * 3 * kTileRows * (LS - TT); i += kMmaThreads) {
      const int row = i / (LS - TT);
      stages[row * LS + TT + (i - row * (LS - TT))] = 0.0;
    }
  }
  // (the first __syncthreads of the tile loop orders these stores before any read)

  const long long tiles = repro::cdiv(n, kTileRows);
  const long long step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    stage_tile<TT>(stages + s * S::kStage, p, ap, po, blockIdx.x + s * step, tiles, n, vec);
  }
  int s = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += step) {
    const int ahead = (s + kStages - 1) % kStages;
    stage_tile<TT>(stages + ahead * S::kStage, p, ap, po, tile + (kStages - 1) * step, tiles, n,
                   vec);
    repro::cp_async_wait<kStages - 1>();  // this thread's copies of tile ``tile`` landed ...
    __syncthreads();                      // ... and every thread's
    const double* sp = stages + s * S::kStage;
    const double* sap = sp + S::kMat;
    const double* spo = sap + S::kMat;
    const long long row0 = tile * kTileRows;
    for (int mt = warp; mt < kTileRows / 8 && row0 + 8 * mt < n; mt += kMmaWarps) {
      const int srow = 8 * mt + g;  // this lane's row in the tile
      const long long row = row0 + srow;
      const bool live = row < n;
      double xv[NT][2], rv[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        load_pair<TT>(xv[nt], x, row, 8 * nt + 2 * q, live, vec);
        load_pair<TT>(rv[nt], r, row, 8 * nt + 2 * q, live, vec);
      }
      double ax[NT][2] = {}, ar[NT][2] = {}, az[NT][2] = {};
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int at = srow * LS + 4 * k + q;
        const double a_p = sp[at], a_ap = sap[at], a_po = spo[at];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const double* f = frag + (k * NT + nt) * 32 + lane;
          repro::mma_f64(ax[nt], a_p, f[0]);
          repro::mma_f64(ar[nt], a_ap, f[0]);
          repro::mma_f64(az[nt], a_p, f[S::kFrag]);
          repro::mma_f64(az[nt], a_po, f[2 * S::kFrag]);
        }
      }
      if (live) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = 8 * nt + 2 * q;
          if (col >= TT) continue;
          const long long e = row * TT + col;
          const double* apv = sap + srow * LS + col;
          if (TT % 2 == 0 && vec) {
            const double2 a2 = *reinterpret_cast<const double2*>(apv);
            *reinterpret_cast<double2*>(xo + e) =
                make_double2(xv[nt][0] + ax[nt][0], xv[nt][1] + ax[nt][1]);
            *reinterpret_cast<double2*>(ro + e) =
                make_double2(rv[nt][0] - ar[nt][0], rv[nt][1] - ar[nt][1]);
            *reinterpret_cast<double2*>(zo + e) = make_double2(a2.x - az[nt][0], a2.y - az[nt][1]);
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (col + j >= TT) break;
              xo[e + j] = xv[nt][j] + ax[nt][j];
              ro[e + j] = rv[nt][j] - ar[nt][j];
              zo[e + j] = apv[j] - az[nt][j];
            }
          }
        }
      }
    }
    __syncthreads();  // stage s is free for the copy issued next round
    s = (s + 1) % kStages;
  }
  repro::cp_async_wait<0>();  // no copy (of a tile past the end: none) outlives the CTA
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

template <int TT>
int launch_mma(const void* x, const void* r, const void* p, const void* ap, const void* po,
               const void* c, const void* d, const void* d_old, void* xo, void* ro, void* zo,
               long long n, bool vec, void* stream) {
  auto kernel = ecg_tail_mma_kernel<TT>;
  constexpr size_t smem = TailSmem<TT>::kBytes;
  // opt in to the dynamic shared memory, then ask for the resident CTAs
  // per SM at that size; both once per instance
  static const cudaError_t opt_in = repro::allow_smem(kernel, smem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  static const int per_sm = repro::ctas_per_sm(kernel, kMmaThreads, smem);
  int sms = 0;
  if (const int e = repro::multiprocessors(sms)) return e;
  const long long grid = std::min(repro::cdiv(n, kTileRows), static_cast<long long>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(grid), kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(r),
      static_cast<const double*>(p), static_cast<const double*>(ap),
      static_cast<const double*>(po), static_cast<const double*>(c),
      static_cast<const double*>(d), static_cast<const double*>(d_old),
      static_cast<double*>(xo), static_cast<double*>(ro), static_cast<double*>(zo), n, vec);
  return repro::launch_status();
}

template <typename T>
int launch(const void* x, const void* r, const void* p, const void* ap,
           const void* po, const void* c, const void* d, const void* d_old,
           void* xo, void* ro, void* zo, long long n, int t, void* stream) {
  if constexpr (std::is_same_v<T, double>) {
    if (t >= kMmaMinT) {
      const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
      const bool vec = t % 2 == 0 && aligned(x) && aligned(r) && aligned(p) && aligned(ap) &&
                       aligned(po) && aligned(xo) && aligned(ro) && aligned(zo);
      switch (t) {
#define REPRO_TAIL_T(TT) \
  case TT: return launch_mma<TT>(x, r, p, ap, po, c, d, d_old, xo, ro, zo, n, vec, stream);
        REPRO_TAIL_T(9) REPRO_TAIL_T(10) REPRO_TAIL_T(11) REPRO_TAIL_T(12)
        REPRO_TAIL_T(13) REPRO_TAIL_T(14) REPRO_TAIL_T(15) REPRO_TAIL_T(16)
        REPRO_TAIL_T(17) REPRO_TAIL_T(18) REPRO_TAIL_T(19) REPRO_TAIL_T(20)
        REPRO_TAIL_T(21) REPRO_TAIL_T(22) REPRO_TAIL_T(23) REPRO_TAIL_T(24)
        REPRO_TAIL_T(25) REPRO_TAIL_T(26) REPRO_TAIL_T(27) REPRO_TAIL_T(28)
        REPRO_TAIL_T(29) REPRO_TAIL_T(30) REPRO_TAIL_T(31) REPRO_TAIL_T(32)
#undef REPRO_TAIL_T
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
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
