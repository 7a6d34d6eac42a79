// Batched block-Cholesky solve for Hopper (sm_90a): for every diagonal
// block i, solve L[i] L[i]ᵀ y[i] = x[i] (the block-Jacobi apply).
//
// Replaces src/repro/kernels/block_trisolve/kernel.py::block_trisolve_pallas.
//
// Layout: l (nb, bs, bs) row-major lower factors, in x's dtype.  x and y are
// (ranks·rmax, t) row-major: ``ranks`` consecutive ranges of rmax rows, one
// per rank of the virtual mesh (ranks = 1 sequentially).  Each rank's range
// is cut into nb_rank = nb / ranks blocks of bs rows; block g = r·nb_rank + i
// covers the rank's rows i·bs .. i·bs + bs - 1.  Rows at or past rmax inside
// a rank (its last block when bs does not divide rmax) read as zero and are
// not written, so the caller never builds a padded copy of x: with identity
// factors on those padding rows the result there is zero, as the reference's
// padded apply gives.
//
// What bounds it on the H100: bytes.  The factor tiles dominate: at the
// full-scale main path (nb = 81 920, bs = 16, t = 8, float64) they are
// 168 MB, plus 84 MB each for x and y, ~0.100 ms at 3.35 TB/s, against
// 2·nb·t·bs² ≈ 0.34 GFLOP (~0.005 ms at 67 TFLOP/s).  At bs = 32 the bound
// is 0.150 ms, at bs = 64 0.250 ms.
//
// Design: a warp per diagonal block, the lane as the row.  Up to bs = 32 a
// lane owns one row of its block (at bs ≤ 16 a warp takes 32/seg blocks,
// seg = bs rounded up to 8 or 16, and each shuffle is segmented per block);
// at bs = 33..64 a lane owns rows lane and lane + 32.  Each lane holds its
// rows' t right-hand-side values in registers.  Both substitutions are
// right-looking: at step i the lane that owns row i has every update of
// that row; it broadcasts its t values with __shfl_sync and every row still
// open does t independent multiply-adds with one factor,
// acc_j −= (L[j,i]/L[i,i])·acc_i (forward, the rows below i, column i of
// L) or acc_j −= (L[i,j]/L[i,i])·acc_i (backward, the rows above i, row i
// of L), the division a multiplication by the reciprocal, which the lanes
// keep in shared memory.  The critical path is 2·bs steps of (shuffle,
// multiply-add), not the ~bs² dependent multiply-adds of a lane that
// solves a column alone.  The sums run in a fixed order (i ascending
// forward, descending backward): deterministic.  After each pass a lane
// multiplies its rows by their reciprocals: y_i = acc_i / L[i,i].  The
// kernel is built for TT columns (1, 2, 4, 8 or 16) and shuffles all TT of
// them, the ones past t zero, so no shuffle sits under a branch.  Up to
// t = 16, TT ≥ t and one pass solves every right-hand side.  Above it (to
// t = 32) a lane would hold 2·TT values of acc and of the next task's x, in
// registers that TT = 16 already fills (124 at one row a lane against the
// 128 of 16 warps an SM, 210 at two): so the kernel walks the right-hand
// sides in chunks of TT = 16 columns against the tile already staged in
// shared memory.  L is read from device memory once a task, and the rows
// of x once a chunk (the first chunk's rows prefetched with the tile, the
// later chunks' loaded when the chunk starts).
//
// Bytes in flight: a CTA is one warp (its warp index, the CTA's, is then
// uniform to the compiler, so no shuffle is wrapped for divergent lanes),
// and the grid is as many persistent CTAs as the shared memory lets each
// SM hold, walking their tasks (a task is a warp's blocks) with a grid
// stride.  Each warp has two stages of factor tiles in shared memory: while it solves one
// task from one stage, cp.async (16 bytes a lane where the rows allow)
// fills the other with the next task's tiles, and the next task's rows of
// x are loaded into registers, so the next tile's loads overlap this
// tile's substitution.  A staged tile row is padded to ls elements, ls/VEC
// odd (VEC = 16 bytes), and where a warp takes several blocks their tiles
// start seg banks apart: the forward pass reads a column of L as 16-byte
// vectors, VEC steps at a time (lane j reads L[j, i .. i + VEC - 1]), the
// backward pass a row, and neither meets a bank conflict.  The whole
// (bs, bs) tile is copied, although only its lower triangle is read.  Each
// lane stores its rows of y.  The launcher picks the geometry (segment,
// blocks per warp, warps per SM) from bs, t and the shared memory, and
// ``trisolve_plan`` in ``block_trisolve/ops.py`` mirrors it.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may use (227 KB)
constexpr int kSmemSm = 233472;   // shared memory of an SM (228 KB) ...
constexpr int kSmemCta = 1024;    // ... of which each CTA holds 1 KB for the system
constexpr unsigned kFull = 0xffffffffu;

// Warps (one-warp CTAs) per SM at most: 16 where a lane owns one row (at
// most 128 registers a thread), 8 where it owns two (255).
constexpr int max_warps(int rows) { return rows == 1 ? 16 : 8; }
constexpr int kRecip = 64;  // reciprocals of a warp's diagonals, one per row of its task

// Launch geometry, the same arithmetic as trisolve_plan in ops.py.
struct Plan {
  int rows;        // rows a lane owns: 2 at bs > 32, else 1
  int seg;         // lanes per block: bs rounded up to 8, 16 or 32
  int per_warp;    // blocks a warp solves at once: 32 / seg
  int cols;        // right-hand sides a pass solves: t rounded up to 1, 2, 4, 8 or 16 (16 above)
  int chunks;      // passes over the staged tile: cdiv(t, cols), 1 up to t = 16, 2 to t = 32
  int ls;          // elements per staged row of L: a multiple of VEC, ls / VEC odd
  int tp;          // elements per staged tile: bs·ls, rounded up to seg modulo 32
                   // where a warp takes several blocks
  int stage;       // elements of one stage: per_warp tiles
  int warp_smem;   // bytes of a warp's two stages and its kRecip reciprocals
  int warps;       // warps per SM (one-warp CTAs)
  long long tasks; // cdiv(nb, per_warp)
};

template <typename T>
Plan make_plan(long long nb, int bs, int t) {
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  Plan p{};
  p.rows = bs > 32 ? 2 : 1;
  p.seg = bs <= 8 ? 8 : bs <= 16 ? 16 : 32;
  p.per_warp = 32 / p.seg;
  p.cols = t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : t <= 8 ? 8 : 16;
  p.chunks = (t + p.cols - 1) / p.cols;
  p.ls = vec * (((bs + vec - 1) / vec) | 1);
  p.tp = bs * p.ls;
  if (p.per_warp > 1) p.tp += ((p.seg - p.tp) % 32 + 32) % 32;
  p.stage = p.per_warp * p.tp;
  p.warp_smem = (2 * p.stage + kRecip) * static_cast<int>(sizeof(T));
  p.warps = std::max(1, std::min(max_warps(p.rows), kSmemSm / (p.warp_smem + kSmemCta)));
  p.tasks = repro::cdiv(nb, p.per_warp);
  return p;
}

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; };
template <> struct Vec<float> { using type = float4; };

template <typename T>
__device__ __forceinline__ T lane_of(const typename Vec<T>::type& v, int k) {
  if constexpr (sizeof(T) == 8) {
    return k == 0 ? v.x : v.y;
  } else {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
}

struct Geometry {
  long long nb, nb_rank, rmax;
  int bs, t, chunks, per_warp, ls, tp, stage;
  bool vec_l;   // bs a multiple of VEC and l 16-byte aligned: tiles move as 16-byte chunks
  bool vec_xy;  // t a multiple of VEC, t == TT or chunked, x and y 16-byte aligned: rows
                // move as vectors
};

// The first row of block g in x, and how many of its bs rows lie below rmax.
__device__ __forceinline__ long long block_rows(const Geometry& geo, long long g, int& live) {
  const long long rank = geo.nb_rank == geo.nb ? 0 : g / geo.nb_rank;
  const long long q0 = (g - rank * geo.nb_rank) * geo.bs;
  live = static_cast<int>(max(0LL, min(static_cast<long long>(geo.bs), geo.rmax - q0)));
  return rank * geo.rmax + q0;
}

// A lane's place in a copy of rows of ``w`` units: lanes in a row take
// consecutive units, 32 / w rows at a time where w ≤ 32.
struct Walk {
  int row, col, rows_per, cols_per;
  __device__ Walk(int w, int lane) {
    if (w <= 32) {
      rows_per = 32 / w;
      cols_per = w;
      row = lane / w;
      col = lane - row * w;
      if (row >= rows_per) row = 1 << 30;  // lanes past the last whole row idle
    } else {
      rows_per = 1;
      cols_per = 32;
      row = 0;
      col = lane;
    }
  }
};

// Stage the factor tiles of one task (blocks g0 .. g0 + here - 1) into
// ``dst``: each tile's bs rows of bs values as rows of ls, tiles tp apart.
template <typename T>
__device__ __forceinline__ void stage_tiles(T* dst, const T* __restrict__ l, const Geometry& geo,
                                            long long g0, int here, const Walk& wk) {
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  const int bs = geo.bs, ls = geo.ls;
  for (int q = 0; q < here; ++q) {
    T* d = dst + q * geo.tp;
    const T* src = l + (g0 + q) * bs * bs;
    if (geo.vec_l) {  // wk walks rows of bs / vec chunks
      for (int r = wk.row; r < bs; r += wk.rows_per) {
        for (int c = wk.col; c < bs / vec; c += wk.cols_per) {
          repro::cp_async<16>(d + r * ls + c * vec, src + r * bs + c * vec);
        }
      }
    } else {  // wk walks rows of bs values
      for (int r = wk.row; r < bs; r += wk.rows_per) {
        for (int c = wk.col; c < bs; c += wk.cols_per) {
          repro::cp_async<sizeof(T)>(d + r * ls + c, src + r * bs + c);
        }
      }
    }
  }
  repro::cp_async_commit();
}

// This lane's rows of x for the block it solves in task ``task``: rows
// row0 (+ 32) below rmax, the TT values of columns c0 .. c0 + TT - 1 each
// (zero past t), and their number.
template <typename T, int R, int TT>
__device__ __forceinline__ int load_x(T (&v)[R][TT], const T* __restrict__ x, const Geometry& geo,
                                      long long task, int b, int row0, int c0) {
  using VT = typename Vec<T>::type;
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  const int here = static_cast<int>(
      min(static_cast<long long>(geo.per_warp), geo.nb - task * geo.per_warp));
  int live = 0;
  long long start = 0;
  if (b < here) start = block_rows(geo, task * geo.per_warp + b, live);
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int row = row0 + 32 * h;
    const T* src = x + (start + row) * geo.t + c0;
    if constexpr (TT % vec == 0) {
      if (geo.vec_xy) {  // t a multiple of vec: a vector lies wholly below t or past it
#pragma unroll
        for (int c = 0; c < TT; c += vec) {
          VT u{};
          if (row < live && c0 + c < geo.t) u = *reinterpret_cast<const VT*>(src + c);
#pragma unroll
          for (int k = 0; k < vec; ++k) v[h][c + k] = lane_of<T>(u, k);
        }
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < TT; ++c) v[h][c] = row < live && c0 + c < geo.t ? src[c] : T(0);
  }
  return live;
}

// One substitution step i, owned by rows of half H (rows 32·H ..), for a
// lane whose rows are r[h] (-1 for rows past bs in the forward pass, bs or
// more in the backward one: such rows never update) and whose factors of
// this step are l[h] (L[r, i] forward, L[i, r] backward).  The owner
// broadcasts its row, column by column, within its segment; each open row
// subtracts its multiple, (l / L[i,i])·acc_i.
template <typename T, int SEG, int R, int TT, int H, bool FWD>
__device__ __forceinline__ void step(T (&acc)[R][TT], const T (&l)[R], T ri, const int (&r)[R],
                                     int i) {
  T f[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    if (FWD ? h < H : h > H) continue;  // rows finished before this half's steps
    f[h] = (FWD ? r[h] > i : r[h] < i) ? -l[h] * ri : T(0);
  }
  const int owner = i - 32 * H;
#pragma unroll
  for (int c = 0; c < TT; ++c) {
    const T y = __shfl_sync(kFull, acc[H][c], owner, SEG);
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if (FWD ? h >= H : h <= H) acc[h][c] = fma(f[h], y, acc[h][c]);
    }
  }
}

// The forward steps i0 .. i1 - 1 (i1 - i0 a multiple of VEC) of half H:
// each lane reads VEC factors of its rows at once, a 16-byte vector of its
// row of the tile.  Steps past bs (where bs is not a multiple of VEC) are
// owned by rows that hold zeros and change nothing.
template <typename T, int SEG, int R, int TT, int H>
__device__ __forceinline__ void forward(T (&acc)[R][TT], const T* __restrict__ rcp,
                                        const T* __restrict__ tile, const int (&rf)[R],
                                        const int (&ra)[R], int ls, int i0, int i1) {
  using VT = typename Vec<T>::type;
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
#pragma unroll 2
  for (int i = i0; i < i1; i += vec) {
    VT lv[R];
#pragma unroll
    for (int h = H; h < R; ++h) lv[h] = *reinterpret_cast<const VT*>(tile + ra[h] * ls + i);
#pragma unroll
    for (int k = 0; k < vec; ++k) {
      T l[R];
#pragma unroll
      for (int h = 0; h < R; ++h) l[h] = h >= H ? lane_of<T>(lv[h], k) : T(0);
      step<T, SEG, R, TT, H, true>(acc, l, rcp[i + k], rf, i + k);
    }
  }
}

// The backward steps i1 - 1 down to i0 of half H: row i of the tile.
template <typename T, int SEG, int R, int TT, int H>
__device__ __forceinline__ void backward(T (&acc)[R][TT], const T* __restrict__ rcp,
                                         const T* __restrict__ tile, const int (&rb)[R],
                                         const int (&ra)[R], int ls, int i0, int i1) {
#pragma unroll 4
  for (int i = i1 - 1; i >= i0; --i) {
    T l[R];
#pragma unroll
    for (int h = 0; h < R; ++h) l[h] = h <= H ? tile[i * ls + ra[h]] : T(0);
    step<T, SEG, R, TT, H, false>(acc, l, rcp[i], rb, i);
  }
}

template <typename T, int R, int TT>
__device__ __forceinline__ void finish(T (&acc)[R][TT], const T (&inv)[R]) {
#pragma unroll
  for (int h = 0; h < R; ++h) {
#pragma unroll
    for (int c = 0; c < TT; ++c) acc[h][c] *= inv[h];
  }
}

// SEG lanes per block, R rows per lane, TT ≥ t columns in registers.
template <typename T, int SEG, int R, int TT>
__global__ void __launch_bounds__(32, max_warps(R)) block_trisolve_kernel(
    const T* __restrict__ l, const T* __restrict__ x, T* __restrict__ y, Geometry geo,
    long long tasks) {
  using VT = typename Vec<T>::type;
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bs = geo.bs, ls = geo.ls, per_warp = geo.per_warp;
  const int lane = threadIdx.x;
  T* const base = reinterpret_cast<T*>(smem_raw);
  // this lane: block b of the task, rows r0 (+ 32) of that block
  const int b = lane / SEG;
  const int r0 = lane - b * SEG;
  T* const rcp = base + 2 * geo.stage + b * bs;  // this segment's reciprocals
  const Walk wk(geo.vec_l ? bs / vec : bs, lane);
  // this lane's rows for the forward and backward conditions, and clamped
  // into the tile for addresses
  int rf[R], rb[R], ra[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int row = r0 + 32 * h;
    rf[h] = row < bs ? row : -1;
    rb[h] = row;
    ra[h] = min(row, bs - 1);
  }
  const long long wstride = gridDim.x;
  long long task = blockIdx.x;
  const auto here_of = [&](long long tk) {
    return static_cast<int>(min(static_cast<long long>(per_warp), geo.nb - tk * per_warp));
  };

  T xn[R][TT];  // the next task's rows of x (its first chunk)
  int live_n = 0;
  if (task < tasks) {
    stage_tiles(base, l, geo, task * per_warp, here_of(task), wk);
    live_n = load_x(xn, x, geo, task, b, r0, 0);
  }
  for (int s = 0; task < tasks; task += wstride, s ^= 1) {
    T acc[R][TT];
#pragma unroll
    for (int h = 0; h < R; ++h) {
#pragma unroll
      for (int c = 0; c < TT; ++c) acc[h][c] = xn[h][c];
    }
    const int live = live_n;
    // the next task's loads go out before this one's substitution
    const long long next = task + wstride;
    T* const cur = base + (s ? geo.stage : 0);
    if (next < tasks) {
      stage_tiles(base + (s ? 0 : geo.stage), l, geo, next * per_warp, here_of(next), wk);
      live_n = load_x(xn, x, geo, next, b, r0, 0);
    } else {
      repro::cp_async_commit();
    }
    repro::cp_async_wait<1>();
    __syncwarp();

    const int here = here_of(task);
    const T* tile = cur + min(b, here - 1) * geo.tp;  // idle lanes solve a live block
    T inv[R];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int row = r0 + 32 * h;
      inv[h] = row < bs ? T(1) / tile[row * ls + row] : T(0);
      if (row < bs) rcp[row] = inv[h];
    }
    __syncwarp();  // the segment's reciprocals are in shared memory

    const int bv = (bs + vec - 1) / vec * vec;  // the forward steps, bs rounded up to VEC
    for (int ch = 0; ch < geo.chunks; ++ch) {
      const int c0 = ch * TT;
      if (ch > 0) load_x(acc, x, geo, task, b, r0, c0);
      // forward, L y = x
      if constexpr (R == 1) {
        forward<T, SEG, R, TT, 0>(acc, rcp, tile, rf, ra, ls, 0, bv);
      } else {
        forward<T, SEG, R, TT, 0>(acc, rcp, tile, rf, ra, ls, 0, 32);
        forward<T, SEG, R, TT, 1>(acc, rcp, tile, rf, ra, ls, 32, bv);
      }
      finish(acc, inv);
      // backward, Lᵀ z = y
      if constexpr (R == 1) {
        backward<T, SEG, R, TT, 0>(acc, rcp, tile, rb, ra, ls, 0, bs);
      } else {
        backward<T, SEG, R, TT, 1>(acc, rcp, tile, rb, ra, ls, 32, bs);
        backward<T, SEG, R, TT, 0>(acc, rcp, tile, rb, ra, ls, 0, 32);
      }
      finish(acc, inv);

      if (b < here) {
        int rows;
        const long long start = block_rows(geo, task * per_warp + b, rows);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int row = r0 + 32 * h;
          if (row >= live) continue;
          T* dst = y + (start + row) * geo.t + c0;
          if constexpr (TT % vec == 0) {
            if (geo.vec_xy) {
#pragma unroll
              for (int c = 0; c < TT; c += vec) {
                if (c0 + c >= geo.t) continue;
                VT u;
                if constexpr (vec == 2) {
                  u = VT{acc[h][c], acc[h][c + 1]};
                } else {
                  u = VT{acc[h][c], acc[h][c + 1], acc[h][c + 2], acc[h][c + 3]};
                }
                *reinterpret_cast<VT*>(dst + c) = u;
              }
              continue;
            }
          }
#pragma unroll
          for (int c = 0; c < TT; ++c) {
            if (c0 + c < geo.t) dst[c] = acc[h][c];
          }
        }
      }
    }
    __syncwarp();  // every lane is done with this stage and the reciprocals
  }
  repro::cp_async_wait<0>();
}

template <typename T, int SEG, int R, int TT>
int launch_k(const void* l, const void* x, void* y, const Plan& p, long long nb, int bs, int t,
             long long nb_rank, long long rmax, void* stream) {
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  auto kernel = block_trisolve_kernel<T, SEG, R, TT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = std::min(static_cast<long long>(sms) * p.warps, p.tasks);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec_l = bs % vec == 0 && aligned(l);
  const bool vec_xy = (t == TT || p.chunks > 1) && t % vec == 0 && aligned(x) && aligned(y);
  const Geometry geo{nb,      nb_rank, rmax, bs,      t,     p.chunks, p.per_warp,
                     p.ls,    p.tp,    p.stage, vec_l, vec_xy};
  kernel<<<static_cast<unsigned>(grid), 32, static_cast<size_t>(p.warp_smem),
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(l), static_cast<const T*>(x),
                                                static_cast<T*>(y), geo, p.tasks);
  return repro::launch_status();
}

template <typename T, int SEG, int R>
int launch_t(const void* l, const void* x, void* y, const Plan& p, long long nb, int bs, int t,
             long long nb_rank, long long rmax, void* stream) {
  switch (p.cols) {
    case 1: return launch_k<T, SEG, R, 1>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
    case 2: return launch_k<T, SEG, R, 2>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
    case 4: return launch_k<T, SEG, R, 4>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
    case 8: return launch_k<T, SEG, R, 8>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
    default: return launch_k<T, SEG, R, 16>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
  }
}

template <typename T>
int launch(const void* l, const void* x, void* y, long long nb, int bs, int t,
           long long nb_rank, long long rmax, void* stream) {
  if (bs < 1 || bs > 64 || t < 1 || t > 32 || nb_rank < 1 || nb % nb_rank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  const Plan p = make_plan<T>(nb, bs, t);
  if (p.rows == 2) return launch_t<T, 32, 2>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
  switch (p.seg) {
    case 8: return launch_t<T, 8, 1>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
    case 16: return launch_t<T, 16, 1>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
    default: return launch_t<T, 32, 1>(l, x, y, p, nb, bs, t, nb_rank, rmax, stream);
  }
}

}  // namespace

REPRO_EXPORT int block_trisolve_f32(const void* l, const void* x, void* y, long long nb, int bs,
                                    int t, long long nb_rank, long long rmax, void* stream) {
  return launch<float>(l, x, y, nb, bs, t, nb_rank, rmax, stream);
}

REPRO_EXPORT int block_trisolve_f64(const void* l, const void* x, void* y, long long nb, int bs,
                                    int t, long long nb_rank, long long rmax, void* stream) {
  return launch<double>(l, x, y, nb, bs, t, nb_rank, rmax, stream);
}

REPRO_ERROR_STRING(block_trisolve)
