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
// Design: the TPU kernel extracts rows and columns with iota masks so each
// substitution step is dense vector work; none of that is needed here.  A
// CTA takes ``blocks_per_cta`` consecutive diagonal blocks (the wrapper
// picks them to fill 64 threads and 32 KB; the CTA is the whole warps that
// cover blocks_per_cta·t threads): all its threads stage those blocks' L
// tiles (one contiguous range of device memory) in shared memory with
// 16-byte loads, each tile padded by 16 bytes so the tiles that one warp
// reads sit in different banks.  Small CTAs let one CTA's staging overlap
// another's substitutions on the same SM.  Then one
// thread per (block, column) loads its column of x into registers (a
// register array of MAXBS entries, with the loops unrolled so every index
// is a constant), runs the forward substitution with L and the backward one
// with Lᵀ, reading L from shared memory (the t threads of a block read the
// same address: a broadcast), and writes y.  Sums run over j in a fixed
// order, so results are deterministic.  The factor tiles are read once and
// the whole tile is staged although only its lower triangle is used;
// storing the triangle alone, TMA staging and double buffering are later
// work.  At bs = 64 in float64 the column takes 128 of the 255 registers
// and each thread's chain of 2·bs² dependent multiply-adds, not bytes,
// sets the time: splitting a column's substitution over several threads
// is later work too.

#include <cstdint>

#include "common.cuh"

namespace {

// 16 bytes of padding between staged tiles
template <typename T>
constexpr int kPad = 16 / static_cast<int>(sizeof(T));

template <typename T, int MAXBS>
__global__ void __launch_bounds__(repro::kThreads) block_trisolve_kernel(
    const T* __restrict__ l, const T* __restrict__ x, T* __restrict__ y,
    long long nb, int bs, int t, long long nb_rank, long long rmax,
    int blocks_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  const int tile = bs * bs;
  const int stride = tile + kPad<T>;
  const long long b0 = static_cast<long long>(blockIdx.x) * blocks_per_cta;
  const int here = static_cast<int>(min(static_cast<long long>(blocks_per_cta), nb - b0));

  // stage this CTA's factor tiles
  const T* src = l + b0 * tile;
  if ((tile * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0) {
    const int chunks = static_cast<int>(tile * sizeof(T) / 16);
    for (int idx = threadIdx.x; idx < here * chunks; idx += blockDim.x) {
      const int q = idx / chunks;
      const int o = idx - q * chunks;
      reinterpret_cast<uint4*>(tiles + q * stride)[o] =
          __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(q) * tile) + o);
    }
  } else {
    for (int idx = threadIdx.x; idx < here * tile; idx += blockDim.x) {
      const int q = idx / tile;
      tiles[q * stride + (idx - q * tile)] = src[idx];
    }
  }
  __syncthreads();

  const int lb = threadIdx.x / t;  // this thread's block in the CTA
  const int c = threadIdx.x - lb * t;
  if (lb >= here) return;
  const long long g = b0 + lb;
  const long long rank = g / nb_rank;
  const long long q0 = (g - rank * nb_rank) * bs;  // first row of the block in its rank
  const T* __restrict__ xr = x + rank * rmax * t + c;
  const T* L = tiles + lb * stride;

  T v[MAXBS];
#pragma unroll
  for (int i = 0; i < MAXBS; ++i) {
    v[i] = (i < bs && q0 + i < rmax) ? xr[(q0 + i) * t] : T(0);
  }
  // forward substitution: L v' = v
#pragma unroll
  for (int i = 0; i < MAXBS; ++i) {
    if (i < bs) {
      T acc = v[i];
#pragma unroll
      for (int j = 0; j < i; ++j) acc -= L[i * bs + j] * v[j];
      v[i] = acc / L[i * bs + i];
    }
  }
  // backward substitution: Lᵀ v'' = v'
#pragma unroll
  for (int i = MAXBS - 1; i >= 0; --i) {
    if (i < bs) {
      T acc = v[i];
#pragma unroll
      for (int j = i + 1; j < MAXBS; ++j) {
        if (j < bs) acc -= L[j * bs + i] * v[j];
      }
      v[i] = acc / L[i * bs + i];
    }
  }
  T* __restrict__ yr = y + rank * rmax * t + c;
#pragma unroll
  for (int i = 0; i < MAXBS; ++i) {
    if (i < bs && q0 + i < rmax) yr[(q0 + i) * t] = v[i];
  }
}

template <typename T, int MAXBS>
int launch_bs(const void* l, const void* x, void* y, long long nb, int bs,
              int t, long long nb_rank, long long rmax, int blocks_per_cta,
              void* stream) {
  const size_t smem =
      static_cast<size_t>(blocks_per_cta) * (bs * bs + kPad<T>) * sizeof(T);
  auto kernel = block_trisolve_kernel<T, MAXBS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = repro::cdiv(nb, blocks_per_cta);
  // whole warps covering the compute threads, at most kThreads
  const int threads = static_cast<int>(repro::cdiv(blocks_per_cta * t, 32) * 32);
  kernel<<<static_cast<unsigned>(grid), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(x), static_cast<T*>(y),
      nb, bs, t, nb_rank, rmax, blocks_per_cta);
  return repro::launch_status();
}

template <typename T>
int launch(const void* l, const void* x, void* y, long long nb, int bs, int t,
           long long nb_rank, long long rmax, int blocks_per_cta, void* stream) {
  if (bs < 1 || bs > 64 || t < 1 || blocks_per_cta * t > repro::kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bs <= 8) return launch_bs<T, 8>(l, x, y, nb, bs, t, nb_rank, rmax, blocks_per_cta, stream);
  if (bs <= 16) return launch_bs<T, 16>(l, x, y, nb, bs, t, nb_rank, rmax, blocks_per_cta, stream);
  if (bs <= 32) return launch_bs<T, 32>(l, x, y, nb, bs, t, nb_rank, rmax, blocks_per_cta, stream);
  return launch_bs<T, 64>(l, x, y, nb, bs, t, nb_rank, rmax, blocks_per_cta, stream);
}

}  // namespace

REPRO_EXPORT int block_trisolve_f32(const void* l, const void* x, void* y,
                                    long long nb, int bs, int t,
                                    long long nb_rank, long long rmax,
                                    int blocks_per_cta, void* stream) {
  return launch<float>(l, x, y, nb, bs, t, nb_rank, rmax, blocks_per_cta, stream);
}

REPRO_EXPORT int block_trisolve_f64(const void* l, const void* x, void* y,
                                    long long nb, int bs, int t,
                                    long long nb_rank, long long rmax,
                                    int blocks_per_cta, void* stream) {
  return launch<double>(l, x, y, nb, bs, t, nb_rank, rmax, blocks_per_cta, stream);
}

REPRO_ERROR_STRING(block_trisolve)
