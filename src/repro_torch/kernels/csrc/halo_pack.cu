// Packed halo-exchange buffers for Hopper (sm_90a): one gather and one
// scatter per exchange phase, over every rank of a virtual mesh at once.
//
//   halo_pack:   out[r, i, :] = src[r, idx[r, i], :]
//   halo_unpack: dst[r, pos[r, i], :] = buf[r, i, :]   (in place)
//
// Replaces src/repro/kernels/halo_pack/kernel.py::halo_pack_pallas and
// ::halo_unpack_pallas.
//
// Layout: src/dst are (p, m, w) row-major, out/buf (p, c, w), idx/pos (p, c)
// int32; rank r's indices address rank r's m rows, and must lie in [0, m)
// (the executor checks every plan array once, when it is built).
//
// What bounds it on the H100: bytes, 2·p·c·w·f + 4·p·c (each packed value
// read once and written once, plus the indices), over 3.35 TB/s.  At the
// main path's widest phase (p = 8, c = 8192, w = 8, f64) that is 8.7 MB,
// ~2.6 µs: a few dependent memory latencies, so what costs time is how many
// loads each thread waits on in a row, and every CTA that has too little
// work.
//
// Design: the Pallas kernels move one (1, w) row per sequential grid step,
// with the index scalar-prefetched into the BlockSpec index map.  Here the
// work is flattened into units over (rank, packed row, unit of the row) in
// one 1-D grid (one unit per thread up to a full wave of CTAs, a
// grid-stride loop past it), so no CTA idles on a
// rank's ragged tail.  A unit is one 16-byte vector when the row size is a
// multiple of 16 bytes and both base pointers are 16-byte aligned (the
// vector path: w = 8 in f64 is 4 neighbouring lanes per 64-byte row, one
// warp instruction moves 8 whole rows, contiguous on the packed side), else
// one value (the scalar path: w = 1 in f64, odd widths, offset views).  Each
// thread loads its row's index through the read-only path (the row's lanes
// read one address, which the warp serves with one transaction), then makes
// one load and one store: two dependent loads per thread instead of the one
// index load plus w·f/16 dependent 16-byte moves of a thread per row.  The
// packed side's flat unit index is the thread's own index, so it coalesces
// whatever the width.  run() below chooses the path and the grid; the
// wrapper's halo_plan only mirrors that choice, for tests and reports.
//
// halo_unpack writes into the caller's dst, the counterpart of the
// reference's donated, aliased operand: slots not named by pos keep their
// contents.  Padding entries of a plan are pre-clamped to the trailing dump
// slot, so several threads may write that one slot at once.  The executor
// discards the dump slot, so the race is harmless; every other slot is
// named at most once per phase and is written exactly.  Both kernels move
// data only, so they equal their plain versions bit for bit.

#include <algorithm>

#include "common.cuh"

namespace {

// units per row and unit type: uint4 on the vector path, T on the scalar one
template <typename U>
__global__ void __launch_bounds__(repro::kThreads) halo_pack_kernel(
    const U* __restrict__ src, const int* __restrict__ idx, U* __restrict__ out,
    long long m, int c, int upr, int units) {
  const int stride = gridDim.x * blockDim.x;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += stride) {
    const int row = u / upr;  // packed row over all ranks, r·c + i
    const int k = u - row * upr;
    const long long r = row / c;
    const long long from = (r * m + __ldg(idx + row)) * upr + k;
    out[u] = __ldg(src + from);
  }
}

template <typename U>
__global__ void __launch_bounds__(repro::kThreads) halo_unpack_kernel(
    U* __restrict__ dst, const U* __restrict__ buf, const int* __restrict__ pos,
    long long m, int c, int upr, int units) {
  const int stride = gridDim.x * blockDim.x;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += stride) {
    const int row = u / upr;
    const int k = u - row * upr;
    const long long r = row / c;
    dst[(r * m + __ldg(pos + row)) * upr + k] = __ldg(buf + u);
  }
}

// 16-byte vectors need a row size that is a multiple of 16 bytes and
// 16-byte aligned base pointers (every row then starts aligned).
template <typename T>
bool vectorizable(int w, const void* a, const void* b) {
  return (w * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
         reinterpret_cast<size_t>(b) % 16 == 0;
}

constexpr int kCtasPerSm = 8;             // resident 256-thread CTAs per SM: one wave
constexpr long long kMaxUnits = 1LL << 30;  // units are indexed with 32-bit ints

// rows: src (pack) or dst (unpack); packed: out (pack) or buf (unpack)
template <typename T, bool kPack>
int run(void* rows, const void* idx, void* packed, int p, long long m, int c, int w,
        void* stream) {
  const bool vec = vectorizable<T>(w, rows, packed);
  const int upr = vec ? w * static_cast<int>(sizeof(T)) / 16 : w;
  const long long units = static_cast<long long>(p) * c * upr;
  if (units >= kMaxUnits) return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(
      std::min(repro::cdiv(units, repro::kThreads), static_cast<long long>(sms) * kCtasPerSm));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const int n = static_cast<int>(units);
  if (vec) {
    if constexpr (kPack)
      halo_pack_kernel<uint4><<<grid, repro::kThreads, 0, s>>>(
          static_cast<const uint4*>(rows), ix, static_cast<uint4*>(packed), m, c, upr, n);
    else
      halo_unpack_kernel<uint4><<<grid, repro::kThreads, 0, s>>>(
          static_cast<uint4*>(rows), static_cast<const uint4*>(packed), ix, m, c, upr, n);
  } else {
    if constexpr (kPack)
      halo_pack_kernel<T><<<grid, repro::kThreads, 0, s>>>(
          static_cast<const T*>(rows), ix, static_cast<T*>(packed), m, c, upr, n);
    else
      halo_unpack_kernel<T><<<grid, repro::kThreads, 0, s>>>(
          static_cast<T*>(rows), static_cast<const T*>(packed), ix, m, c, upr, n);
  }
  return repro::launch_status();
}

}  // namespace

REPRO_EXPORT int halo_pack_f32(const void* src, const void* idx, void* out, int p,
                               long long m, int c, int w, void* stream) {
  return run<float, true>(const_cast<void*>(src), idx, out, p, m, c, w, stream);
}

REPRO_EXPORT int halo_pack_f64(const void* src, const void* idx, void* out, int p,
                               long long m, int c, int w, void* stream) {
  return run<double, true>(const_cast<void*>(src), idx, out, p, m, c, w, stream);
}

REPRO_EXPORT int halo_unpack_f32(void* dst, const void* buf, const void* pos, int p,
                                 long long m, int c, int w, void* stream) {
  return run<float, false>(dst, pos, const_cast<void*>(buf), p, m, c, w, stream);
}

REPRO_EXPORT int halo_unpack_f64(void* dst, const void* buf, const void* pos, int p,
                                 long long m, int c, int w, void* stream) {
  return run<double, false>(dst, pos, const_cast<void*>(buf), p, m, c, w, stream);
}

REPRO_ERROR_STRING(halo_pack)
