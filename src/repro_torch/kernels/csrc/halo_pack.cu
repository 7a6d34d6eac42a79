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
// (the executor checks its plan arrays against the buffer sizes once, when
// it is built).
//
// What bounds it on the H100: bytes, 2·p·c·w·f + 4·p·c (each packed value
// read once and written once, plus the indices), over 3.35 TB/s.  At the
// main path's widest phase (p = 8, c = 8192, w = 8, f64) that is 8.7 MB,
// ~2.6 µs — below a kernel launch, so at these shapes the kernels are bound
// by launch latency, not by bytes.
//
// Design: the Pallas kernels move one (1, w) row per sequential grid step,
// with the index scalar-prefetched into the BlockSpec index map.  Here one
// launch covers all p ranks of a phase: the grid is (row range, rank), each
// CTA owns kThreads consecutive packed rows of one rank, and each thread
// loads its own index and copies its row's w contiguous values — as 16-byte
// vectors when the row size and both base pointers allow it (w = 8 in f64:
// four 16-byte loads and stores), else one value at a time.  Consecutive
// threads write consecutive packed rows, so the packed side coalesces.
//
// halo_unpack writes into the caller's dst, the counterpart of the
// reference's donated, aliased operand: slots not named by pos keep their
// contents.  Padding entries of a plan are pre-clamped to the trailing dump
// slot, so several threads may write that one slot at once.  The executor
// discards the dump slot, so the race is harmless; every other slot is
// named at most once per phase and is written exactly.  Both kernels move
// data only, so they equal their plain versions bit for bit.

#include "common.cuh"

namespace {

template <typename T, bool kVec>
__device__ __forceinline__ void copy_row(T* __restrict__ to, const T* __restrict__ from, int w) {
  if constexpr (kVec) {
    const int n16 = w * static_cast<int>(sizeof(T)) / 16;
    uint4* t16 = reinterpret_cast<uint4*>(to);
    const uint4* f16 = reinterpret_cast<const uint4*>(from);
    for (int k = 0; k < n16; ++k) t16[k] = f16[k];
  } else {
    for (int k = 0; k < w; ++k) to[k] = from[k];
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(repro::kThreads) halo_pack_kernel(
    const T* __restrict__ src, const int* __restrict__ idx, T* __restrict__ out,
    long long m, int c, int w) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const long long row = idx[static_cast<long long>(r) * c + i];
  copy_row<T, kVec>(out + (static_cast<long long>(r) * c + i) * w,
                    src + (static_cast<long long>(r) * m + row) * w, w);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(repro::kThreads) halo_unpack_kernel(
    T* __restrict__ dst, const T* __restrict__ buf, const int* __restrict__ pos,
    long long m, int c, int w) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const long long slot = pos[static_cast<long long>(r) * c + i];
  copy_row<T, kVec>(dst + (static_cast<long long>(r) * m + slot) * w,
                    buf + (static_cast<long long>(r) * c + i) * w, w);
}

// 16-byte vectors need a row size that is a multiple of 16 bytes and
// 16-byte aligned base pointers (every row then starts aligned).
template <typename T>
bool vectorizable(int w, const void* a, const void* b) {
  return (w * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
         reinterpret_cast<size_t>(b) % 16 == 0;
}

template <typename T>
int pack(const void* src, const void* idx, void* out, int p, long long m, int c,
         int w, void* stream) {
  const dim3 grid(static_cast<unsigned>(repro::cdiv(c, repro::kThreads)), p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* src_t = static_cast<const T*>(src);
  const int* idx_t = static_cast<const int*>(idx);
  T* out_t = static_cast<T*>(out);
  if (vectorizable<T>(w, src, out))
    halo_pack_kernel<T, true><<<grid, repro::kThreads, 0, s>>>(src_t, idx_t, out_t, m, c, w);
  else
    halo_pack_kernel<T, false><<<grid, repro::kThreads, 0, s>>>(src_t, idx_t, out_t, m, c, w);
  return repro::launch_status();
}

template <typename T>
int unpack(void* dst, const void* buf, const void* pos, int p, long long m, int c,
           int w, void* stream) {
  const dim3 grid(static_cast<unsigned>(repro::cdiv(c, repro::kThreads)), p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* dst_t = static_cast<T*>(dst);
  const T* buf_t = static_cast<const T*>(buf);
  const int* pos_t = static_cast<const int*>(pos);
  if (vectorizable<T>(w, dst, buf))
    halo_unpack_kernel<T, true><<<grid, repro::kThreads, 0, s>>>(dst_t, buf_t, pos_t, m, c, w);
  else
    halo_unpack_kernel<T, false><<<grid, repro::kThreads, 0, s>>>(dst_t, buf_t, pos_t, m, c, w);
  return repro::launch_status();
}

}  // namespace

REPRO_EXPORT int halo_pack_f32(const void* src, const void* idx, void* out, int p,
                               long long m, int c, int w, void* stream) {
  return pack<float>(src, idx, out, p, m, c, w, stream);
}

REPRO_EXPORT int halo_pack_f64(const void* src, const void* idx, void* out, int p,
                               long long m, int c, int w, void* stream) {
  return pack<double>(src, idx, out, p, m, c, w, stream);
}

REPRO_EXPORT int halo_unpack_f32(void* dst, const void* buf, const void* pos, int p,
                                 long long m, int c, int w, void* stream) {
  return unpack<float>(dst, buf, pos, p, m, c, w, stream);
}

REPRO_EXPORT int halo_unpack_f64(void* dst, const void* buf, const void* pos, int p,
                                 long long m, int c, int w, void* stream) {
  return unpack<double>(dst, buf, pos, p, m, c, w, stream);
}

REPRO_ERROR_STRING(halo_pack)
