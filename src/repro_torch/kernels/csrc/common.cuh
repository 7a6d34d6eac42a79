// Shared by the kernel sources: every C entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() as an int so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C"

// ``<name>_error_string(code)`` for the wrapper's error message.
#define REPRO_ERROR_STRING(name)                                   \
  REPRO_EXPORT const char* name##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

namespace repro {

constexpr int kThreads = 256;

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The card's multiprocessor count, into ``sms``; returns the CUDA error.
inline int multiprocessors(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// Resident CTAs per SM of ``kernel`` at ``threads`` threads and ``smem``
// bytes of dynamic shared memory (at least 1).
template <typename K>
int ctas_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) == cudaSuccess &&
                 n > 0
             ? n
             : 1;
}

// Opt ``kernel`` in to ``smem`` bytes of dynamic shared memory where that is
// above the 48 KB a launch gets without.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem))
                          : cudaSuccess;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of kBytes (4, 8 or 16) from device to shared memory;
// 16-byte copies bypass L1 (.cg).  Both addresses aligned to kBytes.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most ``kPending`` of this thread's committed copy groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d (8x8) += a (8x4) · b (4x8) in float64 on the tensor cores (sm_80+).
// Fragments, per the PTX ISA's m8n8k4 .f64 layout, with g = lane / 4 and
// q = lane % 4: lane holds a = A[g][q], b = B[q][g] and
// d = {D[g][2q], D[g][2q + 1]}.
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

}  // namespace repro
