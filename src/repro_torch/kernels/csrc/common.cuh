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
