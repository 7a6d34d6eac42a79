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

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace repro
