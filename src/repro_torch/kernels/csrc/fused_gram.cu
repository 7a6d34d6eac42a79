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
// 6·n·t² flops (t ≤ 16), far below the compute line; at Example 2.1's full
// scale (n = 1 310 720, t = 8, f64) the floor is the 336 MB read, ~0.10 ms.
//
// Design: the Pallas kernel carries the (t, 3t) sum across its sequential
// grid in VMEM.  Hopper's CTAs run in no order, so the sum is split in two
// passes.  Pass 1: a (parts, ranks) grid; each CTA owns a contiguous row
// range of one rank (a range never crosses a rank boundary), stages
// 32-row chunks of the four operands in shared memory (coalesced loads, each
// input value read from device memory once) and accumulates its (t, 3t)
// partial in registers — one to three outputs per thread — which it writes to
// a scratch row.  Pass 2: one CTA per rank sums that rank's partials in part
// order.  Both sums run in a fixed order and use no atomics, so the result is
// deterministic.

#include "common.cuh"

namespace {

constexpr int kChunk = 32;    // rows staged in shared memory per step
constexpr int kMaxSlots = 3;  // outputs per thread: 3·t² ≤ 3·256 for t ≤ 16

// kRanked = false is the single-rank call: its offsets fold to 0 and the
// code is that of the unranked kernel (the ranked code ran about a third
// slower at ranks = 1 on the H100; PERF.md §6).
template <typename T, bool kRanked>
__global__ void __launch_bounds__(repro::kThreads) fused_gram_partial(
    const T* __restrict__ p, const T* __restrict__ r, const T* __restrict__ ap,
    const T* __restrict__ apo, T* __restrict__ partials, long long n, int t,
    long long rows_per_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sp = reinterpret_cast<T*>(smem_raw);
  T* sr = sp + kChunk * t;
  T* sap = sr + kChunk * t;
  T* sapo = sap + kChunk * t;
  const int width = 3 * t;
  const int n_out = t * width;

  T acc[kMaxSlots];
  int xa[kMaxSlots], yb[kMaxSlots], sel[kMaxSlots];
  for (int m = 0; m < kMaxSlots; ++m) {
    acc[m] = T(0);
    const int o = threadIdx.x + m * blockDim.x;
    const int a = o / width;
    const int rem = o - a * width;
    sel[m] = o < n_out ? rem / t : -1;
    xa[m] = a;
    yb[m] = rem % t;
  }

  // CTA (x, y) owns rows [begin, end) of rank y, whose values start at
  // element y·n·t of each operand
  const long long first = kRanked ? static_cast<long long>(blockIdx.y) * n * t : 0;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long end = min(n, begin + rows_per_part);
  for (long long base = begin; base < end; base += kChunk) {
    const int rows = static_cast<int>(min(static_cast<long long>(kChunk), end - base));
    __syncthreads();  // the previous chunk's reads of shared memory are done
    for (int idx = threadIdx.x; idx < rows * t; idx += blockDim.x) {
      const long long g = first + base * t + idx;
      sp[idx] = p[g];
      sr[idx] = r[g];
      sap[idx] = ap[g];
      sapo[idx] = apo[g];
    }
    __syncthreads();
    for (int m = 0; m < kMaxSlots; ++m) {
      if (sel[m] < 0) continue;
      const T* x = sel[m] == 0 ? sp : (sel[m] == 1 ? sap : sapo);
      const T* y = sel[m] == 0 ? sr : sap;
      T s = acc[m];
      for (int q = 0; q < rows; ++q) s += x[q * t + xa[m]] * y[q * t + yb[m]];
      acc[m] = s;
    }
  }
  for (int m = 0; m < kMaxSlots; ++m) {
    if (sel[m] < 0) continue;
    const int o = threadIdx.x + m * blockDim.x;
    const long long part = kRanked ? static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x
                                   : static_cast<long long>(blockIdx.x);
    partials[part * n_out + o] = acc[m];
  }
}

template <typename T, bool kRanked>
__global__ void __launch_bounds__(repro::kThreads) fused_gram_reduce(
    const T* __restrict__ partials, T* __restrict__ out, int parts, int n_out) {
  if (kRanked) {
    partials += static_cast<long long>(blockIdx.x) * parts * n_out;
    out += static_cast<long long>(blockIdx.x) * n_out;
  }
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    T s = T(0);
    for (int q = 0; q < parts; ++q) s += partials[static_cast<long long>(q) * n_out + o];
    out[o] = s;
  }
}

template <typename T, bool kRanked>
int launch_as(const void* p, const void* r, const void* ap, const void* apo,
              void* partials, void* out, int ranks, long long n, int t, int parts,
              long long rows_per_part, cudaStream_t s) {
  const size_t smem = 4 * static_cast<size_t>(kChunk) * t * sizeof(T);
  fused_gram_partial<T, kRanked><<<dim3(parts, ranks), repro::kThreads, smem, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(r),
      static_cast<const T*>(ap), static_cast<const T*>(apo),
      static_cast<T*>(partials), n, t, rows_per_part);
  const int status = repro::launch_status();
  if (status != 0) return status;
  fused_gram_reduce<T, kRanked><<<ranks, repro::kThreads, 0, s>>>(
      static_cast<const T*>(partials), static_cast<T*>(out), parts, 3 * t * t);
  return repro::launch_status();
}

template <typename T>
int launch(const void* p, const void* r, const void* ap, const void* apo,
           void* partials, void* out, int ranks, long long n, int t, int parts,
           long long rows_per_part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ranks == 1
             ? launch_as<T, false>(p, r, ap, apo, partials, out, 1, n, t, parts, rows_per_part, s)
             : launch_as<T, true>(p, r, ap, apo, partials, out, ranks, n, t, parts, rows_per_part, s);
}

}  // namespace

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
