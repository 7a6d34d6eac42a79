// Block-ELL sparse matrix times block vector, W = A·V, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bsr_spmbv/kernel.py::bsr_spmbv_pallas.
//
// Layout: blocks (nbr, kmax, br, bc) dense tiles, indices (nbr, kmax) int32
// block-column ids (padding tiles are zero and carry column 0), V (n_v, t)
// row-major, W (n_w, t) row-major.  W[i·br + r, j] = Σ_k Σ_c
// blocks[i, k, r, c] · V[indices[i, k]·bc + c, j].  Rows of V at or past n_v
// read as zero, so the caller never builds a padded copy of V; rows of W at or
// past n_w are not written.
//
// What bounds it on the H100: bytes.  At Example 2.1's full scale (nbr =
// 163 840, kmax = 10, 8x8 f64 tiles, t = 8) the tiles alone are 839 MB
// against 2·t·nnz_stored ≈ 1.7 GFLOP, far below the tensor-core line, so the
// floor is one pass over the tiles plus V and W (~1.0 GB, ~0.30 ms at
// 3.35 TB/s).
//
// Design: the TPU kernel walks a sequential (nbr, kmax) grid with the output
// tile resident in VMEM.  Here one CTA owns ``rows_per_cta`` block rows
// (br·t outputs each, one thread per output) and walks k = 0..kmax-1 in order
// itself: per step the CTA stages each row's (br, bc) tile (contiguous in
// memory) and the (bc, t) slice of V it needs (also contiguous, since V is
// row-major) in shared memory, then every thread adds a length-bc dot product
// into a register.  Each tile byte is read from device memory exactly once
// and the sum over k and c runs in a fixed order, so results are
// deterministic (no atomics).  A later PR can replace the staging with TMA and
// the dot products with wgmma.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads) bsr_spmbv_kernel(
    const T* __restrict__ blocks, const int* __restrict__ indices,
    const T* __restrict__ v, T* __restrict__ w, int nbr, int kmax, int br,
    int bc, int t, long long n_v, long long n_w, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile_elems = br * bc;
  const int v_elems = bc * t;
  const int out_elems = br * t;
  T* tiles = reinterpret_cast<T*>(smem_raw);     // rows_per_cta * tile_elems
  T* vs = tiles + rows_per_cta * tile_elems;     // rows_per_cta * v_elems

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int rows_here =
      static_cast<int>(min(static_cast<long long>(rows_per_cta), nbr - row0));
  const int lr = threadIdx.x / out_elems;  // this thread's block row in the CTA
  const int e = threadIdx.x % out_elems;
  const int r = e / t;
  const int j = e % t;
  const bool active = lr < rows_here;

  T acc = T(0);
  for (int k = 0; k < kmax; ++k) {
    __syncthreads();  // the previous step's reads of shared memory are done
    for (int idx = threadIdx.x; idx < rows_here * tile_elems; idx += blockDim.x) {
      const int q = idx / tile_elems;
      const int o = idx - q * tile_elems;
      tiles[idx] = blocks[((row0 + q) * kmax + k) * tile_elems + o];
    }
    for (int idx = threadIdx.x; idx < rows_here * v_elems; idx += blockDim.x) {
      const int q = idx / v_elems;
      const int o = idx - q * v_elems;
      const long long col = indices[(row0 + q) * kmax + k];
      const long long vrow = col * bc + o / t;
      vs[idx] = vrow < n_v ? v[col * v_elems + o] : T(0);
    }
    __syncthreads();
    if (active) {
      const T* a = tiles + lr * tile_elems + r * bc;
      const T* x = vs + lr * v_elems + j;
      for (int c = 0; c < bc; ++c) acc += a[c] * x[c * t];
    }
  }
  if (active) {
    const long long row = (row0 + lr) * br + r;
    if (row < n_w) w[row * t + j] = acc;
  }
}

template <typename T>
int launch(const void* blocks, const void* indices, const void* v, void* w,
           int nbr, int kmax, int br, int bc, int t, long long n_v,
           long long n_w, int rows_per_cta, void* stream) {
  const size_t smem =
      static_cast<size_t>(rows_per_cta) * (br * bc + bc * t) * sizeof(T);
  const long long grid = repro::cdiv(nbr, rows_per_cta);
  bsr_spmbv_kernel<T><<<static_cast<unsigned>(grid), repro::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(indices),
      static_cast<const T*>(v), static_cast<T*>(w), nbr, kmax, br, bc, t, n_v,
      n_w, rows_per_cta);
  return repro::launch_status();
}

}  // namespace

REPRO_EXPORT int bsr_spmbv_f32(const void* blocks, const void* indices,
                               const void* v, void* w, int nbr, int kmax,
                               int br, int bc, int t, long long n_v,
                               long long n_w, int rows_per_cta, void* stream) {
  return launch<float>(blocks, indices, v, w, nbr, kmax, br, bc, t, n_v, n_w,
                       rows_per_cta, stream);
}

REPRO_EXPORT int bsr_spmbv_f64(const void* blocks, const void* indices,
                               const void* v, void* w, int nbr, int kmax,
                               int br, int bc, int t, long long n_v,
                               long long n_w, int rows_per_cta, void* stream) {
  return launch<double>(blocks, indices, v, w, nbr, kmax, br, bc, t, n_v, n_w,
                        rows_per_cta, stream);
}

REPRO_ERROR_STRING(bsr_spmbv)
