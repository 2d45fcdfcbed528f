// The row compare-exchange kernel of csrc/probes.cu in its earlier design,
// kept as a variant for timing beside the current one (kernel_variants.py
// links it in place of probes.cu's entry point): one column a block, held
// in shared memory, a barrier after every stage, at most kMaxRows rows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t umin32(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t umax32(uint32_t a, uint32_t b) {
  return a < b ? b : a;
}

// The top rows of a stage at distance d: r = (p / d) * 2d + p % d for
// p < top_rows(rows, d); those with r + d < rows have a partner.
__device__ __forceinline__ int top_rows(int rows, int d) {
  const int full = rows / (2 * d);
  const int rem = rows - full * 2 * d;
  return full * d + (rem < d ? rem : d);
}

constexpr int kSlabThreads = 1024;
constexpr int kMaxStages = 256;          // stages per launch
constexpr int64_t kMaxRows = 40 * 1024;  // 160 KB of the 227 KB a block may use

struct Distances {
  int32_t d[kMaxStages];
};

// Block c holds column c of every row in shared memory and runs the stages.
__global__ void __launch_bounds__(kSlabThreads)
row_cmpex_slab_kernel(const uint32_t* in, uint32_t* out, int rows, int64_t cols,
                      Distances ds, int nd) {
  extern __shared__ uint32_t col[];
  const int64_t c = blockIdx.x;
  for (int r = threadIdx.x; r < rows; r += kSlabThreads) {
    col[r] = in[static_cast<int64_t>(r) * cols + c];
  }
  __syncthreads();
  for (int s = 0; s < nd; ++s) {
    const int d = ds.d[s];
    const int top = top_rows(rows, d);
    if ((d & (d - 1)) == 0) {
      const int lg = __ffs(d) - 1;
      for (int p = threadIdx.x; p < top; p += kSlabThreads) {
        const int r = ((p >> lg) << (lg + 1)) | (p & (d - 1));
        if (r + d < rows) {
          const uint32_t x = col[r];
          const uint32_t y = col[r + d];
          col[r] = umin32(x, y);
          col[r + d] = umax32(x, y);
        }
      }
    } else {
      for (int p = threadIdx.x; p < top; p += kSlabThreads) {
        const int r = (p / d) * 2 * d + p % d;
        if (r + d < rows) {
          const uint32_t x = col[r];
          const uint32_t y = col[r + d];
          col[r] = umin32(x, y);
          col[r + d] = umax32(x, y);
        }
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rows; r += kSlabThreads) {
    out[static_cast<int64_t>(r) * cols + c] = col[r];
  }
}

}  // namespace

extern "C" {

// The row compare-exchange stages dists[0..nd) (host memory, each in
// [1, rows]) on a (rows, cols) u32 array, rows <= kMaxRows; in == out is
// allowed.  Sets *kernels to the number of kernels launched.  Returns the
// first launch's error, else cudaGetLastError().
int ukt_row_cmpex_u32(const void* in, void* out, int64_t rows, int64_t cols,
                      const int64_t* dists, int64_t nd, int64_t* kernels,
                      void* stream) {
  *kernels = 0;
  if (rows > kMaxRows || cols > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      row_cmpex_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxRows * sizeof(uint32_t)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  for (int64_t s0 = 0; s0 < nd; s0 += kMaxStages) {
    Distances ds;
    const int n = static_cast<int>(nd - s0 < kMaxStages ? nd - s0 : kMaxStages);
    for (int i = 0; i < n; ++i) ds.d[i] = static_cast<int32_t>(dists[s0 + i]);
    row_cmpex_slab_kernel<<<static_cast<unsigned>(cols), kSlabThreads,
                            static_cast<size_t>(rows * sizeof(uint32_t)),
                            static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<uint32_t*>(out), static_cast<int>(rows), cols, ds, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*kernels;
    src = static_cast<const uint32_t*>(out);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
