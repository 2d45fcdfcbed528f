// P1/P2: the Pallas feasibility probes of scripts/exp_pallas_dma.py and
// scripts/exp_pallas_dma2.py as four hand-written kernels for sm_90a.
//
// All four move u32 values.  The probes' arrays are small (2 MiB, or
// 32 MiB for P1a), so each kernel is bound by device-memory bandwidth
// at best, and at these sizes by launch latency: P1b/P1c/P2a/P2b move
// 4.19 MB, 1.25 us at 3.35 TB/s, below one launch's cost.
//
// copy_inc_u32      replaces probe1 (exp_pallas_dma.py:54, call :84) and
//                   probe1_fixed (exp_pallas_dma2.py:49, call :80):
//                   out = in + 1, wrapping at 2^32.  The TPU stages 2 MiB
//                   blocks HBM -> VMEM -> HBM with DMA semaphores to reach
//                   HBM at all; here a grid-stride loop of 16-byte uint4
//                   loads and stores streams device memory directly.
// row_cmpex_u32     replaces probe2 (exp_pallas_dma.py:101, call :118) and
//                   cmpex_rows_kernel (exp_pallas_dma2.py:96, call :123):
//                   compare-exchange stages at row distances d on an (R, C)
//                   array; rows (g*2d + i, g*2d + i + d) for i < d take
//                   (min, max), and a row whose partner would lie past R
//                   (ragged R) keeps its value.  Columns never mix, so each
//                   block holds one column, up to kMaxRows rows (160 KB),
//                   in shared memory and runs all the stages there, one
//                   launch in all (the TPU kept the block in VMEM for the
//                   same reason): C blocks, 128 for the probes, fill the
//                   SMs, and each thread does a few pairs per stage, with
//                   shifts in place of divisions when d is a power of two.
// transpose128_u32  replaces probe3 (exp_pallas_dma.py:130, call :138): each
//                   (128, 128) tile is transposed, through a 32 x 33
//                   shared-memory tile (padded against bank conflicts) so
//                   both the loads and the stores are coalesced.
// lane_cmpex_u32    replaces probe4_roll (exp_pallas_dma2.py:137, call :154):
//                   seven lane stages d = 64, 32, ..., 1 on 128-lane rows;
//                   lane j pairs with lane j ^ d, the lower taking the min.
//                   One warp per row, thread t holding lanes t + 32q,
//                   q = 0..3: d = 64 and 32 exchange between a thread's own
//                   registers, d <= 16 through __shfl_xor_sync, Hopper's
//                   counterpart of pltpu.roll.
//
// Comparisons are unsigned throughout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM for grid-stride loops

__device__ __forceinline__ uint32_t umin32(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t umax32(uint32_t a, uint32_t b) {
  return a < b ? b : a;
}

__global__ void __launch_bounds__(kThreads)
copy_inc_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int64_t n, int vec) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const uint4* __restrict__ in4 = reinterpret_cast<const uint4*>(in);
    uint4* __restrict__ out4 = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      uint4 v = in4[i];
      v.x += 1u;
      v.y += 1u;
      v.z += 1u;
      v.w += 1u;
      out4[i] = v;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) out[i] = in[i] + 1u;
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

constexpr int kTile = 32;
constexpr int kTileRows = 8;

// Block (bx, by, t) transposes the 32 x 32 sub-tile (by, bx) of tile t into
// sub-tile (bx, by) of the output tile.
__global__ void __launch_bounds__(kTile * kTileRows)
transpose128_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int64_t base = static_cast<int64_t>(blockIdx.z) * 128 * 128;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += kTileRows) {
    tile[j][threadIdx.x] = in[base + static_cast<int64_t>(y0 + j) * 128 + x];
  }
  __syncthreads();
  const int ox = blockIdx.y * kTile + threadIdx.x;
  const int oy0 = blockIdx.x * kTile;
  for (int j = threadIdx.y; j < kTile; j += kTileRows) {
    out[base + static_cast<int64_t>(oy0 + j) * 128 + ox] = tile[threadIdx.x][j];
  }
}

constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
lane_cmpex_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int t = threadIdx.x & 31;
  const uint32_t* src = in + row * 128;
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = src[t + 32 * q];
  // d = 64: lane t + 32q pairs with t + 32(q ^ 2); q = 0, 1 are the lower
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t lo = umin32(v[q], v[q + 2]);
    v[q + 2] = umax32(v[q], v[q + 2]);
    v[q] = lo;
  }
  // d = 32: q pairs with q ^ 1; q = 0, 2 are the lower
#pragma unroll
  for (int q = 0; q < 4; q += 2) {
    const uint32_t lo = umin32(v[q], v[q + 1]);
    v[q + 1] = umax32(v[q], v[q + 1]);
    v[q] = lo;
  }
  // d <= 16: lane t + 32q pairs with (t ^ d) + 32q in another thread
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const bool lower = (t & d) == 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t other = __shfl_xor_sync(0xffffffffu, v[q], d);
      v[q] = lower ? umin32(v[q], other) : umax32(v[q], other);
    }
  }
  uint32_t* dst = out + row * 128;
#pragma unroll
  for (int q = 0; q < 4; ++q) dst[t + 32 * q] = v[q];
}

unsigned grid_for(int64_t work, int64_t cap) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// out = in + 1 over n u32 values.  Returns cudaGetLastError().
int ukt_copy_inc_u32(const void* in, void* out, int64_t n, void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  copy_inc_kernel<<<grid_for(vec ? (n >> 2) + 4 : n, kMaxBlocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// The row compare-exchange stages dists[0..nd) (host memory, each in
// [1, rows]) on a (rows, cols) u32 array, rows <= kMaxRows; in == out is
// allowed.  Returns the first launch's error, else cudaGetLastError().
int ukt_row_cmpex_u32(const void* in, void* out, int64_t rows, int64_t cols,
                      const int64_t* dists, int64_t nd, void* stream) {
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
    src = static_cast<const uint32_t*>(out);
  }
  return static_cast<int>(cudaSuccess);
}

// Transpose each of `tiles` (128, 128) u32 tiles.  Returns cudaGetLastError().
int ukt_transpose128_u32(const void* in, void* out, int64_t tiles,
                         void* stream) {
  const dim3 grid(128 / kTile, 128 / kTile, static_cast<unsigned>(tiles));
  const dim3 block(kTile, kTileRows);
  transpose128_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The seven lane stages d = 64..1 on each of `rows` 128-lane u32 rows.
// Returns cudaGetLastError().
int ukt_lane_cmpex_u32(const void* in, void* out, int64_t rows, void* stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  lane_cmpex_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
