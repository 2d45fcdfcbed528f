// S1 in its earlier design, a window a thread scanned element by element,
// kept as a variant for timing beside csrc/sketch.cu (kernel_variants.py
// links it in place of sketch.cu's entry point).  Otherwise as it stood:
//
// S1: sliding-window select of the count sketches, for sm_90a.
//
// Replaces XLA code, not a Pallas kernel: the window min/argmin pyramid
// `_window_argmin` and window AND `_window_all` of
// unikmer_tpu/ops/sketch.py:42,67 with the emit rules of
// `minimizer_windows` (:79-98) and `syncmer_windows` (:205-221), and the
// scaled threshold that count applies to the selected code
// (unikmer_tpu/models/count.py:205-207).  The JAX package builds the
// minimum by log2(w) rounds of shifted compares over the whole array;
// here each window is scanned from shared memory.
//
// Inputs are H1's outputs (csrc/nthash.cu): keyed u64 hashes, 2^64-1 where
// the window is invalid, and u8 validity.  For every window i of n, with
// the elements of [i, i+w) cut at n:
//   argmin[i]  the leftmost position of the minimum key, unsigned order
//   mode 0, minimizer: keys and valid of the k-mers;
//     wvalid[i] = valid[i] & ... & valid[i+w-1] (false past n),
//     emit = wvalid[i] & (!wvalid[i-1] | argmin[i] != argmin[i-1]),
//     code = keys[argmin[i]];
//   mode 1, closed syncmer: keys of the s-mers, valid and khash of the
//     k-mers, w = k-s+1; emit = valid[i] & (argmin[i]-i is 0 or w-1),
//     code = khash[i];
//   modes 0 and 1 write out[i] = code where emit and code <= max_hash, else
//     2^64-1, and out_valid[i] = that condition;
//   mode 2, argmin: out[i] = argmin[i] (the compat rule's vote pass).
//
// Bound on the H100: device-memory bandwidth.  Per window the minimizer
// reads 9 B and writes 9 B; the syncmer reads 17 B and writes 9 B.  The
// scans cost w compares a window, from shared memory.
//
// Design: the simple form.  Block b computes the kTile windows from
// lo = b * kStride - 1: one window before the kStride windows it writes,
// so that the minimizer's rule finds window i-1 in the same block.  The
// block stages elements [lo, lo + kTile + w - 1) of keys (and, for the
// minimizer, of valid) in shared memory, 2^64-1 and invalid outside
// [0, n); a thread scans each of its windows element by element, the
// windows of neighbouring threads on neighbouring elements, so the
// shared loads are free of bank conflicts and the stores coalesce.  A
// stage larger than kMaxStage bytes (w above about 3,500) is not staged:
// the scan then reads device memory, exact and slow.  Later work: a
// monotone deque a thread, and the select fused with H1's roll.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;          // windows a block computes
constexpr int kStride = kTile - 1;   // windows a block writes
constexpr int kMaxStage = 40 * 1024;  // dynamic shared bytes, no opt-in
constexpr int kMinimizer = 0;
constexpr int kSyncmer = 1;
constexpr int kArgmin = 2;
constexpr unsigned long long kMax = ~0ull;
static_assert(kTile % kThreads == 0, "whole rounds of windows");

// Elements [lo, ...) read from device memory: 2^64-1 and invalid outside
// [0, n).
struct FromGlobal {
  const unsigned long long* keys;
  const uint8_t* valid;
  int64_t lo, n;
  __device__ __forceinline__ unsigned long long key(int e) const {
    const int64_t g = lo + e;
    return g >= 0 && g < n ? __ldg(keys + g) : kMax;
  }
  __device__ __forceinline__ bool ok(int e) const {
    const int64_t g = lo + e;
    return g >= 0 && g < n && __ldg(valid + g) != 0;
  }
};

// The same elements staged in shared memory.
struct FromShared {
  const unsigned long long* keys;
  const uint8_t* valid;
  __device__ __forceinline__ unsigned long long key(int e) const {
    return keys[e];
  }
  __device__ __forceinline__ bool ok(int e) const { return valid[e] != 0; }
};

// Leftmost argmin of elements [r, r + w) and, when kAll, whether all are
// valid.
template <bool kAll, class Src>
__device__ __forceinline__ int scan(const Src& src, int r, int w, bool& all) {
  unsigned long long best = src.key(r);
  int arg = r;
  bool ok = true;
  if constexpr (kAll) ok = src.ok(r);
  for (int j = r + 1; j < r + w; ++j) {
    const unsigned long long v = src.key(j);
    if (v < best) {  // strict: the leftmost minimum stays
      best = v;
      arg = j;
    }
    if constexpr (kAll) ok &= src.ok(j);
  }
  all = ok;
  return arg;
}

template <int kMode, class Src>
__device__ __forceinline__ void select_tile(
    const Src& src, int64_t lo, int64_t n, int w,
    const uint8_t* __restrict__ valid,
    const unsigned long long* __restrict__ khash, unsigned long long max_hash,
    unsigned long long* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int t = threadIdx.x;
  if constexpr (kMode == kMinimizer) {
    __shared__ int s_arg[kTile];
    __shared__ uint8_t s_ok[kTile];
    for (int r = t; r < kTile && lo + r < n; r += kThreads) {
      bool all;
      s_arg[r] = scan<true>(src, r, w, all);
      s_ok[r] = all;  // window lo = -1 holds element -1: invalid
    }
    __syncthreads();
    for (int r = t + 1; r < kTile && lo + r < n; r += kThreads) {
      const int a = s_arg[r];
      const bool emit = s_ok[r] && (!s_ok[r - 1] || a != s_arg[r - 1]);
      const unsigned long long code = src.key(a);
      const bool keep = emit && code <= max_hash;
      out[lo + r] = keep ? code : kMax;
      out_valid[lo + r] = keep;
    }
  } else {
    for (int r = t + 1; r < kTile && lo + r < n; r += kThreads) {
      bool all;
      const int a = scan<false>(src, r, w, all);
      const int64_t i = lo + r;
      if constexpr (kMode == kArgmin) {
        out[i] = lo + a;
      } else {
        const int off = a - r;
        const unsigned long long code = khash[i];
        const bool keep = valid[i] && (off == 0 || off == w - 1) &&
                          code <= max_hash;
        out[i] = keep ? code : kMax;
        out_valid[i] = keep;
      }
    }
  }
}

template <int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads)
sketch_select_kernel(const unsigned long long* __restrict__ keys,
                     const uint8_t* __restrict__ valid,
                     const unsigned long long* __restrict__ khash, int64_t n,
                     int w, unsigned long long max_hash,
                     unsigned long long* __restrict__ out,
                     uint8_t* __restrict__ out_valid) {
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kStride - 1;
  if constexpr (!kStaged) {
    select_tile<kMode>(FromGlobal{keys, valid, lo, n}, lo, n, w, valid, khash,
                       max_hash, out, out_valid);
  } else {
    extern __shared__ unsigned long long s_stage[];
    const int span = kTile + w - 1;
    uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_stage + span);
    for (int e = threadIdx.x; e < span; e += kThreads) {
      const int64_t g = lo + e;
      const bool in = g >= 0 && g < n;
      s_stage[e] = in ? __ldg(keys + g) : kMax;
      if constexpr (kMode == kMinimizer) {
        s_valid[e] = in ? __ldg(valid + g) : 0;
      }
    }
    __syncthreads();
    select_tile<kMode>(FromShared{s_stage, s_valid}, lo, n, w, valid, khash,
                       max_hash, out, out_valid);
  }
}

// Bytes of shared stage a launch of this mode needs at window width w.
int64_t stage_bytes(int mode, int w) {
  return (static_cast<int64_t>(kTile) + w - 1) * (mode == kMinimizer ? 9 : 8);
}

template <int kMode>
void launch(unsigned blocks, bool staged, size_t smem, cudaStream_t stream,
            const unsigned long long* keys, const uint8_t* valid,
            const unsigned long long* khash, int64_t n, int w,
            unsigned long long max_hash, unsigned long long* out,
            uint8_t* out_valid) {
  if (staged) {
    sketch_select_kernel<kMode, true><<<blocks, kThreads, smem, stream>>>(
        keys, valid, khash, n, w, max_hash, out, out_valid);
  } else {
    sketch_select_kernel<kMode, false><<<blocks, kThreads, 0, stream>>>(
        keys, valid, khash, n, w, max_hash, out, out_valid);
  }
}

}  // namespace

extern "C" {

// Launch S1 in `mode` (0 minimizer, 1 syncmer, 2 argmin) over n >= 1
// windows of width w >= 1 on `stream`.  keys, khash and out hold n u64;
// valid and out_valid n bytes (valid unused by mode 2, khash used by mode 1
// only, out_valid unused by mode 2).  Returns cudaGetLastError().
int ukt_sketch_select(int mode, const void* keys, const void* valid,
                      const void* khash, int64_t n, int w, uint64_t max_hash,
                      void* out, void* out_valid, void* stream) {
  const int64_t blocks = (n + kStride - 1) / kStride;
  if (n < 1 || w < 1 || w > (1 << 30) || mode < kMinimizer || mode > kArgmin ||
      blocks > 0x7fffffff || keys == nullptr || out == nullptr ||
      (mode != kArgmin && (valid == nullptr || out_valid == nullptr)) ||
      (mode == kSyncmer && khash == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = stage_bytes(mode, w);
  const bool staged = smem <= kMaxStage;
  const auto* k = static_cast<const unsigned long long*>(keys);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* h = static_cast<const unsigned long long*>(khash);
  auto* o = static_cast<unsigned long long*>(out);
  auto* ov = static_cast<uint8_t*>(out_valid);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<unsigned>(blocks);
  const size_t bytes = staged ? static_cast<size_t>(smem) : 0;
  if (mode == kMinimizer) {
    launch<kMinimizer>(b, staged, bytes, s, k, v, h, n, w, max_hash, o, ov);
  } else if (mode == kSyncmer) {
    launch<kSyncmer>(b, staged, bytes, s, k, v, h, n, w, max_hash, o, ov);
  } else {
    launch<kArgmin>(b, staged, bytes, s, k, v, h, n, w, max_hash, o, ov);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
