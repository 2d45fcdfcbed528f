// S1: sliding-window select of the count sketches, for sm_90a.
//
// Replaces XLA code, not a Pallas kernel: the window min/argmin pyramid
// `_window_argmin` and window AND `_window_all` of
// unikmer_tpu/ops/sketch.py:42,67 with the emit rules of
// `minimizer_windows` (:79-98) and `syncmer_windows` (:205-221), and the
// scaled threshold that count applies to the selected code
// (unikmer_tpu/models/count.py:205-207).  The JAX package builds the
// minimum by log2(w) rounds of shifted compares over the whole array.
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
// reads 9 B and writes 9 B, the syncmer reads 17 B and writes 9 B, the
// argmin reads 8 B and writes 8 B.
//
// Design: a run of R consecutive windows a thread, R the largest power of
// two at most min(w, kMaxRun), so the thread's windows share a core.
// Thread t of block b owns windows first + tR .. first + tR + R - 1
// (first = b * kThreads * R), elements from s0 (stage index, below).
// Every one of its windows holds the core [s0+R-1, s0+w); window j is
//   left suffix [s0+j, s0+R-1)  +  core  +  right prefix [s0+w, s0+w+j).
// The left suffix minima are scanned once right to left into registers,
// taking the new element on `<=` (it lies further left); the core minimum
// once left to right; the right prefix grows by one element a window,
// taken on `<` only.  The three parts combine left to right, a part to the
// right taken only when strictly smaller, so each window gets the leftmost
// minimum in (w + 3R - 6) / R compares: 4.1 at w = 15, 4.3 at w = 16 and
// 6.0 at w = 30 (R = 8), against w before.  Runs of 16 (3.6 and 4.5
// compares at 16 and 30) ran 4% slower on the H100: 63-72 registers a
// thread against 40-56, so fewer warps hide the stage's loads.  The
// minimizer's window validity comes from the same parts: the invalid
// elements are a bit array of the stage, and a window is invalid when its
// left bits, its core's or its right bits hold one.  Window i-1, which the
// emit rule reads, is the previous window of the run for j > 0; for j = 0
// it is [s0-1, s0+w-1): element s0-1, the left suffix and the core less
// its last element, parts the run has in hand, so two compares give it and
// no thread waits on another's.
//
// The block stages elements [first - kLead, first + kThreads*R + w - 1) of
// the keys in shared memory by 16-byte loads (2^64-1 outside [0, n)), and
// for the minimizer the validity as invalid bits (16 bytes a load, bit set
// outside [0, n)); stage index s is element first - kLead + s, so s0 =
// kLead + tR.  Stage slot s sits at s + s / R: a thread's elements lie R+1
// words from its neighbour's, so the threads of a warp hit distinct banks.
// A stage larger than kMaxStage bytes (w above about 4,300) is not staged:
// the runs then read device memory, exact and slow.  The outputs leave
// through a shared stage (the same padding): each thread puts its R codes
// or positions there and its R emit bits in one word, and after a barrier
// the block writes two windows a thread, a 16-byte store of keys and a
// 2-byte store of flags, neighbouring threads on neighbouring addresses.
// The syncmer's khash and valid are read there, by the same coalesced
// access, and its threshold applied.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRun = 8;           // windows a thread, at most
constexpr int kLead = 16;            // stage elements before a block's first window
constexpr int kMaxStage = 48 * 1024;  // dynamic shared bytes of the stage
constexpr int kMinimizer = 0;
constexpr int kSyncmer = 1;
constexpr int kArgmin = 2;
constexpr unsigned long long kMax = ~0ull;
static_assert((kMaxRun & (kMaxRun - 1)) == 0, "runs of a power of two");
static_assert(kLead % kMaxRun == 0 && kLead % 16 == 0,
              "the stage's 16-byte words and runs start together");

// Slot of stage (or output stage) index s: one spare word every R.
template <int R>
__host__ __device__ __forceinline__ int pad(int s) {
  return R > 1 ? s + s / R : s;
}

// Stage elements of a block: the lead, its windows and the w-1 halo, even.
template <int R>
__host__ __device__ __forceinline__ int stage_span(int w) {
  return (kLead + kThreads * R + w - 1 + 1) & ~1;
}

// u32 words of the invalid bits of a stage, one spare for a funnel shift.
template <int R>
__host__ __device__ __forceinline__ int stage_bit_words(int w) {
  return stage_span<R>(w) / 32 + 2;
}

// Bytes of the stage: the padded keys, then (minimizer) the invalid bits.
template <int R>
int64_t stage_bytes(int mode, int w) {
  const int64_t keys = 8 * (static_cast<int64_t>(pad<R>(stage_span<R>(w))) + 1);
  return keys + (mode == kMinimizer ? 4 * stage_bit_words<R>(w) : 0);
}

__device__ __forceinline__ uint32_t low_bits(int len) {
  return len >= 32 ? ~0u : (1u << len) - 1u;
}

// 4 bits: bit b set where byte b of x is non-zero.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// Stage elements in shared memory.
template <int R>
struct FromShared {
  const unsigned long long* keys;  // slot pad(s)
  const uint32_t* inv;             // bit s: element s invalid
  __device__ __forceinline__ unsigned long long key(int s) const {
    return keys[pad<R>(s)];
  }
  // len <= 32 invalid bits from s: bit u is element s + u
  __device__ __forceinline__ uint32_t bits(int s, int len) const {
    return __funnelshift_r(inv[s >> 5], inv[(s >> 5) + 1], s & 31) &
           low_bits(len);
  }
  __device__ __forceinline__ bool any(int a, int b) const {
    uint32_t acc = 0;
    for (int s = a; s < b; s += 32) acc |= bits(s, b - s);
    return acc != 0;
  }
};

// The same elements read from device memory: stage index s is element
// base + s, 2^64-1 and invalid outside [0, n).
struct FromGlobal {
  const unsigned long long* keys;
  const uint8_t* valid;
  int64_t base, n;
  __device__ __forceinline__ unsigned long long key(int s) const {
    const int64_t g = base + s;
    return g >= 0 && g < n ? __ldg(keys + g) : kMax;
  }
  __device__ __forceinline__ bool bad(int s) const {
    const int64_t g = base + s;
    return g < 0 || g >= n || __ldg(valid + g) == 0;
  }
  __device__ __forceinline__ uint32_t bits(int s, int len) const {
    uint32_t x = 0;
    for (int u = 0; u < len; ++u) x |= static_cast<uint32_t>(bad(s + u)) << u;
    return x;
  }
  __device__ __forceinline__ bool any(int a, int b) const {
    for (int s = a; s < b; ++s) {
      if (bad(s)) return true;
    }
    return false;
  }
};

struct Best {
  unsigned long long key;
  int pos;  // stage index
};

// Stage the keys (and the minimizer's invalid bits) of the block whose
// stage index 0 is element `base`.
template <int kMode, int R>
__device__ __forceinline__ void stage(const unsigned long long* __restrict__ keys,
                                      const uint8_t* __restrict__ valid,
                                      int64_t base, int64_t n, int w,
                                      unsigned long long* s_keys,
                                      uint32_t* s_inv) {
  const int t = threadIdx.x;
  const int pairs = stage_span<R>(w) / 2;
  for (int q = t; q < pairs; q += kThreads) {
    const int64_t g = base + 2 * q;
    unsigned long long a, b;
    if (g >= 0 && g + 1 < n) {
      const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(keys + g));
      a = v.x;
      b = v.y;
    } else {
      a = g >= 0 && g < n ? __ldg(keys + g) : kMax;
      b = g + 1 >= 0 && g + 1 < n ? __ldg(keys + g + 1) : kMax;
    }
    s_keys[pad<R>(2 * q)] = a;
    s_keys[pad<R>(2 * q + 1)] = b;
  }
  if constexpr (kMode == kMinimizer) {
    uint16_t* inv16 = reinterpret_cast<uint16_t*>(s_inv);
    const int chunks = 2 * stage_bit_words<R>(w);
    for (int q = t; q < chunks; q += kThreads) {
      const int64_t g = base + 16 * q;
      uint32_t ok;
      if (g >= 0 && g + 16 <= n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(valid + g));
        ok = nonzero4(v.x) | (nonzero4(v.y) << 4) | (nonzero4(v.z) << 8) |
             (nonzero4(v.w) << 12);
      } else {
        ok = 0;
        for (int b = 0; b < 16; ++b) {
          const int64_t e = g + b;
          ok |= static_cast<uint32_t>(e >= 0 && e < n && __ldg(valid + e) != 0)
                << b;
        }
      }
      inv16[q] = static_cast<uint16_t>(~ok);
    }
  }
}

// Thread t's run of R windows from stage index s0 = kLead + tR, into the
// output stage: codes (minimizer, 2^64-1 where not kept) or positions
// (argmin) at slot pad(tR + j), and the kept (minimizer) or offset 0 / w-1
// (syncmer) bits in s_bits[t].
template <int kMode, int R, class Src>
__device__ __forceinline__ void select_run(const Src& src, int w, int64_t base,
                                           unsigned long long max_hash,
                                           unsigned long long* s_out,
                                           uint32_t* s_bits) {
  const int t = threadIdx.x;
  const int s0 = kLead + t * R;
  // left suffix minima of [s0 + u, s0 + R - 1), u < R - 1
  unsigned long long lk[R];
  int lp[R];
#pragma unroll
  for (int u = R - 2; u >= 0; --u) {
    const unsigned long long v = src.key(s0 + u);
    if (u == R - 2 || v <= lk[u + 1]) {
      lk[u] = v;
      lp[u] = s0 + u;
    } else {
      lk[u] = lk[u + 1];
      lp[u] = lp[u + 1];
    }
  }
  // the core [s0 + R - 1, s0 + w); `before` is [s0 + R - 1, s0 + w - 1)
  Best core{src.key(s0 + R - 1), s0 + R - 1};
  for (int c = s0 + R; c < s0 + w - 1; ++c) {
    const unsigned long long v = src.key(c);
    if (v < core.key) core = Best{v, c};
  }
  const Best before = core;
  if (w > R) {
    const unsigned long long v = src.key(s0 + w - 1);
    if (v < core.key) core = Best{v, s0 + w - 1};
  }
  uint32_t linv = 0, rinv = 0;
  bool cinv = false, prev_ok = false;
  int prev_arg = 0;
  if constexpr (kMode == kMinimizer) {
    linv = src.bits(s0, R - 1);
    const bool before_inv = src.any(s0 + R - 1, s0 + w - 1);
    cinv = before_inv || src.bits(s0 + w - 1, 1);
    rinv = src.bits(s0 + w, R - 1);
    // window i-1 of the run's first window: [s0 - 1, s0 + w - 1)
    Best p{src.key(s0 - 1), s0 - 1};
    if (R > 1 && lk[0] < p.key) p = Best{lk[0], lp[0]};
    if (w > R && before.key < p.key) p = before;
    prev_arg = p.pos;
    prev_ok = !(src.bits(s0 - 1, 1) || linv || before_inv);
  }
  Best right{kMax, 0};
  uint32_t fl = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j > 0) {
      const unsigned long long v = src.key(s0 + w + j - 1);
      if (j == 1 || v < right.key) right = Best{v, s0 + w + j - 1};
    }
    Best m = core;
    if (j < R - 1 && lk[j] <= m.key) m = Best{lk[j], lp[j]};
    if (j > 0 && right.key < m.key) m = right;
    const int slot = pad<R>(t * R + j);
    if constexpr (kMode == kArgmin) {
      s_out[slot] = static_cast<unsigned long long>(base + m.pos);
    } else if constexpr (kMode == kSyncmer) {
      fl |= static_cast<uint32_t>(m.pos == s0 + j || m.pos == s0 + j + w - 1)
            << j;
    } else {
      const bool ok = !((linv >> j) | cinv | (rinv & ((1u << j) - 1u)));
      const bool keep = ok && (!prev_ok || m.pos != prev_arg) &&
                        m.key <= max_hash;
      s_out[slot] = keep ? m.key : kMax;
      fl |= static_cast<uint32_t>(keep) << j;
      prev_arg = m.pos;
      prev_ok = ok;
    }
  }
  if constexpr (kMode != kArgmin) s_bits[t] = fl;
}

template <int R>
__device__ __forceinline__ uint32_t bit_of(const uint32_t* s_bits, int e) {
  return (s_bits[e / R] >> (e % R)) & 1u;
}

// The block's windows [first, first + have) out of the output stage, two
// windows a thread.
template <int kMode, int R>
__device__ __forceinline__ void write_out(
    const unsigned long long* s_out, const uint32_t* s_bits, int64_t first,
    int have, const uint8_t* __restrict__ valid,
    const unsigned long long* __restrict__ khash, unsigned long long max_hash,
    unsigned long long* __restrict__ out, uint8_t* __restrict__ out_valid) {
  for (int e = 2 * threadIdx.x; e < have; e += 2 * kThreads) {
    const int64_t i = first + e;
    const bool pair = e + 1 < have;
    unsigned long long v[2];
    uint32_t keep[2] = {0u, 0u};
    if constexpr (kMode == kSyncmer) {
      unsigned long long kh[2];
      uint32_t ok[2];
      if (pair) {
        const ulonglong2 h = __ldg(reinterpret_cast<const ulonglong2*>(khash + i));
        const uint16_t f = __ldg(reinterpret_cast<const uint16_t*>(valid + i));
        kh[0] = h.x;
        kh[1] = h.y;
        ok[0] = (f & 0xffu) != 0;
        ok[1] = (f >> 8) != 0;
      } else {
        kh[0] = __ldg(khash + i);
        kh[1] = kMax;
        ok[0] = __ldg(valid + i) != 0;
        ok[1] = 0;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        keep[h] = bit_of<R>(s_bits, e + h) & ok[h] & (kh[h] <= max_hash);
        v[h] = keep[h] ? kh[h] : kMax;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) v[h] = s_out[pad<R>(e + h)];
      if constexpr (kMode == kMinimizer) {
        keep[0] = bit_of<R>(s_bits, e);
        keep[1] = bit_of<R>(s_bits, e + 1);
      }
    }
    if (pair) {
      *reinterpret_cast<ulonglong2*>(out + i) = make_ulonglong2(v[0], v[1]);
      if constexpr (kMode != kArgmin) {
        *reinterpret_cast<uint16_t*>(out_valid + i) =
            static_cast<uint16_t>(keep[0] | (keep[1] << 8));
      }
    } else {
      out[i] = v[0];
      if constexpr (kMode != kArgmin) out_valid[i] = keep[0];
    }
  }
}

template <int kMode, int R, bool kStaged>
__global__ void __launch_bounds__(kThreads)
sketch_select_kernel(const unsigned long long* __restrict__ keys,
                     const uint8_t* __restrict__ valid,
                     const unsigned long long* __restrict__ khash, int64_t n,
                     int w, unsigned long long max_hash,
                     unsigned long long* __restrict__ out,
                     uint8_t* __restrict__ out_valid) {
  __shared__ unsigned long long s_out[kThreads * (R + 1)];
  __shared__ uint32_t s_bits[kThreads];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * R);
  const int64_t base = first - kLead;
  if constexpr (kStaged) {
    extern __shared__ uint4 s_stage[];
    auto* s_keys = reinterpret_cast<unsigned long long*>(s_stage);
    auto* s_inv = reinterpret_cast<uint32_t*>(s_keys + pad<R>(stage_span<R>(w)) + 1);
    stage<kMode, R>(keys, valid, base, n, w, s_keys, s_inv);
    __syncthreads();
    select_run<kMode, R>(FromShared<R>{s_keys, s_inv}, w, base, max_hash,
                         s_out, s_bits);
  } else {
    select_run<kMode, R>(FromGlobal{keys, valid, base, n}, w, base, max_hash,
                         s_out, s_bits);
  }
  __syncthreads();
  const int64_t left = n - first;
  const int have = left < kThreads * R ? static_cast<int>(left) : kThreads * R;
  write_out<kMode, R>(s_out, s_bits, first, have, valid, khash, max_hash, out,
                      out_valid);
}

template <int kMode, int R>
int launch(int64_t n, int w, cudaStream_t stream,
           const unsigned long long* keys, const uint8_t* valid,
           const unsigned long long* khash, unsigned long long max_hash,
           unsigned long long* out, uint8_t* out_valid) {
  const int64_t blocks = (n + kThreads * R - 1) / (kThreads * R);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto b = static_cast<unsigned>(blocks);
  const int64_t smem = stage_bytes<R>(kMode, w);
  if constexpr (R == kMaxRun) {  // only w > kMaxRun outgrows the stage
    if (smem > kMaxStage) {
      sketch_select_kernel<kMode, R, false><<<b, kThreads, 0, stream>>>(
          keys, valid, khash, n, w, max_hash, out, out_valid);
      return static_cast<int>(cudaGetLastError());
    }
  }
  static const cudaError_t raised = cudaFuncSetAttribute(
      sketch_select_kernel<kMode, R, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStage);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  sketch_select_kernel<kMode, R, true>
      <<<b, kThreads, static_cast<size_t>(smem), stream>>>(
          keys, valid, khash, n, w, max_hash, out, out_valid);
  return static_cast<int>(cudaGetLastError());
}

// Launch with R the largest power of two at most min(w, kMaxRun).
template <int kMode, int R = kMaxRun>
int launch_run(int64_t n, int w, cudaStream_t s, const unsigned long long* k,
               const uint8_t* v, const unsigned long long* h,
               unsigned long long max_hash, unsigned long long* o,
               uint8_t* ov) {
  if constexpr (R > 1) {
    if (w < R) return launch_run<kMode, R / 2>(n, w, s, k, v, h, max_hash, o, ov);
  }
  return launch<kMode, R>(n, w, s, k, v, h, max_hash, o, ov);
}

}  // namespace

extern "C" {

// Launch S1 in `mode` (0 minimizer, 1 syncmer, 2 argmin) over n >= 1
// windows of width w >= 1 on `stream`.  keys, khash and out hold n u64;
// valid and out_valid n bytes (valid unused by mode 2, khash used by mode 1
// only, out_valid unused by mode 2); every pointer 16-byte aligned.
// Returns cudaGetLastError().
int ukt_sketch_select(int mode, const void* keys, const void* valid,
                      const void* khash, int64_t n, int w, uint64_t max_hash,
                      void* out, void* out_valid, void* stream) {
  if (n < 1 || w < 1 || w > (1 << 30) || mode < kMinimizer || mode > kArgmin ||
      keys == nullptr || out == nullptr ||
      (mode != kArgmin && (valid == nullptr || out_valid == nullptr)) ||
      (mode == kSyncmer && khash == nullptr) ||
      (reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(valid) |
       reinterpret_cast<uintptr_t>(khash) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(out_valid)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* k = static_cast<const unsigned long long*>(keys);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* h = static_cast<const unsigned long long*>(khash);
  auto* o = static_cast<unsigned long long*>(out);
  auto* ov = static_cast<uint8_t*>(out_valid);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kMinimizer) return launch_run<kMinimizer>(n, w, s, k, v, h, max_hash, o, ov);
  if (mode == kSyncmer) return launch_run<kSyncmer>(n, w, s, k, v, h, max_hash, o, ov);
  return launch_run<kArgmin>(n, w, s, k, v, h, max_hash, o, ov);
}

}  // extern "C"
