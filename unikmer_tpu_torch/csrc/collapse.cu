// C1: the collapse and compaction of a u64 code array in one pass, for
// sm_90a.
//
// It replaces no Pallas kernel: the JAX package does this step as XLA code,
// `compact_sorted`/`compact_aux` (unikmer_tpu/ops/sort.py:189-217), the run
// flags of `collapse_sorted` (:220-272), and `_compact_mask`/`common`
// (unikmer_tpu/ops/device_sets.py:72-86).  The port did it as a chain of
// plain PyTorch kernels (run edges and their cats, a mask, a cumsum, a where,
// a fill, a scatter and a sum: eight to ten passes over the capacity), which
// stays beside this kernel as its CPU twin (ops/collapse.py).
//
// For each slot i of a key array it decides, in registers, whether the slot
// is kept, and writes the kept keys (and an optional 4- or 8-byte aux column
// by the same flags) as a dense prefix of a new array in input order, the
// tail CODE_SENTINEL (aux 0), and the kept count to a device int64.  The
// keep rules (`mode`):
//   distinct   s[i] != sentinel and s[i] starts its run (s sorted)
//   unique     ... and ends it too
//   repeated   ... and does not end it
//   threshold  distinct, and s[i + reach] == s[i]: the run holds at least
//              reach + 1 slots (`common`); a second read at offset reach,
//              issued only for slots that start a run, any reach
//   mask       mask[i] != 0 (keys in any order)
// In the sorted modes every sentinel-keyed slot sorts to the tail, so
// `s[i] != sentinel` is the head of the array; a real sentinel-valued code
// is counted by the caller before the sort (`n_sent_real`, a device int64
// or null) and added to the count as the JAX package does: distinct when
// > 0, unique when == 1, repeated when > 1.
//
// Bound on the H100: device-memory traffic.  One read of 8 B a slot and one
// write of 8 B a slot (a kept key or the sentinel tail): 16 B a slot, with
// 1 B a slot more in mask mode, the aux column's bytes where there is one,
// and the second stream of threshold mode where it misses L2.
//
// Design.  Two launches on the caller's stream, no host synchronisation, no
// allocation (the wrapper allocates the output, the count and the scratch):
//   1. collapse_tile<kSorted, kAuxBytes>: a block takes a tile of 4096 keys
//      (its index from an atomic counter, so it waits only on tiles that
//      started before it).  Lane l of warp w loads pair r of the warp's 512
//      keys, slots 64 r + 2 l and + 1, by one 16-byte load (two 8-byte loads
//      off a 16-byte boundary); a slot past n reads as the sentinel, which no
//      rule keeps.  A key's neighbours come from the pair itself, warp
//      shuffles (the lane before's second key, the lane after's first; lane
//      0 and 31 from the round before and after) and one halo key at each
//      end of the warp's span.  The keep flags of a round are two ballots;
//      a key's slot in its warp is their popcounts below its lane, and the
//      warps' totals are scanned in the block.  The tile's count is
//      published at once as an aggregate; warp 0 then walks back over the
//      earlier tiles, 32 at a time (one lane each), adding aggregates until
//      it meets an inclusive prefix, and publishes its own.  Meanwhile every
//      warp writes its kept keys (and aux) to their block slots in shared
//      memory; after one barrier the block stores them in slot order, so
//      consecutive threads store to consecutive addresses.  The last tile
//      writes the total to the scratch and the count, with the real-sentinel
//      rule, to the output.
//   2. collapse_fill<kAuxBytes>: a grid-strided fill of slots [total, n)
//      with the sentinel (aux 0) by 16-byte stores, the total read on the
//      card.  A fill ahead of the kernel (cudaMemsetAsync) writes every
//      slot twice and measured no faster (slower with an aux column:
//      PERF.md section 6, C1's row); a tile could not write the tail,
//      since only the last tile to finish knows the total.
// Look-back memory order, as K2's (csrc/radix_sort.cu): a status word is 64
// bits, 2 flag bits (aggregate, inclusive prefix) above a 62-bit count,
// stored and loaded as device-scope relaxed atomics; nothing else is
// published through it.  The scratch is [tile counter][total][status words
// a tile], zeroed by one cudaMemsetAsync at the entry point.
// Registers: 16 keys, 16 ballot words and the flags a thread; the stage is
// 32 KB of dynamic shared memory (48 or 64 KB with an aux column).

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using u64 = unsigned long long;

constexpr u64 kSentinel = ~0ull;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                  // 16-byte pairs a thread
constexpr int kWarpKeys = 64 * kRounds;     // consecutive keys a warp
constexpr int kTile = kWarps * kWarpKeys;   // keys a block
constexpr u64 kFlagAggregate = 1ull << 62;
constexpr u64 kFlagPrefix = 2ull << 62;
constexpr u64 kCountMask = kFlagAggregate - 1;
constexpr int kFillBlocks = 1056;           // 8 an SM
constexpr int kScratchHead = 2;             // tile counter, total

enum Mode : int {
  kDistinct = 0,
  kUnique = 1,
  kRepeated = 2,
  kThreshold = 3,
  kMask = 4,
};

template <int kAuxBytes>
using AuxT = std::conditional_t<kAuxBytes == 8, u64, unsigned>;

__device__ __forceinline__ void publish(u64* word, u64 v) {
  cuda::atomic_ref<u64, cuda::thread_scope_device>(*word).store(
      v, cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ u64 peek(u64* word) {
  return cuda::atomic_ref<u64, cuda::thread_scope_device>(*word).load(
      cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ u64 key_at(const u64* __restrict__ keys,
                                      int64_t i, int64_t n) {
  return i >= 0 && i < n ? keys[i] : kSentinel;
}

// The count the JAX package reports beside the kept keys: the kept slots
// plus the real sentinel-valued code, by the mode's rule.
__device__ __forceinline__ int64_t with_real_sentinel(
    int64_t kept, int mode, const int64_t* __restrict__ n_sent_real) {
  if (n_sent_real == nullptr) return kept;
  const int64_t s = *n_sent_real;
  const bool extra = mode == kDistinct   ? s > 0
                     : mode == kUnique   ? s == 1
                     : mode == kRepeated ? s > 1
                                         : false;
  return kept + (extra ? 1 : 0);
}

template <bool kSorted, int kAuxBytes>
__global__ void __launch_bounds__(kThreads)
collapse_tile(const u64* __restrict__ keys,
              const unsigned char* __restrict__ mask,
              const void* __restrict__ aux_in, int64_t n, int mode,
              int64_t reach, int aligned,
              const int64_t* __restrict__ n_sent_real,
              u64* __restrict__ keys_out, void* __restrict__ aux_out,
              int64_t* __restrict__ n_out, u64* __restrict__ scratch,
              int64_t tiles) {
  using Aux = AuxT<kAuxBytes>;
  constexpr bool kAux = kAuxBytes != 0;
  extern __shared__ __align__(16) unsigned char stage[];
  u64* const stage_keys = reinterpret_cast<u64*>(stage);
  Aux* const stage_aux = reinterpret_cast<Aux*>(stage + kTile * 8);
  __shared__ int warp_total[kWarps];
  __shared__ int64_t s_tile;
  __shared__ int64_t s_prefix;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lower_lanes = (1u << lane) - 1;

  if (t == 0) s_tile = static_cast<int64_t>(atomicAdd(scratch, 1ull));
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t warp0 = tile * kTile + static_cast<int64_t>(warp) * kWarpKeys;

  // load: pair r of this lane holds slots warp0 + 64 r + 2 lane and + 1
  u64 a[kRounds], b[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = warp0 + 64 * r + 2 * lane;
    if (aligned && i + 1 < n) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(keys + i);
      a[r] = v.x;
      b[r] = v.y;
    } else {
      a[r] = key_at(keys, i, n);
      b[r] = key_at(keys, i + 1, n);
    }
  }

  // keep flags: bit r of ka / kb for the pair's first / second key
  unsigned ka = 0, kb = 0;
  if constexpr (kSorted) {
    const u64 halo_prev = lane == 0 ? (warp0 > 0 ? key_at(keys, warp0 - 1, n)
                                                 : ~a[0])
                                    : 0ull;
    const u64 halo_next = lane == 31 ? key_at(keys, warp0 + kWarpKeys, n)
                                     : 0ull;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const u64 up = __shfl_up_sync(0xffffffffu, b[r], 1);
      const u64 down = __shfl_down_sync(0xffffffffu, a[r], 1);
      const u64 wrap_prev =
          __shfl_sync(0xffffffffu, r > 0 ? b[r > 0 ? r - 1 : 0] : 0ull, 31);
      const u64 wrap_next = __shfl_sync(
          0xffffffffu, r + 1 < kRounds ? a[r + 1 < kRounds ? r + 1 : r] : 0ull,
          0);
      const u64 prev = lane > 0 ? up : r > 0 ? wrap_prev : halo_prev;
      const u64 next = lane < 31 ? down : r + 1 < kRounds ? wrap_next
                                                          : halo_next;
      const bool pair_differs = a[r] != b[r];
      const bool start_a = a[r] != kSentinel && a[r] != prev;
      const bool start_b = b[r] != kSentinel && pair_differs;
      bool keep_a = start_a, keep_b = start_b;
      if (mode == kUnique) {
        keep_a = start_a && pair_differs;
        keep_b = start_b && next != b[r];
      } else if (mode == kRepeated) {
        keep_a = start_a && !pair_differs;
        keep_b = start_b && next == b[r];
      }
      ka |= static_cast<unsigned>(keep_a) << r;
      kb |= static_cast<unsigned>(keep_b) << r;
    }
    if (mode == kThreshold) {
      // a run that starts at i holds reach + 1 slots when s[i + reach]
      // still holds its key: one load for each start
      u64 far_a[kRounds], far_b[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int64_t i = warp0 + 64 * r + 2 * lane + reach;
        far_a[r] = (ka >> r) & 1 ? key_at(keys, i, n) : 0ull;
        far_b[r] = (kb >> r) & 1 ? key_at(keys, i + 1, n) : 0ull;
      }
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (far_a[r] != a[r]) ka &= ~(1u << r);
        if (far_b[r] != b[r]) kb &= ~(1u << r);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t i = warp0 + 64 * r + 2 * lane;
      const bool keep_a = i < n && mask[i] != 0;
      const bool keep_b = i + 1 < n && mask[i + 1] != 0;
      ka |= static_cast<unsigned>(keep_a) << r;
      kb |= static_cast<unsigned>(keep_b) << r;
    }
  }

  // the aux of the kept keys, loaded while the counts are taken
  Aux xa[kAux ? kRounds : 1], xb[kAux ? kRounds : 1];
  if constexpr (kAux) {
    const Aux* const src = static_cast<const Aux*>(aux_in);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t i = warp0 + 64 * r + 2 * lane;
      xa[r] = (ka >> r) & 1 ? src[i] : Aux(0);
      xb[r] = (kb >> r) & 1 ? src[i + 1] : Aux(0);
    }
  }

  // a key's slot in its warp: the kept keys of earlier rounds, then of
  // lower lanes in its round (a pair's first before its second)
  unsigned vote_a[kRounds], vote_b[kRounds];
  int warp_kept = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    vote_a[r] = __ballot_sync(0xffffffffu, (ka >> r) & 1);
    vote_b[r] = __ballot_sync(0xffffffffu, (kb >> r) & 1);
    warp_kept += __popc(vote_a[r]) + __popc(vote_b[r]);
  }
  if (lane == 0) warp_total[warp] = warp_kept;
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_total[w];
    before += w < warp ? c : 0;
    count += c;
  }
  u64* const status = scratch + kScratchHead;
  if (t == 0)
    publish(status + tile, (tile == 0 ? kFlagPrefix : kFlagAggregate) |
                               static_cast<u64>(count));

  // the kept keys to their block slots, in input order
  int slot = before;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int at = slot + __popc(vote_a[r] & lower_lanes) +
                   __popc(vote_b[r] & lower_lanes);
    const bool keep_a = (ka >> r) & 1;
    if (keep_a) {
      stage_keys[at] = a[r];
      if constexpr (kAux) stage_aux[at] = xa[r];
    }
    if ((kb >> r) & 1) {
      stage_keys[at + keep_a] = b[r];
      if constexpr (kAux) stage_aux[at + keep_a] = xb[r];
    }
    slot += __popc(vote_a[r]) + __popc(vote_b[r]);
  }

  // warp 0: the tile's exclusive prefix by the look-back, 32 tiles a step
  if (warp == 0) {
    u64 prefix = 0;
    if (tile > 0) {
      for (int64_t j = tile - 1 - lane;; j -= 32) {
        u64 s = kFlagPrefix;  // before tile 0: an inclusive prefix of 0
        if (j >= 0) {
          do {
            s = peek(status + j);
          } while ((s & ~kCountMask) == 0);
        }
        const unsigned done =
            __ballot_sync(0xffffffffu, (s & kFlagPrefix) != 0);
        // lanes up to the nearest inclusive prefix add their counts
        const int stop = done ? __ffs(done) - 1 : 31;
        u64 v = lane <= stop ? s & kCountMask : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        prefix += v;
        if (done) break;
      }
      if (lane == 0)
        publish(status + tile, kFlagPrefix | (prefix + static_cast<u64>(count)));
    }
    if (lane == 0) {
      s_prefix = static_cast<int64_t>(prefix);
      if (tile == tiles - 1) {
        const int64_t total = static_cast<int64_t>(prefix) + count;
        scratch[1] = static_cast<u64>(total);
        *n_out = with_real_sentinel(total, mode, n_sent_real);
      }
    }
  }
  __syncthreads();

  // the block's kept keys in slot order: consecutive threads, addresses
  const int64_t base = s_prefix;
  for (int i = t; i < count; i += kThreads) {
    keys_out[base + i] = stage_keys[i];
    if constexpr (kAux) static_cast<Aux*>(aux_out)[base + i] = stage_aux[i];
  }
}

// Slots [total, n) of the output: the sentinel, and 0 in the aux column;
// 16-byte stores of slot pairs (the outputs are fresh allocations).
template <int kAuxBytes>
__global__ void __launch_bounds__(kThreads)
collapse_fill(u64* __restrict__ keys_out, void* __restrict__ aux_out,
              int64_t n, const u64* __restrict__ scratch) {
  using Aux = AuxT<kAuxBytes>;
  const int64_t from = static_cast<int64_t>(scratch[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = from / 2 + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       2 * p < n; p += stride) {
    const int64_t i = 2 * p;
    if (i >= from && i + 1 < n) {
      *reinterpret_cast<ulonglong2*>(keys_out + i) =
          make_ulonglong2(kSentinel, kSentinel);
      if constexpr (kAuxBytes == 8)
        *reinterpret_cast<ulonglong2*>(static_cast<u64*>(aux_out) + i) =
            make_ulonglong2(0ull, 0ull);
      if constexpr (kAuxBytes == 4)
        *reinterpret_cast<uint2*>(static_cast<unsigned*>(aux_out) + i) =
            make_uint2(0u, 0u);
      continue;
    }
    for (int64_t j = i; j < i + 2 && j < n; ++j) {
      if (j < from) continue;
      keys_out[j] = kSentinel;
      if constexpr (kAuxBytes != 0) static_cast<Aux*>(aux_out)[j] = Aux(0);
    }
  }
}

template <bool kSorted, int kAuxBytes>
int launch(const void* keys, const void* mask, const void* aux_in, int64_t n,
           int mode, int64_t reach, const void* n_sent_real, void* keys_out,
           void* aux_out, void* n_out, void* scratch, int64_t tiles,
           cudaStream_t stream) {
  constexpr int kStageBytes = kTile * (8 + kAuxBytes);
  cudaError_t err = cudaFuncSetAttribute(
      collapse_tile<kSorted, kAuxBytes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, (tiles + kScratchHead) * sizeof(u64),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  collapse_tile<kSorted, kAuxBytes>
      <<<static_cast<unsigned>(tiles), kThreads, kStageBytes, stream>>>(
          static_cast<const u64*>(keys),
          static_cast<const unsigned char*>(mask), aux_in, n, mode, reach,
          aligned, static_cast<const int64_t*>(n_sent_real),
          static_cast<u64*>(keys_out), aux_out, static_cast<int64_t*>(n_out),
          static_cast<u64*>(scratch), tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = (n + 1) / 2;
  const int64_t blocks = (pairs + kThreads - 1) / kThreads;
  collapse_fill<kAuxBytes>
      <<<static_cast<unsigned>(blocks < kFillBlocks ? blocks : kFillBlocks),
         kThreads, 0, stream>>>(static_cast<u64*>(keys_out), aux_out, n,
                                static_cast<const u64*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <bool kSorted>
int launch_aux(int aux_bytes, const void* keys, const void* mask,
               const void* aux_in, int64_t n, int mode, int64_t reach,
               const void* n_sent_real, void* keys_out, void* aux_out,
               void* n_out, void* scratch, int64_t tiles,
               cudaStream_t stream) {
  if (aux_bytes == 8)
    return launch<kSorted, 8>(keys, mask, aux_in, n, mode, reach, n_sent_real,
                              keys_out, aux_out, n_out, scratch, tiles,
                              stream);
  if (aux_bytes == 4)
    return launch<kSorted, 4>(keys, mask, aux_in, n, mode, reach, n_sent_real,
                              keys_out, aux_out, n_out, scratch, tiles,
                              stream);
  return launch<kSorted, 0>(keys, mask, aux_in, n, mode, reach, n_sent_real,
                            keys_out, aux_out, n_out, scratch, tiles, stream);
}

}  // namespace

extern "C" {

// Keys a tile: the scratch holds tiles + 2 u64.
int ukt_collapse_tile() { return kTile; }

// C1 over keys[n] (n >= 1): the slots `mode` keeps (0 distinct, 1 unique,
// 2 repeated, 3 threshold at `threshold` >= 1, 4 mask: mask[n] bytes) as a
// dense prefix of keys_out[n] in input order, the tail the sentinel; with
// aux_bytes 4 or 8, aux_in[n] compacted by the same flags into aux_out[n]
// (tail 0).  n_out (an int64) receives the kept count, plus the real
// sentinel-valued code by the mode's rule when n_sent_real (an int64) is
// not null.  keys_out and aux_out are 16-byte aligned and alias no input;
// scratch holds (ceil(n / tile) + 2) u64 and is zeroed here.  Returns the
// first CUDA error, else 0.
int ukt_collapse(const void* keys, const void* mask, const void* aux_in,
                 int aux_bytes, int64_t n, int mode, int64_t threshold,
                 const void* n_sent_real, void* keys_out, void* aux_out,
                 void* n_out, void* scratch, int64_t tiles, void* stream) {
  const bool bad_aux =
      (aux_bytes != 0 && aux_bytes != 4 && aux_bytes != 8) ||
      (aux_bytes != 0) != (aux_in != nullptr) ||
      (aux_in != nullptr) != (aux_out != nullptr) ||
      reinterpret_cast<uintptr_t>(aux_out) % 16 != 0;
  if (n < 1 || mode < kDistinct || mode > kMask || threshold < 1 ||
      (mode == kMask) != (mask != nullptr) || bad_aux ||
      reinterpret_cast<uintptr_t>(keys_out) % 16 != 0 ||
      tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kMask)
    return launch_aux<false>(aux_bytes, keys, mask, aux_in, n, mode, 0,
                             n_sent_real, keys_out, aux_out, n_out, scratch,
                             tiles, s);
  return launch_aux<true>(aux_bytes, keys, mask, aux_in, n, mode,
                          threshold - 1, n_sent_real, keys_out, aux_out,
                          n_out, scratch, tiles, s);
}

}  // extern "C"
