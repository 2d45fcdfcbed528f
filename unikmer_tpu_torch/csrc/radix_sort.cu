// K2: keys-only LSD radix sort of u64 codes (ascending, unsigned), and K3:
// the same sort carrying a u32 value beside each key, for sm_90a.
//
// K2 replaces the TPU bitonic network of unikmer_tpu/ops/pallas_sort.py:
// `_sort_block_kernel` (:235), `_sort_block_kernel_looped` (:174),
// `_merge_block_kernel` (:255) and `_merge_block_kernel_looped` (:211), all
// launched through `_block_call` (:271) from `_bitonic_sort_planes` (:310)
// and `sort_codes_pallas` (:378).  K3 replaces `sort_codes_taxids_pallas`
// (:399), the same network with a value plane moved by every
// compare-exchange of `_exchange` (:104-125).
//
// Bound on the H100: device-memory traffic.  The bitonic network does
// O(n log^2 n) compare-exchanges, a shape chosen for the TPU's wide vector
// unit and VMEM; here an LSD radix sort over 8-bit digits moves every key
// once per pass.  With P passes that is one read of the keys for all the
// histograms, then P x 16 B a key (read + write) for K2 and P x 24 B a pair
// for K3.  A sort of 2-bit codes at k <= 23 takes P = 6 (47 significant bits
// with the sentinel), a full 64-bit sort P = 8.
//
// Design: onesweep (Adinets and Merrill, 2022), three kernels per sort and
// a copy kernel that works only when no pass runs.
//   1. radix_upfront_hist reads the keys once and counts the digits of all P
//      passes at once in P x 256 shared u32 counters (a block takes at most
//      kHistChunk keys, so they cannot overflow), merging runs of equal digits
//      in registers before each shared atomic (duplicate-heavy and sorted
//      input would otherwise serialise on one counter), then adds them into
//      a global [P, 256] u64 table.  radix_bases (one block) turns each
//      pass's row into its exclusive digit bases and writes the pass plan on
//      the card: a pass whose keys all share one digit would leave the order
//      as it is, so it does not run; each pass that runs reads the buffer
//      the one before it wrote (the first reads the input) and the writes
//      alternate between a temporary and the output so that the last pass
//      that runs writes the output.  The host reads nothing back: it queues
//      every pass, and the blocks of a pass that does not run return at
//      once; when no pass runs, radix_copy fills the output (its blocks
//      return at once otherwise).  The passes run and skipped are added to
//      two device counters, read by the wrapper only when asked.
//   2. radix_onesweep_pass<kValues>, one launch per pass.  A block
//      (a) takes its tile index from an atomic counter, so it only ever waits
//      on tiles that have already started (blockIdx.x order is not launch
//      order); (b) loads kTile keys (and values) coalesced into registers,
//      lane-striped so a warp's keys stay in input order; (c) ranks each key
//      among its warp's keys of the same digit: nine ballots find the lanes
//      of one digit in a round (match_digit; __match_any_sync was slower),
//      their lowest lane adds their number to the warp's shared counter
//      with one atomicAdd (an atomic, so the next round's leader, another
//      lane, sees it without a __syncwarp) and
//      broadcasts the old count by __shfl_sync; a per-digit prefix over the
//      warps and a block scan over the digits give every key a block-local
//      slot, digit-major and stable; (d) runs the decoupled look-back:
//      thread t owns digit t, publishes the tile's count of t as an
//      aggregate, walks back over earlier tiles adding aggregates until it
//      meets an inclusive prefix, and publishes its own inclusive prefix;
//      (e) scatters the keys (and values) to their slots in shared memory,
//      then reads them back in slot order, so consecutive threads store to
//      consecutive addresses inside each digit run and the global stores
//      coalesce.  Keys move unchanged; only their digits are read, with the
//      sentinel remap below.  Equal digits keep input order through each
//      pass, so the sort is stable and K3's equal keys keep their values in
//      input order (the TPU network, unstable, had to compare values too).
//   3. The wrapper (ops/radix_sort.py) allocates every buffer; the entry
//      point of the passes zeroes a pass's tile counter and status words with
//      one cudaMemsetAsync on the stream before its launch.
// Look-back memory order: a status word is 64 bits, [tile][digit], 2 flag
// bits (aggregate, inclusive prefix) above a 62-bit count, so a flag and its
// count travel in one single-copy-atomic store and no reader can see one
// without the other.  Nothing else is published through the flags (the
// stage is the block's own shared memory; the next pass is another launch),
// so the words are stored and loaded as device-scope relaxed atomics through
// cuda::atomic_ref, spinning while the flag is 0.  A release store (a fence
// before it) ordered nothing more and made each pass about 20% slower on an
// H100 (PERF.md section 6, K2's row).  Each block publishes its aggregates
// before it waits on anything, and waits only on tiles taken before its own,
// so every wait ends.
// Tile: 256 threads x 16 keys = 4096 keys.  The stage takes 32 KB of dynamic
// shared memory (48 KB with K3's values; above the 48 KB default with the
// 11 KB of static tables, hence cudaFuncSetAttribute).  At 76 registers
// (97 with values) three K2 blocks or two K3 blocks fit an SM.  A larger
// tile gives longer digit runs (16 keys of a digit per tile on random keys,
// 128 B) and fewer tiles to look back over, at the cost of registers,
// shared memory and occupancy; 12, 20 and 24 keys a thread were slower.
// The code_bits hint is the true width of the real codes: every key is
// < 2^code_bits or the all-ones sentinel.  Digits are then taken from the key
// with the sentinel mapped to 2^code_bits, which still orders it last, so
// ceil((code_bits+1)/8) passes sort everything; code_bits >= 63 sorts all
// 64 bits (the map would need 65 bits at k = 32).
// The earlier design (a histogram kernel per pass, a torch.cumsum over a
// [256, tiles] table, a scatter storing each key from registers) is gone.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using u64 = unsigned long long;

constexpr int kRadix = 256;
constexpr int kMaxPasses = 8;
constexpr int kThreads = 256;  // == kRadix: thread t owns digit t
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys per thread
constexpr int kWarpKeys = 32 * kItems;    // consecutive keys per warp
constexpr int kTile = kThreads * kItems;  // keys per onesweep block
constexpr int kHistItems = 8;             // keys per thread per loop step
constexpr int64_t kHistChunk = 4 * kTile;  // keys per histogram block
constexpr u64 kFlagAggregate = 1ull << 62;
constexpr u64 kFlagPrefix = 2ull << 62;
constexpr u64 kCountMask = kFlagAggregate - 1;
// The pass plan: a step of a pass that runs is kRun | src << 1 | dst << 3,
// src and dst buffers of kInput, kTemp and kOutput; 0 for a pass that does
// not run.  Entry `passes` of the plan is 1 when no pass runs.
constexpr int kRun = 1;
constexpr int kInput = 0;
constexpr int kTemp = 1;
constexpr int kOutput = 2;
constexpr int kCopyBlocks = 1024;

__device__ __forceinline__ u64 ranked(u64 x, int code_bits) {
  return (code_bits < 64 && x == ~0ull) ? 1ull << code_bits : x;
}

__device__ __forceinline__ unsigned digit_of(u64 x, int shift, int code_bits) {
  return static_cast<unsigned>((ranked(x, code_bits) >> shift) & (kRadix - 1));
}

// The lanes of the warp whose 9-bit value d (a digit, or 256 for a slot past
// the end) equals this lane's: one ballot a bit, cheaper than
// __match_any_sync when the 32 lanes hold many distinct digits.
__device__ __forceinline__ unsigned match_digit(unsigned d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Exclusive prefix sum of v over the block's threads in thread order.  It
// holds one barrier; the caller needs another before a thread reads what
// another one stored from the result, or before `warp_sum` is reused.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T (&warp_sum)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  T before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
radix_upfront_hist(const u64* __restrict__ keys, int64_t n, int passes,
                   int code_bits, u64* __restrict__ hist) {
  __shared__ unsigned h[kMaxPasses][kRadix];
  const int t = threadIdx.x;
  for (int p = 0; p < passes; ++p) h[p][t] = 0;
  __syncthreads();
  unsigned cur[kMaxPasses], cnt[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) cur[p] = kRadix, cnt[p] = 0;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kHistChunk;
  const int64_t end = n - begin < kHistChunk ? n : begin + kHistChunk;
  for (int64_t base = begin; base < end; base += kThreads * kHistItems) {
    u64 key[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const int64_t idx = base + j * kThreads + t;
      key[j] = idx < end ? keys[idx] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      if (base + j * kThreads + t >= end) break;
      const u64 x = ranked(key[j], code_bits);
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        if (p < passes) {
          const unsigned d = static_cast<unsigned>((x >> (8 * p)) & 0xff);
          if (d != cur[p]) {
            if (cnt[p]) atomicAdd(&h[p][cur[p]], cnt[p]);
            cur[p] = d;
            cnt[p] = 0;
          }
          ++cnt[p];
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p)
    if (p < passes && cnt[p]) atomicAdd(&h[p][cur[p]], cnt[p]);
  __syncthreads();
  for (int p = 0; p < passes; ++p)
    if (h[p][t]) atomicAdd(&hist[p * kRadix + t], static_cast<u64>(h[p][t]));
}

// One block: for each pass p, bases[p][d] = sum of hist[p][< d] and the
// pass plan (above): a pass runs unless one digit holds all n keys, the
// first that runs reads the input, each later one what the one before
// wrote, and the writes alternate so that the last lands in the output.
// counts[0] and counts[1] add the passes run and skipped.
__global__ void __launch_bounds__(kThreads)
radix_bases(const u64* __restrict__ hist, int64_t n, int passes,
            u64* __restrict__ bases, int* __restrict__ plan,
            u64* __restrict__ counts) {
  __shared__ u64 warp_sum[kWarps];
  __shared__ int runs[kMaxPasses];
  for (int p = 0; p < passes; ++p) {
    const int i = p * kRadix + threadIdx.x;
    const u64 h = hist[i];
    bases[i] = block_exclusive_scan(h, warp_sum);
    // a barrier too: every read of warp_sum is done before the next pass
    const int one = __syncthreads_or(h == static_cast<u64>(n));
    if (threadIdx.x == 0) runs[p] = !one;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int ran = 0;
  for (int p = 0; p < passes; ++p) ran += runs[p];
  int src = kInput;
  for (int p = 0, j = 0; p < passes; ++p) {
    if (!runs[p]) {
      plan[p] = 0;
      continue;
    }
    const int dst = (ran - 1 - j) % 2 == 0 ? kOutput : kTemp;
    plan[p] = kRun | src << 1 | dst << 3;
    src = dst;
    ++j;
  }
  plan[passes] = ran == 0;
  atomicAdd(&counts[0], static_cast<u64>(ran));
  atomicAdd(&counts[1], static_cast<u64>(passes - ran));
}

__device__ __forceinline__ void publish(u64* word, u64 v) {
  cuda::atomic_ref<u64, cuda::thread_scope_device>(*word).store(
      v, cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ u64 peek(u64* word) {
  return cuda::atomic_ref<u64, cuda::thread_scope_device>(*word).load(
      cuda::std::memory_order_relaxed);
}

// scratch: word 0 is the tile counter, words kRadix.. the status words
// [tiles][256]; all zero at the launch.  bases: this pass's 256 digit bases.
// step: this pass's entry of the plan, which picks the buffers it reads
// (input, temporary or output) and writes (temporary or output); every block
// of a pass that does not run returns at once.
template <bool kValues>
__global__ void __launch_bounds__(kThreads)
radix_onesweep_pass(const u64* keys_input, u64* keys_temp, u64* keys_output,
                    const unsigned* vals_input, unsigned* vals_temp,
                    unsigned* vals_output, int64_t n, int shift,
                    int code_bits, const u64* __restrict__ bases,
                    const int* __restrict__ step, u64* __restrict__ scratch) {
  const int plan = *step;
  if (!(plan & kRun)) return;
  const int src = (plan >> 1) & 3;
  const bool to_temp = ((plan >> 3) & 3) == kTemp;
  const u64* __restrict__ const keys_in =
      src == kInput ? keys_input : src == kTemp ? keys_temp : keys_output;
  u64* __restrict__ const keys_out = to_temp ? keys_temp : keys_output;
  const unsigned* __restrict__ const vals_in =
      src == kInput ? vals_input : src == kTemp ? vals_temp : vals_output;
  unsigned* __restrict__ const vals_out = to_temp ? vals_temp : vals_output;
  extern __shared__ __align__(16) unsigned char stage[];
  u64* const stage_keys = reinterpret_cast<u64*>(stage);
  unsigned* const stage_vals = reinterpret_cast<unsigned*>(stage + kTile * 8);
  __shared__ int warp_count[kWarps][kRadix];  // keys per (warp, digit)
  __shared__ int block_start[kRadix];         // first block slot per digit
  __shared__ int64_t out_offset[kRadix];      // global slot - block slot
  __shared__ int warp_sum[kWarps];
  __shared__ int64_t s_tile;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lower_lanes = (1u << lane) - 1;

  // (a) the tile index, in the order blocks start
  if (t == 0) s_tile = static_cast<int64_t>(atomicAdd(scratch, 1ull));
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tile0 = tile * kTile;
  const int64_t warp0 = tile0 + warp * kWarpKeys;

  // (b) load: key r of this lane is warp0 + 32 * r + lane
  u64 key[kItems];
  unsigned val[kValues ? kItems : 1];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t idx = warp0 + 32 * r + lane;
    key[r] = idx < n ? keys_in[idx] : 0ull;
    if constexpr (kValues) val[r] = idx < n ? vals_in[idx] : 0u;
  }

  // (c) rank among the warp's keys of the same digit, in input order
  int rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool ok = warp0 + 32 * r + lane < n;
    const unsigned d = ok ? digit_of(key[r], shift, code_bits) : kRadix;
    const unsigned peers = match_digit(d);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (ok && lane == leader)
      before = atomicAdd(&warp_count[warp][d], __popc(peers));
    before = __shfl_sync(0xffffffffu, before, leader);
    rank[r] = before + __popc(peers & lower_lanes);
  }
  __syncthreads();
  int total = 0;  // keys of digit t in the tile
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w][t];
    warp_count[w][t] = total;
    total += c;
  }

  // (d) publish this tile's aggregate of digit t before waiting on anything
  u64* const status = scratch + kRadix;
  u64* const mine = status + tile * kRadix + t;
  publish(mine, (tile == 0 ? kFlagPrefix : kFlagAggregate) |
                    static_cast<u64>(total));
  block_start[t] = block_exclusive_scan(total, warp_sum);
  __syncthreads();

  // (e) stage the keys in their block slots, digit-major and stable
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (warp0 + 32 * r + lane < n) {
      const unsigned d = digit_of(key[r], shift, code_bits);
      const int slot = block_start[d] + warp_count[warp][d] + rank[r];
      stage_keys[slot] = key[r];
      if constexpr (kValues) stage_vals[slot] = val[r];
    }
  }

  // (d) look back over the earlier tiles for digit t's exclusive prefix
  u64 prefix = 0;
  if (tile > 0) {
    for (int64_t j = tile - 1;; --j) {
      u64 s;
      do {
        s = peek(status + j * kRadix + t);
      } while ((s & ~kCountMask) == 0);
      prefix += s & kCountMask;
      if (s & kFlagPrefix) break;
    }
    publish(mine, kFlagPrefix | (prefix + static_cast<u64>(total)));
  }
  out_offset[t] = static_cast<int64_t>(bases[t] + prefix) - block_start[t];
  __syncthreads();

  // (e) write back in slot order: consecutive threads, consecutive addresses
  const int count = n - tile0 < kTile ? static_cast<int>(n - tile0) : kTile;
  for (int i = t; i < count; i += kThreads) {
    const u64 x = stage_keys[i];
    const int64_t pos = out_offset[digit_of(x, shift, code_bits)] + i;
    keys_out[pos] = x;
    if constexpr (kValues) vals_out[pos] = stage_vals[i];
  }
}

// Fills the output from the input when the plan says no pass ran (a grid of
// at most kCopyBlocks blocks that return at once otherwise).
template <bool kValues>
__global__ void __launch_bounds__(kThreads)
radix_copy(const u64* __restrict__ keys_in, u64* __restrict__ keys_out,
           const unsigned* __restrict__ vals_in,
           unsigned* __restrict__ vals_out, int64_t n,
           const int* __restrict__ none_ran) {
  if (!*none_ran) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    keys_out[i] = keys_in[i];
    if constexpr (kValues) vals_out[i] = vals_in[i];
  }
}

template <bool kValues>
int launch_passes(const void* keys_in, void* keys_temp, void* keys_out,
                  const void* vals_in, void* vals_temp, void* vals_out,
                  int64_t n, int passes, int code_bits, const void* bases,
                  const void* plan, void* scratch, int64_t tiles,
                  cudaStream_t stream) {
  constexpr int kStageBytes = kTile * (kValues ? 12 : 8);
  cudaError_t err = cudaFuncSetAttribute(
      radix_onesweep_pass<kValues>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* const steps = static_cast<const int*>(plan);
  for (int p = 0; p < passes; ++p) {
    err = cudaMemsetAsync(scratch, 0, (tiles + 1) * kRadix * sizeof(u64),
                          stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_onesweep_pass<kValues>
        <<<static_cast<unsigned>(tiles), kThreads, kStageBytes, stream>>>(
            static_cast<const u64*>(keys_in), static_cast<u64*>(keys_temp),
            static_cast<u64*>(keys_out),
            static_cast<const unsigned*>(vals_in),
            static_cast<unsigned*>(vals_temp),
            static_cast<unsigned*>(vals_out), n, 8 * p, code_bits,
            static_cast<const u64*>(bases) + p * kRadix, steps + p,
            static_cast<u64*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  radix_copy<kValues>
      <<<static_cast<unsigned>(blocks < kCopyBlocks ? blocks : kCopyBlocks),
         kThreads, 0, stream>>>(
          static_cast<const u64*>(keys_in), static_cast<u64*>(keys_out),
          static_cast<const unsigned*>(vals_in),
          static_cast<unsigned*>(vals_out), n, steps + passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Keys per onesweep tile: the scratch of a pass is (tiles + 1) * 256 u64.
int ukt_radix_tile() { return kTile; }

// Step 1: the digit histograms of all `passes` passes (shifts 0, 8, ...) in
// one read of the keys into hist[passes * 256] (u64, zeroed here), their
// exclusive digit bases into bases[passes * 256] (u64), the pass plan into
// plan[passes + 1] (int32) and the passes run and skipped added to counts[0]
// and counts[1] (u64).  Returns cudaGetLastError().
int ukt_radix_upfront(const void* keys, int64_t n, int passes, int code_bits,
                      void* hist, void* bases, void* plan, void* counts,
                      void* stream) {
  if (n < 1 || passes < 1 || passes > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(hist, 0, passes * kRadix * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + kHistChunk - 1) / kHistChunk;
  radix_upfront_hist<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const u64*>(keys), n, passes, code_bits,
      static_cast<u64*>(hist));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_bases<<<1, kThreads, 0, s>>>(
      static_cast<const u64*>(hist), n, passes, static_cast<u64*>(bases),
      static_cast<int*>(plan), static_cast<u64*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Step 2: every pass at bits 0, 8, ... as the plan says, each the stable
// scatter of its source buffer into its destination at the pass's digit
// bases, the u32 values beside the keys when vals_in is not null; then the
// copy of the input into the output when no pass ran.  keys_temp and
// keys_out (vals_temp and vals_out) hold n keys (values) each and never
// alias the input; the output ends sorted.  scratch holds (tiles + 1) * 256
// u64 and is zeroed before each pass.  Returns the first CUDA error, else 0.
int ukt_radix_onesweep(const void* keys_in, void* keys_temp, void* keys_out,
                       const void* vals_in, void* vals_temp, void* vals_out,
                       int64_t n, int passes, int code_bits,
                       const void* bases, const void* plan, void* scratch,
                       int64_t tiles, void* stream) {
  if (n < 1 || passes < 1 || passes > kMaxPasses ||
      tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_in != nullptr)
    return launch_passes<true>(keys_in, keys_temp, keys_out, vals_in,
                               vals_temp, vals_out, n, passes, code_bits,
                               bases, plan, scratch, tiles, s);
  return launch_passes<false>(keys_in, keys_temp, keys_out, nullptr, nullptr,
                              nullptr, n, passes, code_bits, bases, plan,
                              scratch, tiles, s);
}

}  // extern "C"
