// K2: keys-only LSD radix sort of u64 codes (ascending, unsigned), and K3:
// the same sort carrying a u32 value beside each key, for sm_90a.
//
// K2 replaces the TPU bitonic network of unikmer_tpu/ops/pallas_sort.py:
// `_sort_block_kernel` (:235), `_sort_block_kernel_looped` (:174),
// `_merge_block_kernel` (:255) and `_merge_block_kernel_looped` (:211), all
// launched through `_block_call` (:271) from `_bitonic_sort_planes` (:310)
// and `sort_codes_pallas` (:378).  K3 replaces `sort_codes_taxids_pallas`
// (:397), the same network with a value plane moved by every
// compare-exchange of `_exchange` (:104-125).
//
// Bound on the H100: device-memory traffic.  Each 8-bit digit pass reads every
// key twice (histogram, scatter) and writes it once, 24 B per key; K3 also
// reads and writes the value once, 32 B per pair (6.4 GB for 2^25 pairs over
// 6 passes).  A sort of 2-bit codes at k <= 23 takes 6 passes (47
// significant bits with the sentinel), a full 64-bit sort 8.  The scatter's
// stores fall into up to 256 runs per warp-round of 32 keys, so they coalesce
// only partly: that, and reading the keys twice, are what a later onesweep
// version removes.
//
// Design: the bitonic network does O(n log^2 n) compare-exchanges, a shape
// chosen for the TPU's wide vector unit and VMEM.  A GPU sorts u64 keys in
// O(passes * n) with an LSD radix sort.  Each pass has three steps:
//   1. radix_hist_kernel: every tile of kTile keys counts its 256 digits in
//      shared memory and writes them digit-major into a [256, tiles] table;
//   2. the wrapper's exclusive scan of that table (torch.cumsum) gives each
//      (digit, tile) its first output slot;
//   3. radix_scatter_kernel: each warp owns kWarpKeys consecutive keys of the
//      tile, loads them all into registers up front, and walks them in input
//      order, 32 per round.  A key's rank among the warp's keys of its digit
//      is its rank in the round (__match_any_sync) plus the warp's running
//      count of that digit; after one barrier a per-digit prefix over the
//      warps turns ranks into global slots.  Ranks follow input order, so each
//      pass is stable, as LSD radix must be, and a tile needs two barriers.
//      K3 instantiates the same kernel with values: each value is loaded
//      beside its key and stored to the key's slot, so the whole sort is
//      stable and equal keys keep their values in input order (the TPU
//      network, unstable, had to compare values too to lose none).
// The code_bits hint is the true width of the real codes: every key is
// < 2^code_bits or the all-ones sentinel.  Digits are then taken from the key
// with the sentinel mapped to 2^code_bits, which still orders it last, so
// ceil((code_bits+1)/8) passes sort everything; code_bits >= 63 sorts all
// 64 bits (the map would need 65 bits at k = 32).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // == kRadix: thread t owns digit t in the tables
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys per thread
constexpr int kWarpKeys = 32 * kItems;    // consecutive keys per warp
constexpr int kTile = kThreads * kItems;  // keys per block

__device__ __forceinline__ unsigned digit_of(unsigned long long x, int shift,
                                             int code_bits) {
  if (code_bits < 64 && x == ~0ull) x = 1ull << code_bits;
  return static_cast<unsigned>((x >> shift) & (kRadix - 1));
}

// Key r of this lane: index warp0 + 32 * r + lane (0 past the end).
__device__ __forceinline__ void load_keys(
    const unsigned long long* __restrict__ keys, int64_t n, int64_t warp0,
    int lane, unsigned long long (&key)[kItems]) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t idx = warp0 + 32 * r + lane;
    key[r] = idx < n ? keys[idx] : 0ull;
  }
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const unsigned long long* __restrict__ keys, int64_t n,
                  int shift, int code_bits, int* __restrict__ hist,
                  int64_t tiles) {
  __shared__ int h[kRadix];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * kTile + (t >> 5) * kWarpKeys;
  unsigned long long key[kItems];
  load_keys(keys, n, warp0, lane, key);
  h[t] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool ok = warp0 + 32 * r + lane < n;
    const unsigned d = ok ? digit_of(key[r], shift, code_bits) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  hist[static_cast<int64_t>(t) * tiles + blockIdx.x] = h[t];
}

template <bool kValues>
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const unsigned long long* __restrict__ keys_in,
                     unsigned long long* __restrict__ keys_out,
                     const unsigned* __restrict__ vals_in,
                     unsigned* __restrict__ vals_out, int64_t n,
                     int shift, int code_bits,
                     const int64_t* __restrict__ offsets, int64_t tiles) {
  __shared__ int warp_count[kWarps][kRadix];     // keys per (warp, digit)
  __shared__ int64_t warp_base[kWarps][kRadix];  // first slot per (warp, digit)
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lower_lanes = (1u << lane) - 1;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * kTile + warp * kWarpKeys;
  unsigned long long key[kItems];
  load_keys(keys_in, n, warp0, lane, key);
  unsigned val[kValues ? kItems : 1];
  if constexpr (kValues) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int64_t idx = warp0 + 32 * r + lane;
      val[r] = idx < n ? vals_in[idx] : 0u;
    }
  }
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  __syncthreads();
  int rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool ok = warp0 + 32 * r + lane < n;
    const unsigned d = ok ? digit_of(key[r], shift, code_bits) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int in_round = __popc(peers & lower_lanes);
    rank[r] = ok ? warp_count[warp][d] + in_round : 0;
    __syncwarp();
    if (ok && in_round == 0) warp_count[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int64_t next = offsets[static_cast<int64_t>(t) * tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) {
    warp_base[w][t] = next;
    next += warp_count[w][t];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (warp0 + 32 * r + lane < n) {
      const unsigned d = digit_of(key[r], shift, code_bits);
      const int64_t slot = warp_base[warp][d] + rank[r];
      keys_out[slot] = key[r];
      if constexpr (kValues) vals_out[slot] = val[r];
    }
  }
}

}  // namespace

extern "C" {

int ukt_radix_tile() { return kTile; }

// Pass step 1: digit histogram of each tile into hist[256 * tiles] (int32,
// digit-major).  Returns cudaGetLastError().
int ukt_radix_hist(const void* keys, int64_t n, int shift, int code_bits,
                   void* hist, int64_t tiles, void* stream) {
  radix_hist_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys), n, shift, code_bits,
      static_cast<int*>(hist), tiles);
  return static_cast<int>(cudaGetLastError());
}

// Pass step 3: stable scatter of keys_in into keys_out at the exclusive
// offsets[256 * tiles] (int64, digit-major).  Returns cudaGetLastError().
int ukt_radix_scatter(const void* keys_in, void* keys_out, int64_t n,
                      int shift, int code_bits, const void* offsets,
                      int64_t tiles, void* stream) {
  radix_scatter_kernel<false><<<static_cast<unsigned>(tiles), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys_in),
      static_cast<unsigned long long*>(keys_out), nullptr, nullptr, n, shift,
      code_bits, static_cast<const int64_t*>(offsets), tiles);
  return static_cast<int>(cudaGetLastError());
}

// K3's pass step 3: the stable scatter of ukt_radix_scatter, moving the u32
// vals_in[i] to the slot of keys_in[i].  Returns cudaGetLastError().
int ukt_radix_scatter_kv(const void* keys_in, void* keys_out,
                         const void* vals_in, void* vals_out, int64_t n,
                         int shift, int code_bits, const void* offsets,
                         int64_t tiles, void* stream) {
  radix_scatter_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys_in),
      static_cast<unsigned long long*>(keys_out),
      static_cast<const unsigned*>(vals_in), static_cast<unsigned*>(vals_out),
      n, shift, code_bits, static_cast<const int64_t*>(offsets), tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
