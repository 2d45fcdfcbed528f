// K1 in its earlier design, one window a thread, kept as a variant for
// timing beside csrc/encode.cu (kernel_variants.py links it in place of
// encode.cu's entry point).  Otherwise as it stood:
//
// K1: fused 2-bit window encode of the count pipeline, for sm_90a.
// Replaces the TPU kernel unikmer_tpu/ops/pallas_encode.py:79 `_encode_kernel`
// (reached via `encode_canonical_pallas`, :140).  It also absorbs the device
// unpack of the 2-bit ingress (unikmer_tpu/models/count.py:278) and the
// sentinel keying before the sort (unikmer_tpu/ops/sort.py:239).
//
// Input is the host pack of unikmer_tpu/models/count.py:249: `packed2` holds
// base j at bits 2*(j%4) of byte j/4 (invalid bases packed as 0), `validmask`
// holds validity bit j at bit j%8 of byte j/8.  Output, for every window
// [i, i+k): `keyed[i]` is its u64 code (first base in the top 2-bit group,
// min(code, revcomp) when canonical), or 2^64-1 where the window is invalid;
// `valid[i]` is 1 when all k bases are valid and i <= n-k.
//
// Bound on the H100: device-memory bandwidth.  Per base it reads 0.375 B and
// writes 9 B (an 8-byte key and a 1-byte flag); the few dozen integer
// instructions per window are far below the card's integer rate.
//
// Design: one thread per window.  Window i is the 2k-bit slice S at bit 2i of
// the packed stream, read from two 64-bit words with a funnel shift; its code
// is rev2(S) >> (64-2k), where rev2 reverses the 2-bit groups, its reverse
// complement is ~S & (4^k-1), and it is valid when the k validity bits at
// bit i are all set.  Neighbouring threads read the same few words, so loads
// are served from L1 and the coalesced stores are the whole cost.  The TPU
// kernel's halo'd rows and doubling composition are not needed: a thread can
// read any bit offset directly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// 64-bit little-endian word j of a byte stream of `nbytes` bytes; bytes past
// the end read as 0.  `p` must be 8-byte aligned.
__device__ __forceinline__ uint64_t load_word(const uint8_t* __restrict__ p,
                                              int64_t nbytes, int64_t j) {
  const int64_t off = j * 8;
  if (off + 8 <= nbytes) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p) + j);
  }
  uint64_t w = 0;
  for (int b = 0; b < 8; ++b) {
    if (off + b < nbytes) {
      w |= static_cast<uint64_t>(__ldg(p + off + b)) << (8 * b);
    }
  }
  return w;
}

// The 64 bits of the stream that start at bit `bit`.
__device__ __forceinline__ uint64_t load_bits(const uint8_t* __restrict__ p,
                                              int64_t nbytes, int64_t bit) {
  const int64_t j = bit >> 6;
  const int s = static_cast<int>(bit & 63);
  const uint64_t lo = load_word(p, nbytes, j);
  if (s == 0) return lo;
  return (lo >> s) | (load_word(p, nbytes, j + 1) << (64 - s));
}

// Reverse the order of the 32 2-bit groups of x.
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);  // group g -> 31-g, with the two bits of each group swapped
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__global__ void __launch_bounds__(kThreads)
encode_2bit_kernel(const uint8_t* __restrict__ packed2, int64_t packed_bytes,
                   const uint8_t* __restrict__ validmask, int64_t valid_bytes,
                   int64_t n, int k, int canonical,
                   unsigned long long* __restrict__ keyed,
                   uint8_t* __restrict__ valid) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint64_t s = load_bits(packed2, packed_bytes, 2 * i);
  uint64_t code = rev2(s) >> (64 - 2 * k);
  if (canonical) {
    const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint64_t rc = ~s & mask;
    code = rc < code ? rc : code;
  }
  const uint64_t kmask = (1ull << k) - 1;  // k <= 32
  const bool ok = (i <= n - k) &&
                  ((load_bits(validmask, valid_bytes, i) & kmask) == kmask);
  keyed[i] = ok ? code : ~0ull;
  valid[i] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch K1 over n windows on `stream`.  Returns cudaGetLastError().
int ukt_encode_2bit(const void* packed2, int64_t packed_bytes,
                    const void* validmask, int64_t valid_bytes, int64_t n,
                    int k, int canonical, void* keyed, void* valid,
                    void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  encode_2bit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed2), packed_bytes,
      static_cast<const uint8_t*>(validmask), valid_bytes, n, k, canonical,
      static_cast<unsigned long long*>(keyed), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
