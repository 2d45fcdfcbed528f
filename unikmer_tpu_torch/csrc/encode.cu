// K1: fused 2-bit window encode of the count pipeline, for sm_90a.
//
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
// Bound on the H100: device-memory bandwidth.  Per window it reads 0.375 B
// and writes 9 B (an 8-byte key and a 1-byte flag).
//
// Design: a thread takes kW = 32 consecutive windows and rolls the code.
// Block b takes the span of kBlockWindows windows from b * kBlockWindows.
// It first copies the span's `packed2` and `validmask` (its windows plus a
// k - 1 halo, at most one more word) into shared memory, one 16-byte load a
// thread, so a block waits on device memory once; six blocks an SM keep
// the stores going while one waits.  Thread t's windows start at bit 64t of
// the packed span: packed words t and t + 1 hold its 32 + k - 1 <= 63 bases
// and validity words t and t + 1 (u32) its validity bits.  Its first code
// is rev2(lo) >> (64 - 2k) and its reverse complement ~lo & mask, as in one
// window; each next window shifts one base in:
//   fwd = ((fwd << 2) | b) & mask,  rc = (rc >> 2) | ((3 ^ b) << (2k - 2)).
// Window j is valid when bits j..j+k-1 of the 64 validity bits are set: an
// AND of the word with itself shifted, in log2(k) doubling steps, gives all
// 32 answers at once.  The keys go to a shared stage, two to a 16-byte slot
// (slot s of thread t at t * kW/2 + (s ^ (t & 15)), so the eight threads of
// one 16-byte access hit eight bank groups), and after one barrier the block
// copies the stage out, 16 bytes a thread, neighbouring threads on
// neighbouring addresses.  Each thread writes its 32 flag bytes as two
// 16-byte stores.  The tail (windows past n - k, a ragged last block) is
// exact: those windows are invalid and nothing past n is written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kW = 32;  // windows a thread; kW + k - 1 <= 64 bases
constexpr int kBlockWindows = kThreads * kW;
constexpr int kPackedVecs = (kBlockWindows / 4 + 16) / 16;  // span + 1 word
constexpr int kValidVecs = (kBlockWindows / 8 + 16) / 16;
constexpr int kKeyVecs = kBlockWindows / 2;  // two keys a 16-byte slot
constexpr int kSpanVecs = kPackedVecs + kValidVecs;
static_assert(kW == 32, "one packed word and one validity word a thread");
static_assert(kSpanVecs <= kThreads, "one 16-byte word of a span a thread");

// Reverse the order of the 32 2-bit groups of x.
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);  // group g -> 31-g, with the two bits of each group swapped
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// 16 bytes of a byte stream from byte `off`; bytes past `nbytes` read as 0.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int64_t nbytes, int64_t off) {
  if (off + 16 <= nbytes) return __ldg(reinterpret_cast<const uint4*>(p + off));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 16 && off + b < nbytes; ++b) {
    w[b >> 2] |= static_cast<uint32_t>(__ldg(p + off + b)) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The key stage's slot of pair s (keys 2s, 2s+1) of thread t.
__device__ __forceinline__ int key_slot(int t, int s) {
  return t * (kW / 2) + (s ^ (t & 15));
}

// Flag bytes of four windows: byte e is bit e of x (x < 16).
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// Thread t's 16-byte word of span `span`: packed words, then validity.
__device__ __forceinline__ uint4 span_word(const uint8_t* __restrict__ packed2,
                                           int64_t packed_bytes,
                                           const uint8_t* __restrict__ validmask,
                                           int64_t valid_bytes, int64_t span,
                                           int t) {
  const int64_t first = span * kBlockWindows;
  return t < kPackedVecs
             ? load16(packed2, packed_bytes, first / 4 + 16 * t)
             : load16(validmask, valid_bytes, first / 8 + 16 * (t - kPackedVecs));
}

// The span from `first` in shared memory: the keys staged and copied out,
// the flags stored.
__device__ __forceinline__ void encode_span(const uint4* s_span, uint4* s_keys,
                                            int64_t first, int64_t n, int k,
                                            int canonical,
                                            unsigned long long* __restrict__ keyed,
                                            uint8_t* __restrict__ valid) {
  const int t = threadIdx.x;
  const uint64_t* words = reinterpret_cast<const uint64_t*>(s_span);
  const uint32_t* vwords = reinterpret_cast<const uint32_t*>(s_span + kPackedVecs);
  const uint64_t lo = words[t];
  const uint64_t hi = words[t + 1];
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t fwd = rev2(lo) >> (64 - 2 * k);
  uint64_t rc = ~lo & mask;
  // bases k .. k + 30 of the thread's span, the ones shifted in
  uint64_t in = (k == 32) ? hi : ((lo >> (2 * k)) | (hi << (64 - 2 * k)));
  // bit j: bits j .. j + k - 1 of the validity word all set
  const uint64_t vbits = static_cast<uint64_t>(vwords[t]) |
                         (static_cast<uint64_t>(vwords[t + 1]) << 32);
  uint64_t run = vbits;
  for (int have = 1; have < k;) {
    const int step = have < k - have ? have : k - have;
    run &= run >> step;
    have += step;
  }
  const int64_t i0 = first + static_cast<int64_t>(t) * kW;
  const int64_t last = n - k - i0;  // windows j <= last may be valid
  uint32_t ok = static_cast<uint32_t>(run);
  if (last < kW - 1) ok = last < 0 ? 0u : ok & ((2u << last) - 1u);

#pragma unroll
  for (int s = 0; s < kW / 2; ++s) {
    unsigned long long key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * s + h;
      if (j > 0) {
        const uint64_t b = in & 3;
        in >>= 2;
        fwd = ((fwd << 2) | b) & mask;
        rc = (rc >> 2) | ((3 ^ b) << (2 * k - 2));
      }
      const uint64_t code = (canonical && rc < fwd) ? rc : fwd;
      key[h] = ((ok >> j) & 1) ? code : ~0ull;
    }
    s_keys[key_slot(t, s)] = make_uint4(
        static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[0] >> 32),
        static_cast<uint32_t>(key[1]), static_cast<uint32_t>(key[1] >> 32));
  }
  // the thread's kW flag bytes
  if (i0 + kW <= n) {
    uint4* dst = reinterpret_cast<uint4*>(valid + i0);
    dst[0] = make_uint4(spread4(ok & 15), spread4((ok >> 4) & 15),
                        spread4((ok >> 8) & 15), spread4((ok >> 12) & 15));
    dst[1] = make_uint4(spread4((ok >> 16) & 15), spread4((ok >> 20) & 15),
                        spread4((ok >> 24) & 15), spread4(ok >> 28));
  } else {
    for (int j = 0; i0 + j < n; ++j) valid[i0 + j] = (ok >> j) & 1;
  }
  __syncthreads();

  const int64_t have = n - first;  // windows of this block, > 0
  uint4* out = reinterpret_cast<uint4*>(keyed + first);
  for (int p = t; p < kKeyVecs; p += kThreads) {
    const uint4 v = s_keys[key_slot(p / (kW / 2), p % (kW / 2))];
    if (2 * p + 1 < have) {
      out[p] = v;
    } else if (2 * p < have) {
      keyed[first + 2 * p] = static_cast<unsigned long long>(v.x) |
                             (static_cast<unsigned long long>(v.y) << 32);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
encode_2bit_kernel(const uint8_t* __restrict__ packed2, int64_t packed_bytes,
                   const uint8_t* __restrict__ validmask, int64_t valid_bytes,
                   int64_t n, int k, int canonical,
                   unsigned long long* __restrict__ keyed,
                   uint8_t* __restrict__ valid) {
  __shared__ uint4 s_span[kSpanVecs];
  __shared__ uint4 s_keys[kKeyVecs];
  const int t = threadIdx.x;
  if (t < kSpanVecs) {
    s_span[t] = span_word(packed2, packed_bytes, validmask, valid_bytes,
                          blockIdx.x, t);
  }
  __syncthreads();
  encode_span(s_span, s_keys, static_cast<int64_t>(blockIdx.x) * kBlockWindows,
              n, k, canonical, keyed, valid);
}

}  // namespace

extern "C" {

const char* ukt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch K1 over n windows on `stream`; every pointer 16-byte aligned.
// Returns cudaGetLastError().
int ukt_encode_2bit(const void* packed2, int64_t packed_bytes,
                    const void* validmask, int64_t valid_bytes, int64_t n,
                    int k, int canonical, void* keyed, void* valid,
                    void* stream) {
  const int64_t blocks = (n + kBlockWindows - 1) / kBlockWindows;
  if (k < 1 || k > 32 || blocks > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(packed2) | reinterpret_cast<uintptr_t>(validmask) |
       reinterpret_cast<uintptr_t>(keyed) | reinterpret_cast<uintptr_t>(valid)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  encode_2bit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed2), packed_bytes,
      static_cast<const uint8_t*>(validmask), valid_bytes, n, k, canonical,
      static_cast<unsigned long long*>(keyed), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
