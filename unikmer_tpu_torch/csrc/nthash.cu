// H1: fused 2-bit ingress unpack + ntHash window hash + scaled threshold +
// keying of the hashed count pipeline, for sm_90a.
//
// Replaces XLA code, not a Pallas kernel: unikmer_tpu/ops/nthash.py:68
// `nthash_windows`, together with the device unpack of the 2-bit ingress
// (unikmer_tpu/models/count.py:278), the scaled-MinHash threshold
// (count.py:195-197) and the sentinel keying before the sort
// (unikmer_tpu/ops/sort.py:239).  XLA fuses those into the count program;
// this kernel is the fusion's counterpart.
//
// Input is the host pack read by K1 (csrc/encode.cu): `packed2` holds base j
// at bits 2*(j%4) of byte j/4, `validmask` validity bit j at bit j%8 of byte
// j/8.  Output, for every window [i, i+k), k = 1..64:
//   F = XOR_j rol(seed[s_j], k-1-j)   (ntHash v1 forward)
//   R = XOR_j rol(seedrc[s_j], j)     (reverse complement)
//   code = canonical ? min(F, R) : F  (unsigned compare)
//   valid[i] = 1 when all k bases are valid, i <= n-k and code <= max_hash;
//   keyed[i] = code where valid, else 2^64-1.
//
// Invalid bases: the pack stores them as base 0 (A), not as ntHash's seed 0.
// That is exact because every window holding one is keyed to the sentinel,
// and the roll below XORs out of a window the same seed that it XORed in
// (both read the same packed base), so the code of the next window is not
// disturbed.  Whoever changes the pack or the keying must keep both halves.
//
// Bound on the H100: device-memory bandwidth, as K1's.  Per window it reads
// 0.375 B and writes 9 B (an 8-byte key and a 1-byte flag).
//
// Design: K1's (csrc/encode.cu), with a wider halo.  A thread takes kW = 32
// consecutive windows, block b the span of kBlockWindows windows from
// b * kBlockWindows.  The block first copies the span's `packed2` and
// `validmask` into shared memory, one 16-byte load a thread.  Thread t's
// windows need 32 + k - 1 <= 95 bases from base 32t of the span: three packed
// u64 words (t, t+1, t+2) and three u32 validity words.  The span's one
// 16-byte word of halo past the block's windows (64 bases, 64 validity bits)
// holds word t+2 of the last thread (static_asserts below), and a ragged last
// block reads zeros past the buffers (invalid bases).  The thread hashes its
// first window directly, k steps, then rolls one base a window:
//   F' = rol(F, 1) ^ rol(seed[out], k) ^ seed[in]
//   R' = ror(R, 1) ^ ror(seedrc[out], 1) ^ rol(seedrc[in], k-1)
// with `out` the base leaving and `in` the base entering (rotations mod 64:
// rol by k = 64 is the identity).  A seed is picked from its four values by
// two selects on the base's bits; the tables rotated by k are computed once a
// thread.  Window j is valid when validity bits j..j+k-1 of the 96 are set: a
// doubling AND over the 96 bits (held as a 64-bit and a 32-bit word; every
// step shifts by at most 32) gives all 32 answers at once.  The keys leave
// through K1's swizzled shared stage as 16-byte stores, the flags as two
// 16-byte stores a thread; windows past n - k are invalid and nothing past n
// is written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kW = 32;  // windows a thread; kW + k - 1 <= 95 bases
constexpr int kBlockWindows = kThreads * kW;
constexpr int kPackedVecs = (kBlockWindows / 4 + 16) / 16;  // span + 1 word
constexpr int kValidVecs = (kBlockWindows / 8 + 16) / 16;
constexpr int kKeyVecs = kBlockWindows / 2;  // two keys a 16-byte slot
constexpr int kSpanVecs = kPackedVecs + kValidVecs;
constexpr int kMaxK = 64;
static_assert(kW == 32, "one packed u64 word and one validity u32 word a kW");
static_assert((kThreads + 2) * 8 <= kPackedVecs * 16,
              "packed words t .. t + 2 of the last thread lie in the span");
static_assert((kThreads + 2) * 4 <= kValidVecs * 16,
              "validity words t .. t + 2 of the last thread lie in the span");
static_assert(kW + kMaxK - 1 <= 96, "a thread's bases fit three words");
static_assert(kSpanVecs <= kThreads, "one 16-byte word of a span a thread");

// ntHash v1 seeds (will-rowe/nthash), by 2-bit base A, C, G, T.
constexpr uint64_t kSeedA = 0x3C8BFBB395C60474ull;
constexpr uint64_t kSeedC = 0x3193C18562A02B4Cull;
constexpr uint64_t kSeedG = 0x20323ED082572324ull;
constexpr uint64_t kSeedT = 0x295549F54BE24456ull;

// Rotate left by s, 0 <= s < 64 (s = 0: x | x).
__host__ __device__ constexpr uint64_t rol(uint64_t x, int s) {
  return (x << s) | (x >> ((64 - s) & 63));
}

// t[b] for a base b < 4, by two selects (no indexed register array).
__device__ __forceinline__ uint64_t pick(const uint64_t (&t)[4], uint32_t b) {
  const uint64_t lo = (b & 1) ? t[1] : t[0];
  const uint64_t hi = (b & 1) ? t[3] : t[2];
  return (b & 2) ? hi : lo;
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

// The key stage's slot of pair s (keys 2s, 2s+1) of thread t (as K1's).
__device__ __forceinline__ int key_slot(int t, int s) {
  return t * (kW / 2) + (s ^ (t & 15));
}

// Flag bytes of four windows: byte e is bit e of x (x < 16).
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
encode_nthash_kernel(const uint8_t* __restrict__ packed2, int64_t packed_bytes,
                     const uint8_t* __restrict__ validmask, int64_t valid_bytes,
                     int64_t n, int k, int canonical, uint64_t max_hash,
                     unsigned long long* __restrict__ keyed,
                     uint8_t* __restrict__ valid) {
  __shared__ uint4 s_span[kSpanVecs];
  __shared__ uint4 s_keys[kKeyVecs];
  const int t = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlockWindows;
  if (t < kSpanVecs) {
    s_span[t] = t < kPackedVecs
                    ? load16(packed2, packed_bytes, first / 4 + 16 * t)
                    : load16(validmask, valid_bytes,
                             first / 8 + 16 * (t - kPackedVecs));
  }
  __syncthreads();

  const uint64_t* words = reinterpret_cast<const uint64_t*>(s_span);
  const uint32_t* vwords = reinterpret_cast<const uint32_t*>(s_span + kPackedVecs);
  const uint64_t w0 = words[t], w1 = words[t + 1], w2 = words[t + 2];

  // seed of a base entering F, and the same rotated for leaving; seedrc of a
  // base leaving R (ror 1) and entering it (rol k-1)
  const uint64_t f_in[4] = {kSeedA, kSeedC, kSeedG, kSeedT};
  const uint64_t r_out[4] = {rol(kSeedT, 63), rol(kSeedG, 63), rol(kSeedC, 63),
                             rol(kSeedA, 63)};
  const uint64_t rc[4] = {kSeedT, kSeedG, kSeedC, kSeedA};
  uint64_t f_out[4], r_in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f_out[q] = rol(f_in[q], k & 63);
    r_in[q] = rol(rc[q], (k - 1) & 63);
  }

  // the first window, bases 0 .. k-1 (words 0 and 1), hashed directly
  uint64_t f = 0, r = 0, cur = w0;
  for (int j = 0; j < k; ++j) {
    if (j == 32) cur = w1;
    const uint32_t b = static_cast<uint32_t>(cur) & 3u;
    cur >>= 2;
    f = rol(f, 1) ^ pick(f_in, b);
    r ^= rol(pick(rc, b), j);
  }
  // bases 0 .. 30 leave the windows, bases k .. k + 30 enter them
  uint64_t out = w0;
  const int wi = k >> 5, sh = 2 * (k & 31);
  const uint64_t lo = wi == 0 ? w0 : (wi == 1 ? w1 : w2);
  const uint64_t hi = wi == 0 ? w1 : w2;
  uint64_t in = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;

  // bit j: validity bits j .. j + k - 1 of the 96 all set
  uint64_t vlo = static_cast<uint64_t>(vwords[t]) |
                 (static_cast<uint64_t>(vwords[t + 1]) << 32);
  uint64_t vhi = vwords[t + 2];
  for (int have = 1; have < k;) {
    const int step = have < k - have ? have : k - have;  // 1 .. 32
    vlo &= (vlo >> step) | (vhi << (64 - step));
    vhi &= vhi >> step;
    have += step;
  }
  const int64_t i0 = first + static_cast<int64_t>(t) * kW;
  const int64_t last = n - k - i0;  // windows j <= last may be valid
  uint32_t ok = static_cast<uint32_t>(vlo);
  if (last < kW - 1) ok = last < 0 ? 0u : ok & ((2u << last) - 1u);

  uint32_t kept = 0;
#pragma unroll
  for (int s = 0; s < kW / 2; ++s) {
    unsigned long long key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * s + h;
      if (j > 0) {
        const uint32_t bo = static_cast<uint32_t>(out) & 3u;
        const uint32_t bi = static_cast<uint32_t>(in) & 3u;
        out >>= 2;
        in >>= 2;
        f = rol(f, 1) ^ pick(f_out, bo) ^ pick(f_in, bi);
        r = rol(r, 63) ^ pick(r_out, bo) ^ pick(r_in, bi);
      }
      const uint64_t code = (canonical && r < f) ? r : f;
      const bool keep = ((ok >> j) & 1) && code <= max_hash;
      kept |= static_cast<uint32_t>(keep) << j;
      key[h] = keep ? code : ~0ull;
    }
    s_keys[key_slot(t, s)] = make_uint4(
        static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[0] >> 32),
        static_cast<uint32_t>(key[1]), static_cast<uint32_t>(key[1] >> 32));
  }
  // the thread's kW flag bytes
  if (i0 + kW <= n) {
    uint4* dst = reinterpret_cast<uint4*>(valid + i0);
    dst[0] = make_uint4(spread4(kept & 15), spread4((kept >> 4) & 15),
                        spread4((kept >> 8) & 15), spread4((kept >> 12) & 15));
    dst[1] = make_uint4(spread4((kept >> 16) & 15), spread4((kept >> 20) & 15),
                        spread4((kept >> 24) & 15), spread4(kept >> 28));
  } else {
    for (int j = 0; i0 + j < n; ++j) valid[i0 + j] = (kept >> j) & 1;
  }
  __syncthreads();

  const int64_t have = n - first;  // windows of this block, > 0
  uint4* dst = reinterpret_cast<uint4*>(keyed + first);
  for (int p = t; p < kKeyVecs; p += kThreads) {
    const uint4 v = s_keys[key_slot(p / (kW / 2), p % (kW / 2))];
    if (2 * p + 1 < have) {
      dst[p] = v;
    } else if (2 * p < have) {
      keyed[first + 2 * p] = static_cast<unsigned long long>(v.x) |
                             (static_cast<unsigned long long>(v.y) << 32);
    }
  }
}

}  // namespace

extern "C" {

// Launch H1 over n windows on `stream`; every pointer 16-byte aligned,
// 1 <= k <= 64.  Returns cudaGetLastError().
int ukt_encode_nthash(const void* packed2, int64_t packed_bytes,
                      const void* validmask, int64_t valid_bytes, int64_t n,
                      int k, int canonical, uint64_t max_hash, void* keyed,
                      void* valid, void* stream) {
  const int64_t blocks = (n + kBlockWindows - 1) / kBlockWindows;
  if (k < 1 || k > kMaxK || blocks > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(packed2) | reinterpret_cast<uintptr_t>(validmask) |
       reinterpret_cast<uintptr_t>(keyed) | reinterpret_cast<uintptr_t>(valid)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  encode_nthash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed2), packed_bytes,
      static_cast<const uint8_t*>(validmask), valid_bytes, n, k, canonical,
      max_hash, static_cast<unsigned long long*>(keyed),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
