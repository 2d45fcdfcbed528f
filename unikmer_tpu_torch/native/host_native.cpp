// Native host codecs of unikmer_tpu_torch: the port's own copy of the
// entry points of unikmer_tpu/native/unikit_native.cpp that its host
// layers call, built by native/__init__.py with g++ at first use.
//
//   gb64_encode_deltas, unik_encode_sorted_blocks   .unik sorted payload
//   unik_scan_blocks, unik_decode_sorted_blocks     .unik sorted payload
//                                                   read back
//   pack_bases_2bit_native                          2-bit ingress pack
//   fastx_load, fastx_pack_free                     fused FASTA/Q ingest
//   radix_sort_u64[_u32|_u64], msd_partition_u64    host sorts
//   set2_{union,inter,diff}_u64                     host set algebra
//   member_mask_sorted_u64                          sorted merge-join
//   render_kmer_lines, render_kmer_u64_lines,       view's text lines
//   render_u64_lines, render_u64_pair_lines,
//   decode_codes_ascii
//   parse_code_lines                                dump's text parse
//   encode_windows_u64, nthash_windows_u64,         the host count engine
//   minimizer_emit_u64, syncmer_emit_u64,           (models/count_host.py):
//   syncmer_compat_emit_u64                         every window's code or
//                                                   hash, the sketch streams
//
// It links no libdeflate: whole-file gzip inputs inflate with zlib when
// native/__init__.py finds <zlib.h> (it then defines UKT_HAVE_ZLIB and
// links -lz); without it fastx_load reports GZIP_UNSUPPORTED and the
// caller reads the file with the Python reader.  The .unik writer's gzip
// members are made by Python's zlib (io/pgzip.py).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>

#include <sys/mman.h>

#ifdef UKT_HAVE_ZLIB
#include <zlib.h>
#endif

namespace {

inline int byte_len_u64(uint64_t v) {
    if (v == 0) return 1;
    int bits = 64 - __builtin_clzll(v);
    return (bits + 7) >> 3;
}

// ASCII -> 2-bit base code (255 invalid), matching ops/codec.BASE_LUT.
uint8_t BASE_LUT[256];
bool lut_init = []() {
    std::memset(BASE_LUT, 0xFF, sizeof(BASE_LUT));
    BASE_LUT[(unsigned char)'A'] = BASE_LUT[(unsigned char)'a'] = 0;
    BASE_LUT[(unsigned char)'C'] = BASE_LUT[(unsigned char)'c'] = 1;
    BASE_LUT[(unsigned char)'G'] = BASE_LUT[(unsigned char)'g'] = 2;
    BASE_LUT[(unsigned char)'T'] = BASE_LUT[(unsigned char)'t'] = 3;
    BASE_LUT[(unsigned char)'U'] = BASE_LUT[(unsigned char)'u'] = 3;
    return true;
}();

inline bool is_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
}

}  // namespace

extern "C" {

// 1 when this build inflates gzip inputs itself (zlib found).
int32_t ukt_have_zlib() {
#ifdef UKT_HAVE_ZLIB
    return 1;
#else
    return 0;
#endif
}

// ---------------------------------------------------------------------
// varint-GB64 of sorted deltas (layout in io/varint.py): groups of 4
// values, one u16 control word per group (3 bits per value = byte
// length - 1), all control words first.  Returns bytes written, or
// (size_t)-1 if out_cap is below the worst case 2*ceil(n/4) + 8n.
// ---------------------------------------------------------------------

size_t gb64_encode_deltas(const uint64_t* vals, size_t n, uint64_t prev,
                          uint8_t* out, size_t out_cap) {
    if (n == 0) return 0;
    size_t ngroups = (n + 3) / 4;
    size_t ctrl_bytes = 2 * ngroups;
    if (out_cap < ctrl_bytes + 8 * n) return (size_t)-1;
    uint8_t* ctrl = out;
    uint8_t* data = out + ctrl_bytes;
    size_t dpos = 0;
    uint64_t p = prev;
    for (size_t g = 0; g < ngroups; g++) {
        uint16_t c = 0;
        size_t base = g * 4;
        size_t in_group = (base + 4 <= n) ? 4 : (n - base);
        for (size_t j = 0; j < in_group; j++) {
            uint64_t v = vals[base + j] - p;
            p = vals[base + j];
            int len = byte_len_u64(v);
            c |= (uint16_t)(len - 1) << (3 * j);
            std::memcpy(data + dpos, &v, 8);
            dpos += len;
        }
        ctrl[2 * g] = (uint8_t)(c & 0xFF);
        ctrl[2 * g + 1] = (uint8_t)(c >> 8);
    }
    return ctrl_bytes + dpos;
}

// varint-GB64 -> cumulative sums (delta decode).  Returns bytes
// consumed, or (size_t)-1 on truncation.
size_t gb64_decode_deltas(const uint8_t* buf, size_t buflen, size_t n,
                          uint64_t prev, uint64_t* out) {
    if (n == 0) return 0;
    size_t ngroups = (n + 3) / 4;
    size_t ctrl_bytes = 2 * ngroups;
    if (buflen < ctrl_bytes) return (size_t)-1;
    const uint8_t* data = buf + ctrl_bytes;
    size_t data_len = buflen - ctrl_bytes;
    size_t dpos = 0;
    uint64_t acc = prev;
    for (size_t g = 0; g < ngroups; g++) {
        uint16_t c = (uint16_t)buf[2 * g] | ((uint16_t)buf[2 * g + 1] << 8);
        size_t base = g * 4;
        size_t in_group = (base + 4 <= n) ? 4 : (n - base);
        for (size_t j = 0; j < in_group; j++) {
            int len = ((c >> (3 * j)) & 7) + 1;
            if (dpos + (size_t)len > data_len) return (size_t)-1;
            uint64_t v = 0;
            if (dpos + 8 <= data_len) {
                std::memcpy(&v, data + dpos, 8);
                if (len < 8) v &= (~0ULL) >> (8 * (8 - len));
            } else {
                std::memcpy(&v, data + dpos, len);
            }
            acc += v;
            out[base + j] = acc;
            dpos += len;
        }
    }
    return ctrl_bytes + dpos;
}

// Total records across the blocks of a sorted block region, or -1 on
// bad framing.
int64_t unik_scan_blocks(const uint8_t* buf, int64_t len) {
    int64_t pos = 0, total = 0;
    while (pos + 8 <= len) {
        uint32_t n, nbytes;
        std::memcpy(&n, buf + pos, 4);
        std::memcpy(&nbytes, buf + pos + 4, 4);
        if (n == 0) break;
        if (pos + 8 + (int64_t)nbytes > len) return -1;
        total += n;
        pos += 8 + (int64_t)nbytes;
    }
    return total;
}

// Decode every block of a sorted block region (.unik minor version >=
// 1: each block's delta chain restarts at 0) concurrently; taxid_w =
// 0..4 bytes per record.  Returns records decoded, or -1 on any
// framing or decode error.
int64_t unik_decode_sorted_blocks(const uint8_t* buf, int64_t len,
                                  int32_t taxid_w, uint64_t* codes,
                                  uint32_t* taxids, int64_t cap,
                                  int32_t threads) {
    struct Blk { int64_t body; uint32_t n, nbytes; int64_t out; };
    std::vector<Blk> blks;
    int64_t pos = 0, total = 0;
    while (pos + 8 <= len) {
        uint32_t n, nbytes;
        std::memcpy(&n, buf + pos, 4);
        std::memcpy(&nbytes, buf + pos + 4, 4);
        if (n == 0) break;
        if (pos + 8 + (int64_t)nbytes > len) return -1;
        blks.push_back({pos + 8, n, nbytes, total});
        total += n;
        pos += 8 + (int64_t)nbytes;
    }
    if (total > cap) return -1;
    std::atomic<size_t> next(0);
    std::atomic<bool> failed(false);
    auto work = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= blks.size() || failed.load(std::memory_order_relaxed))
                return;
            const Blk& b = blks[i];
            size_t consumed = gb64_decode_deltas(buf + b.body, b.nbytes, b.n,
                                                 0, codes + b.out);
            if (consumed == (size_t)-1 ||
                consumed + (size_t)b.n * taxid_w != b.nbytes) {
                failed = true;
                return;
            }
            if (taxid_w) {
                const uint8_t* t = buf + b.body + consumed;
                uint32_t* out = taxids + b.out;
                if (taxid_w == 4) {
                    std::memcpy(out, t, (size_t)b.n * 4);
                } else {
                    for (uint32_t j = 0; j < b.n; j++) {
                        uint32_t v = 0;
                        std::memcpy(&v, t + (size_t)j * taxid_w, taxid_w);
                        out[j] = v;
                    }
                }
            }
        }
    };
    int nt = threads < 1 ? 1 : threads;
    if ((size_t)nt > blks.size()) nt = (int)blks.size();
    if (nt <= 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < nt; t++) pool.emplace_back(work);
        for (auto& t : pool) t.join();
    }
    return failed.load() ? -1 : total;
}

// Encode a sorted code array (+ optional taxid column, taxid_w bytes
// per record) into the full framed block region: blocks of
// "u32 n, u32 nbytes, varint-GB deltas ++ taxids", delta chain
// restarting at 0 per block (.unik minor version 1).  Returns total
// bytes, or -1 if out_cap is below nblocks per-block worst cases.
int64_t unik_encode_sorted_blocks(const uint64_t* codes,
                                  const uint32_t* taxids, int64_t n,
                                  int64_t block_elems, int32_t taxid_w,
                                  uint8_t* out, int64_t out_cap,
                                  int32_t threads) {
    if (block_elems < 1) return -1;
    int64_t nblocks = (n + block_elems - 1) / block_elems;
    int64_t worst_payload =
        2 * ((block_elems + 3) / 4) + 8 * block_elems +
        (int64_t)taxid_w * block_elems;
    int64_t slot = 8 + worst_payload;
    if (out_cap < nblocks * slot) return -1;
    std::vector<int64_t> sizes((size_t)nblocks, 0);
    std::atomic<int64_t> next(0);
    std::atomic<bool> failed(false);
    auto work = [&]() {
        for (;;) {
            int64_t b = next.fetch_add(1);
            if (b >= nblocks || failed.load(std::memory_order_relaxed))
                return;
            int64_t base = b * block_elems;
            int64_t bn = (base + block_elems <= n) ? block_elems : (n - base);
            uint8_t* dst = out + b * slot;
            size_t payload = gb64_encode_deltas(codes + base, (size_t)bn, 0,
                                                dst + 8, (size_t)worst_payload);
            if (payload == (size_t)-1) { failed = true; return; }
            if (taxid_w) {
                uint8_t* t = dst + 8 + payload;
                if (taxid_w == 4) {
                    std::memcpy(t, taxids + base, (size_t)bn * 4);
                } else {
                    for (int64_t j = 0; j < bn; j++)
                        std::memcpy(t + j * taxid_w, &taxids[base + j],
                                    (size_t)taxid_w);
                }
                payload += (size_t)bn * taxid_w;
            }
            uint32_t n32 = (uint32_t)bn, p32 = (uint32_t)payload;
            std::memcpy(dst, &n32, 4);
            std::memcpy(dst + 4, &p32, 4);
            sizes[(size_t)b] = 8 + (int64_t)payload;
        }
    };
    int nt = threads < 1 ? 1 : threads;
    if (nt > nblocks) nt = (int)nblocks;
    if (nt <= 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < nt; t++) pool.emplace_back(work);
        for (auto& t : pool) t.join();
    }
    if (failed.load()) return -1;
    int64_t w = sizes.empty() ? 0 : sizes[0];
    for (int64_t b = 1; b < nblocks; b++) {
        std::memmove(out + w, out + b * slot, (size_t)sizes[(size_t)b]);
        w += sizes[(size_t)b];
    }
    return w;
}

// ---------------------------------------------------------------------
// 2-bit ingress pack: bases (0..3 valid, else invalid) -> packed2
// (4 bases/byte, bit 2*(i%4)) + bit validmask (bit i%8), both
// little-ordered to match numpy packbits(bitorder='little').
// ---------------------------------------------------------------------

static void pack_2bit_range(const uint8_t* bases, size_t lo, size_t hi,
                            uint8_t* packed2, uint8_t* validmask) {
    // lo/hi must be multiples of 8 (except hi == n at the tail)
    size_t i = lo;
    for (; i + 8 <= hi; i += 8) {
        uint8_t m = 0, p0 = 0, p1 = 0;
        for (int j = 0; j < 4; j++) {
            uint8_t b = bases[i + j];
            uint8_t v = (uint8_t)(b < 4);
            m |= (uint8_t)(v << j);
            p0 |= (uint8_t)((v ? b : 0) << (2 * j));
        }
        for (int j = 0; j < 4; j++) {
            uint8_t b = bases[i + 4 + j];
            uint8_t v = (uint8_t)(b < 4);
            m |= (uint8_t)(v << (4 + j));
            p1 |= (uint8_t)((v ? b : 0) << (2 * j));
        }
        validmask[i >> 3] = m;
        packed2[i >> 2] = p0;
        packed2[(i >> 2) + 1] = p1;
    }
    for (; i < hi; i++) {
        uint8_t b = bases[i];
        if (b < 4) {
            validmask[i >> 3] |= (uint8_t)(1u << (i & 7));
            packed2[i >> 2] |= (uint8_t)(b << (2 * (i & 3)));
        }
    }
}

void pack_bases_2bit_native(const uint8_t* bases, size_t n,
                            uint8_t* packed2, uint8_t* validmask,
                            int threads) {
    size_t n4 = (n + 3) / 4, n8 = (n + 7) / 8;
    std::memset(packed2, 0, n4);
    std::memset(validmask, 0, n8);
    if (threads < 2 || n < (1u << 20)) {
        pack_2bit_range(bases, 0, n, packed2, validmask);
        return;
    }
    size_t chunk =
        (((n + (size_t)threads - 1) / (size_t)threads) + 7) & ~(size_t)7;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; t++) {
        size_t lo = (size_t)t * chunk;
        if (lo >= n) break;
        size_t hi = std::min(n, lo + chunk);
        ts.emplace_back(pack_2bit_range, bases, lo, hi, packed2,
                        validmask);
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Sorted-set kernels over u64 codes: 2-way union / intersection /
// difference and membership merge-join, range-partitioned across a
// thread pool.
// ---------------------------------------------------------------------

namespace {

// Slice boundaries for p partitions of (a, b) aligned on code value:
// partition i covers a[ai[i]..ai[i+1]) and b[bi[i]..bi[i+1]).
void partition_pair(const uint64_t* a, int64_t na, const uint64_t* b,
                    int64_t nb, int p, std::vector<int64_t>& ai,
                    std::vector<int64_t>& bi) {
    ai.resize(p + 1);
    bi.resize(p + 1);
    ai[0] = bi[0] = 0;
    ai[p] = na;
    bi[p] = nb;
    for (int i = 1; i < p; i++) {
        int64_t pos = na * i / p;
        uint64_t pivot = a[pos < na ? pos : na - 1];
        // split below the first occurrence of pivot in both arrays so
        // equal runs never straddle a boundary
        ai[i] = std::lower_bound(a, a + na, pivot) - a;
        bi[i] = std::lower_bound(b, b + nb, pivot) - b;
    }
    for (int i = 1; i < p; i++) {  // monotonize (tiny/duplicate pivots)
        if (ai[i] < ai[i - 1]) ai[i] = ai[i - 1];
        if (bi[i] < bi[i - 1]) bi[i] = bi[i - 1];
    }
}

enum SetOp { OP_UNION = 0, OP_INTER = 1, OP_DIFF = 2 };

// Union, intersection or difference of two sorted slices, duplicates
// collapsed.
int64_t merge_slice(SetOp op, const uint64_t* a, int64_t na,
                    const uint64_t* b, int64_t nb, uint64_t* out) {
    int64_t i = 0, j = 0, w = 0;
    while (i < na && j < nb) {
        uint64_t x = a[i], y = b[j];
        if (x < y) {
            if (op != OP_INTER) out[w++] = x;
            while (++i < na && a[i] == x) {}
        } else if (y < x) {
            if (op == OP_UNION) out[w++] = y;
            while (++j < nb && b[j] == y) {}
        } else {
            if (op != OP_DIFF) out[w++] = x;
            while (++i < na && a[i] == x) {}
            while (++j < nb && b[j] == y) {}
        }
    }
    if (op != OP_INTER) {
        while (i < na) {
            uint64_t x = a[i];
            out[w++] = x;
            while (++i < na && a[i] == x) {}
        }
    }
    if (op == OP_UNION) {
        while (j < nb) {
            uint64_t y = b[j];
            out[w++] = y;
            while (++j < nb && b[j] == y) {}
        }
    }
    return w;
}

int64_t set2_run(SetOp op, const uint64_t* a, int64_t na, const uint64_t* b,
                 int64_t nb, uint64_t* out, int32_t threads) {
    int p = threads < 1 ? 1 : threads;
    if (na + nb < (1 << 16) || na == 0) p = 1;
    std::vector<int64_t> ai, bi;
    partition_pair(a, na, b, nb, p, ai, bi);
    std::vector<int64_t> sizes(p, 0);
    // per-partition scratch laid out at input-sum offsets (cannot
    // overflow), compacted afterwards
    std::vector<int64_t> cap_off(p + 1, 0);
    for (int i = 0; i < p; i++)
        cap_off[i + 1] =
            cap_off[i] + (ai[i + 1] - ai[i]) + (bi[i + 1] - bi[i]);
    auto work_part = [&](int i) {
        sizes[i] = merge_slice(op, a + ai[i], ai[i + 1] - ai[i], b + bi[i],
                               bi[i + 1] - bi[i], out + cap_off[i]);
    };
    if (p == 1) {
        work_part(0);
        return sizes[0];
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < p; t++) pool.emplace_back(work_part, t);
    for (auto& t : pool) t.join();
    int64_t w = sizes[0];
    for (int i = 1; i < p; i++) {
        std::memmove(out + w, out + cap_off[i],
                     (size_t)sizes[i] * sizeof(uint64_t));
        w += sizes[i];
    }
    return w;
}

}  // namespace

extern "C" {

// out must hold na + nb.  Inputs sorted (duplicates allowed; collapsed).
int64_t set2_union_u64(const uint64_t* a, int64_t na, const uint64_t* b,
                       int64_t nb, uint64_t* out, int32_t threads) {
    return set2_run(OP_UNION, a, na, b, nb, out, threads);
}

int64_t set2_inter_u64(const uint64_t* a, int64_t na, const uint64_t* b,
                       int64_t nb, uint64_t* out, int32_t threads) {
    return set2_run(OP_INTER, a, na, b, nb, out, threads);
}

int64_t set2_diff_u64(const uint64_t* a, int64_t na, const uint64_t* b,
                      int64_t nb, uint64_t* out, int32_t threads) {
    return set2_run(OP_DIFF, a, na, b, nb, out, threads);
}

// Membership of each (sorted) query in sorted ref: mask[j] in {0,1},
// idx[j] = matching ref index where mask (0 otherwise; idx may be
// NULL).  Queries partitioned evenly; ref ranges via binary search.
void member_mask_sorted_u64(const uint64_t* ref, int64_t nref,
                            const uint64_t* q, int64_t nq, uint8_t* mask,
                            int64_t* idx, int32_t threads) {
    int p = threads < 1 ? 1 : threads;
    if (nq < (1 << 16)) p = 1;
    auto work = [&](int t) {
        int64_t q0 = nq * t / p, q1 = nq * (t + 1) / p;
        if (q0 >= q1) return;
        const uint64_t* r =
            std::lower_bound(ref, ref + nref, q[q0]);
        for (int64_t j = q0; j < q1; j++) {
            uint64_t v = q[j];
            while (r < ref + nref && *r < v) r++;
            bool hit = (r < ref + nref && *r == v);
            mask[j] = hit ? 1 : 0;
            if (idx) idx[j] = hit ? (r - ref) : 0;
        }
    };
    if (p == 1) {
        work(0);
        return;
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < p; t++) pool.emplace_back(work, t);
    for (auto& t : pool) t.join();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Parallel LSD radix sort over u64 keys (8-bit digits), optionally
// carrying a value column.  Stable; skips passes whose digit is
// constant, and runs only ceil(significant_bits/8) passes.
// ---------------------------------------------------------------------

namespace {

struct NoVal {};

// Persistent grow-only scratch: pages are faulted once per process and
// reused, never returned (first touch of fresh pages is slow and
// variable on virtualized hosts); MADV_NOHUGEPAGE opts out of 2 MB
// huge faults.
struct ScratchArena {
    void* p = nullptr;
    size_t bytes = 0;
    std::mutex mu;
    // Returns a buffer of >= b bytes, or nullptr; hold until release().
    void* acquire(size_t b) {
        mu.lock();
        if (b <= bytes) return p;
        if (p) munmap(p, bytes);
        p = mmap(nullptr, b, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
        if (p == MAP_FAILED) {
            p = nullptr;
            bytes = 0;
            mu.unlock();
            return nullptr;
        }
#ifdef MADV_NOHUGEPAGE
        madvise(p, b, MADV_NOHUGEPAGE);
#endif
        bytes = b;
        return p;
    }
    void release() { mu.unlock(); }
};

ScratchArena g_radix_scratch;

template <typename V>
int32_t radix_sort_kv(uint64_t* keys, V* vals, int64_t n, int threads) {
    constexpr bool HasVals = !std::is_same<V, NoVal>::value;
    if (n < 2) return 0;
    int p = threads < 1 ? 1 : threads;
    if (n < (1 << 16)) p = 1;
    uint64_t mx = 0;
    {
        std::vector<uint64_t> mxs(p, 0);
        auto work = [&](int t) {
            int64_t i0 = n * t / p, i1 = n * (t + 1) / p;
            uint64_t m = 0;
            for (int64_t i = i0; i < i1; i++) m = std::max(m, keys[i]);
            mxs[t] = m;
        };
        if (p == 1) {
            work(0);
        } else {
            std::vector<std::thread> pool;
            for (int t = 0; t < p; t++) pool.emplace_back(work, t);
            for (auto& t : pool) t.join();
        }
        for (int t = 0; t < p; t++) mx = std::max(mx, mxs[t]);
    }
    if (mx == 0) return 0;  // all keys zero
    // NOT `while (mx >> bits)`: keys with bit 63 set would reach a shift
    // of 64, which is undefined.
    int bits = 64 - __builtin_clzll(mx);
    int passes = (bits + 7) / 8;

    size_t k_bytes = (size_t)n * sizeof(uint64_t);
    size_t v_bytes = HasVals ? (size_t)n * sizeof(V) : 0;
    // hist is allocated before taking the scratch lock so a bad_alloc
    // cannot leave the arena mutex held.
    std::vector<int64_t> hist((size_t)p * 256);
    void* scratch = g_radix_scratch.acquire(k_bytes + v_bytes);
    if (!scratch) return -1;  // OOM
    uint64_t* ka = keys;
    uint64_t* kb = static_cast<uint64_t*>(scratch);
    V* va = vals;
    V* vb = reinterpret_cast<V*>(static_cast<uint8_t*>(scratch) + k_bytes);
    try {
    for (int pass = 0; pass < passes; pass++) {
        int shift = 8 * pass;
        std::fill(hist.begin(), hist.end(), 0);
        auto count = [&](int t) {
            int64_t i0 = n * t / p, i1 = n * (t + 1) / p;
            int64_t* h = hist.data() + (size_t)t * 256;
            for (int64_t i = i0; i < i1; i++)
                h[(ka[i] >> shift) & 0xff]++;
        };
        if (p == 1) {
            count(0);
        } else {
            std::vector<std::thread> pool;
            for (int t = 0; t < p; t++) pool.emplace_back(count, t);
            for (auto& t : pool) t.join();
        }
        // column-major exclusive prefix over (digit, thread): thread t's
        // run of digit d lands after all smaller digits and all earlier
        // threads' runs of d, which is what makes LSD stable.
        int64_t run = 0;
        bool constant_digit = false;
        for (int d = 0; d < 256 && !constant_digit; d++) {
            int64_t total_d = 0;
            for (int t = 0; t < p; t++) total_d += hist[(size_t)t * 256 + d];
            if (total_d == n) constant_digit = true;
            for (int t = 0; t < p; t++) {
                int64_t c = hist[(size_t)t * 256 + d];
                hist[(size_t)t * 256 + d] = run;
                run += c;
            }
        }
        if (constant_digit) continue;  // nothing moves this pass
        auto scatter = [&](int t) {
            int64_t i0 = n * t / p, i1 = n * (t + 1) / p;
            int64_t* off = hist.data() + (size_t)t * 256;
            for (int64_t i = i0; i < i1; i++) {
                int64_t w = off[(ka[i] >> shift) & 0xff]++;
                kb[w] = ka[i];
                if constexpr (HasVals) vb[w] = va[i];
            }
        };
        if (p == 1) {
            scatter(0);
        } else {
            std::vector<std::thread> pool;
            for (int t = 0; t < p; t++) pool.emplace_back(scatter, t);
            for (auto& t : pool) t.join();
        }
        std::swap(ka, kb);
        if constexpr (HasVals) std::swap(va, vb);
    }
    if (ka != keys) {
        std::memcpy(keys, ka, (size_t)n * sizeof(uint64_t));
        if constexpr (HasVals) std::memcpy(vals, va, (size_t)n * sizeof(V));
    }
    } catch (...) {
        // thread creation can throw under resource pressure; the arena
        // mutex must not stay locked, and the rc tells callers to fall
        // back (they sort a copy, so a partial permutation is discarded)
        g_radix_scratch.release();
        return -1;
    }
    g_radix_scratch.release();
    return 0;
}

// One parallel MSD pass on the byte at ``shift``: partitions keys into
// 256 value-range buckets (stable within buckets) and writes the 257
// exclusive bucket offsets; the caller sorts each bucket with numpy.
int32_t msd_partition_impl(uint64_t* keys, int64_t n, int shift,
                           int64_t* offsets, int threads) {
    if (shift < 0 || shift > 56 || (shift & 7)) return -2;
    int p = threads < 1 ? 1 : threads;
    if (n < (1 << 16)) p = 1;
    std::vector<int64_t> hist((size_t)p * 256);
    size_t k_bytes = (size_t)n * sizeof(uint64_t);
    void* scratch = g_radix_scratch.acquire(k_bytes);
    if (!scratch) return -1;
    uint64_t* kb = static_cast<uint64_t*>(scratch);
    try {
        std::fill(hist.begin(), hist.end(), 0);
        auto count = [&](int t) {
            int64_t i0 = n * t / p, i1 = n * (t + 1) / p;
            int64_t* h = hist.data() + (size_t)t * 256;
            for (int64_t i = i0; i < i1; i++)
                h[(keys[i] >> shift) & 0xff]++;
        };
        auto run = [&](auto fn) {
            if (p == 1) { fn(0); return; }
            std::vector<std::thread> pool;
            for (int t = 0; t < p; t++) pool.emplace_back(fn, t);
            for (auto& t : pool) t.join();
        };
        run(count);
        int64_t runoff = 0;
        for (int d = 0; d < 256; d++) {
            offsets[d] = runoff;
            for (int t = 0; t < p; t++) {
                int64_t c = hist[(size_t)t * 256 + d];
                hist[(size_t)t * 256 + d] = runoff;
                runoff += c;
            }
        }
        offsets[256] = n;
        auto scatter = [&](int t) {
            int64_t i0 = n * t / p, i1 = n * (t + 1) / p;
            int64_t* off = hist.data() + (size_t)t * 256;
            for (int64_t i = i0; i < i1; i++)
                kb[off[(keys[i] >> shift) & 0xff]++] = keys[i];
        };
        run(scatter);
        std::memcpy(keys, kb, k_bytes);
    } catch (...) {
        g_radix_scratch.release();
        return -1;
    }
    g_radix_scratch.release();
    return 0;
}

}  // namespace

extern "C" {

int32_t msd_partition_u64(uint64_t* keys, int64_t n, int32_t shift,
                          int64_t* offsets, int32_t threads) {
    try {
        return msd_partition_impl(keys, n, shift, offsets, threads);
    } catch (...) {
        return -1;
    }
}

// Return 0 on success, -1 on scratch allocation failure (input is then
// left in its original order: callers must check).
int32_t radix_sort_u64(uint64_t* keys, int64_t n, int32_t threads) {
    try {
        return radix_sort_kv<NoVal>(keys, nullptr, n, threads);
    } catch (...) {
        return -1;
    }
}

int32_t radix_sort_u64_u32(uint64_t* keys, uint32_t* vals, int64_t n,
                           int32_t threads) {
    try {
        return radix_sort_kv<uint32_t>(keys, vals, n, threads);
    } catch (...) {
        return -1;
    }
}

int32_t radix_sort_u64_u64(uint64_t* keys, uint64_t* vals, int64_t n,
                           int32_t threads) {
    try {
        return radix_sort_kv<uint64_t>(keys, vals, n, threads);
    } catch (...) {
        return -1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Fused FASTA/FASTQ loader: file -> (inflate) -> parse -> 2-bit pack,
// in the exact layout of io/fastx.pack_records: records joined with one
// RECORD_SEP byte after each (circular genomes first append their k-1
// leading bases), records shorter than k dropped, line ends trimmed.
// ---------------------------------------------------------------------

namespace {

// Record-separator byte between records (ops/codec.RECORD_SEP): invalid
// (>= 4) to every window kernel.
constexpr uint8_t kRecordSep = 0xFE;

struct Growable {
    uint8_t* data = nullptr;
    size_t len = 0, cap = 0;
    void reserve(size_t want) {
        if (want <= cap) return;
        size_t ncap = cap ? cap : 1 << 20;
        while (ncap < want) ncap *= 2;
        data = (uint8_t*)std::realloc(data, ncap);
        cap = ncap;
    }
    void append(const uint8_t* src, size_t n) {
        reserve(len + n);
        std::memcpy(data + len, src, n);
        len += n;
    }
    void push(uint8_t b) {
        reserve(len + 1);
        data[len++] = b;
    }
};

bool read_whole_file(const char* path, std::vector<uint8_t>& out, char* err) {
    FILE* f = std::fopen(path, "rb");
    if (!f) { std::snprintf(err, 256, "cannot open %s", path); return false; }
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (sz < 0) { std::fclose(f); std::snprintf(err, 256, "cannot stat %s", path); return false; }
    out.resize((size_t)sz);
    size_t got = sz ? std::fread(out.data(), 1, (size_t)sz, f) : 0;
    std::fclose(f);
    if (got != (size_t)sz) { std::snprintf(err, 256, "short read on %s", path); return false; }
    return true;
}

// Inflate a (possibly multi-member) gzip buffer with zlib, member after
// member, as Python's gzip module reads it (zero padding after a member
// ends the stream).  Fails with TOO_LARGE when the inflated size
// exceeds max_out (> 0), and with GZIP_UNSUPPORTED in a build without
// zlib; the caller then streams the file through the Python reader.
bool gunzip_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out,
                int64_t max_out, char* err) {
#ifndef UKT_HAVE_ZLIB
    (void)in; (void)out; (void)max_out;
    std::snprintf(err, 256, "GZIP_UNSUPPORTED");
    return false;
#else
    const size_t kStep = (size_t)1 << 30;  // zlib counts in 32-bit uInt
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) {
        std::snprintf(err, 256, "zlib init failed");
        return false;
    }
    out.resize(in.size() * 4 + (1 << 20));
    size_t pos = 0, w = 0;
    bool ok = true;
    for (;;) {
        if (zs.avail_in == 0 && pos < in.size()) {
            size_t take = std::min(in.size() - pos, kStep);
            zs.next_in = const_cast<Bytef*>(in.data() + pos);
            zs.avail_in = (uInt)take;
            pos += take;
        }
        if (w == out.size()) {
            if (max_out > 0 && (int64_t)out.size() > max_out) {
                std::snprintf(err, 256, "TOO_LARGE");
                ok = false;
                break;
            }
            out.resize(out.size() * 2);
        }
        size_t room = std::min(out.size() - w, kStep);
        zs.next_out = out.data() + w;
        zs.avail_out = (uInt)room;
        int rc = inflate(&zs, Z_NO_FLUSH);
        w += room - zs.avail_out;
        if (max_out > 0 && (int64_t)w > max_out) {
            std::snprintf(err, 256, "TOO_LARGE");
            ok = false;
            break;
        }
        if (rc == Z_STREAM_END) {
            // skip zero padding; anything else starts the next member
            for (;;) {
                while (zs.avail_in && *zs.next_in == 0) {
                    zs.next_in++;
                    zs.avail_in--;
                }
                if (zs.avail_in || pos >= in.size()) break;
                size_t take = std::min(in.size() - pos, kStep);
                zs.next_in = const_cast<Bytef*>(in.data() + pos);
                zs.avail_in = (uInt)take;
                pos += take;
            }
            if (zs.avail_in == 0) break;
            inflateReset(&zs);
            continue;
        }
        if (rc == Z_OK) continue;
        if (rc == Z_BUF_ERROR && (zs.avail_out == 0 || pos < in.size()))
            continue;
        std::snprintf(err, 256, "gzip decompress error %d", rc);
        ok = false;
        break;
    }
    inflateEnd(&zs);
    if (ok) out.resize(w);
    return ok;
#endif
}

}  // namespace

extern "C" {

struct FastxPack {
    uint8_t* bases;     // packed base codes + separators
    int64_t n_bases;
    int64_t* starts;    // per-record start offset in bases
    int64_t* lengths;   // per-record original length (no wrap bases)
    int64_t n_records;
    uint8_t* ids;       // concatenated record IDs (first header token)
    int64_t* id_offs;   // n_records+1 offsets into ids
    int32_t fastq;      // 1 if input was FASTQ
    char err[256];      // nonempty on failure
};

void fastx_pack_free(FastxPack* p) {
    if (!p) return;
    std::free(p->bases);
    std::free(p->starts);
    std::free(p->lengths);
    std::free(p->ids);
    std::free(p->id_offs);
    std::free(p);
}

// Load + parse + pack one FASTA/FASTQ file (gzip sniffed by magic).
// Returns a FastxPack; on failure the pack has err[0] != 0.
FastxPack* fastx_load(const char* path, int64_t k, int32_t circular,
                      int64_t max_text) {
    FastxPack* p = (FastxPack*)std::calloc(1, sizeof(FastxPack));
    std::vector<uint8_t> raw;
    if (!read_whole_file(path, raw, p->err)) return p;
    if (max_text > 0 && (int64_t)raw.size() > max_text) {
        std::snprintf(p->err, 256, "TOO_LARGE");
        return p;
    }
    std::vector<uint8_t> text;
    if (raw.size() >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
        if (!gunzip_all(raw, text, max_text, p->err)) return p;
        raw.clear();
        raw.shrink_to_fit();
    } else {
        text.swap(raw);
    }

    // locate first non-whitespace byte for format detection
    size_t i = 0, n = text.size();
    while (i < n && is_ws(text[i])) i++;
    if (i == n) {  // empty input: zero records
        p->starts = (int64_t*)std::malloc(1);
        p->lengths = (int64_t*)std::malloc(1);
        p->id_offs = (int64_t*)std::calloc(1, sizeof(int64_t));
        return p;
    }
    bool fastq = text[i] == '@';
    if (!fastq && text[i] != '>') {
        std::snprintf(p->err, 256, "not FASTA/FASTQ (starts with 0x%02x)",
                      text[i]);
        return p;
    }
    p->fastq = fastq ? 1 : 0;

    Growable bases;
    bases.reserve(n + (1 << 16));
    std::vector<int64_t> starts, lengths, id_offs;
    Growable ids;
    id_offs.push_back(0);
    int64_t wrap = (circular && k > 1) ? (k - 1) : 0;

    // per-record state
    int64_t rec_start = -1;   // offset in bases
    int64_t rec_ids_len = 0;  // ids.len before this record's id

    auto line_end = [&](size_t pos) {
        while (pos < n && text[pos] != '\n') pos++;
        return pos;
    };
    auto trim = [&](size_t& a, size_t& b) {
        while (a < b && is_ws(text[a])) a++;
        while (b > a && is_ws(text[b - 1])) b--;
    };
    auto start_record = [&](size_t hdr_a, size_t hdr_b) {
        // header in text[hdr_a, hdr_b): id = first token
        trim(hdr_a, hdr_b);
        size_t tok = hdr_a;
        while (tok < hdr_b && !is_ws(text[tok])) tok++;
        rec_ids_len = ids.len;
        ids.append(text.data() + hdr_a, tok - hdr_a);
        rec_start = (int64_t)bases.len;
    };
    auto finish_record = [&]() {
        if (rec_start < 0) return;
        int64_t len = (int64_t)bases.len - rec_start;
        if (len < k) {  // shorter than k: dropped
            bases.len = (size_t)rec_start;
            ids.len = (size_t)rec_ids_len;
            rec_start = -1;
            return;
        }
        starts.push_back(rec_start);
        lengths.push_back(len);
        if (wrap) {  // circular: append leading k-1 bases before the separator
            bases.reserve(bases.len + (size_t)wrap + 1);
            std::memcpy(bases.data + bases.len, bases.data + rec_start,
                        (size_t)wrap);
            bases.len += (size_t)wrap;
        }
        bases.push(kRecordSep);
        id_offs.push_back((int64_t)ids.len);
        rec_start = -1;
    };
    auto append_seq_line = [&](size_t a, size_t b) {
        trim(a, b);
        bases.reserve(bases.len + (b - a));
        uint8_t* dst = bases.data + bases.len;
        const uint8_t* src = text.data() + a;
        for (size_t j = 0; j < b - a; j++) dst[j] = BASE_LUT[src[j]];
        bases.len += b - a;
    };

    if (!fastq) {
        while (i < n) {
            size_t e = line_end(i);
            if (text[i] == '>') {
                finish_record();
                start_record(i + 1, e);
            } else if (rec_start >= 0) {
                append_seq_line(i, e);
            }
            i = e + 1;
        }
        finish_record();
    } else {
        while (i < n) {
            // skip blank lines between records
            while (i < n && is_ws(text[i])) i++;
            if (i >= n) break;
            if (text[i] != '@') {
                std::snprintf(p->err, 256, "malformed FASTQ header at %zu", i);
                std::free(bases.data);
                std::free(ids.data);
                return p;
            }
            size_t e = line_end(i);
            start_record(i + 1, e);
            i = e + 1;
            size_t sa = i, se = line_end(i);
            append_seq_line(sa, se);
            int64_t seq_len = (int64_t)bases.len - rec_start;
            i = se + 1;
            size_t pe = line_end(i);
            if (i >= n || text[i] != '+') {
                std::snprintf(p->err, 256, "malformed FASTQ: missing + at %zu",
                              i);
                std::free(bases.data);
                std::free(ids.data);
                return p;
            }
            i = pe + 1;
            // quality: one line always, more while shorter than the seq
            // (multi-line quality, mirroring io/fastx._read_fastq)
            int64_t qlen = -1;
            while (qlen < seq_len && i < n) {
                size_t qa = i, qe = line_end(i);
                size_t ta = qa, tb = qe;
                trim(ta, tb);
                qlen = (qlen < 0 ? 0 : qlen) + (int64_t)(tb - ta);
                i = qe + 1;
            }
            finish_record();
        }
    }

    p->n_bases = (int64_t)bases.len;
    p->bases = bases.data;
    p->n_records = (int64_t)starts.size();
    p->starts = (int64_t*)std::malloc(sizeof(int64_t) * (starts.size() + 1));
    p->lengths = (int64_t*)std::malloc(sizeof(int64_t) * (lengths.size() + 1));
    std::memcpy(p->starts, starts.data(), sizeof(int64_t) * starts.size());
    std::memcpy(p->lengths, lengths.data(), sizeof(int64_t) * lengths.size());
    p->ids = ids.data;
    p->id_offs = (int64_t*)std::malloc(sizeof(int64_t) * id_offs.size());
    std::memcpy(p->id_offs, id_offs.data(), sizeof(int64_t) * id_offs.size());
    return p;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Text emission (view's hot loops): k-mer decode and decimal rendering
// fused into sequential single-pass writers, and the bulk parse of
// dump's input lines.
// ---------------------------------------------------------------------

namespace {

const char kBaseChar[4] = {'A', 'C', 'G', 'T'};

inline uint8_t* put_u64(uint8_t* p, uint64_t v) {
    char tmp[20];
    int len = 0;
    do {
        tmp[len++] = (char)('0' + (v % 10));
        v /= 10;
    } while (v);
    for (int i = len - 1; i >= 0; i--) *p++ = (uint8_t)tmp[i];
    return p;
}

inline uint8_t* put_kmer(uint8_t* p, uint64_t code, int k) {
    for (int j = k - 1; j >= 0; j--) p[j] = (uint8_t)kBaseChar[code & 3], code >>= 2;
    return p + k;
}

}  // namespace

extern "C" {

// "<kmer>\n" lines; out capacity n*(k+1); returns bytes written.
int64_t render_kmer_lines(const uint64_t* codes, int64_t n, int32_t k,
                          uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        p = put_kmer(p, codes[i], k);
        *p++ = '\n';
    }
    return p - out;
}

// "<kmer>\t<val>\n" lines; out capacity n*(k+22).
int64_t render_kmer_u64_lines(const uint64_t* codes, const uint64_t* vals,
                              int64_t n, int32_t k, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        p = put_kmer(p, codes[i], k);
        *p++ = '\t';
        p = put_u64(p, vals[i]);
        *p++ = '\n';
    }
    return p - out;
}

// "<val>\n" lines; out capacity n*21.
int64_t render_u64_lines(const uint64_t* vals, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        p = put_u64(p, vals[i]);
        *p++ = '\n';
    }
    return p - out;
}

// "<a>\t<b>\n" lines; out capacity n*42.
int64_t render_u64_pair_lines(const uint64_t* a, const uint64_t* b,
                              int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        p = put_u64(p, a[i]);
        *p++ = '\t';
        p = put_u64(p, b[i]);
        *p++ = '\n';
    }
    return p - out;
}

// (n, k) ASCII matrix of k-mer strings (ops/codec.decode_codes twin).
void decode_codes_ascii(const uint64_t* codes, int64_t n, int32_t k,
                        uint8_t* out) {
    for (int64_t i = 0; i < n; i++) put_kmer(out + i * k, codes[i], k);
}

// Bulk text parse (dump's hot loop): lines of "<token>[\t<int>]" where
// token is a k-mer (mode 0, fixed length k) or a decimal u64 (mode 1).
// Blank lines skipped; \r and trailing spaces tolerated.  Returns the
// number of records parsed, or -(1 + byte_offset_of_bad_line) on the
// first malformed line (the caller re-parses in Python for the exact
// reference error message).
int64_t parse_code_lines(const uint8_t* text, int64_t len, int32_t mode,
                         int32_t k, int32_t has_taxid, uint64_t* codes,
                         uint32_t* taxids, int64_t cap) {
    int64_t n = 0, i = 0;
    while (i < len) {
        int64_t line_start = i;
        int64_t e = i;
        while (e < len && text[e] != '\n') e++;
        int64_t a = i, b = e;
        while (a < b && is_ws(text[a])) a++;
        while (b > a && is_ws(text[b - 1])) b--;
        i = e + 1;
        if (a == b) continue;  // blank line
        if (n >= cap) return -(1 + line_start);
        // token = [a, t); no inner trimming: the Python/Go parsers see
        // 'ACGTA \t..' as a 6-char token and reject it, so must this
        int64_t t = a;
        while (t < b && text[t] != '\t') t++;
        if (!has_taxid && t < b) return -(1 + line_start);  // unexpected column
        int64_t tok_end = t;
        uint64_t code = 0;
        if (mode == 0) {
            if (tok_end - a != k) return -(1 + line_start);
            for (int64_t j = a; j < tok_end; j++) {
                uint8_t c = BASE_LUT[text[j]];
                if (c > 3) return -(1 + line_start);
                code = (code << 2) | c;
            }
        } else {
            if (tok_end == a) return -(1 + line_start);
            for (int64_t j = a; j < tok_end; j++) {
                if (text[j] < '0' || text[j] > '9') return -(1 + line_start);
                uint64_t d = (uint64_t)(text[j] - '0');
                if (code > (~0ULL - d) / 10) return -(1 + line_start);  // u64 overflow
                code = code * 10 + d;
            }
        }
        codes[n] = code;
        if (has_taxid) {
            if (t >= b) return -(1 + line_start);
            int64_t ta = t + 1, tb = b;
            while (ta < tb && is_ws(text[ta])) ta++;
            // the taxid column may itself be followed by further columns
            int64_t te = ta;
            uint64_t tax = 0;
            if (te >= tb) return -(1 + line_start);
            while (te < tb && text[te] != '\t') te++;
            while (te > ta && is_ws(text[te - 1])) te--;
            if (te == ta) return -(1 + line_start);
            for (int64_t j = ta; j < te; j++) {
                if (text[j] < '0' || text[j] > '9') return -(1 + line_start);
                tax = tax * 10 + (uint64_t)(text[j] - '0');
                if (tax > 0xFFFFFFFFULL) return -(1 + line_start);
            }
            taxids[n] = (uint32_t)tax;
        }
        n++;
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Host count engine: rolling 2-bit window encode over a packed base
// buffer (0..3 valid, >=4 separator/invalid resets the window), the
// same window semantics as the device pipeline (models/count
// window_codes; reference sketches NewKmerIterator, count.go:314-367).
// Canonical = min(code, revcomp), both maintained incrementally.
// Two passes so threads write disjoint exact output slots:
//   pass 1: count emit positions per chunk (validity runs only)
//   pass 2: emit codes.
// ---------------------------------------------------------------------

namespace {

// Emit positions in [lo, hi): i with >= k consecutive valid bases
// ending at i.  Seeds the run/codes by scanning back k-1 bases.
template <typename F>
static inline void walk_windows(const uint8_t* bases, int64_t lo, int64_t hi,
                                int k, F&& emit) {
    int64_t start = lo - (k - 1);
    if (start < 0) start = 0;
    uint64_t code = 0, rc = 0;
    int run = 0;
    const int rc_shift = 2 * (k - 1);
    for (int64_t i = start; i < hi; i++) {
        uint8_t b = bases[i];
        if (b > 3) {
            run = 0;
            continue;
        }
        code = (code << 2) | b;
        rc = (rc >> 2) | ((uint64_t)(3 - b) << rc_shift);
        if (run < k) run++;
        if (run >= k && i >= lo) emit(i, code, rc);
    }
}

}  // namespace

extern "C" {

// out must hold up to (n) uint64 (exact count returned).  threads<=0
// picks the hardware count.  k in [1, 32].
int64_t encode_windows_u64(const uint8_t* bases, int64_t n, int32_t k,
                           int32_t canonical, uint64_t* out,
                           int32_t threads) {
    if (k < 1 || k > 32 || n <= 0) return 0;
    const uint64_t mask =
        (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    int t = threads > 0 ? threads
                        : (int)std::thread::hardware_concurrency();
    if (t < 1) t = 1;
    if ((int64_t)t > n / (1 << 16) + 1) t = (int)(n / (1 << 16) + 1);
    std::vector<int64_t> lo(t + 1);
    for (int i = 0; i <= t; i++) lo[i] = n * i / t;
    std::vector<int64_t> counts(t, 0);

    auto count_chunk = [&](int ci) {
        int64_t c = 0;
        walk_windows(bases, lo[ci], lo[ci + 1], k,
                     [&](int64_t, uint64_t, uint64_t) { c++; });
        counts[ci] = c;
    };
    auto run_pool = [&](auto&& fn) {
        if (t == 1) {
            fn(0);
            return;
        }
        std::vector<std::thread> pool;
        pool.reserve(t);
        for (int i = 0; i < t; i++) pool.emplace_back(fn, i);
        for (auto& th : pool) th.join();
    };
    run_pool(count_chunk);

    std::vector<int64_t> offs(t + 1, 0);
    for (int i = 0; i < t; i++) offs[i + 1] = offs[i] + counts[i];

    auto emit_chunk = [&](int ci) {
        uint64_t* p = out + offs[ci];
        if (canonical) {
            walk_windows(bases, lo[ci], lo[ci + 1], k,
                         [&](int64_t, uint64_t code, uint64_t rc) {
                             uint64_t f = code & mask;
                             *p++ = f < rc ? f : rc;
                         });
        } else {
            walk_windows(bases, lo[ci], lo[ci + 1], k,
                         [&](int64_t, uint64_t code, uint64_t) {
                             *p++ = code & mask;
                         });
        }
    };
    run_pool(emit_chunk);
    return offs[t];
}

}  // extern "C"

// ---------------------------------------------------------------------
// ntHash v1 window hashes (reference: will-rowe/nthash v0.4.0 via
// unikmer/cmd call sites; same contract as ops/nthash.py):
//   NTF64 = XOR_j rol64(seedF[s_j], k-1-j)
//   NTR64 = XOR_j rol64(seedR[s_j], j)       (seedR = complement seeds)
//   canonical = min(NTF, NTR); k <= 64.
// Window validity semantics identical to encode_windows_u64 (invalid
// base resets the run; only all-valid windows emit) — the behavior the
// scaled-MinHash fixture pins for hashed counts.
// ---------------------------------------------------------------------

namespace {

static const uint64_t kSeedF[5] = {
    0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL, 0x20323ED082572324ULL,
    0x295549F54BE24456ULL, 0ULL};
static const uint64_t kSeedR[5] = {  // complement: A<->T, C<->G
    0x295549F54BE24456ULL, 0x20323ED082572324ULL, 0x3193C18562A02B4CULL,
    0x3C8BFBB395C60474ULL, 0ULL};

// The scaled-MinHash threshold (count.go:98 semantics), as
// ops/nthash.scaled_max_hash computes it.
static inline uint64_t scaled_max_hash_u64(uint32_t scale) {
    return scale > 1 ? (uint64_t)((double)(~0ULL) / (double)scale) : ~0ULL;
}

static inline uint64_t rol64(uint64_t x, int s) {
    s &= 63;
    return s ? (x << s) | (x >> (64 - s)) : x;
}

// Emit (i, ntf, ntr) for each all-valid window ending at i in [lo, hi).
template <typename F>
static inline void walk_nthash(const uint8_t* bases, int64_t lo, int64_t hi,
                               int k, F&& emit) {
    int64_t start = lo - (k - 1);
    if (start < 0) start = 0;
    uint64_t f = 0, r = 0;
    int run = 0;
    for (int64_t i = start; i < hi; i++) {
        uint8_t b = bases[i];
        if (b > 3) {
            run = 0;
            continue;
        }
        if (run >= k) {
            // rolling update: drop bases[i-k], admit b
            uint8_t out = bases[i - k];
            f = rol64(f, 1) ^ rol64(kSeedF[out], k) ^ kSeedF[b];
            r = (rol64(r ^ kSeedR[out], 63)) ^ rol64(kSeedR[b], k - 1);
        } else if (++run == k) {
            // first complete window after a reset: from scratch
            f = r = 0;
            for (int j = 0; j < k; j++) {
                uint8_t c = bases[i - k + 1 + j];
                f ^= rol64(kSeedF[c], k - 1 - j);
                r ^= rol64(kSeedR[c], j);
            }
        }
        if (run >= k && i >= lo) emit(i, f, r);
    }
}

}  // namespace

extern "C" {

// out must hold up to n uint64; returns the emit count.  scale>1 keeps
// only hashes <= scaled_max_hash_u64(scale) (FracMinHash threshold,
// count.go:89-98).  k in [1, 64].
int64_t nthash_windows_u64(const uint8_t* bases, int64_t n, int32_t k,
                           int32_t canonical, uint32_t scale, uint64_t* out,
                           int32_t threads) {
    if (k < 1 || k > 64 || n <= 0) return 0;
    // Go computes uint64(float64(^uint64(0)) / float64(scale))
    // (count.go:98): float64(2^64-1) rounds to 2^64 exactly, so the
    // double-math threshold differs from integer division by up to a
    // few hundred (scale=7: 146).  The device (ops/nthash.scaled_max_hash)
    // and this kernel share the float64 rule.
    const uint64_t max_hash = scaled_max_hash_u64(scale);
    int t = threads > 0 ? threads
                        : (int)std::thread::hardware_concurrency();
    if (t < 1) t = 1;
    if ((int64_t)t > n / (1 << 16) + 1) t = (int)(n / (1 << 16) + 1);
    std::vector<int64_t> lo(t + 1);
    for (int i = 0; i <= t; i++) lo[i] = n * i / t;
    std::vector<int64_t> counts(t, 0);
    std::vector<std::vector<uint64_t>> parts(t);

    auto run_pool = [&](auto&& fn) {
        if (t == 1) {
            fn(0);
            return;
        }
        std::vector<std::thread> pool;
        pool.reserve(t);
        for (int i = 0; i < t; i++) pool.emplace_back(fn, i);
        for (auto& th : pool) th.join();
    };
    // hashes are filtered by value (scaled), so per-chunk counts are
    // value-dependent: emit into per-thread buffers, then concatenate
    auto emit_chunk = [&](int ci) {
        auto& buf = parts[ci];
        buf.reserve((lo[ci + 1] - lo[ci]) / (scale > 1 ? scale : 1) + 16);
        if (canonical) {
            walk_nthash(bases, lo[ci], lo[ci + 1], k,
                        [&](int64_t, uint64_t f, uint64_t r) {
                            uint64_t h = f < r ? f : r;
                            if (h <= max_hash) buf.push_back(h);
                        });
        } else {
            walk_nthash(bases, lo[ci], lo[ci + 1], k,
                        [&](int64_t, uint64_t f, uint64_t) {
                            if (f <= max_hash) buf.push_back(f);
                        });
        }
    };
    run_pool(emit_chunk);
    uint64_t* p = out;
    for (int i = 0; i < t; i++) {
        std::memcpy(p, parts[i].data(), parts[i].size() * sizeof(uint64_t));
        p += parts[i].size();
    }
    return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Sketch emission streams — host twins of ops/sketch.py (same contract:
// sketches force hashed+canonical; invalid windows keyed to U64_MAX;
// leftmost argmin ties; minimizer emits on selected-POSITION change
// per run of fully-valid window groups; closed syncmer emits the k-mer
// hash where the min s-mer sits at offset 0 or k-s).
// Monotonic-deque sliding min replaces the device's doubling argmin.
// ---------------------------------------------------------------------

namespace {

// keyed[i] = canonical ntHash of window [i, i+k) or U64MAX when any
// base in it is invalid; valid[i] likewise.  i in [0, n-k+1).
static void nthash_keyed(const uint8_t* bases, int64_t n, int k,
                         uint64_t* keyed, uint8_t* valid) {
    const int64_t n_pos = n - k + 1;
    for (int64_t i = 0; i < n_pos; i++) {
        keyed[i] = ~0ULL;
        valid[i] = 0;
    }
    walk_nthash(bases, 0, n, k, [&](int64_t i, uint64_t f, uint64_t r) {
        int64_t p = i - k + 1;
        keyed[p] = f < r ? f : r;
        valid[p] = 1;
    });
}

struct MinDeque {
    std::vector<std::pair<uint64_t, int64_t>> q;  // (value, index)
    size_t head = 0;

    void push(uint64_t v, int64_t i) {
        // strict >: equal values keep the EARLIER index (leftmost tie)
        while (q.size() > head && q.back().first > v) q.pop_back();
        q.emplace_back(v, i);
    }
    void drop_before(int64_t lo) {
        while (q.size() > head && q[head].second < lo) head++;
    }
    uint64_t min_value() const { return q[head].first; }
    int64_t min_index() const { return q[head].second; }
};

}  // namespace

extern "C" {

// out must hold up to n uint64; returns emit count (the linear
// minimizer stream; callers sort/dedup for count semantics).
int64_t minimizer_emit_u64(const uint8_t* bases, int64_t n, int32_t k,
                           int32_t w, uint64_t* out) {
    if (k < 1 || k > 64 || w < 1 || n < k) return 0;
    const int64_t n_pos = n - k + 1;
    std::vector<uint64_t> keyed(n_pos);
    std::vector<uint8_t> valid(n_pos);
    nthash_keyed(bases, n, k, keyed.data(), valid.data());
    if (n_pos < w) return 0;
    MinDeque dq;
    int64_t run = 0;  // consecutive valid k-positions ending at j
    uint64_t* p = out;
    bool prev_group_valid = false;
    int64_t prev_arg = -1;
    for (int64_t j = 0; j < n_pos; j++) {
        dq.push(keyed[j], j);
        run = valid[j] ? run + 1 : 0;
        int64_t i = j - w + 1;  // window group [i, j]
        if (i < 0) continue;
        dq.drop_before(i);
        bool gvalid = run >= w;
        if (gvalid && (!prev_group_valid || dq.min_index() != prev_arg)) {
            *p++ = dq.min_value();
        }
        prev_group_valid = gvalid;
        prev_arg = dq.min_index();
    }
    return p - out;
}

// Closed syncmer: emit the canonical k-mer hash at every valid
// k-position whose minimal s-mer (leftmost tie) sits at offset 0 or
// k-s.  out must hold up to n uint64.
int64_t syncmer_emit_u64(const uint8_t* bases, int64_t n, int32_t k,
                         int32_t s, uint64_t* out) {
    if (k < 1 || k > 64 || s < 1 || s > k || n < k) return 0;
    const int64_t nk = n - k + 1;
    const int64_t ns = n - s + 1;
    std::vector<uint64_t> khash(nk);
    std::vector<uint8_t> kvalid(nk);
    nthash_keyed(bases, n, k, khash.data(), kvalid.data());
    std::vector<uint64_t> shash(ns);
    std::vector<uint8_t> svalid(ns);
    nthash_keyed(bases, n, s, shash.data(), svalid.data());
    const int w = k - s + 1;  // s-mers per k-mer
    MinDeque dq;
    uint64_t* p = out;
    for (int64_t j = 0; j < ns; j++) {
        dq.push(shash[j], j);
        int64_t i = j - w + 1;  // k-position
        if (i < 0 || i >= nk) continue;
        dq.drop_before(i);
        if (!kvalid[i]) continue;
        int64_t off = dq.min_index() - i;
        if (off == 0 || off == (int64_t)(k - s)) *p++ = khash[i];
    }
    return p - out;
}

// "Compat" closed syncmer: the forensic reconstruction of the
// reference's actual behavior (docs/DIVERGENCES.md §2; scripts/
// exp_syncmer_rules.py).  Select every k-position that is the leftmost
// argmin of ANY sliding window of W = 2(k-s) s-mer hashes (tail
// windows partial), then force an emission every T = k-s positions
// between consecutive base selections (and backwards from the first
// one) — reproducing the reference's gap histogram (flat interior,
// 166k spike at 15, zero gaps > 15) and 447,951 distinct k-mers on
// MG1655 k=31 s=16 vs the published 446,227 (+0.39%).
int64_t syncmer_compat_emit_u64(const uint8_t* bases, int64_t n,
                                int32_t k, int32_t s, uint64_t* out) {
    if (k < 1 || k > 64 || s < 1 || s > k || n < k) return 0;
    const int64_t nk = n - k + 1;
    const int64_t ns = n - s + 1;
    std::vector<uint64_t> khash(nk);
    std::vector<uint8_t> kvalid(nk);
    nthash_keyed(bases, n, k, khash.data(), kvalid.data());
    uint64_t* p = out;
    if (s == k) {  // degenerate: every valid k-mer is a closed syncmer
        for (int64_t i = 0; i < nk; i++)
            if (kvalid[i]) *p++ = khash[i];
        return p - out;
    }
    std::vector<uint64_t> shash(ns);
    std::vector<uint8_t> svalid(ns);
    nthash_keyed(bases, n, s, shash.data(), svalid.data());
    for (int64_t j = 0; j < ns; j++)
        if (!svalid[j]) shash[j] = ~0ULL;
    const int64_t W = 2 * (int64_t)(k - s);
    const int64_t T = k - s;
    // base set: leftmost argmin of every window [t, min(t+W, ns))
    std::vector<uint8_t> mark(nk, 0);
    MinDeque dq;
    int64_t pushed = 0;
    for (int64_t t = 0; t < ns; t++) {
        int64_t r = t + W - 1 < ns - 1 ? t + W - 1 : ns - 1;
        while (pushed <= r) {
            dq.push(shash[pushed], pushed);
            pushed++;
        }
        dq.drop_before(t);
        int64_t m = dq.min_index();
        if (dq.min_value() != ~0ULL && m < nk && kvalid[m]) mark[m] = 1;
    }
    int64_t b_first = -1, b_last = -1;
    for (int64_t i = 0; i < nk; i++)
        if (mark[i]) {
            if (b_first < 0) b_first = i;
            b_last = i;
        }
    if (b_first < 0) return 0;
    // head fills: b_first - m*T for m = 1..(b_first-1)/T, ascending
    for (int64_t q = b_first - T * ((b_first - 1) / T); q < b_first;
         q += T)
        if (kvalid[q]) *p++ = khash[q];
    // base emissions + interior fills every T since the last base
    int64_t last_base = -1;
    for (int64_t i = b_first; i < nk; i++) {
        if (mark[i]) {
            *p++ = khash[i];
            last_base = i;
        } else if (i < b_last && (i - last_base) % T == 0 && kvalid[i]) {
            *p++ = khash[i];
        }
    }
    return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------------
// UK-indexed gzip members (io/pgzip.py): every member the writer makes
// carries a BGZF-style FEXTRA subfield ('U', 'K', u32 = the member's
// compressed length), so a reader splits the stream without inflating
// and inflates the members concurrently; stock gzip readers skip FEXTRA
// (RFC 1952).  The port's copy of the JAX package's reader and writer
// (unikmer_tpu/native/unikit_native.cpp pgz_*), with zlib in place of
// libdeflate: members inflate through zlib's gzip wrapper, which checks
// each member's CRC-32 and ISIZE, and deflate as Python's zlib route of
// io/pgzip._compress_member does, byte for byte.  Without zlib every
// entry point fails (-1) and the callers take the Python route.
// ---------------------------------------------------------------------

namespace {

// Member length from the 'UK' FEXTRA subfield of the member at `off`; 0
// when it has no such subfield, -1 on a malformed or truncated header.
int64_t uk_member_len(const uint8_t* in, size_t n, size_t off) {
    if (off + 20 > n) return -1;
    const uint8_t* p = in + off;
    if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8) return -1;
    if (!(p[3] & 4)) return 0;  // no FEXTRA
    size_t e = off + 10;
    const uint16_t xlen = (uint16_t)in[e] | ((uint16_t)in[e + 1] << 8);
    e += 2;
    const size_t end = e + xlen;
    if (end > n) return -1;
    while (e + 4 <= end) {
        const uint8_t si1 = in[e], si2 = in[e + 1];
        const uint16_t slen =
            (uint16_t)in[e + 2] | ((uint16_t)in[e + 3] << 8);
        if (e + 4 + slen > end) return -1;
        if (si1 == 'U' && si2 == 'K' && slen == 4) {
            uint32_t v;
            std::memcpy(&v, in + e + 4, 4);
            return (int64_t)v;
        }
        e += 4 + slen;
    }
    return 0;
}

// (offset, member length, inflated offset) of every member; returns the
// total inflated size, or -1 unless EVERY member carries the index and
// lies whole inside the buffer.
int64_t uk_scan(const uint8_t* in, int64_t n, std::vector<size_t>* offs,
                std::vector<size_t>* mlens, std::vector<size_t>* oouts) {
    size_t off = 0;
    int64_t total = 0;
    while ((int64_t)off < n) {
        const int64_t mlen = uk_member_len(in, (size_t)n, off);
        if (mlen < 28 || (int64_t)(off + (size_t)mlen) > n) return -1;
        uint32_t isize;
        std::memcpy(&isize, in + off + (size_t)mlen - 4, 4);
        if (offs) {
            offs->push_back(off);
            mlens->push_back((size_t)mlen);
            oouts->push_back((size_t)total);
        }
        total += isize;
        off += (size_t)mlen;
    }
    return total;
}

#ifdef UKT_HAVE_ZLIB
// One whole member through zlib's gzip wrapper into exactly `want` bytes.
bool inflate_member(const uint8_t* in, size_t mlen, uint8_t* out,
                    size_t want) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
    zs.next_in = const_cast<Bytef*>(in);
    zs.avail_in = (uInt)mlen;
    zs.next_out = out;
    zs.avail_out = (uInt)want;
    uint8_t spare;
    int rc = inflate(&zs, Z_FINISH);
    if (rc == Z_BUF_ERROR && zs.avail_out == 0) {
        // the member holds more than its ISIZE said: fail on one more byte
        zs.next_out = &spare;
        zs.avail_out = 1;
        rc = inflate(&zs, Z_FINISH);
        if (rc == Z_STREAM_END && zs.avail_out == 0) rc = Z_DATA_ERROR;
    }
    const bool ok = rc == Z_STREAM_END && zs.total_out == want &&
                    zs.avail_in == 0;
    inflateEnd(&zs);
    return ok;
}
#endif

}  // namespace

extern "C" {

// Total inflated size of a fully UK-indexed buffer, or -1 when any member
// lacks the index (the caller inflates the buffer sequentially).
int64_t pgz_indexed_isize(const uint8_t* in, int64_t n) {
    return uk_scan(in, n, nullptr, nullptr, nullptr);
}

// One UK-indexed gzip member of data[n] at zlib `level` into out[out_cap]:
// the 20-byte header (XFL 2 at level >= 9, 4 at level 1, else 0; OS 255),
// a raw deflate stream (window 15, memLevel 8, the default strategy; all
// the input, then a finish) and the CRC-32 and ISIZE trailer.  Returns
// the member's size, or -1 on failure, a small out_cap or no zlib.
// Level 0 is refused: its stored blocks are cut where the caller's output
// buffer fills, so only Python's own buffer steps give Python's bytes.
int64_t pgz_compress_member(const uint8_t* data, int64_t n, int32_t level,
                            uint8_t* out, int64_t out_cap) {
#ifndef UKT_HAVE_ZLIB
    (void)data; (void)n; (void)level; (void)out; (void)out_cap;
    return -1;
#else
    if (n < 0 || n > (int64_t)0xFFFFFFFFu || level == 0 || level < -1 ||
        level > 9)
        return -1;
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -MAX_WBITS, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return -1;
    const uLong bound = deflateBound(&zs, (uLong)n);
    if (out_cap < (int64_t)(28 + bound)) {
        deflateEnd(&zs);
        return -1;
    }
    zs.next_in = const_cast<Bytef*>(data);
    zs.avail_in = (uInt)n;
    zs.next_out = out + 20;
    zs.avail_out = (uInt)bound;
    int rc = deflate(&zs, Z_NO_FLUSH);
    if (rc == Z_OK || rc == Z_BUF_ERROR) rc = deflate(&zs, Z_FINISH);
    const size_t body = zs.total_out;
    deflateEnd(&zs);
    if (rc != Z_STREAM_END) return -1;
    const uint32_t mlen = (uint32_t)(28 + body);
    const uint8_t xfl = level >= 9 ? 2 : (level == 1 ? 4 : 0);
    const uint8_t hdr[10] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, xfl, 255};
    std::memcpy(out, hdr, 10);
    out[10] = 8;  out[11] = 0;  // XLEN
    out[12] = 'U'; out[13] = 'K'; out[14] = 4; out[15] = 0;
    std::memcpy(out + 16, &mlen, 4);
    const uint32_t crc = (uint32_t)crc32(0L, data, (uInt)n);
    std::memcpy(out + 20 + body, &crc, 4);
    const uint32_t isz = (uint32_t)((uint64_t)n & 0xFFFFFFFFu);
    std::memcpy(out + 24 + body, &isz, 4);
    return (int64_t)mlen;
#endif
}

// The members of a UK-indexed buffer inflated on `threads` threads into
// out[out_cap].  Returns the bytes written, or -1 (a member without the
// index, one that fails its CRC-32 or ISIZE, a small out_cap, no zlib).
int64_t pgz_inflate_parallel(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t out_cap, int32_t threads) {
#ifndef UKT_HAVE_ZLIB
    (void)in; (void)n; (void)out; (void)out_cap; (void)threads;
    return -1;
#else
    std::vector<size_t> offs, mlens, oouts;
    const int64_t total = uk_scan(in, n, &offs, &mlens, &oouts);
    if (total < 0 || total > out_cap) return -1;
    std::atomic<size_t> next(0);
    std::atomic<bool> failed(false);
    auto work = [&]() {
        for (;;) {
            const size_t i = next.fetch_add(1);
            if (i >= offs.size() || failed.load(std::memory_order_relaxed))
                break;
            const size_t want =
                (i + 1 < oouts.size() ? oouts[i + 1] : (size_t)total) -
                oouts[i];
            if (!inflate_member(in + offs[i], mlens[i], out + oouts[i], want))
                failed = true;
        }
    };
    int nt = threads < 1 ? 1 : threads;
    if ((size_t)nt > offs.size()) nt = (int)offs.size();
    if (nt <= 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < nt; t++) pool.emplace_back(work);
        for (auto& t : pool) t.join();
    }
    return failed.load() ? -1 : total;
#endif
}

}  // extern "C"
