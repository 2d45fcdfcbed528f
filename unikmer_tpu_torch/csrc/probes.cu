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
//                   HBM at all; here each thread moves kIncVecs 16-byte
//                   uint4 straight from device memory, all its loads issued
//                   before its first store, and the grid covers the array in
//                   one round (2,048 blocks for the probe's 2^21 uint4), so
//                   no thread idles in a ragged last round of a grid-stride
//                   loop.  The data is touched once, so loads and stores are
//                   streaming (__ldcs / __stcs, evict-first): 3-4% faster than
//                   default-cached ones with L2 warm and level with them with
//                   L2 flushed; ld.global.nc.L1::no_allocate.L2::256B loads
//                   were slower (chip_smoke.py's VARIANTS time these).
// row_cmpex_u32     replaces probe2 (exp_pallas_dma.py:101, call :118) and
//                   cmpex_rows_kernel (exp_pallas_dma2.py:96, call :123):
//                   compare-exchange stages at row distances d on an (R, C)
//                   array; rows (g*2d + i, g*2d + i + d) for i < d take
//                   (min, max), and a row whose partner would lie past R
//                   (ragged R) keeps its value.  Columns never mix, and a
//                   stage at d = 2^b pairs rows that differ in bit b only,
//                   so a run of such stages touches only the rows that its
//                   bits link.  The host splits the stages into launches of
//                   three routes, any R:
//                   - registers: a run whose distances are powers of two
//                     of at most kRegBits distinct bits.  A thread holds
//                     the 2^b rows that the run's b bits link, 16 bytes of
//                     columns each where C % 4 == 0, applies the whole run
//                     with no barrier and writes them back; neighbouring
//                     threads take neighbouring column groups, so every
//                     access moves whole rows a warp.  P1b's 64 stages at
//                     d = 2048 are one launch: two uint4 in, 64
//                     compare-exchanges, two uint4 out.
//                   - tile: a longer power-of-two run (P2a's cycle d =
//                     2048 .. 1).  A block holds the 2^bits rows that the
//                     run's bits link in shared memory (64 KB): a column
//                     group of 16 bytes a row, at most kVecTileBits bits,
//                     where C % 4 == 0, else one column, at most kTileBits
//                     bits.  Each thread holds kRegBits of the bits in
//                     registers at a time (a phase), so a barrier comes
//                     only where the register mapping changes.  The tile's
//                     slots are swizzled so that the phases of a bitonic
//                     cycle hit every bank once a warp (a quarter-warp for
//                     16-byte slots).
//                   - pass: any other stage (d not a power of two), one pass
//                     over device memory, 16 bytes a thread where C % 4 ==
//                     0; consecutive stages at one distance fuse into it.
//                   The host hands each launch its row bits' positions and
//                   its stages as runs (a bit, a repeat count), so a thread
//                   finds its rows by inserting zero bits and applies a run
//                   with one dispatch; a descending sweep over a thread's
//                   bits (a bitonic merge's) is unrolled.  Rows past R
//                   hold 0xffffffff, so no compare-exchange needs a branch.
//                   A tile's global loads and stores move one piece of each
//                   row (4 or 16 bytes, a 32-byte sector either way): a
//                   block that links all of R's rows reads each row
//                   alone.  A column group moves 4x the bytes a sector
//                   but leaves a quarter of the blocks, each with 4x the
//                   compare-exchanges: on the H100 it is level with one
//                   column a block at the probes' 4,096 rows and several
//                   times faster at 2^16 rows.  The phase-0 load stays a
//                   select: as an if/else it compiles to more branches
//                   and runs slower (PERF.md section 6, P1b's row,
//                   holds the numbers).  (The TPU kept
//                   the whole block in VMEM; here no block can hold it.)
// transpose128_u32  replaces probe3 (exp_pallas_dma.py:130, call :138): each
//                   (128, 128) tile is transposed.  A block takes one
//                   kSub x kSub sub-tile (a 1-D grid with an int64 tile
//                   index, so any number of tiles is taken): each thread
//                   loads 4 x 4 squares as four 16-byte rows, transposes
//                   them in registers and stores the four transposed rows
//                   into shared memory as 16-byte words; after one barrier
//                   the block copies the staged rows out, 16 bytes a thread.
//                   Both global phases move whole 256-byte row segments a
//                   half-warp.  The staged uint4 of row r, column group g,
//                   sits at slot g ^ ((r >> 2) & 7) of its row, so the eight
//                   threads that one 16-byte shared access serves at a time
//                   hit eight different groups of four banks in both phases.
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

__device__ __forceinline__ uint32_t umin32(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t umax32(uint32_t a, uint32_t b) {
  return a < b ? b : a;
}

constexpr int kIncVecs = 4;  // uint4 (or u32) a thread
constexpr int64_t kIncBlockItems = static_cast<int64_t>(kThreads) * kIncVecs;

__device__ __forceinline__ uint4 inc4(uint4 v) {
  v.x += 1u;
  v.y += 1u;
  v.z += 1u;
  v.w += 1u;
  return v;
}

// Block b moves items b * kIncBlockItems + threadIdx.x + u * kThreads,
// u < kIncVecs: uint4 when `vec` (then block 0 also moves the last n % 4
// values), else single u32.
__global__ void __launch_bounds__(kThreads)
copy_inc_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int64_t n, int vec) {
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kIncBlockItems + threadIdx.x;
  if (vec) {
    const int64_t n4 = n >> 2;
    const uint4* __restrict__ in4 = reinterpret_cast<const uint4*>(in);
    uint4* __restrict__ out4 = reinterpret_cast<uint4*>(out);
    uint4 v[kIncVecs];
#pragma unroll
    for (int u = 0; u < kIncVecs; ++u) {
      const int64_t i = first + u * kThreads;
      v[u] = i < n4 ? __ldcs(in4 + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kIncVecs; ++u) {
      const int64_t i = first + u * kThreads;
      if (i < n4) __stcs(out4 + i, inc4(v[u]));
    }
    const int64_t head = n4 << 2;
    if (blockIdx.x == 0 && threadIdx.x < n - head) {
      out[head + threadIdx.x] = in[head + threadIdx.x] + 1u;
    }
  } else {
    uint32_t v[kIncVecs];
#pragma unroll
    for (int u = 0; u < kIncVecs; ++u) {
      const int64_t i = first + u * kThreads;
      v[u] = i < n ? __ldcs(in + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kIncVecs; ++u) {
      const int64_t i = first + u * kThreads;
      if (i < n) __stcs(out + i, v[u] + 1u);
    }
  }
}

// ---- row_cmpex_u32 ----

constexpr int kRegBits = 4;      // a thread holds up to 2^kRegBits rows
constexpr int kTileBits = 14;    // a one-column tile holds up to 2^14 rows
constexpr int kVecTileBits = 12;  // a column-group tile holds up to 2^12 rows
constexpr int kTileBytes = 4 << kTileBits;  // 64 KB either way
constexpr int kMaxStages = 256;  // stages a launch
constexpr int kRowThreads = 256;  // threads a block of the register and pass routes
static_assert(kRegBits == 4, "the cases of stages_at");
static_assert(16 << kVecTileBits == kTileBytes, "both tiles take 64 KB");

// Tile bits of a tile whose rows hold one T.
template <typename T>
constexpr int tile_bits_of() {
  return sizeof(T) == 16 ? kVecTileBits : kTileBits;
}

// x with a zero bit inserted at bit b (the bits from b up move up one).
__device__ __forceinline__ uint64_t insert_zero(uint64_t x, int b) {
  return ((x >> b) << (b + 1)) | (x & ((1ull << b) - 1));
}

__device__ __forceinline__ void cmpex(uint32_t& a, uint32_t& b) {
  const uint32_t lo = umin32(a, b);
  b = umax32(a, b);
  a = lo;
}

__device__ __forceinline__ void cmpex(uint4& a, uint4& b) {
  cmpex(a.x, b.x);
  cmpex(a.y, b.y);
  cmpex(a.z, b.z);
  cmpex(a.w, b.w);
}

// A row past R holds 0xffffffff in registers and shared memory: as the
// bottom of a pair it leaves the top row as it is, and its own top row is
// past R too, so it stays 0xffffffff and no stage needs a branch; it is
// never stored.
__device__ __forceinline__ void absent(uint32_t& x) { x = ~0u; }
__device__ __forceinline__ void absent(uint4& x) { x = make_uint4(~0u, ~0u, ~0u, ~0u); }
template <typename T>
__device__ __forceinline__ T absent_row() {
  T x;
  absent(x);
  return x;
}

// One stage on a thread's rows v[u], u < 2^PB: u and u | 2^Q (bit Q of u
// clear) are the pair.
template <int Q, int PB, typename T>
__device__ __forceinline__ void cmpex_bit(T (&v)[1 << PB]) {
#pragma unroll
  for (int u = 0; u < (1 << PB); ++u) {
    if (!(u & (1 << Q))) cmpex(v[u], v[u | (1 << Q)]);
  }
}

// `reps` stages on the bit at position q of the thread's rows.
template <int PB, typename T>
__device__ __forceinline__ void stages_at(T (&v)[1 << PB], int q, int reps) {
  switch (q) {
    case 0:
      for (int i = 0; i < reps; ++i) cmpex_bit<0, PB>(v);
      break;
    case 1:
      if constexpr (PB > 1) {
        for (int i = 0; i < reps; ++i) cmpex_bit<1, PB>(v);
      }
      break;
    case 2:
      if constexpr (PB > 2) {
        for (int i = 0; i < reps; ++i) cmpex_bit<2, PB>(v);
      }
      break;
    default:
      if constexpr (PB > 3) {
        for (int i = 0; i < reps; ++i) cmpex_bit<3, PB>(v);
      }
      break;
  }
}

// One stage on each held bit, the highest first: a bitonic merge's sweep,
// unrolled (a dispatch a stage costs as much as the stages here).
template <int PB, typename T>
__device__ __forceinline__ void sweep(T (&v)[1 << PB]) {
  if constexpr (PB > 3) cmpex_bit<3, PB>(v);
  if constexpr (PB > 2) cmpex_bit<2, PB>(v);
  if constexpr (PB > 1) cmpex_bit<1, PB>(v);
  cmpex_bit<0, PB>(v);
}

// Stages as runs: run r is reps[r] stages on the bit at position q[r].
struct Runs {
  uint8_t q[kMaxStages];
  uint16_t reps[kMaxStages];
};

// Runs first .. last on a thread's rows; `is_sweep` when they are one
// stage on each held bit, the highest first.
template <int PB, typename T>
__device__ __forceinline__ void apply_runs(T (&v)[1 << PB], const Runs& runs,
                                           int first, int last, bool is_sweep) {
  if (is_sweep) {
    sweep<PB>(v);
  } else {
    for (int r = first; r < last; ++r) stages_at<PB>(v, runs.q[r], runs.reps[r]);
  }
}

// Row u of a thread whose other bits are `base`; bit q of u is `bit[q]`.
template <int PB, typename I>
__device__ __forceinline__ I row_of(I base, const I (&bit)[PB], int u) {
#pragma unroll
  for (int q = 0; q < PB; ++q) {
    if ((u >> q) & 1) base |= bit[q];
  }
  return base;
}

struct RegRun {  // a run of stages on the rows of PB row bits
  uint8_t ubit[kRegBits];  // the row bits, ascending
  int nruns;
  int sweep;  // the runs are one sweep (see apply_runs)
  Runs runs;
};

// The register route.  Thread id holds column group id % groups of the
// 2^PB rows whose other bits are id / groups (zeros inserted at ubit).
template <int PB, typename T>
__global__ void __launch_bounds__(kRowThreads)
row_cmpex_regs_kernel(const uint32_t* in, uint32_t* out, int64_t rows,
                      int64_t cols, int64_t threads, RegRun run) {
  constexpr int kV = sizeof(T) / 4;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= threads) return;
  const int64_t groups = cols / kV;
  const int64_t col = (id % groups) * kV;
  uint64_t base = static_cast<uint64_t>(id / groups);
  uint64_t bit[PB];
#pragma unroll
  for (int q = 0; q < PB; ++q) {
    base = insert_zero(base, run.ubit[q]);
    bit[q] = 1ull << run.ubit[q];
  }
  T v[1 << PB];
  uint32_t present = 0;
#pragma unroll
  for (int u = 0; u < (1 << PB); ++u) {
    const uint64_t r = row_of<PB>(base, bit, u);
    if (r < static_cast<uint64_t>(rows)) {
      present |= 1u << u;
      v[u] = *reinterpret_cast<const T*>(in + r * cols + col);
    } else {
      absent(v[u]);
    }
  }
  apply_runs<PB>(v, run.runs, 0, run.nruns, run.sweep);
#pragma unroll
  for (int u = 0; u < (1 << PB); ++u) {
    if ((present >> u) & 1) {
      *reinterpret_cast<T*>(out + row_of<PB>(base, bit, u) * cols + col) = v[u];
    }
  }
}

struct TileRun {  // a run of stages on the rows of tbits row bits
  uint8_t ubit[kTileBits];  // tile bit i is row bit ubit[i], ascending
  int tbits;
  int nphases;
  uint8_t ppos[kMaxStages][kRegBits];  // phase p's tile bits, ascending
  uint16_t first[kMaxStages + 1];  // phase p: runs first[p] .. first[p+1]
  uint8_t sweep[kMaxStages];  // phase p's runs are one sweep
  Runs runs;
};

// Shared-memory slot of tile row t, so that every phase of a bitonic cycle
// (bits 0-3, 4-7, 8-11) hits each bank once.  u32 slots: within each 32
// rows the slot is t's low five bits xor bits 5-9 and xor bit 8 into bit
// 4 (a warp on 32 banks).  uint4 slots: t's low three bits xor bits 4-6
// (each quarter-warp, which one 16-byte access serves at a time, on the
// 8 groups of four banks).
template <typename T>
__device__ __forceinline__ uint32_t tile_slot(uint32_t t) {
  if constexpr (sizeof(T) == 16) {
    return t ^ ((t >> 4) & 7);
  } else {
    return t ^ (((t >> 5) & 31) ^ ((t >> 4) & 16));
  }
}

// The dynamic shared memory of a tile, declared with its element type.
template <typename T>
struct TileMemory;
template <>
struct TileMemory<uint32_t> {
  __device__ static uint32_t* get() {
    extern __shared__ uint32_t tile_u32[];
    return tile_u32;
  }
};
template <>
struct TileMemory<uint4> {
  __device__ static uint4* get() {
    extern __shared__ uint4 tile_u4[];
    return tile_u4;
  }
};

// The tile route.  Block b holds column group b % groups (one T of each
// row) of the rows whose other bits are b / groups (zeros inserted at
// ubit); in phase p thread tau holds the 2^4 tile rows whose bits ppos[p]
// run over u and whose other tile bits are tau (zeros inserted at
// ppos[p]).
template <typename T>
__global__ void __launch_bounds__(1 << (tile_bits_of<T>() - kRegBits))
row_cmpex_tile_kernel(const uint32_t* in, uint32_t* out, int64_t rows,
                      int64_t cols, TileRun run) {
  constexpr int PB = kRegBits;
  constexpr int kV = sizeof(T) / 4;
  T* tile = TileMemory<T>::get();
  const int64_t groups = cols / kV;
  const int64_t col = (blockIdx.x % groups) * kV;
  uint64_t base = static_cast<uint64_t>(blockIdx.x / groups);
  uint64_t umask = 0;
  for (int i = 0; i < run.tbits; ++i) {
    base = insert_zero(base, run.ubit[i]);
    umask |= 1ull << run.ubit[i];
  }
  const bool ragged = (base | umask) >= static_cast<uint64_t>(rows);
  T v[1 << PB];
  for (int p = 0; p < run.nphases; ++p) {
    uint32_t tb = threadIdx.x;
    uint32_t tbit[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      tb = static_cast<uint32_t>(insert_zero(tb, run.ppos[p][q]));
      tbit[q] = 1u << run.ppos[p][q];
    }
    const bool global = p == 0 || p + 1 == run.nphases;
    uint64_t gbase = base, gbit[PB];
    uint32_t present = 0xffffu;  // which rows lie below R, for the global phases
    if (global) {
      for (uint32_t t = tb; t; t &= t - 1) gbase |= 1ull << run.ubit[__ffs(t) - 1];
#pragma unroll
      for (int q = 0; q < PB; ++q) gbit[q] = 1ull << run.ubit[run.ppos[p][q]];
      if (ragged) {
        present = 0;
#pragma unroll
        for (int u = 0; u < (1 << PB); ++u) {
          if (row_of<PB>(gbase, gbit, u) < static_cast<uint64_t>(rows)) {
            present |= 1u << u;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < (1 << PB); ++u) {
      if (p == 0) {
        v[u] = ((present >> u) & 1)
                   ? *reinterpret_cast<const T*>(
                         in + row_of<PB>(gbase, gbit, u) * cols + col)
                   : absent_row<T>();
      } else {
        v[u] = tile[tile_slot<T>(row_of<PB>(tb, tbit, u))];
      }
    }
    apply_runs<PB>(v, run.runs, run.first[p], run.first[p + 1], run.sweep[p]);
    if (p + 1 == run.nphases) {
#pragma unroll
      for (int u = 0; u < (1 << PB); ++u) {
        if ((present >> u) & 1) {
          *reinterpret_cast<T*>(out + row_of<PB>(gbase, gbit, u) * cols + col) = v[u];
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < (1 << PB); ++u) {
        tile[tile_slot<T>(row_of<PB>(tb, tbit, u))] = v[u];
      }
      __syncthreads();
    }
  }
}

// The pass route: stage d `reps` times over every top row r = (p / d) * 2d
// + p % d, p = id / groups; a top row without a partner is copied.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
row_cmpex_pass_kernel(const uint32_t* in, uint32_t* out, int64_t rows,
                      int64_t cols, int64_t d, int64_t reps, int64_t threads) {
  constexpr int kV = sizeof(T) / 4;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= threads) return;
  const int64_t groups = cols / kV;
  const int64_t col = (id % groups) * kV;
  const int64_t p = id / groups;
  const int64_t r = (p / d) * 2 * d + p % d;
  const T* src = reinterpret_cast<const T*>(in + r * cols + col);
  T* dst = reinterpret_cast<T*>(out + r * cols + col);
  if (r + d < rows) {
    const int64_t step = d * cols / kV;
    T a = src[0], b = src[step];
    for (int64_t i = 0; i < reps; ++i) cmpex(a, b);
    dst[0] = a;
    dst[step] = b;
  } else if (in != out) {
    dst[0] = src[0];
  }
}

// Rows r with r % 2d < d: the top rows of a stage at distance d.
int64_t top_rows(int64_t rows, int64_t d) {
  const int64_t full = rows / (2 * d);
  const int64_t rem = rows - full * 2 * d;
  return full * d + (rem < d ? rem : d);
}

int popcount64(uint64_t x) { return __builtin_popcountll(x); }

// Blocks of up to kRowThreads threads for `threads` threads, halved down to
// one warp while the grid would not reach two blocks an SM.
int64_t row_block(int64_t threads) {
  int64_t blk = kRowThreads;
  while (blk > 32 && (threads + blk - 1) / blk < 2 * 132) blk /= 2;
  return blk;
}

template <int PB, typename T>
cudaError_t launch_regs(const uint32_t* in, uint32_t* out, int64_t rows,
                        int64_t cols, int64_t threads, const RegRun& run,
                        cudaStream_t stream) {
  const int64_t blk = row_block(threads);
  const int64_t blocks = (threads + blk - 1) / blk;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  row_cmpex_regs_kernel<PB, T><<<static_cast<unsigned>(blocks),
                                 static_cast<unsigned>(blk), 0, stream>>>(
      in, out, rows, cols, threads, run);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_regs_pb(int pb, int nbits, const uint32_t* in,
                           uint32_t* out, int64_t rows, int64_t cols,
                           const RegRun& run, cudaStream_t stream) {
  const int64_t threads =
      (int64_t{1} << (nbits - pb)) * (cols / static_cast<int64_t>(sizeof(T) / 4));
  switch (pb) {
    case 1: return launch_regs<1, T>(in, out, rows, cols, threads, run, stream);
    case 2: return launch_regs<2, T>(in, out, rows, cols, threads, run, stream);
    case 3: return launch_regs<3, T>(in, out, rows, cols, threads, run, stream);
    default: return launch_regs<4, T>(in, out, rows, cols, threads, run, stream);
  }
}

// Append stage `q` to the runs: one more repeat of the last run when it is
// on the same bit, else a new run.  Returns the number of runs.
int add_stage(Runs& runs, int nruns, int first_of_phase, int q) {
  if (nruns > first_of_phase && runs.q[nruns - 1] == q) {
    ++runs.reps[nruns - 1];
    return nruns;
  }
  runs.q[nruns] = static_cast<uint8_t>(q);
  runs.reps[nruns] = 1;
  return nruns + 1;
}

// Whether runs first .. last are one stage on each of `bits` bits, the
// highest first.
int is_sweep(const Runs& runs, int first, int last, int bits) {
  if (last - first != bits) return 0;
  for (int r = first; r < last; ++r) {
    if (runs.q[r] != bits - 1 - (r - first) || runs.reps[r] != 1) return 0;
  }
  return 1;
}

// The set bits of mask, ascending, into bits[]; returns how many.
int bit_positions(uint64_t mask, uint8_t* bits) {
  int n = 0;
  for (; mask; mask &= mask - 1) bits[n++] = static_cast<uint8_t>(__builtin_ctzll(mask));
  return n;
}

template <typename T>
cudaError_t launch_tile(const uint32_t* in, uint32_t* out, int64_t rows,
                        int64_t cols, int nbits, const TileRun& run,
                        cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      row_cmpex_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTileBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const int64_t blocks = (int64_t{1} << (nbits - run.tbits)) *
                         (cols / static_cast<int64_t>(sizeof(T) / 4));
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  row_cmpex_tile_kernel<T><<<static_cast<unsigned>(blocks),
                             1u << (run.tbits - kRegBits),
                             static_cast<unsigned>(sizeof(T)) << run.tbits,
                             stream>>>(in, out, rows, cols, run);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pass(const uint32_t* in, uint32_t* out, int64_t rows,
                        int64_t cols, int64_t d, int64_t reps,
                        cudaStream_t stream) {
  const int64_t threads =
      top_rows(rows, d) * (cols / static_cast<int64_t>(sizeof(T) / 4));
  const int64_t blk = row_block(threads);
  const int64_t blocks = (threads + blk - 1) / blk;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  row_cmpex_pass_kernel<T><<<static_cast<unsigned>(blocks),
                             static_cast<unsigned>(blk), 0, stream>>>(
      in, out, rows, cols, d, reps, threads);
  return cudaGetLastError();
}

constexpr int kSub = 64;  // sub-tile side; 128 makes one whole tile a block
constexpr int kSubsPerSide = 128 / kSub;
constexpr int kQuads = kSub / 4;  // 4 x 4 squares along a side; uint4 a row
constexpr int kTransposeSmem = kSub * kSub * 4;
static_assert(kQuads * kQuads % kThreads == 0, "whole squares a thread");

// Slot of the staged uint4 at row r, column group g of a sub-tile.
__device__ __forceinline__ int stage_slot(int r, int g) {
  return r * kQuads + (g ^ ((r >> 2) & 7));
}

// Block b transposes sub-tile (sr, sc) of tile b / kSubsPerSide^2 into
// sub-tile (sc, sr) of the output tile.  Rows are 32 uint4.
__global__ void __launch_bounds__(kThreads)
transpose128_kernel(const uint4* __restrict__ in, uint4* __restrict__ out) {
  extern __shared__ uint4 stage[];  // kSub rows of kQuads uint4, swizzled
  const int64_t tile = blockIdx.x / (kSubsPerSide * kSubsPerSide);
  const int sub = static_cast<int>(blockIdx.x % (kSubsPerSide * kSubsPerSide));
  const int sr = sub / kSubsPerSide;
  const int sc = sub % kSubsPerSide;
  const uint4* __restrict__ src = in + tile * 128 * 32 + sr * kSub * 32 +
                                  sc * kQuads;
  uint4* __restrict__ dst = out + tile * 128 * 32 + sc * kSub * 32 +
                            sr * kQuads;
  // square (p, g): input rows 4p..4p+3, column group g; g varies fastest
#pragma unroll
  for (int q = 0; q < kQuads * kQuads / kThreads; ++q) {
    const int s = threadIdx.x + q * kThreads;
    const int g = s % kQuads;
    const int p = s / kQuads;
    uint4 a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = src[(4 * p + k) * 32 + g];
    stage[stage_slot(4 * g + 0, p)] = make_uint4(a[0].x, a[1].x, a[2].x, a[3].x);
    stage[stage_slot(4 * g + 1, p)] = make_uint4(a[0].y, a[1].y, a[2].y, a[3].y);
    stage[stage_slot(4 * g + 2, p)] = make_uint4(a[0].z, a[1].z, a[2].z, a[3].z);
    stage[stage_slot(4 * g + 3, p)] = make_uint4(a[0].w, a[1].w, a[2].w, a[3].w);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kSub * kQuads / kThreads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / kQuads;
    const int g = i % kQuads;
    dst[r * 32 + g] = stage[stage_slot(r, g)];
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

}  // namespace

extern "C" {

// out = in + 1 over n u32 values.  Returns cudaGetLastError().
int ukt_copy_inc_u32(const void* in, void* out, int64_t n, void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t items = vec ? n >> 2 : n;
  const int64_t blocks = (items + kIncBlockItems - 1) / kIncBlockItems;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  copy_inc_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// The row compare-exchange stages dists[0..nd) (host memory, each in
// [1, rows)) on a (rows, cols) u32 array, any rows; in == out is allowed.
// Splits the stages into launches of the three routes (see the top of this
// file); the first launch reads `in`, the others work on `out` in place.
// Sets *kernels to the number of kernels launched.  Returns the first
// launch's error, else cudaSuccess.
int ukt_row_cmpex_u32(const void* in, void* out, int64_t rows, int64_t cols,
                      const int64_t* dists, int64_t nd, int64_t* kernels,
                      void* stream) {
  *kernels = 0;
  if (rows < 2 || cols < 1 || nd < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t i = 0; i < nd; ++i) {
    if (dists[i] < 1 || dists[i] >= rows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nbits = 64 - __builtin_clzll(static_cast<uint64_t>(rows - 1));
  const bool vec_tile = vec;  // a tile of column groups
  const int tile_max = vec_tile ? kVecTileBits : kTileBits;
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  for (int64_t i = 0; i < nd;) {
    const int64_t d = dists[i];
    int64_t j = i + 1;
    cudaError_t err;
    if (d & (d - 1)) {  // the pass route, with the stages at d that follow
      while (j < nd && dists[j] == d) ++j;
      err = vec ? launch_pass<uint4>(src, dst, rows, cols, d, j - i, st)
                : launch_pass<uint32_t>(src, dst, rows, cols, d, j - i, st);
    } else {
      uint64_t umask = static_cast<uint64_t>(d);
      for (; j < nd && j - i < kMaxStages && !(dists[j] & (dists[j] - 1)) &&
             popcount64(umask | static_cast<uint64_t>(dists[j])) <= tile_max;
           ++j) {
        umask |= static_cast<uint64_t>(dists[j]);
      }
      const int tbits = popcount64(umask);
      // the position of a stage's bit among umask's
      auto tile_bit = [&](int64_t s) {
        return popcount64(umask & (static_cast<uint64_t>(dists[s]) - 1));
      };
      if (tbits <= kRegBits) {
        RegRun run{};
        bit_positions(umask, run.ubit);
        for (int64_t s = i; s < j; ++s) {
          run.nruns = add_stage(run.runs, run.nruns, 0, tile_bit(s));
        }
        run.sweep = is_sweep(run.runs, 0, run.nruns, tbits);
        err = vec ? launch_regs_pb<uint4>(tbits, nbits, src, dst, rows, cols, run, st)
                  : launch_regs_pb<uint32_t>(tbits, nbits, src, dst, rows, cols, run, st);
      } else {
        // phases: consecutive stages while they name at most kRegBits
        // tile bits, then padded with the lowest other tile bits
        TileRun run{};
        run.tbits = bit_positions(umask, run.ubit);
        int nruns = 0;
        uint32_t cur = 0;
        int64_t open = i;  // the phase's first stage
        auto close = [&](int64_t end) {
          uint32_t pm = cur;
          for (uint32_t free = ((1u << tbits) - 1) & ~pm; popcount64(pm) < kRegBits;
               free &= free - 1) {
            pm |= free & (~free + 1);
          }
          bit_positions(pm, run.ppos[run.nphases]);
          for (int64_t s = open; s < end; ++s) {
            nruns = add_stage(run.runs, nruns, run.first[run.nphases],
                              popcount64(pm & ((1u << tile_bit(s)) - 1)));
          }
          run.sweep[run.nphases] = is_sweep(run.runs, run.first[run.nphases],
                                            nruns, kRegBits);
          run.first[++run.nphases] = static_cast<uint16_t>(nruns);
          cur = 0;
          open = end;
        };
        for (int64_t s = i; s < j; ++s) {
          const uint32_t b = 1u << tile_bit(s);
          if (popcount64(cur | b) > kRegBits) close(s);
          cur |= b;
        }
        close(j);
        err = vec_tile ? launch_tile<uint4>(src, dst, rows, cols, nbits, run, st)
                       : launch_tile<uint32_t>(src, dst, rows, cols, nbits, run, st);
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*kernels;
    src = dst;
    i = j;
  }
  return static_cast<int>(cudaSuccess);
}

// Transpose each of `tiles` (128, 128) u32 tiles; `in` and `out` 16-byte
// aligned.  Returns cudaGetLastError().
int ukt_transpose128_u32(const void* in, void* out, int64_t tiles,
                         void* stream) {
  const int64_t blocks = tiles * kSubsPerSide * kSubsPerSide;
  if (blocks > 0x7fffffff || reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kTransposeSmem > 48 * 1024) {  // kSub = 128: one tile a block
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        transpose128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTransposeSmem);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  transpose128_kernel<<<static_cast<unsigned>(blocks), kThreads,
                        kTransposeSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out));
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
