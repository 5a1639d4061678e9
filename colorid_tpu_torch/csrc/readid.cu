// The read classifier's device dispatches on Hopper (sm_90a): kernel H.
//
// Replaces no Pallas kernel: code that XLA compiles in the JAX package.
// Mode 1, the order-free pass, replaces the body of colorid_tpu/ops/
// query.py::query_readid_orderfree_reads after the window keys (the per-read
// lax.sort of the keys, the repeat mask, _device_rows, _and_present,
// _unpack_bits and the per-read sums). Mode 2, the exact replay, replaces
// query.py::_readid_core (_first_absent, _readid_report) and
// _readid_firsthit_core (_firsthit_report): the gather, the AND over the H
// rows, presence, and the per-read segment min / sum. The plain PyTorch twins
// are colorid_tpu_torch/ops/query.py::_orderfree_plain, _readid_core_plain
// and _readid_firsthit_core_plain; the kernel equals them bit for bit.
//
// Mode 1 (readid_orderfree_launch), per read r of R, from its WR window keys
// (ops/extract.py sort keys: value ^ 2^63, SENT_KEY = 2^63 - 1 for a window
// that does not count) writes int32 out[r, C + 3]: columns 0..C-1 the number
// of the read's distinct present k-mers whose AND of the H rows has color
// bit c; C whether any distinct k-mer has a row that is all zero words; C+1
// D, the number of distinct keys; C+2 the distinct present k-mers whose AND
// has no bit below C. Every output is a function of the read's key set.
//
// Mode 2 (readid_exact_launch), over N k-mers with rows [N, H] (int32 or
// int64), their read seg [N] and position pos [N] (pos >= 2^30 is padding):
// fa[r] = the least pos of an absent k-mer of read r (2^30: none); a k-mer
// counts when pos < fa[seg] (such a k-mer is present); with B > 0 a k-mer at
// pos >= B counts only toward the colors that the read's counted k-mers at
// pos < B hit. Out, counts: int32 [R, C + 1], the counts and no_hits (fa <
// 2^30); first hit: int32 [R, C + 1], the least pos of a counted phase-1
// k-mer (pos < B where B > 0) hitting each color (2^30: never) and fa.
//
// What bounds it on an H100. Mode 1 at the read classifier's dispatch (8,192
// pairs of 2 x 160 bp mates, k 31, H 4: 2,129,920 windows): the keys (8 bytes
// a window, 17 MB), the 32-byte sectors of the H rows of each distinct valid
// k-mer (a classic index of 200 MB does not fit the 50 MB L2), the output
// (0.8 MB); XXH3 of four seeds is some 380 SASS instructions a k-mer (kernel
// A's count). The gathers are scattered 4-byte reads, one sector each, and
// scattered sectors come from HBM at a rate far below its streaming rate:
// both modes' gathers run at about the same number of sectors a second
// however the threads are laid out (PERF.md §6 times the layouts tried:
// a warp a read, 2-4 keys a thread in flight, 320 or 384 threads a read,
// more or fewer resident warps, L1 bypass, keys evicted first, a
// persistent grid with the next read's keys prefetched, per-color ballots
// in place of the shared atomics: none faster than the layout below).
// Mode 2 moves its rows, seg and pos (16-24 bytes a k-mer at H 4), the
// rows' sectors once, and 4 wpad bytes a k-mer of scratch.
//
// What the design does about that:
// - Mode 1 runs a block a read. It deduplicates the read's keys in a hash
//   set of 2^s >= 2 WR slots in shared memory (one 64-bit atomicCAS a key:
//   the thread whose CAS fills the slot owns the distinct key), so SENT
//   keys and repeats are dropped before any placement or gather, and the
//   keys are never sorted. A read whose set does not fit 128 KB of shared
//   memory takes a set in global scratch, one per resident block, with the
//   same code (WR past 8,192: nm > 2 with long mates).
// - The owner places its k-mer with kernel A's own device code
//   (csrc/placement.cuh, H of 1-4 unrolled), loads the wpad words of its H
//   rows together (classic: word r * wpad; blocked: block * 128 + offset *
//   wpad; csrc/row_gather.cuh, shared with kernel C's gather mode), tests
//   presence (every row has a nonzero word) and adds each
//   color bit of the AND into per-read counts in shared memory (the output
//   row itself where C does not fit), then the block writes one row.
// - Mode 2 does not assume that seg is sorted or that a read's k-mers are
//   contiguous (padding mates carry seg 0): every per-read reduction is an
//   integer atomic, exact in any order. Launches: one writes the outputs'
//   initial values; the first-absent pass (a block for every 256 k-mers)
//   loads a k-mer's pos, seg and H row indices, then all its H wpad words
//   through L2 only, before it tests any (no early exit, no wait on fa),
//   writes the k-mer's AND words to the scratch andw [N, wpad] and lowers
//   fa by atomicMin; then one counting pass (two with B > 0: phase 1 also
//   ORs the read's candidate colors) or the first hits read the scratch,
//   coalesced, and gather no matrix word. A k-mer at or past its read's
//   final fa never counts, so the scratch of one the pass did not need is
//   never read.
// - Mode 2's atomics are aggregated in the warp: __match_any_sync on seg
//   groups the lanes of one read (a read's k-mers lie side by side in the
//   route's layout), and the group's minimum, OR or per-color popcount
//   goes out in one atomic.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): plain C
// entry points that launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "placement.cuh"
#include "row_gather.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int32_t BIG = 1 << 30;  // ops/query.py::BIG and PAD_POS
constexpr unsigned long long SENT = 0x7FFFFFFFFFFFFFFFull;  // SENT_KEY, the set's empty slot
constexpr int MAX_H = 32;  // rows a k-mer (the wrapper checks)

// Mode 1's parameters; the placement fields carry place_fields' names.
struct OrderFree {
  int k, H;
  uint64_t mod, mod_inv, n_blocks;
  int64_t rpb;
  uint32_t gmask, gstep;
  int g_bits;
  Consts c;
  const int64_t* keys;  // [R, WR]
  int64_t R;
  int WR;
  int set_log2;                 // the hash set has 2^set_log2 slots
  unsigned long long* gset;     // [gridDim.x << set_log2], or nullptr: in shared memory
  bool cnt_global;              // per-read counts in the output row, not shared memory
  const uint32_t* blocks;       // the matrix, [n_words] words
  int64_t n_words;
  int wpad, C;
  int32_t* out;                 // [R, C + 3]
};

// Adds 1 to cnt[32 w + b] for each set bit b of word w of an AND below C;
// returns whether it had one.
__device__ __forceinline__ bool count_word(int32_t* cnt, int w, uint32_t a, int C) {
  const int lo = 32 * w;
  if (lo >= C) return false;
  if (C - lo < 32) a &= (1u << (C - lo)) - 1u;
  const bool any = a != 0;
  while (a) {
    atomicAdd(cnt + lo + __ffs(a) - 1, 1);
    a &= a - 1;
  }
  return any;
}

// Inserts key into the set; true where this call filled its slot (the key
// is new to the read). Linear probing: the set never fills (2^s >= 2 WR).
__device__ __forceinline__ bool set_insert(unsigned long long* set, int log2,
                                           unsigned long long key) {
  const uint32_t mask = (1u << log2) - 1u;
  uint32_t s = (uint32_t)((key * 0x9E3779B97F4A7C15ull) >> (64 - log2));
  while (true) {
    const unsigned long long prev = atomicCAS(set + s, SENT, key);
    if (prev == SENT) return true;
    if (prev == key) return false;
    s = (s + 1) & mask;
  }
}

// Placement of one k-mer for a run-time H (HT == 0 in the kernel): vals[h]
// is the row (classic) or the offset of hash h; returns the block. The same
// arithmetic as place_fixed, one hash at a time.
template <int PATH>
__device__ uint64_t place_any_h(const OrderFree& p, uint64_t v, uint32_t* vals) {
  if constexpr (PATH == PATH_V3 || PATH == PATH_V4) {
    uint64_t x = v << (64 - 2 * p.k);
    if constexpr (PATH == PATH_V4) {
      const uint64_t y = ~x;
      x = ~__umul64hi(y, y);
    }
    const uint64_t m = fmix64(v, p.c);
#pragma unroll 1
    for (int h = 0; h < p.H; ++h)
      vals[h] = (uint32_t)h * p.gstep + ((uint32_t)shr(m, p.g_bits * h) & p.gmask);
    return __umul64hi(x, p.n_blocks);
  } else {
    constexpr int CLS = xxh_class<PATH>();
    const uint64_t f = base_fields(v, p.k);
    uint64_t h0 = 0;
#pragma unroll 1
    for (int h = 0; h < p.H; ++h) {
      const uint64_t hv = xxh3<CLS>(f, p.k, seed_consts<CLS>(p.c, (uint64_t)h), p.c);
      if constexpr (PATH <= PATH_CL_17_32) {
        vals[h] = (uint32_t)mod_u64(hv, p.mod, p.mod_inv);
      } else if (h == 0) {
        h0 = hv;
        vals[0] = (uint32_t)(hv >> 32) & p.gmask;
      } else {
        vals[h] = (uint32_t)h * p.gstep + ((uint32_t)hv & p.gmask);
      }
    }
    return PATH <= PATH_CL_17_32 ? 0 : mod_u64(h0, p.mod, p.mod_inv);
  }
}

template <int PATH, int HT>
__global__ void __launch_bounds__(THREADS) readid_orderfree_kernel(const OrderFree p) {
  extern __shared__ unsigned long long smem[];
  __shared__ int facts[3];  // any absent, D, zero-hit k-mers
  constexpr int CLS = xxh_class<PATH>();
  constexpr bool BLOCKED = PATH > PATH_CL_17_32;
  constexpr int NH = HT > 0 ? HT : MAX_H;
  const int H = HT > 0 ? HT : p.H;
  const int S = 1 << p.set_log2;
  const RowGeo g{p.blocks, p.n_words, p.wpad, 0, 0};  // base[] holds the words' offsets
  unsigned long long* set = p.gset ? p.gset + ((int64_t)blockIdx.x << p.set_log2) : smem;
  int32_t* cnt_smem = reinterpret_cast<int32_t*>(p.gset ? smem : smem + S);
  SeedConsts sc[HT > 0 ? HT : 1];
  if constexpr (HT > 0) {
#pragma unroll
    for (int h = 0; h < HT; ++h) sc[h] = seed_consts<CLS>(p.c, (uint64_t)h);
  }
  for (int64_t r = blockIdx.x; r < p.R; r += gridDim.x) {
    int32_t* row = p.out + r * (p.C + 3);
    int32_t* cnt = p.cnt_global ? row : cnt_smem;
    for (int i = threadIdx.x; i < S; i += THREADS) set[i] = SENT;
    for (int i = threadIdx.x; i < p.C; i += THREADS) cnt[i] = 0;
    if (threadIdx.x < 3) facts[threadIdx.x] = 0;
    __syncthreads();
    int absent = 0, d = 0, zero = 0;
    const int64_t* keys = p.keys + r * p.WR;
    for (int i = threadIdx.x; i < p.WR; i += THREADS) {
      const unsigned long long key = (unsigned long long)keys[i];
      if (key == SENT || !set_insert(set, p.set_log2, key)) continue;
      ++d;
      const uint64_t v = key ^ (1ull << 63);
      uint32_t vals[NH];
      uint64_t block;
      if constexpr (HT > 0)
        block = place_fixed<PATH, HT>(p, v, sc, vals);
      else
        block = place_any_h<PATH>(p, v, vals);
      int64_t base[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h)
        base[h] = h >= H ? 0
                  : BLOCKED ? (int64_t)block * 128 + (int64_t)vals[h] * p.wpad
                            : (int64_t)vals[h] * p.wpad;
      bool any;
      uint32_t nz = 0;
      if (p.wpad == 1) {
        const uint32_t a = and_word<ROW_LOAD_L1, NH>(g, base, H, 0, nz);
        if (!rows_present(nz, H)) {
          absent = 1;
          continue;
        }
        any = count_word(cnt, 0, a, p.C);
      } else {
        for (int w = 0; w < p.wpad && !rows_present(nz, H); ++w)
          and_word<ROW_LOAD_L1, NH>(g, base, H, w, nz);
        if (!rows_present(nz, H)) {
          absent = 1;
          continue;
        }
        any = false;
        for (int w = 0; w < p.wpad; ++w)
          any |= count_word(cnt, w, and_word<ROW_LOAD_L1, NH>(g, base, H, w, nz), p.C);
      }
      zero += !any;
    }
    absent = __reduce_or_sync(0xFFFFFFFFu, absent);
    d = __reduce_add_sync(0xFFFFFFFFu, d);
    zero = __reduce_add_sync(0xFFFFFFFFu, zero);
    if ((threadIdx.x & 31) == 0) {
      if (absent) facts[0] = 1;
      atomicAdd(&facts[1], d);
      atomicAdd(&facts[2], zero);
    }
    __syncthreads();
    if (!p.cnt_global)
      for (int i = threadIdx.x; i < p.C; i += THREADS) row[i] = cnt_smem[i];
    if (threadIdx.x < 3) row[p.C + threadIdx.x] = facts[threadIdx.x];
    __syncthreads();  // the next read resets the set, the counts and the facts
  }
}

template <int PATH, int HT>
cudaError_t launch_orderfree(const OrderFree& p, int grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(readid_orderfree_kernel<PATH, HT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  readid_orderfree_kernel<PATH, HT><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int PATH>
cudaError_t launch_orderfree_h(const OrderFree& p, int grid, size_t smem, cudaStream_t st) {
  switch (p.H) {
    case 1: return launch_orderfree<PATH, 1>(p, grid, smem, st);
    case 2: return launch_orderfree<PATH, 2>(p, grid, smem, st);
    case 3: return launch_orderfree<PATH, 3>(p, grid, smem, st);
    case 4: return launch_orderfree<PATH, 4>(p, grid, smem, st);
    default: return launch_orderfree<PATH, 0>(p, grid, smem, st);
  }
}

// Mode 2's parameters.
struct Exact {
  const void* rows;  // [N, H], int32 or int64
  const int32_t* seg;
  const int32_t* pos;
  int64_t N;
  int H;
  const uint32_t* blocks;
  int64_t n_words;
  int wpad;
  int64_t rpb;   // 0: classic rows
  int rpb_log2;  // log2(rpb)
  int C, B;
  int64_t R;
  int32_t* out;    // [R, C + 1]
  int32_t* fa;     // first absent: out's column C (first hit) or [R] scratch (counts)
  int fa_stride;   // C + 1 or 1
  uint32_t* cand;  // [R, wpad] the colors of the phase-1 k-mers (counts, B > 0)
  uint32_t* andw;  // [N, wpad] the AND words of each k-mer that the first pass checked
};

__global__ void __launch_bounds__(THREADS) readid_init_kernel(const Exact p, int firsthit) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t n_out = p.R * (p.C + 1);
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n_out; i += stride)
    p.out[i] = firsthit ? BIG : 0;
  if (firsthit) return;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < p.R; i += stride)
    p.fa[i] = BIG;
  if (p.cand)
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < p.R * p.wpad; i += stride)
      p.cand[i] = 0u;
}

// fa[seg] = min over absent k-mers of pos, and andw[i] = the AND words of
// every k-mer that is not padding. A k-mer's H row indices, then all its H
// wpad words, are loaded before any is tested.
template <typename RowT, int HT>
__global__ void __launch_bounds__(THREADS) readid_absent_kernel(const Exact p) {
  const int lane = threadIdx.x & 31;
  // a warp takes 32 consecutive k-mers a round: its lanes hold neighbours
  // (the same read, mostly), and every lane runs each round's warp-wide calls
  for (int64_t i0 = (int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31); i0 < p.N;
       i0 += (int64_t)gridDim.x * THREADS) {
    const int64_t i = i0 + lane;
    int32_t pi = BIG, s = -1;
    if (i < p.N) {
      pi = p.pos[i];
      s = p.seg[i];
    }
    const bool live = pi < BIG && s >= 0 && s < p.R;
    bool present = true;
    if (live) {
      const RowGeo g{p.blocks, p.n_words, p.wpad, p.rpb, p.rpb_log2};
      const RowT* const rows = static_cast<const RowT*>(p.rows) + i * p.H;
      uint32_t* const andw = p.andw + i * p.wpad;
      uint32_t nz = 0;
      if constexpr (HT > 0) {
        int64_t off[HT];
        row_starts<RowT, HT>(g, rows, HT, (int64_t)rows[0], off);
#pragma unroll 4
        for (int w = 0; w < p.wpad; ++w) andw[w] = and_word<ROW_LOAD_L2, HT>(g, off, HT, w, nz);
      } else {  // a run-time H
        const int64_t r0 = (int64_t)rows[0];
        for (int w = 0; w < p.wpad; ++w)
          andw[w] = kmer_word<ROW_LOAD_L2>(g, rows, p.H, r0, w, nz);
      }
      present = rows_present(nz, HT > 0 ? HT : p.H);
    }
    // one atomicMin for the absent k-mers of a read in the warp
    const bool miss = live && !present;
    const unsigned grp = __match_any_sync(FULL, miss ? s : -1);
    if (miss) {
      const int32_t m = __reduce_min_sync(grp, pi);
      if (lane == __ffs(grp) - 1) atomicMin(p.fa + (int64_t)s * p.fa_stride, m);
    }
  }
}

enum Pass : int {
  PASS_ALL = 0,     // counts, B == 0: every counted k-mer
  PASS_PHASE1 = 1,  // counts, B > 0: pos < B, and the read's candidate colors
  PASS_PHASE2 = 2,  // counts, B > 0: pos >= B, toward candidate colors only
  PASS_FIRST = 3,   // first hit: the counted phase-1 k-mers' least pos a color
};

// A k-mer counts where pos < fa[seg] (it is then present); its AND words
// come from the scratch. The lanes of one read (__match_any_sync on seg)
// send one atomic a color. The first counting pass also writes the counts'
// no_hits column.
template <int PASS>
__global__ void __launch_bounds__(THREADS) readid_count_kernel(const Exact p) {
  if (PASS == PASS_ALL || PASS == PASS_PHASE1)
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < p.R;
         i += (int64_t)gridDim.x * THREADS)
      p.out[i * (p.C + 1) + p.C] = p.fa[i] < BIG;
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = (int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31); i0 < p.N;
       i0 += (int64_t)gridDim.x * THREADS) {
    const int64_t i = i0 + lane;
    int32_t pi = BIG, s = -1;
    if (i < p.N) {
      pi = p.pos[i];
      s = p.seg[i];
    }
    bool live = pi < BIG && s >= 0 && s < p.R;
    if (live) live = pi < p.fa[(int64_t)s * p.fa_stride];
    if (PASS == PASS_PHASE1 || (PASS == PASS_FIRST && p.B > 0)) live = live && pi < p.B;
    if (PASS == PASS_PHASE2) live = live && pi >= p.B;
    const unsigned grp = __match_any_sync(FULL, live ? s : -1);
    const bool lead = live && lane == __ffs(grp) - 1;
    int32_t* const row = p.out + (int64_t)(live ? s : 0) * (p.C + 1);
    for (int w = 0; w < p.wpad && 32 * w < p.C; ++w) {
      uint32_t a = live ? p.andw[i * p.wpad + w] : 0u;
      if (p.C - 32 * w < 32) a &= (1u << (p.C - 32 * w)) - 1u;
      if (PASS == PASS_PHASE2 && live) a &= p.cand[(int64_t)s * p.wpad + w];
      if (PASS == PASS_PHASE1) {
        const uint32_t o = __reduce_or_sync(grp, a);
        if (lead && o) atomicOr(p.cand + (int64_t)s * p.wpad + w, o);
      }
      uint32_t bits = __reduce_or_sync(FULL, a);
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        if (PASS == PASS_FIRST) {
          const int32_t m = __reduce_min_sync(grp, (a >> b) & 1u ? pi : BIG);
          if (lead && m < BIG) atomicMin(row + 32 * w + b, m);
        } else {
          const unsigned m = __ballot_sync(FULL, (a >> b) & 1u) & grp;
          if (lead && m) atomicAdd(row + 32 * w + b, __popc(m));
        }
      }
    }
  }
}

// Blocks for n items, one a thread: at most 8 an SM, which then stride;
// every one (cap false) for the first-absent pass, whose gathers want as
// many warps in flight as the SMs take.
int grid_for(int64_t n, bool cap = true) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t needed = (n + THREADS - 1) / THREADS;
  const int64_t most = cap ? (int64_t)(sms > 0 ? sms : 1) * 8 : needed;
  return (int)(needed < 1 ? 1 : needed < most ? needed : most);
}

template <typename RowT>
cudaError_t launch_exact(const Exact& p, int firsthit, cudaStream_t st) {
  readid_init_kernel<<<grid_for(p.R * (p.C + 1 > p.wpad ? p.C + 1 : p.wpad)), THREADS, 0, st>>>(
      p, firsthit);
  const int ga = grid_for(p.N, false);
  switch (p.H) {
    case 1: readid_absent_kernel<RowT, 1><<<ga, THREADS, 0, st>>>(p); break;
    case 2: readid_absent_kernel<RowT, 2><<<ga, THREADS, 0, st>>>(p); break;
    case 3: readid_absent_kernel<RowT, 3><<<ga, THREADS, 0, st>>>(p); break;
    case 4: readid_absent_kernel<RowT, 4><<<ga, THREADS, 0, st>>>(p); break;
    default: readid_absent_kernel<RowT, 0><<<ga, THREADS, 0, st>>>(p); break;
  }
  const int g = grid_for(p.N > p.R ? p.N : p.R);
  if (firsthit) {
    readid_count_kernel<PASS_FIRST><<<g, THREADS, 0, st>>>(p);
  } else if (p.B > 0) {
    readid_count_kernel<PASS_PHASE1><<<g, THREADS, 0, st>>>(p);
    readid_count_kernel<PASS_PHASE2><<<g, THREADS, 0, st>>>(p);
  } else {
    readid_count_kernel<PASS_ALL><<<g, THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Mode 1. keys int64 [R, WR]; blocks the matrix's n_words uint32 words;
// out int32 [R, C + 3]; ops/query.py::readid_orderfree_plan chooses the
// rest. The hash set has 2^set_log2 >= 2 WR slots: in
// shared memory where gset is null (grid blocks, each walking reads r, r +
// grid, ...), else in gset, 2^set_log2 slots for each of the grid's blocks.
// cnt_global: the per-read counts live in the output row (C too large for
// shared memory beside the set). smem: the dynamic shared memory, the set
// (unless gset) and C int32 counts (unless cnt_global). version 0 =
// classic, 1..4 = the blocked layouts; consts: the 12 u64 of struct Consts.
extern "C" int readid_orderfree_launch(const void* keys, int64_t R, int32_t WR,
                                       int32_t set_log2, void* gset, int32_t grid,
                                       int32_t cnt_global, int64_t smem, const void* blocks,
                                       int64_t n_words, int32_t wpad, int32_t C, void* out,
                                       int32_t k, int32_t H, int32_t version,
                                       int64_t bloom_size, int64_t rpb, const void* consts,
                                       void* stream) {
  if (R <= 0) return 0;
  if (WR < 1 || set_log2 < 1 || set_log2 > 30 || (1ll << set_log2) < 2ll * WR || grid < 1 ||
      H > MAX_H || wpad < 1 || C < 0 || C > 32 * wpad ||
      smem < (gset ? 0 : 8ll << set_log2) + (cnt_global ? 0 : 4ll * C))
    return (int)cudaErrorInvalidValue;
  OrderFree p{};
  const int path = place_fields(p, k, H, version, bloom_size, rpb, consts);
  p.keys = (const int64_t*)keys;
  p.R = R;
  p.WR = WR;
  p.set_log2 = set_log2;
  p.gset = (unsigned long long*)gset;
  p.cnt_global = cnt_global != 0;
  p.blocks = (const uint32_t*)blocks;
  p.n_words = n_words;
  p.wpad = wpad;
  p.C = C;
  p.out = (int32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  switch (path) {
    case PATH_CL_4_8: return (int)launch_orderfree_h<PATH_CL_4_8>(p, grid, sm, st);
    case PATH_CL_9_16: return (int)launch_orderfree_h<PATH_CL_9_16>(p, grid, sm, st);
    case PATH_CL_17_32: return (int)launch_orderfree_h<PATH_CL_17_32>(p, grid, sm, st);
    case PATH_BL_4_8: return (int)launch_orderfree_h<PATH_BL_4_8>(p, grid, sm, st);
    case PATH_BL_9_16: return (int)launch_orderfree_h<PATH_BL_9_16>(p, grid, sm, st);
    case PATH_BL_17_32: return (int)launch_orderfree_h<PATH_BL_17_32>(p, grid, sm, st);
    case PATH_V3: return (int)launch_orderfree_h<PATH_V3>(p, grid, sm, st);
    case PATH_V4: return (int)launch_orderfree_h<PATH_V4>(p, grid, sm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Mode 2. rows [N, H] (int64 where rows64), seg and pos int32 [N]; rpb 0
// for classic rows, else a power of two; andw uint32 [N, wpad] scratch.
// firsthit 0: out int32 [R, C + 1] counts and no_hits, fa int32 [R]
// scratch, cand uint32 [R, wpad] scratch where B > 0 (else null);
// firsthit 1: out the first hits and fa, fa and cand null.
extern "C" int readid_exact_launch(const void* rows, int32_t rows64, const void* seg,
                                   const void* pos, int64_t N, int32_t H, const void* blocks,
                                   int64_t n_words, int32_t wpad, int64_t rpb, int32_t C,
                                   int32_t B, int64_t R, int32_t firsthit, void* out, void* fa,
                                   void* cand, void* andw, void* stream) {
  if (R <= 0) return 0;
  if (N < 0 || H < 1 || H > MAX_H || wpad < 1 || rpb < 0 || (rpb & (rpb - 1)) || C < 0 ||
      C > 32 * wpad || (N > 0 && andw == nullptr) ||
      (!firsthit && (fa == nullptr || (B > 0 && cand == nullptr))))
    return (int)cudaErrorInvalidValue;
  Exact p{};
  p.rows = rows;
  p.seg = (const int32_t*)seg;
  p.pos = (const int32_t*)pos;
  p.N = N;
  p.H = H;
  p.blocks = (const uint32_t*)blocks;
  p.n_words = n_words;
  p.wpad = wpad;
  p.rpb = rpb;
  while (rpb > 1 && (1ll << p.rpb_log2) < rpb) ++p.rpb_log2;
  p.C = C;
  p.B = B;
  p.R = R;
  p.out = (int32_t*)out;
  p.fa = firsthit ? p.out + C : (int32_t*)fa;
  p.fa_stride = firsthit ? C + 1 : 1;
  p.cand = firsthit || B <= 0 ? nullptr : (uint32_t*)cand;
  p.andw = (uint32_t*)andw;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(rows64 ? launch_exact<int64_t>(p, firsthit, st)
                      : launch_exact<int32_t>(p, firsthit, st));
}
