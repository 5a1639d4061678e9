// The search epilogue on Hopper (sm_90a): per-color counts, the global AND,
// the all-valid flag, the uniq-hit frequency histogram and the overflow list
// of a batch of k-mers, from their row words or from their Bloom rows.
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU: colorid_tpu/ops/query.py::_accumulate_tail (its
// histogram an int8 one-hot contraction on the MXU, its overflow list a
// cumsum and two scatters), its generic gather in front of it
// (_accumulate_one: _gather_rows, XLA's block take with a one-hot lane
// select, or _gather_rows_blocked; _and_present), and around the classic
// stream's word kernel
// the residual patch, the un-sort to k-mer order, the AND over the H hash
// words and the presence test (colorid_tpu/ops/stream_query.py,
// stream_accumulate_classic_exact). Its plain PyTorch twins, which run the
// same arithmetic as some hundred tensor ops (one launch each on the card),
// are colorid_tpu_torch/ops/query.py::_accumulate_tail_plain,
// _accumulate_one_plain and _accumulate_sorted_words_plain; kernel and
// twins agree bit for bit.
//
// Three entry points.
//
// epilogue_launch, the AND-words mode, over rows i < N, in place on the
// four accumulators (stats int32 [C + W + 2], hist int32 [C, FREQ_CAP],
// over_col / over_freq int32 [capO]):
//   x_i      = andw[i] (W words), present_i the given flag
//   valid_i  = present_i & mask_i;  x'_i = x_i with the bits >= C cleared
//   stats[c]          += #{valid i : bit c of x'_i}            (c < C)
//   stats[C + w]      &= AND over valid i of x_i[w] (all 32 bits; no change
//                        when no row is valid)
//   stats[C + W]      *= every i with mask_i has present_i
//   uniq_i   = valid_i and x'_i has exactly one set bit, color col_i
//   hist[col_i, max(q_i, 0)] += 1      for uniq i with q_i < FREQ_CAP
//   big_i    = uniq_i and q_i >= FREQ_CAP; in k-mer order, big i of rank r
//              adds (col_i, gidx_i or base_idx + i as int32) to slot
//              stats[C + W + 1] + r of over_col / over_freq where that slot
//              is below capO; then stats[C + W + 1] += #big (not clamped).
//
// epilogue_gather_launch, the gather mode: the rows [N, H] (int32, or int64
// past int32 row addressing) in place of the AND words. x_i is the AND over
// k-mer i's H rows of their wpad words in the matrix (csrc/row_gather.cuh:
// classic row r at word r * wpad, blocked lanes (r % rpb) * wpad of the
// block of its hash-0 row), present_i "every row has a nonzero word", and
// the rest is the AND-words mode with W = wpad. No gathered word, AND word
// or presence flag is written to memory.
//
// epilogue_sorted_launch, the sorted-words mode of the classic stream (W =
// 1): the classic word kernel's output in row order, words_s int32 [P],
// with the sorted rows row_s int32 [P] and the sort's permutation gidx_s
// int64 [P] (probe gidx_s[j] of k-mer gidx_s[j] / H). Chunk c of pc probes
// read its words from the window of rows [tb[c] * tile_rows, (tb[c] + nt)
// * tile_rows); a probe outside it holds the de-offset word, and where
// reread[c] its word is read again from the matrix. Then x_i is the AND of
// k-mer i's H words and present_i "none of them is zero", and the rest is
// the AND-words mode over those N = P / H rows.
//
// What bounds it on an H100: bytes, by count. The AND-words row pass reads
// each row's word, present, mask and frequency: 10 bytes at W 1 against
// 3.35 TB/s; the rest is a few dozen integer instructions a row. The
// gather mode reads a k-mer's rows (4 H or 8 H bytes), mask and frequency,
// and the 32-byte sectors of its H rows' words: scattered sectors over a
// matrix far larger than the 50 MB L2, which the card serves at a rate far
// below its streaming rate (PERF.md §6, kernel H). The
// sorted mode adds 16 bytes a probe (word, row, permutation) and the
// per-k-mer arrays written and read (5 bytes a k-mer, 43 MB at the main
// cell's 8.65 M k-mers), and one L2 atomic a probe, which measured slower
// than the bytes on the card (PERF.md). chip_smoke.py reports both bounds.
//
// What the design does about that:
// - The sorted mode's first pass (epilogue_sorted_kernel) reads four probes
//   a thread as 16-byte vectors, streaming (evict-first), and ANDs each
//   word into its k-mer's word with a fire-and-forget atomic, clearing the
//   k-mer's presence byte on a zero word; no un-sorted copy of the 4
//   P-byte words is ever written. AND is order-free, so the result does not
//   depend on the atomics' order. The atomics bind it: they resolve in L2
//   only while their targets fit about half of it, so a batch whose
//   per-k-mer arrays do not (the main cell's 43 MB) runs as passes over
//   ranges of k-mers, each reading all probes again (two at the main cell).
// - One pass over the rows (kernel 1, a persistent grid, 2,048-row tiles at
//   W 1: four rows a thread as vector loads, all issued before any is
//   used; no block barrier inside the loop): the words are read once and
//   nothing per row is written back.
// - The gather mode feeds the row pass directly: at W 1 a thread loads its
//   four k-mers' rows, then all their H words (16 loads at H 4, through L2
//   only: a row word is read once), before any is used.
// - Per-color counts without a collective a row: each lane adds its masked
//   words into 8 bit planes (a carry-save counter: bit c of plane k is bit
//   k of color c's count), and a warp folds the planes into the counts with
//   ballots only every 252 words a lane. At W 1 a thread takes four rows
//   and lane c owns color c. At W > 1 (epilogue_wide_kernel) a group of G
//   lanes (the power of two from W up to 32) takes a row and lane j owns
//   word j, so a warp step reads 32 / G whole rows as one coalesced line
//   (one 32-byte sector a row at W 8, one 128-byte line at W 32) and each
//   lane keeps the planes of its own word, the register cost of W 1; rows
//   of 64 and 128 words give a lane two or four 32-word pieces. nh and the
//   first color are reductions within the group, presence an OR within it
//   in the gather mode, and the group's first lane adds the histogram bin.
//   The wide tier (W > 128, past 4,096 colors) takes a row a warp, a piece
//   at a time, and adds each color bit to the block's counts. The AND is
//   kept in each lane's registers and folded once; a block flushes counts
//   and AND once.
// - The histogram, where the reads pile onto a few dozen (color,
//   frequency) bins. The bins of frequency below hf live in shared memory,
//   private to the block and flushed once at its end; hf is the largest
//   power of two whose band fits 100 KB, so that two blocks share an SM;
//   bins at and above hf add to the global histogram directly. At W 1 each
//   lane adds its own row (shared-memory atomics took the hot bins faster
//   than folding them); wider rows first group a warp's lanes of one bin
//   with __match_any_sync, and one of them adds the group's size.
// - The overflow list keeps k-mer order without a scan over N and without
//   a launch for the scan: kernel 1 adds each warp's count of big rows to
//   its tile's count and to a total, and writes the color of each row with
//   mask and q >= FREQ_CAP (-1 where it is not uniq) to the scratch, so no
//   row's words are read twice; kernel 2 returns at once when the total is
//   0, else each block sums the counts of the tiles before its own range
//   of tiles (a few thousand ints), ranks the big rows of its tiles with
//   ballots, adds them to their slots (the slots beyond n_over are zero,
//   so adding writes them, as in the twin), and the last block to finish
//   advances n_over.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): plain C
// entry points that launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "row_gather.cuh"

namespace {

constexpr int THREADS = 512;  // a block; also the rows of a tile at W > 1
constexpr int WARPS = THREADS / 32;
constexpr int RPT1 = 4;  // rows a thread in a W = 1 tile (a multiple of 4)
constexpr int FREQ_CAP = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_COLOR = 0x7fffffff;
// counts and AND words stay in shared memory up to this row width
constexpr int SMEM_WORDS_MAX = 256;
// dynamic shared memory of kernel 1: two blocks of 512 threads an SM
constexpr int SMEM_BUDGET = 100 * 1024;
// bit planes of the carry-save counters: up to 255 words a lane, flushed
// every FLUSH_TILES additions of four
constexpr int PLANES = 8;
constexpr int FLUSH_TILES = ((1 << PLANES) - 1) / 4;
constexpr int MAX_H = 32;  // rows a k-mer in the gather modes (the wrapper checks)

enum Mode : int {
  MODE_WORDS = 0,   // the AND words [N, W] and presence given
  MODE_ROWS32 = 1,  // the rows int32 [N, H]: gathered, ANDed and tested here
  MODE_ROWS64 = 2,  // the rows int64 [N, H]
};

template <int MODE>
struct RowType {
  using T = int32_t;
};
template <>
struct RowType<MODE_ROWS64> {
  using T = int64_t;
};

struct Params {
  const uint32_t* words;   // [N, W] AND words (MODE_WORDS)
  const uint8_t* present;  // [N] (MODE_WORDS)
  const void* rows;        // [N, H] (the gather modes)
  int32_t H;
  RowGeo geo;              // the matrix (the gather modes)
  const uint8_t* mask;     // [N]
  const int32_t* q;        // [N]
  const int32_t* gidx;     // [N] or nullptr
  int64_t base_idx;
  int64_t N;
  int64_t n_tiles;
  int64_t capO;
  int32_t W;
  int32_t C;
  int32_t vec;  // W = 1 rows load four at a time as vectors
  int32_t lg;   // W > 1: log2 of the lanes that take a row
  int32_t* stats;
  int32_t* hist;
  int32_t* over_col;
  int32_t* over_freq;
  int32_t* big;  // [2 + n_tiles]: total big rows, blocks done, big rows per tile
  int32_t* bigcol;  // [N]: rows with mask and q >= FREQ_CAP: color if uniq, else -1
};

// the bits of word w that hold colors below C
__device__ __forceinline__ uint32_t cmask_of(int C, int w) {
  const int r = C - 32 * w;
  return r >= 32 ? FULL : r <= 0 ? 0u : (1u << r) - 1u;
}

// The RPT1 W = 1 rows of a thread from i0: word, frequency, mask and
// presence; rows at or past N are masked out. The gather modes read each
// row's H words from the matrix here, every load of the thread's rows in
// flight before any is used, and AND them.
template <int MODE>
__device__ __forceinline__ void load_rows(const Params& p, int64_t i0, uint32_t (&x)[RPT1],
                                          int (&q)[RPT1], bool (&mk)[RPT1], bool (&pr)[RPT1]) {
  if (p.vec && i0 + RPT1 <= p.N) {
#pragma unroll
    for (int v = 0; v < RPT1; v += 4) {
      const int4 qq = *reinterpret_cast<const int4*>(p.q + i0 + v);
      const uchar4 m = *reinterpret_cast<const uchar4*>(p.mask + i0 + v);
      q[v] = qq.x, q[v + 1] = qq.y, q[v + 2] = qq.z, q[v + 3] = qq.w;
      mk[v] = m.x, mk[v + 1] = m.y, mk[v + 2] = m.z, mk[v + 3] = m.w;
      if constexpr (MODE == MODE_WORDS) {
        const uint4 w = *reinterpret_cast<const uint4*>(p.words + i0 + v);
        const uchar4 pp = *reinterpret_cast<const uchar4*>(p.present + i0 + v);
        x[v] = w.x, x[v + 1] = w.y, x[v + 2] = w.z, x[v + 3] = w.w;
        pr[v] = pp.x, pr[v + 1] = pp.y, pr[v + 2] = pp.z, pr[v + 3] = pp.w;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPT1; ++r) {
      const int64_t i = i0 + r;
      const bool in = i < p.N;
      q[r] = in ? p.q[i] : 0;
      mk[r] = in && p.mask[i];
      if constexpr (MODE == MODE_WORDS) {
        x[r] = in ? p.words[i] : 0u;
        pr[r] = !in || p.present[i];
      }
    }
  }
  if constexpr (MODE != MODE_WORDS) {
    using RowT = typename RowType<MODE>::T;
    const RowT* rows = static_cast<const RowT*>(p.rows);
    uint32_t nz[RPT1];
#pragma unroll
    for (int r = 0; r < RPT1; ++r) x[r] = ~0u, nz[r] = 0;
    for (int h0 = 0; h0 < p.H; h0 += 4) {
      const int n = p.H - h0 < 4 ? p.H - h0 : 4;
#pragma unroll
      for (int r = 0; r < RPT1; ++r) {
        const bool in = i0 + r < p.N;
        const RowT* ri = rows + (in ? i0 + r : 0) * p.H;
        int64_t off[4];
        row_starts<RowT, 4>(p.geo, ri + h0, in ? n : 0, in ? (int64_t)ri[0] : 0, off);
        uint32_t z = 0;
        x[r] &= and_word<ROW_LOAD_L2, 4>(p.geo, off, in ? n : 0, 0, z);
        nz[r] |= (z & ((1u << n) - 1u)) << h0;
      }
    }
#pragma unroll
    for (int r = 0; r < RPT1; ++r) {
      const bool in = i0 + r < p.N;
      pr[r] = !in || rows_present(nz[r], p.H);
      x[r] = in ? x[r] : 0u;
    }
  }
}

// Adds four words x[0..3] into the bit planes (bit c of plane k: bit k of
// the number of words with bit c set): a full adder and two half adders
// make the 3-bit per-bit sum of the four, which ripples into the planes.
__device__ __forceinline__ void planes_add4(uint32_t (&P)[PLANES], const uint32_t* x) {
  const uint32_t sa = x[0] ^ x[1] ^ x[2];
  const uint32_t ca = (x[0] & x[1]) | (x[2] & (x[0] ^ x[1]));
  const uint32_t s0 = sa ^ x[3], cb = sa & x[3];
  const uint32_t s1 = ca ^ cb, s2 = ca & cb;
  uint32_t c = P[0] & s0;
  P[0] ^= s0;
  uint32_t t = P[1] ^ s1 ^ c;
  c = (P[1] & s1) | (c & (P[1] ^ s1));
  P[1] = t;
  t = P[2] ^ s2 ^ c;
  c = (P[2] & s2) | (c & (P[2] ^ s2));
  P[2] = t;
#pragma unroll
  for (int k = 3; k < PLANES; ++k) {
    t = P[k] & c;
    P[k] ^= c;
    c = t;
  }
}

// Folds the warp's bit planes into counts and clears them: for each bit b
// set in any lane's planes, the lanes of class `cls` (the lanes that count
// the same word) sum their counts by ballots, and the `owner` of the class
// adds the sum to cnt[b]. At W 1 every lane is one class and lane b owns
// color b.
__device__ __forceinline__ void planes_flush(uint32_t (&P)[PLANES], int* cnt, unsigned cls,
                                             bool owner) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < PLANES; ++k) any |= P[k];
  any = __reduce_or_sync(FULL, any);
  while (any) {
    const int b = __ffs(any) - 1;
    any &= any - 1;
    int c = 0;
#pragma unroll
    for (int k = 0; k < PLANES; ++k) c += __popc(__ballot_sync(FULL, (P[k] >> b) & 1u) & cls) << k;
    if (owner && c) atomicAdd(cnt + b, c);
  }
#pragma unroll
  for (int k = 0; k < PLANES; ++k) P[k] = 0;
}

// One histogram add for each lane with `small`: in shared memory below hf,
// else in the global one. FOLD: the lanes of one bin are first folded into
// one add (measured faster for rows of several words, slower at W 1).
template <bool FOLD>
__device__ __forceinline__ void hist_add(const Params& p, int* s_hist, int hf, int lane,
                                         bool small, int col, int q) {
  const unsigned sm = __ballot_sync(FULL, small);
  if (!sm || !small) return;
  const int qq = q < 0 ? 0 : q;
  int n = 1;
  if constexpr (FOLD) {
    const unsigned same = __match_any_sync(sm, col * FREQ_CAP + qq);
    if (lane != __ffs(same) - 1) return;
    n = __popc(same);
  }
  if (qq < hf)
    atomicAdd(&s_hist[col * hf + qq], n);
  else
    atomicAdd(&p.hist[col * FREQ_CAP + qq], n);
}

// Row i's color for kernel 2 where it has mask and q >= FREQ_CAP: its
// color if uniq, else -1 (the other rows' entries are never read).
__device__ __forceinline__ void put_big(const Params& p, int64_t i, bool mk, int q, bool uniq,
                                        int col) {
  if (mk && q >= FREQ_CAP) p.bigcol[i] = uniq ? col : -1;
}

// A warp's big rows of tile t, added to the tile's count and the total.
__device__ __forceinline__ void count_big(const Params& p, int64_t t, int nbig, int lane) {
  const int wb = __reduce_add_sync(FULL, nbig);
  if (lane == 0 && wb) {
    atomicAdd(&p.big[2 + t], wb);
    atomicAdd(&p.big[0], wb);
  }
}

// Kernel 1's shared memory: the block's counts and AND words (where
// smem_words; else the global ones) and the histogram band [C, hf].
struct BlockAcc {
  int* cnt;
  int* andp;
  int* s_hist;
};

__device__ __forceinline__ BlockAcc block_begin(const Params& p, int* smem, int hf,
                                                int smem_words, int* s_bad) {
  const int W = p.W;
  BlockAcc b;
  int* s_cnt = smem;                              // [32 * W] when smem_words
  int* s_and = smem + (smem_words ? 32 * W : 0);  // [W] when smem_words
  b.s_hist = s_and + (smem_words ? W : 0);        // [C, hf]
  b.cnt = smem_words ? s_cnt : p.stats;
  b.andp = smem_words ? s_and : p.stats + p.C;
  if (smem_words) {
    for (int j = threadIdx.x; j < 32 * W; j += THREADS) s_cnt[j] = 0;
    for (int j = threadIdx.x; j < W; j += THREADS) s_and[j] = -1;
  }
  for (int j = threadIdx.x; j < p.C * hf; j += THREADS) b.s_hist[j] = 0;
  if (threadIdx.x == 0) *s_bad = 0;
  __syncthreads();
  return b;
}

// The block's all-valid flag, counts, AND words and histogram band, flushed.
__device__ __forceinline__ void block_end(const Params& p, const BlockAcc& b, int hf,
                                          int smem_words, bool bad, int* s_bad) {
  if (bad) *s_bad = 1;
  __syncthreads();
  if (threadIdx.x == 0 && *s_bad) p.stats[p.C + p.W] = 0;
  if (smem_words) {
    for (int j = threadIdx.x; j < p.C; j += THREADS)
      if (b.cnt[j]) atomicAdd(&p.stats[j], b.cnt[j]);
    for (int j = threadIdx.x; j < p.W; j += THREADS)
      if (b.andp[j] != -1) atomicAnd(&p.stats[p.C + j], b.andp[j]);
  }
  for (int j = threadIdx.x; j < p.C * hf; j += THREADS)
    if (b.s_hist[j]) atomicAdd(&p.hist[(j / hf) * FREQ_CAP + j % hf], b.s_hist[j]);
}

// Kernel 1 at W 1: counts, AND, all-valid flag, histogram, big rows per tile.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) epilogue_w1_kernel(Params p, int hf, int smem_words) {
  extern __shared__ int smem[];
  __shared__ int s_bad;
  const BlockAcc acc = block_begin(p, smem, hf, smem_words, &s_bad);
  const int lane = threadIdx.x & 31;
  constexpr int TILE = THREADS * RPT1;
  bool bad = false;  // a real row that lacks one of its rows
  uint32_t P[PLANES] = {};
  uint32_t my_and = FULL;  // the AND over this thread's valid rows
  const uint32_t cm0 = cmask_of(p.C, 0);
  int since = 0;
  for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    uint32_t x[RPT1];
    int q[RPT1];
    bool mk[RPT1], pr[RPT1];
    const int64_t i0 = t * TILE + threadIdx.x * RPT1;
    load_rows<MODE>(p, i0, x, q, mk, pr);
    uint32_t xc[RPT1];
#pragma unroll
    for (int r = 0; r < RPT1; ++r) {
      const bool valid = mk[r] && pr[r];
      bad = bad || (mk[r] && !pr[r]);
      my_and &= valid ? x[r] : FULL;
      xc[r] = valid ? x[r] & cm0 : 0u;
    }
#pragma unroll
    for (int v = 0; v < RPT1; v += 4) planes_add4(P, xc + v);
    int nbig = 0;
#pragma unroll
    for (int r = 0; r < RPT1; ++r) {
      const bool uniq = xc[r] != 0 && (xc[r] & (xc[r] - 1)) == 0;
      hist_add<false>(p, acc.s_hist, hf, lane, uniq && q[r] < FREQ_CAP, __ffs(xc[r]) - 1, q[r]);
      put_big(p, i0 + r, mk[r], q[r], uniq, __ffs(xc[r]) - 1);
      nbig += uniq && q[r] >= FREQ_CAP;
    }
    count_big(p, t, nbig, lane);
    if (++since == FLUSH_TILES * 4 / RPT1) {
      planes_flush(P, acc.cnt, 1u << lane, true);
      since = 0;
    }
  }
  planes_flush(P, acc.cnt, 1u << lane, true);
  const uint32_t a = __reduce_and_sync(FULL, my_and);
  if (lane == 0 && a != FULL) atomicAnd(&acc.andp[0], (int)a);
  block_end(p, acc, hf, smem_words, bad, &s_bad);
}

// The gather modes at W > 1: words wj[pc] of the U rows i[u] that a lane
// group takes in a loop iteration (row u is lane src0 + u's own row), all
// their loads in flight before any is used; x the words of the AND of each
// row's H rows, pr its presence (the OR of the group's nonzero-row bits
// holds every row). The first four rows' starts come from the lane whose
// row it is (st, placed once a tile), a shuffle each; any further rows
// are placed here.
template <int MODE, int NP, int U>
__device__ __forceinline__ void gather_group(const Params& p, const int64_t (&i)[U],
                                             const bool (&act)[U], const int (&wj)[NP],
                                             int src0, unsigned gmask, const int64_t (&st)[4],
                                             uint32_t (&x)[U][NP], bool (&pr)[U]) {
  using RowT = typename RowType<MODE>::T;
  const RowT* rows = static_cast<const RowT*>(p.rows);
  const int n0 = p.H < 4 ? p.H : 4;
  uint32_t nz[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int64_t off[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) off[h] = __shfl_sync(FULL, st[h], (src0 + u) & 31);
    nz[u] = 0;
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
      const bool live = act[u] && wj[pc] < p.W;
      uint32_t z = 0;
      x[u][pc] = and_word<ROW_LOAD_L2, 4>(p.geo, off, live ? n0 : 0, wj[pc], z);
      if (live) nz[u] |= z & ((1u << n0) - 1u);
    }
  }
  for (int h0 = 4; h0 < p.H; h0 += 4) {
    const int n = p.H - h0 < 4 ? p.H - h0 : 4;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int nr = act[u] ? n : 0;
      const RowT* ri = rows + (act[u] ? i[u] : 0) * p.H;
      int64_t off[4];
      row_starts<RowT, 4>(p.geo, ri + h0, nr, nr ? (int64_t)ri[0] : 0, off);
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        const bool live = wj[pc] < p.W;
        uint32_t z = 0;
        x[u][pc] &= and_word<ROW_LOAD_L2, 4>(p.geo, off, live ? nr : 0, wj[pc], z);
        if (live) nz[u] |= (z & ((1u << n) - 1u)) << h0;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    pr[u] = !act[u] || rows_present(__reduce_or_sync(gmask, nz[u]), p.H);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
      if (!act[u] || wj[pc] >= p.W) x[u][pc] = 0u;
  }
}

// Kernel 1 at W > 1. NP > 0: a group of G = 2^lg lanes (the power of two
// from W up to 32) takes a row a step, and lane j of the group owns word j
// (NP = 1) or words j, j + 32, ... (NP pieces of 32 words, W up to 128): a
// warp step reads 32 / G whole rows. Each lane keeps its words' counts in
// bit planes and their AND in registers; nh and the first color are
// reductions within the group (at G < 32 two ballots and a shuffle for the
// step's 32 / G rows at once), kept by the lane whose row it is, and the
// per-row rest (mask, frequency, presence flag, histogram, big rows) runs
// once for 32 rows, a row a lane; the planes fold into the counts every
// FLUSH_TILES steps of four. NP = 0 (the
// wide tier, W > 128): the warp takes a row at a time, a 32-word piece of
// it at a time, and adds each color bit to the counts.
template <int MODE, int NP>
__global__ void __launch_bounds__(THREADS, NP == 1 ? 2 : 1)
    epilogue_wide_kernel(Params p, int hf, int smem_words) {
  extern __shared__ int smem[];
  __shared__ int s_bad;
  const BlockAcc acc = block_begin(p, smem, hf, smem_words, &s_bad);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  using RowT = typename RowType<MODE>::T;
  const RowT* rows = static_cast<const RowT*>(p.rows);
  bool bad = false;  // a real row that lacks one of its rows
  if constexpr (NP > 0) {
    constexpr int U = 4;  // rows a group takes in a loop iteration (a multiple of 4)
    // group g0 / G of the warp takes the warp's rows g0 .. g0 + G - 1 of a
    // tile, one a step; lane l keeps row l's frequency, mask and presence,
    // and its nh and color from the step its group took it
    const int G = 1 << p.lg;
    const int j = lane & (G - 1), g0 = lane & ~(G - 1);
    const unsigned gbits = G == 32 ? FULL : (1u << G) - 1u;
    const unsigned gmask = gbits << g0;
    unsigned cls = 1;  // lanes j, j + G, j + 2G, ...: the lanes of word j
    for (int s = G; s < 32; s <<= 1) cls |= cls << s;
    cls <<= j;
    int wj[NP];
    uint32_t cm[NP], my_and[NP], P[NP][PLANES];
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
      wj[pc] = 32 * pc + j;
      cm[pc] = cmask_of(p.C, wj[pc]);
      my_and[pc] = FULL;
#pragma unroll
      for (int k = 0; k < PLANES; ++k) P[pc][k] = 0;
    }
    int since = 0;
    for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const int64_t base = t * THREADS + warp * 32;
      const int64_t il = base + lane;
      const bool in = il < p.N;
      const bool mk = in && p.mask[il];
      const int q = in ? p.q[il] : 0;
      bool pr = !in || MODE != MODE_WORDS || p.present[il];
      const unsigned mk_bits = __ballot_sync(FULL, mk);
      const unsigned pr_bits = __ballot_sync(FULL, pr);
      int64_t st[4] = {0, 0, 0, 0};  // the gather modes: the starts of row il's first rows
      if constexpr (MODE != MODE_WORDS) {
        if (in) {
          const RowT* ri = rows + il * p.H;
          row_starts<RowT, 4>(p.geo, ri, p.H < 4 ? p.H : 4, (int64_t)ri[0], st);
        }
      }
      int nh = 0, col = NO_COLOR;
      for (int s0 = 0; s0 < G; s0 += U) {
        int64_t i[U];
        bool act[U], prs[U];
        uint32_t x[U][NP];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          i[u] = base + g0 + s0 + u;
          act[u] = s0 + u < G && i[u] < p.N;
        }
        if constexpr (MODE == MODE_WORDS) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            prs[u] = (pr_bits >> ((g0 + s0 + u) & 31)) & 1u;
#pragma unroll
            for (int pc = 0; pc < NP; ++pc)
              x[u][pc] = act[u] && wj[pc] < p.W ? p.words[i[u] * p.W + wj[pc]] : 0u;
          }
        } else {
          gather_group<MODE, NP, U>(p, i, act, wj, g0 + s0, gmask, st, x, prs);
        }
        uint32_t xc[NP][U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool valid = act[u] && ((mk_bits >> ((g0 + s0 + u) & 31)) & 1u) && prs[u];
          int n = 0, c0 = NO_COLOR;
#pragma unroll
          for (int pc = 0; pc < NP; ++pc) {
            my_and[pc] &= valid ? x[u][pc] : FULL;
            const uint32_t c = valid ? x[u][pc] & cm[pc] : 0u;
            xc[pc][u] = c;
            if (c && c0 == NO_COLOR) c0 = 32 * wj[pc] + __ffs(c) - 1;
            n += __popc(c);
          }
          if (G == 32) {  // one row a step: two reductions
            n = __reduce_add_sync(FULL, n);
            c0 = __reduce_min_sync(FULL, c0);
          } else {  // 32 / G rows a step: two ballots serve them all
            const unsigned nz = (__ballot_sync(FULL, n != 0) >> g0) & gbits;
            const unsigned multi = (__ballot_sync(FULL, n > 1) >> g0) & gbits;
            c0 = __shfl_sync(FULL, c0, nz ? g0 + __ffs(nz) - 1 : lane);
            n = !nz ? 0 : (nz & (nz - 1)) || multi ? 2 : 1;  // 2: more than one
          }
          if (j == s0 + u) {
            nh = n;
            col = c0;
            pr = pr && prs[u];
          }
        }
#pragma unroll
        for (int pc = 0; pc < NP; ++pc)
#pragma unroll
          for (int v = 0; v < U; v += 4) planes_add4(P[pc], xc[pc] + v);
        if ((since += U / 4) > FLUSH_TILES - U / 4) {
#pragma unroll
          for (int pc = 0; pc < NP; ++pc)
            planes_flush(P[pc], acc.cnt + 32 * wj[pc], cls, g0 == 0 && wj[pc] < p.W);
          since = 0;
        }
      }
      const bool uniq = mk && pr && nh == 1;
      bad = bad || (mk && !pr);
      hist_add<true>(p, acc.s_hist, hf, lane, uniq && q < FREQ_CAP, col, q);
      put_big(p, il, mk, q, uniq, col);
      count_big(p, t, uniq && q >= FREQ_CAP, lane);
    }
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
      planes_flush(P[pc], acc.cnt + 32 * wj[pc], cls, g0 == 0 && wj[pc] < p.W);
      uint32_t a = my_and[pc];  // folded over the lanes of word wj[pc]
      for (int o = G; o < 32; o <<= 1) a &= __shfl_xor_sync(FULL, a, o);
      if (g0 == 0 && wj[pc] < p.W && a != FULL) atomicAnd(&acc.andp[wj[pc]], (int)a);
    }
  } else {
    const int n_pc = (p.W + 31) >> 5;
    for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const int64_t base = t * THREADS + warp * 32;
      // lane s keeps row base + s's frequency, mask, presence, nh and color
      const int64_t im = base + lane;
      const bool in = im < p.N;
      const bool mk = in && p.mask[im];
      const int q = in ? p.q[im] : 0;
      bool pr = true;
      if constexpr (MODE == MODE_WORDS) {
        pr = !in || p.present[im];
      } else {
        for (int s = 0; s < 32 && base + s < p.N; ++s) {
          const RowT* ri = rows + (base + s) * p.H;
          const int64_t r0 = (int64_t)ri[0];
          uint32_t nz = 0;
          for (int pc = 0; pc < n_pc; ++pc)
            if (32 * pc + lane < p.W) kmer_word<ROW_LOAD_L2>(p.geo, ri, p.H, r0, 32 * pc + lane, nz);
          const bool ok = rows_present(__reduce_or_sync(FULL, nz), p.H);
          if (lane == s) pr = ok;
        }
      }
      const bool valid = mk && pr;
      bad = bad || (mk && !pr);
      const unsigned vmask = __ballot_sync(FULL, valid);
      int nh = 0, col = NO_COLOR;
      for (int pc = 0; pc < n_pc; ++pc) {
        const int w = 32 * pc + lane;
        const bool live = w < p.W;
        const uint32_t cm = cmask_of(p.C, w);
        uint32_t a = FULL;
        for (unsigned v = vmask; v; v &= v - 1) {
          const int s = __ffs(v) - 1;
          const int64_t i = base + s;
          uint32_t x = 0;
          if (live) {
            if constexpr (MODE == MODE_WORDS) {
              x = p.words[i * p.W + w];
            } else {
              const RowT* ri = rows + i * p.H;
              uint32_t z = 0;
              x = kmer_word<ROW_LOAD_L2>(p.geo, ri, p.H, (int64_t)ri[0], w, z);
            }
          }
          a &= x;
          uint32_t xc = x & cm;
          const int rn = __reduce_add_sync(FULL, __popc(xc));
          const int rc = __reduce_min_sync(FULL, xc ? 32 * w + __ffs(xc) - 1 : NO_COLOR);
          if (lane == s) {
            nh += rn;
            col = rc < col ? rc : col;
          }
          while (xc) {
            atomicAdd(&acc.cnt[32 * w + __ffs(xc) - 1], 1);
            xc &= xc - 1;
          }
        }
        if (live && a != FULL) atomicAnd(&acc.andp[w], (int)a);
      }
      const bool uniq = valid && nh == 1;
      hist_add<true>(p, acc.s_hist, hf, lane, uniq && q < FREQ_CAP, col, q);
      put_big(p, im, mk, q, uniq, col);
      count_big(p, t, uniq && q >= FREQ_CAP, lane);
    }
  }
  block_end(p, acc, hf, smem_words, bad, &s_bad);
}

// Whether row i is big (valid, uniq with q >= FREQ_CAP), and its color,
// as kernel 1 left them.
__device__ __forceinline__ bool row_big(const Params& p, int64_t i, int& col) {
  if (i >= p.N || !p.mask[i] || p.q[i] < FREQ_CAP) return false;
  col = p.bigcol[i];
  return col >= 0;
}

// Kernel 2: the big rows, in k-mer order, added to their slots below capO;
// the last block to finish advances n_over by the total. Block b takes a
// contiguous range of tiles and starts at n_over plus the big rows of the
// tiles before it.
template <bool W1>
__global__ void __launch_bounds__(THREADS) epilogue_overflow_kernel(Params p) {
  constexpr int RPT = W1 ? RPT1 : 1;
  constexpr int TILE = THREADS * RPT;
  __shared__ long long s_red[WARPS];
  __shared__ long long s_first;
  const int total = p.big[0];
  if (total == 0) return;  // the same for every block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* n_over = p.stats + p.C + p.W + 1;
  const int64_t per = (p.n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t lo = min((int64_t)blockIdx.x * per, p.n_tiles);
  const int64_t hi = min(lo + per, p.n_tiles);
  int s = 0;
  for (int64_t j = threadIdx.x; j < lo; j += THREADS) s += p.big[2 + j];
  s = (int)__reduce_add_sync(FULL, (unsigned)s);
  if (lane == 0) s_red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long before = 0;
    for (int w = 0; w < WARPS; ++w) before += s_red[w];
    s_first = (long long)*n_over + before;
  }
  __syncthreads();
  long long first = s_first;  // n_over before this batch plus the tiles before lo
  for (int64_t t = lo; t < hi && first < p.capO; ++t) {
    const int nb = p.big[2 + t];  // the same for the whole block
    if (nb == 0) continue;
    int col[RPT];
    bool bg[RPT];
    int n = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      bg[r] = row_big(p, t * TILE + threadIdx.x * RPT + r, col[r]);
      n += bg[r];
    }
    int incl = n;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    __syncthreads();  // the previous tile's s_red reads are done
    if (lane == 31) s_red[warp] = incl;
    __syncthreads();
    long long slot = first + incl - n;
    for (int w = 0; w < warp; ++w) slot += s_red[w];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (!bg[r]) continue;
      if (slot < p.capO) {
        const int64_t i = t * TILE + threadIdx.x * RPT + r;
        p.over_col[slot] += col[r];
        p.over_freq[slot] += p.gidx ? p.gidx[i] : (int32_t)(uint32_t)(uint64_t)(p.base_idx + i);
      }
      ++slot;
    }
    first += nb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // every block read n_over before it counts itself done
    __threadfence();
    if (atomicAdd(&p.big[1], 1) == (int)gridDim.x - 1)
      *n_over = (int32_t)(uint32_t)((long long)*n_over + total);
  }
}

template <int MODE>
int launch(Params p, cudaStream_t st) {
  const bool w1 = p.W == 1;
  const int tile = THREADS * (w1 ? RPT1 : 1);
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.n_tiles = (p.N + tile - 1) / tile;
  p.vec = w1 && (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.mask % 4 == 0 &&
          (MODE != MODE_WORDS ||
           ((uintptr_t)p.words % 16 == 0 && (uintptr_t)p.present % 4 == 0));
  p.lg = 0;
  while (!w1 && p.lg < 5 && (1 << p.lg) < p.W) ++p.lg;
  const int smem_words = p.W <= SMEM_WORDS_MAX;
  const size_t words_bytes = smem_words ? (size_t)33 * p.W * 4 : 0;
  int hf = FREQ_CAP;
  while (hf > 1 && words_bytes + (size_t)p.C * hf * 4 > SMEM_BUDGET) hf >>= 1;
  if (words_bytes + (size_t)p.C * hf * 4 > SMEM_BUDGET) hf = 0;
  const size_t dyn = words_bytes + (size_t)p.C * hf * 4;
  void (*k1)(Params, int, int) = w1            ? epilogue_w1_kernel<MODE>
                                 : p.W <= 32  ? epilogue_wide_kernel<MODE, 1>
                                 : p.W <= 64  ? epilogue_wide_kernel<MODE, 2>
                                 : p.W <= 128 ? epilogue_wide_kernel<MODE, 4>
                                              : epilogue_wide_kernel<MODE, 0>;
  cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1, THREADS, dyn);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if ((e = cudaMemsetAsync(p.big, 0, (size_t)(2 + p.n_tiles) * 4, st)) != cudaSuccess)
    return (int)e;
  const int64_t g1 = p.n_tiles < (int64_t)per_sm * sms ? p.n_tiles : (int64_t)per_sm * sms;
  k1<<<(unsigned)g1, THREADS, dyn, st>>>(p, hf, smem_words);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t g2 = p.n_tiles < (int64_t)4 * sms ? p.n_tiles : (int64_t)4 * sms;
  if (w1)
    epilogue_overflow_kernel<true><<<(unsigned)g2, THREADS, 0, st>>>(p);
  else
    epilogue_overflow_kernel<false><<<(unsigned)g2, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The accumulators and per-k-mer inputs that every mode takes.
Params params(const void* mask, const void* q, const void* gidx, int64_t base_idx, int64_t N,
              int32_t W, int32_t C, void* stats, void* hist, void* over_col, void* over_freq,
              int64_t capO, void* scratch) {
  Params p{};
  p.mask = (const uint8_t*)mask;
  p.q = (const int32_t*)q;
  p.gidx = (const int32_t*)gidx;
  p.base_idx = base_idx;
  p.N = N;
  p.capO = capO;
  p.W = W;
  p.C = C;
  p.stats = (int32_t*)stats;
  p.hist = (int32_t*)hist;
  p.over_col = (int32_t*)over_col;
  p.over_freq = (int32_t*)over_freq;
  p.big = (int32_t*)scratch;
  p.bigcol = p.big + 2 + (N + THREADS - 1) / THREADS;
  return p;
}

int run(const void* words, const void* present, const void* mask, const void* q,
        const void* gidx, int64_t base_idx, int64_t N, int32_t W, int32_t C, void* stats,
        void* hist, void* over_col, void* over_freq, int64_t capO, void* scratch,
        cudaStream_t st) {
  Params p = params(mask, q, gidx, base_idx, N, W, C, stats, hist, over_col, over_freq, capO,
                    scratch);
  p.words = (const uint32_t*)words;
  p.present = (const uint8_t*)present;
  return launch<MODE_WORDS>(p, st);
}

struct SortedParams {
  const int4* words_s;     // [P / 4]
  const int4* row_s;       // [P / 4]
  const longlong2* gidx_s;  // [P / 2]
  const int32_t* tb;       // [P >> pc_log2]
  const uint8_t* reread;   // [P >> pc_log2]
  const uint32_t* blocks;  // [n_words]
  int64_t n_words;
  int64_t P;
  int64_t tile_rows;
  int32_t nt;
  int32_t pc_log2;
  int32_t H;
  int64_t klo, khi;  // this pass's k-mers
  uint32_t* acc;     // [P / H], all ones on entry
  uint8_t* present;  // [P / H], all 1 on entry
};

// One probe of a k-mer of this pass: its word (read again from the matrix
// where it lies outside its chunk's window in a chunk that rereads), ANDed
// into its k-mer's word.
template <int HS>
__device__ __forceinline__ void put(const SortedParams& p, int32_t row, int32_t word, int64_t g,
                                    bool rr, int64_t lo, int64_t hi) {
  const int64_t k = HS >= 0 ? g >> HS : g / p.H;
  if (k < p.klo || k >= p.khi) return;
  uint32_t x = (uint32_t)word;
  if (rr && (row < lo || row >= hi) && row >= 0 && row < p.n_words) x = p.blocks[row];
  atomicAnd(p.acc + k, x);
  if (x == 0) p.present[k] = 0;
}

// The sorted mode's first pass over the probes of the k-mers in [klo, khi):
// four probes a thread (one chunk holds all four: pc is a multiple of 4).
// HS: log2 H for H 1, 2, 4; -1 divides.
template <int HS>
__global__ void __launch_bounds__(THREADS) epilogue_sorted_kernel(SortedParams p) {
  const int64_t n4 = p.P / 4;
  for (int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x; g < n4;
       g += (int64_t)gridDim.x * THREADS) {
    const int4 r = __ldcs(p.row_s + g);
    const int4 w = __ldcs(p.words_s + g);
    const longlong2 g01 = __ldcs(p.gidx_s + 2 * g);
    const longlong2 g23 = __ldcs(p.gidx_s + 2 * g + 1);
    const int64_t c = (4 * g) >> p.pc_log2;
    const bool rr = p.reread[c] != 0;
    const int64_t lo = (int64_t)p.tb[c] * p.tile_rows, hi = lo + p.nt * p.tile_rows;
    put<HS>(p, r.x, w.x, g01.x, rr, lo, hi);
    put<HS>(p, r.y, w.y, g01.y, rr, lo, hi);
    put<HS>(p, r.z, w.z, g23.x, rr, lo, hi);
    put<HS>(p, r.w, w.w, g23.y, rr, lo, hi);
  }
}

}  // namespace

// The AND-words mode. words: [N, W] int32 AND words; present, mask [N]
// bool; q, gidx (or nullptr) [N] int32; stats [C + W + 2], hist [C, 1024],
// over_col / over_freq [capO] int32, all contiguous; scratch: 2 + ceil(N /
// 512) + N int32. N == 0 launches nothing.
extern "C" int epilogue_launch(const void* words, const void* present, const void* mask,
                               const void* q, const void* gidx, int64_t base_idx, int64_t N,
                               int32_t W, int32_t C, void* stats, void* hist, void* over_col,
                               void* over_freq, int64_t capO, void* scratch, void* stream) {
  if (N < 0 || W < 1 || C < 0 || C > 32 * W || capO < 0 || present == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return run(words, present, mask, q, gidx, base_idx, N, W, C, stats, hist, over_col,
             over_freq, capO, scratch, (cudaStream_t)stream);
}

// The gather mode. rows [N, H] (int64 where rows64; 1 <= H <= 32), the
// matrix blocks [n_words] int32 of rows of wpad words, rpb 0 (classic rows)
// or a power of two (blocked: a k-mer's rows share the block of its hash-0
// row); the rest as for epilogue_launch with W = wpad. N == 0 launches
// nothing.
extern "C" int epilogue_gather_launch(const void* rows, int32_t rows64, int64_t N, int32_t H,
                                      const void* blocks, int64_t n_words, int32_t wpad,
                                      int64_t rpb, const void* mask, const void* q,
                                      const void* gidx, int64_t base_idx, int32_t C,
                                      void* stats, void* hist, void* over_col, void* over_freq,
                                      int64_t capO, void* scratch, void* stream) {
  if (N < 0 || H < 1 || H > MAX_H || wpad < 1 || rpb < 0 || (rpb & (rpb - 1)) || C < 0 ||
      C > 32 * wpad || capO < 0 || rows == nullptr || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Params p = params(mask, q, gidx, base_idx, N, wpad, C, stats, hist, over_col, over_freq, capO,
                    scratch);
  p.rows = rows;
  p.H = H;
  p.geo.blocks = (const uint32_t*)blocks;
  p.geo.n_words = n_words;
  p.geo.wpad = wpad;
  p.geo.rpb = rpb;
  while (rpb > 1 && (1ll << p.geo.rpb_log2) < rpb) ++p.geo.rpb_log2;
  const cudaStream_t st = (cudaStream_t)stream;
  return rows64 ? launch<MODE_ROWS64>(p, st) : launch<MODE_ROWS32>(p, st);
}

// The sorted-words mode. words_s, row_s [P] int32 and gidx_s [P] int64,
// 16-byte aligned; tb int32 and reread bool [P >> pc_log2], pc_log2 >= 2;
// blocks [n_words] int32 (the matrix); acc int32 and present bool [P / H]
// (scratch, filled here); mask bool, q and gidx (or nullptr) int32 [P / H];
// C <= 32; the accumulators and scratch as for epilogue_launch with N = P /
// H. P == 0 launches nothing.
extern "C" int epilogue_sorted_launch(const void* words_s, const void* row_s, const void* gidx_s,
                                      int64_t P, const void* tb, const void* reread,
                                      int32_t pc_log2, int64_t tile_rows, int32_t nt,
                                      const void* blocks, int64_t n_words, int32_t H,
                                      void* acc, void* present, const void* mask, const void* q,
                                      const void* gidx, int64_t base_idx, int32_t C, void* stats,
                                      void* hist, void* over_col, void* over_freq, int64_t capO,
                                      void* scratch, void* stream) {
  if (P < 0 || H < 1 || P % H || P % 4 || pc_log2 < 2 || (P & ((1LL << pc_log2) - 1)) ||
      C < 0 || C > 32 || capO < 0 || tile_rows < 1 || nt < 1)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int64_t N = P / H;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0xff, (size_t)N * 4, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(present, 1, (size_t)N, st);
  if (e != cudaSuccess) return (int)e;
  SortedParams s{};
  s.words_s = (const int4*)words_s;
  s.row_s = (const int4*)row_s;
  s.gidx_s = (const longlong2*)gidx_s;
  s.tb = (const int32_t*)tb;
  s.reread = (const uint8_t*)reread;
  s.blocks = (const uint32_t*)blocks;
  s.n_words = n_words;
  s.P = P;
  s.tile_rows = tile_rows;
  s.nt = nt;
  s.pc_log2 = pc_log2;
  s.H = H;
  s.acc = (uint32_t*)acc;
  s.present = (uint8_t*)present;
  const int64_t n4 = P / 4;
  const unsigned grid = (unsigned)((n4 + THREADS - 1) / THREADS);
  // The atomics resolve in L2 only while a pass's per-k-mer words and
  // presence bytes (5 bytes a k-mer) fit about half of it; beyond, the
  // probes are read once for each range of k-mers that does.
  int dev, l2;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  const int64_t per_pass = l2 / 2 / 5 > 0 ? l2 / 2 / 5 : 1;
  const int64_t n_pass = (N + per_pass - 1) / per_pass;
  for (int64_t k = 0; k < n_pass; ++k) {
    s.klo = N * k / n_pass;
    s.khi = N * (k + 1) / n_pass;
    switch (H) {
      case 1:
        epilogue_sorted_kernel<0><<<grid, THREADS, 0, st>>>(s);
        break;
      case 2:
        epilogue_sorted_kernel<1><<<grid, THREADS, 0, st>>>(s);
        break;
      case 4:
        epilogue_sorted_kernel<2><<<grid, THREADS, 0, st>>>(s);
        break;
      default:
        epilogue_sorted_kernel<-1><<<grid, THREADS, 0, st>>>(s);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return run(acc, present, mask, q, gidx, base_idx, N, 1, C, stats, hist, over_col, over_freq,
             capO, scratch, st);
}
