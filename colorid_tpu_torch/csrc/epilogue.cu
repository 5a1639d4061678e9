// The search epilogue on Hopper (sm_90a): per-color counts, the global AND,
// the all-valid flag, the uniq-hit frequency histogram and the overflow list
// of a batch of k-mers whose row words are already gathered.
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU: colorid_tpu/ops/query.py::_accumulate_tail (its
// histogram an int8 one-hot contraction on the MXU, its overflow list a
// cumsum and two scatters), and around the classic stream's word kernel
// the residual patch, the un-sort to k-mer order, the AND over the H hash
// words and the presence test (colorid_tpu/ops/stream_query.py,
// stream_accumulate_classic_exact). Its plain PyTorch twins, which run the
// same arithmetic as some hundred tensor ops (one launch each on the card),
// are colorid_tpu_torch/ops/query.py::_accumulate_tail_plain and
// _accumulate_sorted_words_plain; kernel and twins agree bit for bit.
//
// Two entry points.
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
// - Per-color counts at W 1 without a collective a row: each thread adds
//   its rows' masked words into 8 bit planes (a carry-save counter: bit c
//   of plane k is bit k of color c's count), and a warp folds the planes
//   into lane c's count with ballots only every 252 rows a thread. Wider
//   rows count a word at a time with one ballot per color set in the warp.
//   The AND is a warp reduction; a block flushes counts and AND once.
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
//   its tile's count and to a total; kernel 2 returns at once when the
//   total is 0, else each block sums the counts of the tiles before its
//   own range of tiles (a few thousand ints), ranks the big rows of its
//   tiles with ballots, adds them to their slots (the slots beyond n_over
//   are zero, so adding writes them, as in the twin), and the last block
//   to finish advances n_over.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): plain C
// entry points that launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RPT1 = 4;  // rows a thread in a W = 1 tile (a multiple of 4)
constexpr int FREQ_CAP = 1024;
constexpr unsigned FULL = 0xffffffffu;
// counts and AND words stay in shared memory up to this row width
constexpr int SMEM_WORDS_MAX = 256;
// dynamic shared memory of kernel 1: two blocks of 512 threads an SM
constexpr int SMEM_BUDGET = 100 * 1024;
// bit planes of the W = 1 carry-save counters: up to 255 rows a thread,
// flushed every FLUSH_TILES tiles
constexpr int PLANES = 8;
constexpr int FLUSH_TILES = ((1 << PLANES) - 1) / RPT1;

struct Params {
  const uint32_t* words;   // [N, W] AND words
  const uint8_t* present;  // [N]
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
  int32_t* stats;
  int32_t* hist;
  int32_t* over_col;
  int32_t* over_freq;
  int32_t* big;  // [2 + n_tiles]: total big rows, blocks done, big rows per tile
};

// the bits of word w that hold colors below C
__device__ __forceinline__ uint32_t cmask_of(int C, int w) {
  const int r = C - 32 * w;
  return r >= 32 ? FULL : r <= 0 ? 0u : (1u << r) - 1u;
}

// The RPT1 W = 1 rows of a thread from i0; rows at or past N are masked out.
__device__ __forceinline__ void load_rows(const Params& p, int64_t i0, uint32_t (&x)[RPT1],
                                          int (&q)[RPT1], bool (&mk)[RPT1], bool (&pr)[RPT1]) {
  if (p.vec && i0 + RPT1 <= p.N) {
#pragma unroll
    for (int v = 0; v < RPT1; v += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(p.words + i0 + v);
      const int4 qq = *reinterpret_cast<const int4*>(p.q + i0 + v);
      const uchar4 m = *reinterpret_cast<const uchar4*>(p.mask + i0 + v);
      const uchar4 pp = *reinterpret_cast<const uchar4*>(p.present + i0 + v);
      x[v] = w.x, x[v + 1] = w.y, x[v + 2] = w.z, x[v + 3] = w.w;
      q[v] = qq.x, q[v + 1] = qq.y, q[v + 2] = qq.z, q[v + 3] = qq.w;
      mk[v] = m.x, mk[v + 1] = m.y, mk[v + 2] = m.z, mk[v + 3] = m.w;
      pr[v] = pp.x, pr[v + 1] = pp.y, pr[v + 2] = pp.z, pr[v + 3] = pp.w;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT1; ++r) {
    const int64_t i = i0 + r;
    const bool in = i < p.N;
    x[r] = in ? p.words[i] : 0u;
    q[r] = in ? p.q[i] : 0;
    mk[r] = in && p.mask[i];
    pr[r] = !in || p.present[i];
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

// Folds the warp's bit planes into lane c's count of color c and clears them.
__device__ __forceinline__ void planes_flush(uint32_t (&P)[PLANES], int& my_cnt, int lane) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < PLANES; ++k) any |= P[k];
  any = __reduce_or_sync(FULL, any);
  while (any) {
    const int b = __ffs(any) - 1;
    any &= any - 1;
    int c = 0;
#pragma unroll
    for (int k = 0; k < PLANES; ++k) c += __popc(__ballot_sync(FULL, (P[k] >> b) & 1u)) << k;
    if (lane == b) my_cnt += c;
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

// A warp's big rows of tile t, added to the tile's count and the total.
__device__ __forceinline__ void count_big(const Params& p, int64_t t, int nbig, int lane) {
  const int wb = __reduce_add_sync(FULL, nbig);
  if (lane == 0 && wb) {
    atomicAdd(&p.big[2 + t], wb);
    atomicAdd(&p.big[0], wb);
  }
}

// Kernel 1: counts, AND, all-valid flag, histogram, big rows per tile.
template <bool W1>
__global__ void __launch_bounds__(THREADS, 2) epilogue_kernel(Params p, int hf, int smem_words) {
  extern __shared__ int smem[];
  __shared__ int s_bad;
  const int lane = threadIdx.x & 31;
  const int C = p.C, W = p.W;
  int* s_cnt = smem;                              // [32 * W] when smem_words
  int* s_and = smem + (smem_words ? 32 * W : 0);  // [W] when smem_words
  int* s_hist = s_and + (smem_words ? W : 0);     // [C, hf]
  int* cnt = smem_words ? s_cnt : p.stats;
  int* andp = smem_words ? s_and : p.stats + C;
  if (smem_words) {
    for (int j = threadIdx.x; j < 32 * W; j += THREADS) s_cnt[j] = 0;
    for (int j = threadIdx.x; j < W; j += THREADS) s_and[j] = -1;
  }
  for (int j = threadIdx.x; j < C * hf; j += THREADS) s_hist[j] = 0;
  if (threadIdx.x == 0) s_bad = 0;
  __syncthreads();

  bool bad = false;  // a real row that lacks one of its rows
  if constexpr (W1) {
    constexpr int TILE = THREADS * RPT1;
    uint32_t P[PLANES] = {};
    int my_cnt = 0;          // color `lane`'s count over this warp's rows
    uint32_t my_and = FULL;  // the AND over this thread's valid rows
    const uint32_t cm0 = cmask_of(C, 0);
    int since = 0;
    for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      uint32_t x[RPT1];
      int q[RPT1];
      bool mk[RPT1], pr[RPT1];
      load_rows(p, t * TILE + threadIdx.x * RPT1, x, q, mk, pr);
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
        hist_add<false>(p, s_hist, hf, lane, uniq && q[r] < FREQ_CAP, __ffs(xc[r]) - 1, q[r]);
        nbig += uniq && q[r] >= FREQ_CAP;
      }
      count_big(p, t, nbig, lane);
      if (++since == FLUSH_TILES) {
        planes_flush(P, my_cnt, lane);
        since = 0;
      }
    }
    planes_flush(P, my_cnt, lane);
    if (my_cnt) atomicAdd(&cnt[lane], my_cnt);
    const uint32_t a = __reduce_and_sync(FULL, my_and);
    if (lane == 0 && a != FULL) atomicAnd(&andp[0], (int)a);
  } else {
    for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const int64_t i = t * THREADS + threadIdx.x;
      const bool in = i < p.N;
      bool msk = false, pres = true;
      int q = 0;
      if (in) {
        msk = p.mask[i] != 0;
        q = p.q[i];
        pres = p.present[i] != 0;
      }
      const bool valid = msk && pres;
      const uint32_t* row = p.words + i * W;
      int nh = 0, col = 0;
      bool found = false;
      for (int w = 0; w < W; ++w) {
        const uint32_t x = valid ? row[w] : 0u;
        const uint32_t a = __reduce_and_sync(FULL, valid ? x : FULL);
        if (lane == 0 && a != FULL) atomicAnd(&andp[w], (int)a);
        const uint32_t xc = x & cmask_of(C, w);
        uint32_t u = __reduce_or_sync(FULL, xc);
        while (u) {
          const int b = __ffs(u) - 1;
          u &= u - 1;
          const int c = __popc(__ballot_sync(FULL, (xc >> b) & 1u));
          if (lane == 0) atomicAdd(&cnt[32 * w + b], c);
        }
        nh += __popc(xc);
        if (!found && xc) {
          found = true;
          col = 32 * w + __ffs(xc) - 1;
        }
      }
      bad = bad || (msk && !pres);
      const bool uniq = valid && nh == 1;
      hist_add<true>(p, s_hist, hf, lane, uniq && q < FREQ_CAP, col, q);
      count_big(p, t, uniq && q >= FREQ_CAP, lane);
    }
  }

  if (bad) s_bad = 1;
  __syncthreads();
  if (threadIdx.x == 0 && s_bad) p.stats[C + W] = 0;
  if (smem_words) {
    for (int j = threadIdx.x; j < C; j += THREADS)
      if (s_cnt[j]) atomicAdd(&p.stats[j], s_cnt[j]);
    for (int j = threadIdx.x; j < W; j += THREADS)
      if (s_and[j] != -1) atomicAnd(&p.stats[C + j], s_and[j]);
  }
  for (int j = threadIdx.x; j < C * hf; j += THREADS)
    if (s_hist[j]) atomicAdd(&p.hist[(j / hf) * FREQ_CAP + j % hf], s_hist[j]);
}

// Whether row i is big (uniq with q >= FREQ_CAP), and its color.
template <bool W1>
__device__ __forceinline__ bool row_big(const Params& p, int64_t i, int& col) {
  if (i >= p.N || !p.mask[i] || p.q[i] < FREQ_CAP || !p.present[i]) return false;
  if constexpr (W1) {
    const uint32_t x = p.words[i] & cmask_of(p.C, 0);
    if (__popc(x) != 1) return false;
    col = __ffs(x) - 1;
    return true;
  } else {
    const uint32_t* row = p.words + i * p.W;
    int nh = 0;
    for (int w = 0; w < p.W && nh <= 1; ++w) {
      const uint32_t xc = row[w] & cmask_of(p.C, w);
      if (xc && nh == 0) col = 32 * w + __ffs(xc) - 1;
      nh += __popc(xc);
    }
    return nh == 1;
  }
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
      bg[r] = row_big<W1>(p, t * TILE + threadIdx.x * RPT + r, col[r]);
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

template <bool W1>
int launch(Params p, cudaStream_t st) {
  constexpr int TILE = THREADS * (W1 ? RPT1 : 1);
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.n_tiles = (p.N + TILE - 1) / TILE;
  p.vec = W1 && (uintptr_t)p.words % 16 == 0 && (uintptr_t)p.q % 16 == 0 &&
          (uintptr_t)p.mask % 4 == 0 && (uintptr_t)p.present % 4 == 0;
  const int smem_words = p.W <= SMEM_WORDS_MAX;
  const size_t words_bytes = smem_words ? (size_t)33 * p.W * 4 : 0;
  int hf = FREQ_CAP;
  while (hf > 1 && words_bytes + (size_t)p.C * hf * 4 > SMEM_BUDGET) hf >>= 1;
  if (words_bytes + (size_t)p.C * hf * 4 > SMEM_BUDGET) hf = 0;
  const size_t dyn = words_bytes + (size_t)p.C * hf * 4;
  auto k1 = epilogue_kernel<W1>;
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
  epilogue_overflow_kernel<W1><<<(unsigned)g2, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

int run(const void* words, const void* present, const void* mask, const void* q,
        const void* gidx, int64_t base_idx, int64_t N, int32_t W, int32_t C, void* stats,
        void* hist, void* over_col, void* over_freq, int64_t capO, void* scratch,
        cudaStream_t st) {
  Params p{};
  p.words = (const uint32_t*)words;
  p.present = (const uint8_t*)present;
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
  return W == 1 ? launch<true>(p, st) : launch<false>(p, st);
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
// 512) int32. N == 0 launches nothing.
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
