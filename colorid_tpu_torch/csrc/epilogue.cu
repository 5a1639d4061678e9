// The search epilogue on Hopper (sm_90a): per-color counts, the global AND,
// the all-valid flag, the uniq-hit frequency histogram and the overflow list
// of a batch of k-mers whose per-hash row words are already gathered.
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU: colorid_tpu/ops/query.py::_accumulate_tail (its
// histogram an int8 one-hot contraction on the MXU, its overflow list a
// cumsum and two scatters), and the classic stream's AND over the H hash
// words and presence test before it (colorid_tpu/ops/stream_query.py,
// stream_accumulate_classic_exact). Its plain PyTorch twins, which run the
// same arithmetic as some hundred tensor ops (one launch each on the card),
// are colorid_tpu_torch/ops/query.py::_accumulate_tail_plain and
// _accumulate_words_plain; kernel and twins agree bit for bit.
//
// What it computes over rows i < N, in place on the four accumulators
// (stats int32 [C + W + 2], hist int32 [C, FREQ_CAP], over_col / over_freq
// int32 [capO]):
//   x_i      = andw[i] (W words), or in words mode (W = 1) the AND of the
//              row's H words; present_i = the given flag, or in words mode
//              "every one of the H words is nonzero"
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
// What bounds it on an H100: bytes. In the classic mode each k-mer reads its
// H = 4 words, its frequency and its mask: 21 bytes against 3.35 TB/s (the
// 8.65 M-slot batch of the main path: 0.05 ms); the rest is tens of
// integer instructions a row (chip_smoke.py counts the tile loop's SASS
// instructions and reports both bounds). The launches that the twin makes
// each read the whole batch, some of them as int64 copies.
//
// What the design does about that:
// - One pass over the rows (kernel 1, a persistent grid, 512-row tiles, one
//   row per thread): the words are read once, ANDed in registers, and
//   nothing per row is written back.
// - Per-color counts without contention: a warp ORs its 32 rows' masked
//   words, and for each bit set anywhere one ballot + popcount counts it
//   over the warp (one lane's register for W = 1; a shared-memory counter
//   otherwise). The AND is a warp reduction. A block flushes its counts and
//   AND once, at its end.
// - The histogram, where the reads pile onto a few dozen (color, frequency)
//   bins: lanes with the same bin are grouped with __match_any_sync and one
//   of them adds the group's size. The bins live in shared memory, private
//   to the block and flushed once at its end, while C * FREQ_CAP ints fit
//   (C <= 55 on an H100: 4 KB a color; the classic stream's C <= 32); for
//   wider indexes the same code adds to the global histogram directly.
// - The overflow list keeps k-mer order without a scan over N: kernel 1
//   writes each tile's count of big rows, kernel 2 (one block) scans those
//   counts from stats[C + W + 1] into each tile's first slot and updates
//   n_over, and kernel 3 revisits only the tiles that hold a big row, ranks
//   them within the tile with ballots and adds them to their slots (the
//   slots beyond n_over are zero, so adding writes them, as in the twin).
// - The words mode's H (1, 2 or 4; any other H takes a loop) and W = 1 are
//   template parameters: the classic row is one vector load and straight
//   code.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches the three kernels on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;  // rows per tile: one per thread
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int FREQ_CAP = 1024;
constexpr unsigned FULL = 0xffffffffu;
// counts and AND words stay in shared memory up to this row width
constexpr int SMEM_WORDS_MAX = 256;

struct Params {
  const uint32_t* words;   // [N, W] AND words, or [N, H] per-hash words (words mode)
  const uint8_t* present;  // [N] (AND-words mode) or nullptr (words mode)
  const uint8_t* mask;     // [N]
  const int32_t* q;        // [N]
  const int32_t* gidx;     // [N] or nullptr
  int64_t base_idx;
  int64_t N;
  int64_t n_tiles;
  int64_t capO;
  int32_t W;
  int32_t H;  // words per row in words mode, 0 in AND-words mode
  int32_t C;
  int32_t* stats;
  int32_t* hist;
  int32_t* over_col;
  int32_t* over_freq;
  int64_t* bcount;  // [n_tiles] big rows per tile
  int64_t* offs;    // [n_tiles] each tile's first overflow slot
};

// the bits of word w that hold colors below C
__device__ __forceinline__ uint32_t cmask_of(int C, int w) {
  const int r = C - 32 * w;
  return r >= 32 ? FULL : r <= 0 ? 0u : (1u << r) - 1u;
}

// A one-word row (W = 1): its AND word and its presence. HW 0: the given
// AND word and flag; HW 1, 2, 4: the AND of that many per-hash words, one
// load; HW -1: p.H words in a loop.
template <int HW>
__device__ __forceinline__ void load_row1(const Params& p, int64_t i, uint32_t& x, bool& pres) {
  if constexpr (HW == 0) {
    x = p.words[i];
    pres = p.present[i] != 0;
  } else if constexpr (HW == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(p.words)[i];
    x = v.x & v.y & v.z & v.w;
    pres = v.x && v.y && v.z && v.w;
  } else if constexpr (HW == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(p.words)[i];
    x = v.x & v.y;
    pres = v.x && v.y;
  } else if constexpr (HW == 1) {
    x = p.words[i];
    pres = x != 0;
  } else {
    const uint32_t* r = p.words + i * p.H;
    x = FULL;
    pres = true;
    for (int h = 0; h < p.H; ++h) {
      const uint32_t v = r[h];
      x &= v;
      pres = pres && v != 0;
    }
  }
}

// Kernel 1: counts, AND, all-valid flag, histogram, big rows per tile.
template <int HW, bool W1>
__global__ void __launch_bounds__(THREADS)
    epilogue_kernel(Params p, int smem_hist, int smem_words) {
  extern __shared__ int smem[];
  __shared__ int s_bad;
  const int lane = threadIdx.x & 31;
  const int C = p.C, W = p.W;
  int* s_cnt = smem;                             // [32 * W] when smem_words
  int* s_and = smem + (smem_words ? 32 * W : 0);  // [W] when smem_words
  int* s_hist = s_and + (smem_words ? W : 0);     // [C * FREQ_CAP] when smem_hist
  int* cnt = smem_words ? s_cnt : p.stats;
  int* andp = smem_words ? s_and : p.stats + C;
  int* hist = smem_hist ? s_hist : p.hist;
  if (smem_words) {
    for (int j = threadIdx.x; j < 32 * W; j += THREADS) s_cnt[j] = 0;
    for (int j = threadIdx.x; j < W; j += THREADS) s_and[j] = -1;
  }
  if (smem_hist)
    for (int j = threadIdx.x; j < C * FREQ_CAP; j += THREADS) s_hist[j] = 0;
  if (threadIdx.x == 0) s_bad = 0;
  __syncthreads();

  int my_cnt = 0;         // W1: color `lane`'s count over this warp's rows
  uint32_t my_and = FULL;  // W1: the AND over this warp's valid rows
  bool bad = false;        // a real row that lacks one of its rows
  const uint32_t cm0 = cmask_of(C, 0);
  for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const int64_t i = t * THREADS + threadIdx.x;
    const bool in = i < p.N;
    bool msk = false, pres = true;
    int q = 0, nh = 0, col = 0;
    if (in) {
      msk = p.mask[i] != 0;
      q = p.q[i];
    }
    bool valid;
    if constexpr (W1) {
      uint32_t x = 0;
      if (in) load_row1<HW>(p, i, x, pres);
      valid = msk && pres;
      my_and &= __reduce_and_sync(FULL, valid ? x : FULL);
      const uint32_t xc = valid ? x & cm0 : 0u;
      uint32_t u = __reduce_or_sync(FULL, xc);
      while (u) {
        const int b = __ffs(u) - 1;
        u &= u - 1;
        const int c = __popc(__ballot_sync(FULL, (xc >> b) & 1u));
        if (lane == b) my_cnt += c;
      }
      nh = __popc(xc);
      col = __ffs(xc) - 1;
    } else {
      if (in) pres = p.present[i] != 0;
      valid = msk && pres;
      const uint32_t* row = p.words + i * W;
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
    }
    bad = bad || (msk && !pres);
    const bool uniq = valid && nh == 1;
    const bool small = uniq && q < FREQ_CAP;
    const unsigned sm = __ballot_sync(FULL, small);
    if (small) {
      const int bin = col * FREQ_CAP + (q < 0 ? 0 : q);
      const unsigned same = __match_any_sync(sm, bin);
      if (lane == __ffs(same) - 1) atomicAdd(&hist[bin], __popc(same));
    }
    const int n_big = __syncthreads_count(uniq && q >= FREQ_CAP);
    if (threadIdx.x == 0) p.bcount[t] = n_big;
  }

  if constexpr (W1) {
    if (my_cnt) atomicAdd(&cnt[lane], my_cnt);
    if (lane == 0 && my_and != FULL) atomicAnd(&andp[0], (int)my_and);
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
  if (smem_hist)
    for (int j = threadIdx.x; j < C * FREQ_CAP; j += THREADS)
      if (s_hist[j]) atomicAdd(&p.hist[j], s_hist[j]);
}

// Kernel 2, one block: each tile's first overflow slot, from the running
// n_over in stats[C + W + 1], which it then advances by the batch's count.
__global__ void __launch_bounds__(SCAN_THREADS) epilogue_scan_kernel(Params p) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  __shared__ long long s_run;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* n_over = p.stats + p.C + p.W + 1;
  if (tid == 0) s_run = *n_over;
  __syncthreads();
  for (int64_t s = 0; s < p.n_tiles; s += SCAN_THREADS) {
    const int64_t j = s + tid;
    const int v = j < p.n_tiles ? (int)p.bcount[j] : 0;
    int x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int z = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, z, o);
        if (lane >= o) z += y;
      }
      s_warp[lane] = z;
    }
    __syncthreads();
    const long long run = s_run;
    if (j < p.n_tiles) p.offs[j] = run + (warp ? s_warp[warp - 1] : 0) + x - v;
    __syncthreads();
    if (tid == 0) s_run = run + s_warp[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) *n_over = (int32_t)(uint32_t)(unsigned long long)s_run;
}

// Whether row i is big (uniq with q >= FREQ_CAP), and its color.
template <int HW, bool W1>
__device__ __forceinline__ bool row_big(const Params& p, int64_t i, int& col) {
  if (!p.mask[i] || p.q[i] < FREQ_CAP) return false;
  if constexpr (W1) {
    uint32_t x;
    bool pres;
    load_row1<HW>(p, i, x, pres);
    x &= cmask_of(p.C, 0);
    if (!pres || __popc(x) != 1) return false;
    col = __ffs(x) - 1;
    return true;
  } else {
    if (!p.present[i]) return false;
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

// Kernel 3: the big rows of each tile that has any, in k-mer order, added
// to their slots below capO.
template <int HW, bool W1>
__global__ void __launch_bounds__(THREADS) epilogue_overflow_kernel(Params p) {
  __shared__ int s_wc[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const int64_t first = p.offs[t];
    if (p.bcount[t] == 0 || first >= p.capO) continue;  // the same for the whole block
    const int64_t i = t * THREADS + threadIdx.x;
    int col = 0;
    const bool big = i < p.N && row_big<HW, W1>(p, i, col);
    const unsigned bal = __ballot_sync(FULL, big);
    if (lane == 0) s_wc[warp] = __popc(bal);
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_wc[w];
    const int64_t slot = first + before + __popc(bal & ((1u << lane) - 1u));
    if (big && slot < p.capO) {
      p.over_col[slot] += col;
      p.over_freq[slot] += p.gidx ? p.gidx[i] : (int32_t)(uint32_t)(uint64_t)(p.base_idx + i);
    }
    __syncthreads();
  }
}

template <int HW, bool W1>
int launch(const Params& p, cudaStream_t st) {
  int dev, sms, optin, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int smem_words = p.W <= SMEM_WORDS_MAX;
  const size_t words_bytes = smem_words ? (size_t)33 * p.W * 4 : 0;
  const size_t hist_bytes = (size_t)p.C * FREQ_CAP * 4;
  // a kilobyte of the block's shared memory is left for the static part
  const int smem_hist = words_bytes + hist_bytes + 1024 <= (size_t)optin;
  const size_t dyn = words_bytes + (smem_hist ? hist_bytes : 0);
  auto k1 = epilogue_kernel<HW, W1>;
  cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1, THREADS, dyn);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t g1 = p.n_tiles < (int64_t)per_sm * sms ? p.n_tiles : (int64_t)per_sm * sms;
  epilogue_kernel<HW, W1><<<(unsigned)g1, THREADS, dyn, st>>>(p, smem_hist, smem_words);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  epilogue_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t g3 = p.n_tiles < (int64_t)4 * sms ? p.n_tiles : (int64_t)4 * sms;
  epilogue_overflow_kernel<HW, W1><<<(unsigned)g3, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// words: [N, W] int32 AND words with present [N] (H == 0), or [N, H] int32
// per-hash words (H >= 1, W == 1; 16-byte aligned for H == 4, 8 for H ==
// 2); mask [N] bool; q, gidx (or nullptr) [N] int32; stats [C + W + 2],
// hist [C, 1024], over_col / over_freq [capO] int32, all contiguous;
// scratch: 2 * ceil(N / 512) int64. N == 0 launches nothing.
extern "C" int epilogue_launch(const void* words, const void* present, const void* mask,
                               const void* q, const void* gidx, int64_t base_idx, int64_t N,
                               int32_t W, int32_t H, int32_t C, void* stats, void* hist,
                               void* over_col, void* over_freq, int64_t capO, void* scratch,
                               void* stream) {
  if (N < 0 || W < 1 || H < 0 || C < 0 || C > 32 * W || capO < 0 ||
      (H == 0) != (present != nullptr) || (H > 0 && W != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Params p{};
  p.words = (const uint32_t*)words;
  p.present = (const uint8_t*)present;
  p.mask = (const uint8_t*)mask;
  p.q = (const int32_t*)q;
  p.gidx = (const int32_t*)gidx;
  p.base_idx = base_idx;
  p.N = N;
  p.n_tiles = (N + THREADS - 1) / THREADS;
  p.capO = capO;
  p.W = W;
  p.H = H;
  p.C = C;
  p.stats = (int32_t*)stats;
  p.hist = (int32_t*)hist;
  p.over_col = (int32_t*)over_col;
  p.over_freq = (int32_t*)over_freq;
  p.bcount = (int64_t*)scratch;
  p.offs = (int64_t*)scratch + p.n_tiles;
  cudaStream_t st = (cudaStream_t)stream;
  switch (H) {
    case 0:
      return W == 1 ? launch<0, true>(p, st) : launch<0, false>(p, st);
    case 1:
      return launch<1, true>(p, st);
    case 2:
      return launch<2, true>(p, st);
    case 4:
      return launch<4, true>(p, st);
    default:
      return launch<-1, true>(p, st);
  }
}
