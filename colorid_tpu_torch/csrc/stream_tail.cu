// The blocked probe stream's glue on Hopper (sm_90a): the chunk plan before
// the probe kernel, the tail after it, and the residual gather that feeds
// the search epilogue (kernel D).
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU and skips the overflow routing and the residual pass
// with lax.cond when they are empty: colorid_tpu/ops/stream_query.py::
// _stream_core (:895-1029), its window plan, the merge of the kernel's
// accumulators, the overflow list and the chunk-granular residual pass, and
// around it the unpacking of the sorted key in stream_accumulate_hash[_exact]
// (:622, :676). Its plain PyTorch twins, which run the same arithmetic as
// about a hundred tensor ops (one launch each on the card), are
// colorid_tpu_torch/ops/stream_query.py::stream_chunk_plan_plain,
// stream_tail_plain and stream_residual_plain; kernels and twins agree bit
// for bit, and composed with the probe kernel and the epilogue they equal
// _stream_core_plain.
//
// Three entry points, in the order the stream runs them (probes in chunks of
// pc; T = 128 blocks a tile; a chunk's window is nt tiles from its tb):
//
// stream_plan_launch (D1), one block a chunk. From the key sorted with its
// payloads by kernel E (csrc/radix_sort.cu), the frequency in its low qbits:
// blk_s and qc_s, its bits (off_s and gidx_s came sorted); or from probes
// sorted already (E sorted the block alone, with the frequency as an
// operand); then tb[c] = clamp(blk_s[c * pc] // T, 0, tb_hi), the window
// test blk < (tb + nt) * T, qcw = qc where in the window, else 0, and per
// chunk its residual probes (outside, qc > 0) and its counted ones (qcw > 0).
//
// stream_tail_launch (D2), after the probe kernel: three launches.
//   D2a, one block a tile of 2,048 probes: the tile's valid probes (uniq >
//     -2) and big ones (uniq >= 0 and qc >= hw); over the grid, hist[:, :hw]
//     += hist_out[:C].
//   D2b, the overflow list: returns at once when no probe is big (the JAX
//     package's lax.cond), else the big probes in probe order, rank r adding
//     (uniq, gidx) to slot n_over + r of over_col / over_freq while r <
//     over_cap and the slot is below capO.
//   D2c, one block: stats[:C] += counts, the AND words from counts ==
//     n_valid ANDed into the running ones, the all-valid flag times (n_valid
//     == n_real), n_over += min(n_big, over_cap); the residual plan: the
//     first nch chunks with residual probes (the rest count into n_drop) as
//     a compact list with its count; n_drop = max(n_big - over_cap, 0) + the
//     residual probes left out.
//
// stream_residual_launch (D3), one block a slot of that list: for the
// residual probes of a listed chunk, the H rows in their block, their AND
// and presence, in the layout that the epilogue's AND-words mode takes
// (andw [slots * pc, W], present, mask, q, gidx); every other row is zero
// and masked, and a slot past the count writes its zeros and stops.
//
// What bounds it on an H100: bytes. D1 reads the sorted key and writes
// blk_s, qc_s and qcw, 16 bytes a probe (12 from probes sorted already); D2
// reads uniq and qc, 8 bytes a probe; D3 and the epilogue touch a few MB.
// The operations are a few dozen integer instructions a probe.
//
// What the design does about that: one pass a stage over the probes, each
// coalesced; no P-sized mask, no scatter over all probes (the twins' two
// index_add_ over P become D2b, which runs only when a probe is big); the
// residual chunks are listed by one scan over the chunks' counts instead of
// a sort; only the listed chunks' residual probes touch the matrix. Nothing
// waits for the device: counts stay on the card, and the epilogue's N is the
// list's capacity.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): plain C
// entry points that launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 128;  // blocks a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS * 8;  // probes a tile of D2a / D2b
constexpr int FIN_THREADS = 1024;
constexpr int FREQ_CAP = 1024;
constexpr unsigned FULL = 0xffffffffu;

// The sum of v over the block (THREADS or FIN_THREADS threads), in every
// thread; s_red holds one int a warp.
__device__ __forceinline__ long long block_sum(long long v, long long* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // earlier readers of s_red are done
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += s_red[w];
  return t;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

struct PlanParams {
  const int32_t* key;  // [P] sorted keys, the frequency in the low qbits, or nullptr
  int32_t qbits;
  int32_t* blk_s;  // [P] written from the key, or read
  int32_t* qc_s;
  int32_t* qcw;
  int32_t* tb;          // [n_chunks]
  int32_t* chunk_res;   // [n_chunks]
  int32_t* chunk_real;  // [n_chunks]
  int32_t pc, nt;
  int64_t tb_hi;
};

__global__ void __launch_bounds__(THREADS) plan_kernel(PlanParams p) {
  __shared__ long long s_red[WARPS];
  __shared__ int s_tb;
  const int64_t c = blockIdx.x;
  const int64_t i0 = c * p.pc;
  if (threadIdx.x == 0) {
    const int64_t first = p.key ? p.key[i0] >> p.qbits : p.blk_s[i0];
    long long t = floor_div(first, T);
    t = t < 0 ? 0 : t;
    s_tb = (int)(t > p.tb_hi ? p.tb_hi : t);
    p.tb[c] = s_tb;
  }
  __syncthreads();
  const int64_t lim = ((int64_t)s_tb + p.nt) * T;
  const int32_t qmask = (1 << p.qbits) - 1;
  int res = 0, real = 0;
  for (int64_t j = i0 + threadIdx.x; j < i0 + p.pc; j += THREADS) {
    int32_t blk, qc;
    if (p.key) {  // sorted with its payloads: the frequency in the key
      const int32_t kv = p.key[j];
      blk = kv >> p.qbits;
      qc = kv & qmask;
      p.blk_s[j] = blk;
      p.qc_s[j] = qc;
    } else {
      blk = p.blk_s[j];
      qc = p.qc_s[j];
    }
    const bool inwin = (int64_t)blk < lim;
    const int32_t qw = inwin ? qc : 0;
    p.qcw[j] = qw;
    res += !inwin && qc > 0;
    real += qw > 0;
  }
  const long long r = block_sum(res, s_red);
  const long long n = block_sum(real, s_red);
  if (threadIdx.x == 0) {
    p.chunk_res[c] = (int32_t)r;
    p.chunk_real[c] = (int32_t)n;
  }
}

struct TailParams {
  const int32_t* uniq;  // [P]
  const int32_t* qc_s;  // [P]
  const int32_t* gidx;  // [P] the overflow payload (qc_s itself in exact mode)
  int64_t P, n_tiles;
  int32_t hw;
  const int32_t* counts;    // [32 * W] the probe kernel's
  const int32_t* hist_out;  // [cp, hw] the probe kernel's
  int32_t C, W;
  int32_t* stats;  // [C + W + 2]
  int32_t* hist;   // [C, FREQ_CAP]
  int32_t* over_col;
  int32_t* over_freq;
  int64_t capO, over_cap;
  const int32_t* chunk_res;   // [n_chunks]
  const int32_t* chunk_real;  // [n_chunks]
  int64_t n_chunks;
  int32_t nch;        // residual chunk capacity
  int32_t n_slots;    // min(nch, n_chunks): the list's length
  int32_t* tile_valid;  // [n_tiles]
  int32_t* tile_big;    // [n_tiles]
  int32_t* cidx;        // [n_slots] listed chunks, then -1
  int32_t* meta;        // [2]: the list's count, n_drop
};

__device__ __forceinline__ bool is_big(const TailParams& p, int64_t i) {
  return i < p.P && p.uniq[i] >= 0 && p.qc_s[i] >= p.hw;
}

// D2a: valid and big probes a tile; the histogram merge over the grid.
__global__ void __launch_bounds__(THREADS) tail_count_kernel(TailParams p) {
  __shared__ long long s_red[WARPS];
  const int64_t t = blockIdx.x;
  int nv = 0, nb = 0;
#pragma unroll
  for (int r = 0; r < TILE / THREADS; ++r) {
    const int64_t i = t * TILE + r * THREADS + threadIdx.x;
    if (i < p.P) {
      const int32_t u = p.uniq[i];
      nv += u > -2;
      nb += u >= 0 && p.qc_s[i] >= p.hw;
    }
  }
  const long long v = block_sum(nv, s_red);
  const long long b = block_sum(nb, s_red);
  if (threadIdx.x == 0) {
    p.tile_valid[t] = (int32_t)v;
    p.tile_big[t] = (int32_t)b;
  }
  const int64_t cells = (int64_t)p.C * p.hw;
  for (int64_t j = t * THREADS + threadIdx.x; j < cells; j += (int64_t)gridDim.x * THREADS) {
    const int64_t c = j / p.hw, q = j % p.hw;
    p.hist[c * FREQ_CAP + q] += p.hist_out[j];
  }
}

// D2b: the big probes in probe order, added to their slots. Block b takes a
// contiguous range of tiles and starts at the big probes of the tiles before
// it; each thread takes 8 consecutive probes of a tile.
__global__ void __launch_bounds__(THREADS) tail_overflow_kernel(TailParams p) {
  constexpr int RPT = TILE / THREADS;
  __shared__ long long s_red[WARPS];
  __shared__ int s_warp[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = (p.n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t lo = min((int64_t)blockIdx.x * per, p.n_tiles);
  const int64_t hi = min(lo + per, p.n_tiles);
  long long total = 0, before = 0;
  for (int64_t j = threadIdx.x; j < p.n_tiles; j += THREADS) {
    const int nb = p.tile_big[j];
    total += nb;
    before += j < lo ? nb : 0;
  }
  total = block_sum(total, s_red);
  if (total == 0) return;  // the same for every block
  before = block_sum(before, s_red);
  const long long n_over = p.stats[p.C + p.W + 1];
  long long first = before;  // the rank of this block's first big probe
  for (int64_t t = lo; t < hi && first < p.over_cap && n_over + first < p.capO; ++t) {
    const int nb = p.tile_big[t];  // the same for the whole block
    if (nb == 0) continue;
    bool bg[RPT];
    int n = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      bg[r] = is_big(p, t * TILE + threadIdx.x * RPT + r);
      n += bg[r];
    }
    int incl = n;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    __syncthreads();  // the previous tile's s_warp reads are done
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    long long rank = first + incl - n;
    for (int w = 0; w < warp; ++w) rank += s_warp[w];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (!bg[r]) continue;
      const long long to = n_over + rank;
      if (rank < p.over_cap && to < p.capO) {
        const int64_t i = t * TILE + threadIdx.x * RPT + r;
        p.over_col[to] += p.uniq[i];
        p.over_freq[to] += p.gidx[i];
      }
      ++rank;
    }
    first += nb;
  }
}

// D2c: the statistics and the residual plan, one block.
__global__ void __launch_bounds__(FIN_THREADS) tail_finish_kernel(TailParams p) {
  __shared__ long long s_red[FIN_THREADS / 32];
  __shared__ int s_warp[FIN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long nv = 0, nb = 0, nr = 0;
  for (int64_t j = threadIdx.x; j < p.n_tiles; j += FIN_THREADS) {
    nv += p.tile_valid[j];
    nb += p.tile_big[j];
  }
  for (int64_t j = threadIdx.x; j < p.n_chunks; j += FIN_THREADS) nr += p.chunk_real[j];
  const long long n_valid = block_sum(nv, s_red);
  const long long n_big = block_sum(nb, s_red);
  const long long n_real = block_sum(nr, s_red);
  const int C = p.C, W = p.W;
  for (int c = threadIdx.x; c < C; c += FIN_THREADS) p.stats[c] += p.counts[c];
  for (int w = threadIdx.x; w < W; w += FIN_THREADS) {
    uint32_t a = 0;
    for (int b = 0; b < 32; ++b) a |= (uint32_t)(p.counts[32 * w + b] == n_valid) << b;
    p.stats[C + w] &= (int32_t)a;
  }
  if (threadIdx.x == 0) {
    p.stats[C + W] *= (int32_t)(n_valid == n_real);
    p.stats[C + W + 1] += (int32_t)(n_big < p.over_cap ? n_big : p.over_cap);
  }
  // the first nch chunks with residual probes, in chunk order
  long long seen = 0;  // chunks with residual probes before this round
  long long dropped = 0;
  for (int64_t base = 0; base < p.n_chunks; base += FIN_THREADS) {
    const int64_t c = base + threadIdx.x;
    const int r = c < p.n_chunks ? p.chunk_res[c] : 0;
    const bool has = r > 0;
    const unsigned bal = __ballot_sync(FULL, has);
    __syncthreads();  // the previous round's s_warp reads are done
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    long long rank = seen + __popc(bal & ((1u << lane) - 1));
    long long round_total = 0;
    for (int w = 0; w < FIN_THREADS / 32; ++w) {
      rank += w < warp ? s_warp[w] : 0;
      round_total += s_warp[w];
    }
    if (has) {
      if (rank < p.nch)
        p.cidx[rank] = (int32_t)c;
      else
        dropped += r;
    }
    seen += round_total;
  }
  dropped = block_sum(dropped, s_red);
  const long long n_cov = seen < p.nch ? seen : p.nch;
  for (int64_t j = n_cov + threadIdx.x; j < p.n_slots; j += FIN_THREADS) p.cidx[j] = -1;
  if (threadIdx.x == 0) {
    p.meta[0] = (int32_t)n_cov;
    const long long over = n_big - p.over_cap;
    p.meta[1] = (int32_t)(uint32_t)(uint64_t)((over > 0 ? over : 0) + (int32_t)dropped);
  }
}

struct ResParams {
  const int32_t* blocks;  // [n_blocks, 128]
  int64_t n_blocks;
  const int32_t* blk_s;
  const int32_t* off_s;
  const int32_t* qc_s;
  const int32_t* gidx_s;
  const int32_t* tb;
  const int32_t* cidx;
  const int32_t* meta;
  int32_t pc, nt, H, W, rpb;
  int32_t* andw;     // [n_slots * pc, W]
  uint8_t* present;  // [n_slots * pc]
  uint8_t* mask;
  int32_t* q;
  int32_t* gidx;
};

// D3: one block a slot of the residual chunk list.
__global__ void __launch_bounds__(THREADS) residual_kernel(ResParams p) {
  const int64_t slot = blockIdx.x;
  const bool listed = slot < p.meta[0];
  const int64_t c = listed ? p.cidx[slot] : 0;
  const int64_t lim = listed ? ((int64_t)p.tb[c] + p.nt) * T : 0;
  const int W = p.W;
  for (int r = threadIdx.x; r < p.pc; r += THREADS) {
    const int64_t o = slot * p.pc + r;
    bool live = false;
    int64_t src = 0;
    if (listed) {
      src = c * p.pc + r;
      live = !((int64_t)p.blk_s[src] < lim) && p.qc_s[src] > 0;
    }
    if (!live) {
      for (int w = 0; w < W; ++w) p.andw[o * W + w] = 0;
      p.present[o] = 0;
      p.mask[o] = 0;
      p.q[o] = 0;
      p.gidx[o] = 0;
      continue;
    }
    const int32_t blk = p.blk_s[src];
    const uint32_t off = (uint32_t)p.off_s[src];
    // the rows of the twin (ops/stream_query.py::_residual_rows), in int32,
    // and their block from hash 0's row (ops/query.py::_gather_rows_blocked)
    const int64_t r0 = (int32_t)((uint32_t)blk * (uint32_t)p.rpb + (off & 0xFFu));
    const int64_t b = floor_div(r0, p.rpb);
    const bool inb = b >= 0 && b < p.n_blocks;
    const int32_t* row = p.blocks + (inb ? b : 0) * 128;
    bool pres = true;
    for (int w = 0; w < W; ++w) p.andw[o * W + w] = -1;
    for (int h = 0; h < p.H; ++h) {
      const int64_t rh = (int32_t)((uint32_t)blk * (uint32_t)p.rpb + ((off >> (8 * h)) & 0xFFu));
      const int64_t lane0 = (rh - floor_div(rh, p.rpb) * p.rpb) * W;
      bool any = false;
      for (int w = 0; w < W; ++w) {
        const int32_t x = inb ? row[lane0 + w] : 0;
        any = any || x != 0;
        p.andw[o * W + w] &= x;
      }
      pres = pres && any;
    }
    p.present[o] = pres;
    p.mask[o] = 1;
    p.q[o] = p.qc_s[src];
    p.gidx[o] = p.gidx_s[src];
  }
}

}  // namespace

// D1. key: the int32 key [P] sorted with its payloads (kernel E), the
// frequency in its low qbits (1..30); blk_s and qc_s [P] are written. key ==
// nullptr: blk_s and qc_s are read (probes sorted already). qcw [P] and tb,
// chunk_res, chunk_real [P / pc] are written. P % pc == 0; tb_hi = n_blocks /
// 128 - nt.
extern "C" int stream_plan_launch(const void* key, int32_t qbits, void* blk_s, void* qc_s,
                                  void* qcw, void* tb, void* chunk_res, void* chunk_real,
                                  int64_t P, int32_t pc, int32_t nt, int64_t tb_hi,
                                  void* stream) {
  if (P < 0 || pc <= 0 || P % pc || nt < 1 || (key && (qbits < 1 || qbits > 30)))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  PlanParams p{};
  p.key = (const int32_t*)key;
  p.qbits = key ? qbits : 0;
  p.blk_s = (int32_t*)blk_s;
  p.qc_s = (int32_t*)qc_s;
  p.qcw = (int32_t*)qcw;
  p.tb = (int32_t*)tb;
  p.chunk_res = (int32_t*)chunk_res;
  p.chunk_real = (int32_t*)chunk_real;
  p.pc = pc;
  p.nt = nt;
  p.tb_hi = tb_hi;
  plan_kernel<<<(unsigned)(P / pc), THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// D2. uniq, qc_s, gidx [P]; counts [32 * W] and hist_out [cp, hw] from the
// probe kernel; the accumulators stats [C + W + 2], hist [C, 1024],
// over_col / over_freq [capO]; chunk_res, chunk_real [n_chunks]; scratch
// 2 * ceil(P / 2048) int32; cidx [n_slots] and meta [2] out.
extern "C" int stream_tail_launch(const void* uniq, const void* qc_s, const void* gidx, int64_t P,
                                  int32_t hw, const void* counts, const void* hist_out,
                                  int32_t C, int32_t W, void* stats, void* hist, void* over_col,
                                  void* over_freq, int64_t capO, int64_t over_cap,
                                  const void* chunk_res, const void* chunk_real,
                                  int64_t n_chunks, int32_t nch, int32_t n_slots, void* scratch,
                                  void* cidx, void* meta, void* stream) {
  if (P < 0 || hw < 1 || hw > FREQ_CAP || C < 0 || W < 1 || C > 32 * W || capO < 0 ||
      over_cap < 0 || n_chunks < 0 || nch < 0 || n_slots < 0 || n_slots > nch ||
      n_slots > n_chunks)
    return (int)cudaErrorInvalidValue;
  TailParams p{};
  p.uniq = (const int32_t*)uniq;
  p.qc_s = (const int32_t*)qc_s;
  p.gidx = (const int32_t*)gidx;
  p.P = P;
  p.n_tiles = (P + TILE - 1) / TILE;
  p.hw = hw;
  p.counts = (const int32_t*)counts;
  p.hist_out = (const int32_t*)hist_out;
  p.C = C;
  p.W = W;
  p.stats = (int32_t*)stats;
  p.hist = (int32_t*)hist;
  p.over_col = (int32_t*)over_col;
  p.over_freq = (int32_t*)over_freq;
  p.capO = capO;
  p.over_cap = over_cap;
  p.chunk_res = (const int32_t*)chunk_res;
  p.chunk_real = (const int32_t*)chunk_real;
  p.n_chunks = n_chunks;
  p.nch = nch;
  p.n_slots = n_slots;
  p.tile_valid = (int32_t*)scratch;
  p.tile_big = (int32_t*)scratch + p.n_tiles;
  p.cidx = (int32_t*)cidx;
  p.meta = (int32_t*)meta;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.n_tiles) {
    tail_count_kernel<<<(unsigned)p.n_tiles, THREADS, 0, st>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    int dev, sms;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t g = p.n_tiles < (int64_t)4 * sms ? p.n_tiles : (int64_t)4 * sms;
    tail_overflow_kernel<<<(unsigned)g, THREADS, 0, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  tail_finish_kernel<<<1, FIN_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// D3. blocks [n_blocks, 128]; blk_s, off_s, qc_s, gidx_s [n_chunks * pc];
// tb [n_chunks]; cidx [n_slots] and meta from D2; andw [n_slots * pc, W]
// int32, present and mask bool, q and gidx int32 [n_slots * pc] out.
extern "C" int stream_residual_launch(const void* blocks, int64_t n_blocks, const void* blk_s,
                                      const void* off_s, const void* qc_s, const void* gidx_s,
                                      const void* tb, const void* cidx, const void* meta,
                                      int32_t n_slots, int32_t pc, int32_t nt, int32_t H,
                                      int32_t W, int32_t rpb, void* andw, void* present,
                                      void* mask, void* q, void* gidx, void* stream) {
  if (n_slots < 0 || pc <= 0 || nt < 1 || H < 1 || H > 4 || W < 1 || rpb < 1 ||
      (int64_t)rpb * W > 128 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return 0;
  ResParams p{};
  p.blocks = (const int32_t*)blocks;
  p.n_blocks = n_blocks;
  p.blk_s = (const int32_t*)blk_s;
  p.off_s = (const int32_t*)off_s;
  p.qc_s = (const int32_t*)qc_s;
  p.gidx_s = (const int32_t*)gidx_s;
  p.tb = (const int32_t*)tb;
  p.cidx = (const int32_t*)cidx;
  p.meta = (const int32_t*)meta;
  p.pc = pc;
  p.nt = nt;
  p.H = H;
  p.W = W;
  p.rpb = rpb;
  p.andw = (int32_t*)andw;
  p.present = (uint8_t*)present;
  p.mask = (uint8_t*)mask;
  p.q = (int32_t*)q;
  p.gidx = (int32_t*)gidx;
  residual_kernel<<<(unsigned)n_slots, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
