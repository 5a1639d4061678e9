// The blocked probe stream's glue on Hopper (sm_90a): the chunk plan before
// the probe kernel, and after it the tail with the residual gather that
// feeds the search epilogue (kernel D). Two launches a stream batch.
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU and skips the overflow routing and the residual pass
// with lax.cond when they are empty: colorid_tpu/ops/stream_query.py::
// _stream_core (:895-1029), its window plan (:924-929), the merge of the
// kernel's accumulators (:935-947), the overflow list (:954-973), the
// chunk-granular residual pass (:979-1028), and around it the unpacking of
// the sorted key in stream_accumulate_hash[_exact] (:622, :676). Its plain
// PyTorch twins are colorid_tpu_torch/ops/stream_query.py::
// stream_chunk_plan_plain and stream_tail_plain; kernels and twins agree bit
// for bit, and composed with the probe kernel and the epilogue they equal
// _stream_core_plain.
//
// stream_plan_launch (D1), one block a chunk of pc probes. From the key
// sorted with its payloads by kernel E (csrc/radix_sort.cu), the frequency
// in its low qbits: blk_s and qc_s, its bits; or from probes sorted already
// (blk_s and qc_s read). Then tb = clamp(blk_s[c * pc] // T, 0, tb_hi), the
// window test blk < (tb + nt) * T, qcw = qc where in the window, else 0,
// all with 16-byte accesses. Each chunk publishes whether it has residual
// probes (outside its window, qc > 0) to a decoupled look-back over the
// chunks; only a chunk that has some walks back, for the number r of such
// chunks before it, and writes cidx[r] = c while r < nch. n_real (the
// probes with qcw > 0), n_cov (the chunks listed) and the residual probes
// of the chunks past nch are added by atomics; the list's other entries
// stay -1. That is the JAX package's covered = has_res & cumsum(has_res)
// <= nch, in chunk order.
//
// stream_tail_launch (D2), after the probe kernel, one launch of two kinds
// of block:
//   gather blocks, one thread a row of the residual list's capacity (n_slots
//     * pc rows): the row of a listed chunk whose probe is a residual one
//     gets the AND and presence of its H rows in their block (the H loads
//     issued together), its qc and its payload, in the layout of the
//     epilogue's AND-words mode (andw [n_slots * pc, W], present, mask, q,
//     gidx); every other row, the rows of slots past n_cov included, is
//     zero and masked.
//   tile blocks, one a tile of 2,048 probes: the tile's valid probes (uniq
//     > -2) and big ones (uniq >= 0 and qc >= hw) from 16-byte loads,
//     hist[:, :hw] += hist_out[:C] over the tiles; each tile publishes its
//     big count to a look-back over the tiles, and only a tile that has big
//     probes walks back for its first rank and adds (uniq, gidx) to slots
//     n_over + rank below capO while rank < over_cap, in probe order. The
//     last tile to finish (a ticket after a fence) adds counts into stats,
//     ANDs the AND words (counts == n_valid) into the running ones,
//     multiplies the all-valid flag by (n_valid == n_real), adds min(n_big,
//     over_cap) to n_over and writes n_drop = max(n_big - over_cap, 0) +
//     the plan's dropped residual probes.
// Blocks start in index order, so a look-back (csrc/look_back.cuh) waits
// only on blocks that have started and publish without waiting themselves.
//
// What bounds it on an H100: bytes. D1 reads the sorted key and writes
// blk_s, qc_s and qcw, 16 bytes a probe (12 from probes sorted already); D2
// reads uniq and qc, 8 bytes a probe, and the residual gather writes a few
// MB. The operations are a few integer instructions a probe. The earlier
// design took five launches through three wrappers: D2 counted the tiles, re-read
// every tile count in each block of its overflow kernel, and listed the
// residual chunks in one block of 1,024 threads (two scans over the chunks
// on one SM); D3 gathered in one block a slot, eight probes a thread one
// after another, each row's AND read and written in device memory. Here
// the chunk list comes out of the plan's own pass, the overflow list and
// the statistics out of the tail's pass, and the gather runs at one thread
// a row beside the tiles: two launches a batch. On this card (tail_bench.py,
// PERF.md) a block's life is short, so any round trip that every block
// waits for at its end costs the pass some 0.015-0.02 ms: a look-back in
// every chunk, or a ticket for a last block that lists the chunks, did;
// so a block without residual probes (or big ones) publishes and goes.
// Nothing waits for the device: counts stay on the card, and the
// epilogue's N is the list's capacity.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): plain C
// entry points that clear their scratch (cudaMemsetAsync), launch on the
// caller's stream and return cudaGetLastError().

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "look_back.cuh"

namespace {

constexpr int T = 128;  // blocks a tile
constexpr int THREADS = 256;  // threads a chunk of D1
constexpr int WARPS = THREADS / 32;
constexpr int TT = 256;  // threads a block of D2
constexpr int TWARPS = TT / 32;
constexpr int TILE = TT * 8;  // probes a tile of D2: two 16-byte loads a thread
constexpr int FREQ_CAP = 1024;
constexpr unsigned FULL = 0xffffffffu;
// a look-back status word: the flag in the top two bits, a count below
using Status = LookBack<uint32_t>;
constexpr uint32_t AGG = Status::AGG, INC = Status::INC;
// D2's counters at the head of its scratch (int32 words): [1] the done
// ticket, [4, 8) n_valid and n_big as 64-bit sums
constexpr int TAIL_HEAD = 8;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct PlanParams {
  const int32_t* key;  // [P] sorted keys, the frequency in the low qbits, or nullptr
  int32_t qbits;
  int32_t* blk_s;  // [P] written from the key, or read
  int32_t* qc_s;
  int32_t* qcw;
  int64_t n_chunks;
  int32_t pc, nt;
  int64_t tb_hi;
  int32_t nch, n_slots;
  int32_t* meta;     // [3]: n_real, n_cov, the residual probes past nch (zeroed)
  uint32_t* status;  // [n_chunks] (zeroed)
  int32_t* cidx;     // [n_slots] (all -1)
};

__device__ __forceinline__ int4 ld4(const int32_t* a) {
  return __ldg(reinterpret_cast<const int4*>(a));
}

// Four probes of D1 at o: the block and frequency from the key a (blk_s and
// qc_s written), or a = blk_s and q = qc_s read; qcw written, the residual
// and counted probes added to res and real.
__device__ __forceinline__ void plan4(const PlanParams& p, int64_t o, int4 a, int4 q,
                                      int64_t lim, int& res, int& real) {
  int bk[4] = {a.x, a.y, a.z, a.w}, qc[4] = {q.x, q.y, q.z, q.w}, w[4];
  if (p.key) {  // sorted with its payloads: the frequency in the key
    const int32_t qmask = (1 << p.qbits) - 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qc[e] = bk[e] & qmask;
      bk[e] >>= p.qbits;
    }
    *reinterpret_cast<int4*>(p.blk_s + o) = make_int4(bk[0], bk[1], bk[2], bk[3]);
    *reinterpret_cast<int4*>(p.qc_s + o) = make_int4(qc[0], qc[1], qc[2], qc[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool inwin = (int64_t)bk[e] < lim;
    w[e] = inwin ? qc[e] : 0;
    res += !inwin && qc[e] > 0;
    real += w[e] > 0;
  }
  *reinterpret_cast<int4*>(p.qcw + o) = make_int4(w[0], w[1], w[2], w[3]);
}

// D1: one block a chunk.
__global__ void __launch_bounds__(THREADS) plan_kernel(PlanParams p) {
  __shared__ int s_red[2][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the card starts blocks in index order: a look-back waits on started blocks only
  const int64_t c = blockIdx.x;
  const int64_t i0 = c * p.pc;
  const int64_t first = p.key ? p.key[i0] >> p.qbits : p.blk_s[i0];
  long long tb = floor_div(first, T);
  tb = tb < 0 ? 0 : tb;
  tb = tb > p.tb_hi ? p.tb_hi : tb;
  const int64_t lim = (tb + p.nt) * T;
  const int32_t* src = p.key ? p.key : p.blk_s;
  const int q4 = p.pc / 4;
  int res = 0, real = 0;
  for (int j = tid; j < q4; j += 2 * THREADS) {
    // both of a thread's 16-byte loads in flight before any store
    const bool two = j + THREADS < q4;
    const int64_t o0 = i0 + 4 * j, o1 = o0 + 4 * THREADS;
    const int4 a0 = ld4(src + o0), a1 = two ? ld4(src + o1) : a0;
    const int4 q0 = p.key ? a0 : ld4(p.qc_s + o0);
    const int4 q1 = p.key ? a1 : two ? ld4(p.qc_s + o1) : q0;
    plan4(p, o0, a0, q0, lim, res, real);
    if (two) plan4(p, o1, a1, q1, lim, res, real);
  }
  res = warp_sum(res);
  real = warp_sum(real);
  if (lane == 0) {
    s_red[0][warp] = res;
    s_red[1][warp] = real;
  }
  __syncthreads();
  if (warp) return;
  res = warp_sum(lane < WARPS ? s_red[0][lane] : 0);
  real = warp_sum(lane < WARPS ? s_red[1][lane] : 0);
  if (lane == 0 && real) atomicAdd(p.meta, real);
  if (res == 0) {  // nothing to list: publish and go, no wait
    if (lane == 0) Status::publish(p.status, c, c == 0 ? INC : AGG);
    return;
  }
  if (lane == 0) Status::publish(p.status, c, (c == 0 ? INC : AGG) | 1);
  // only a chunk with residual probes walks back, for its rank in the list
  const uint32_t rank = c ? Status::look_back(p.status, c) : 0;
  if (lane == 0) {
    if (c) Status::publish(p.status, c, INC | (rank + 1));
    if (rank < (uint32_t)p.nch) {
      p.cidx[rank] = (int32_t)c;
      atomicAdd(p.meta + 1, 1);  // n_cov: the chunks listed
    } else {
      atomicAdd(p.meta + 2, res);
    }
  }
}

struct TailParams {
  const int32_t* uniq;  // [P] the probe kernel's
  const int32_t* qc_s;  // [P]
  const int32_t* qcw;   // [P] the plan's
  const int32_t* gidx;  // [P] the overflow payload (qc_s itself in exact mode)
  const int32_t* blk_s;
  const int32_t* off_s;
  int64_t P, n_tiles, n_gather;
  int32_t hw;
  const int32_t* counts;    // [32 * W] the probe kernel's
  const int32_t* hist_out;  // [cp, hw] the probe kernel's
  int32_t C, W;
  int32_t* stats;  // [C + W + 2]
  int32_t* hist;   // [C, FREQ_CAP]
  int32_t* over_col;
  int32_t* over_freq;
  int64_t capO, over_cap;
  const int32_t* cidx;  // [n_slots] the plan's list
  const int32_t* meta;  // [3] the plan's: n_real, n_cov, residual probes past nch
  int32_t n_slots, pc, H, rpb;
  const int32_t* blocks;  // [n_blocks, 128]
  int64_t n_blocks;
  int32_t* andw;     // [n_slots * pc, W]
  uint8_t* present;  // [n_slots * pc]
  uint8_t* mask;
  int32_t* q;
  int32_t* gidx_out;
  int32_t* n_drop;  // [1]
  int32_t* head;    // [TAIL_HEAD] (zeroed)
  uint32_t* status;  // [n_tiles] (zeroed)
};

// D2, a gather block: one thread a row of the residual list's capacity.
__device__ void residual_rows(const TailParams& p) {
  const int64_t o = (int64_t)blockIdx.x * TT + threadIdx.x;
  if (o >= (int64_t)p.n_slots * p.pc) return;
  const int64_t slot = o / p.pc;
  const int W = p.W, H = p.H;
  bool live = false;
  int64_t src = 0;
  int32_t qv = 0;
  if (slot < p.meta[1]) {
    src = (int64_t)p.cidx[slot] * p.pc + (o - slot * p.pc);
    qv = p.qc_s[src];
    live = qv > 0 && p.qcw[src] == 0;  // counted, outside its chunk's window
  }
  if (!live) {
    for (int w = 0; w < W; ++w) p.andw[o * W + w] = 0;
    p.present[o] = 0;
    p.mask[o] = 0;
    p.q[o] = 0;
    p.gidx_out[o] = 0;
    return;
  }
  const uint32_t blk = (uint32_t)p.blk_s[src];
  const uint32_t off = (uint32_t)p.off_s[src];
  const int32_t g = p.gidx[src];
  // the rows of the twin (ops/stream_query.py::_residual_rows), in int32,
  // and their block from hash 0's row (ops/query.py::_gather_rows_blocked)
  const int64_t b = floor_div((int32_t)(blk * (uint32_t)p.rpb + (off & 0xFFu)), p.rpb);
  const bool inb = b >= 0 && b < p.n_blocks;
  const int32_t* row = p.blocks + (inb ? b : 0) * 128;
  int64_t lane0[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int64_t rh = (int32_t)(blk * (uint32_t)p.rpb + ((off >> (8 * h)) & 0xFFu));
    lane0[h] = (rh - floor_div(rh, p.rpb) * p.rpb) * W;
  }
  unsigned nz = 0;  // bit h: row h has a nonzero word
  for (int w = 0; w < W; ++w) {
    int32_t x[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) x[h] = inb && h < H ? row[lane0[h] + w] : -1;
    int32_t a = -1;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      a &= x[h];
      nz |= (unsigned)(h < H && x[h] != 0) << h;
    }
    p.andw[o * W + w] = inb ? a : 0;
  }
  p.present[o] = inb && nz == (1u << H) - 1;
  p.mask[o] = 1;
  p.q[o] = qv;
  p.gidx_out[o] = g;
}

// D2, a tile block: counts, the histogram band, the overflow list; the last
// tile to finish, the statistics.
__device__ void tail_tile(const TailParams& p) {
  __shared__ int s_red[2][TWARPS];
  __shared__ uint32_t s_scan[TWARPS];
  __shared__ uint32_t s_first;
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t = blockIdx.x - p.n_gather;  // tiles after the gather blocks, in index order
  // probes t * TILE + g * 1,024 + 4 * tid + e for g 0, 1 and e 0..3 (P % 4 == 0)
  unsigned big = 0;  // bit 4 g + e
  int nv = 0;
  int4 uv[2], qv[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {  // both groups' loads in flight first
    const int64_t o = t * TILE + g * (TILE / 2) + 4 * tid;
    uv[g] = o < p.P ? ld4(p.uniq + o) : make_int4(-2, -2, -2, -2);
    qv[g] = o < p.P ? ld4(p.qc_s + o) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int uu[4] = {uv[g].x, uv[g].y, uv[g].z, uv[g].w};
    const int qq[4] = {qv[g].x, qv[g].y, qv[g].z, qv[g].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nv += uu[e] > -2;
      big |= (unsigned)(uu[e] >= 0 && qq[e] >= p.hw) << (4 * g + e);
    }
  }
  int v = warp_sum(nv), nb = warp_sum(__popc(big));
  if (lane == 0) {
    s_red[0][warp] = v;
    s_red[1][warp] = nb;
  }
  __syncthreads();
  v = nb = 0;
  for (int w = 0; w < TWARPS; ++w) {
    v += s_red[0][w];
    nb += s_red[1][w];
  }
  if (tid == 0) {
    Status::publish(p.status, t, (t == 0 ? INC : AGG) | (uint32_t)nb);
    unsigned long long* sums = reinterpret_cast<unsigned long long*>(p.head + 4);
    if (v) atomicAdd(sums, (unsigned long long)v);
    if (nb) atomicAdd(sums + 1, (unsigned long long)nb);
  }
  const int64_t cells = (int64_t)p.C * p.hw;
  for (int64_t j = t * TT + tid; j < cells; j += p.n_tiles * TT) {
    const int64_t c = j / p.hw, q = j % p.hw;
    p.hist[c * FREQ_CAP + q] += p.hist_out[j];
  }
  if (nb) {  // the same for the whole block: its first rank, then its entries in probe order
    const long long n_over = p.stats[p.C + p.W + 1];  // the finisher adds to it after every tile
    if (warp == 0) {
      const uint32_t first = t ? Status::look_back(p.status, t) : 0;
      if (lane == 0) {
        if (t) Status::publish(p.status, t, INC | (first + (uint32_t)nb));
        s_first = first;
      }
    }
    // a thread's big probes of group 0 in the low half, of group 1 in the high
    const uint32_t mine = __popc(big & 0xFu) | (uint32_t)__popc(big >> 4) << 16;
    uint32_t incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    uint32_t ex = incl - mine, tot = 0;
    for (int w = 0; w < TWARPS; ++w) {
      ex += w < warp ? s_scan[w] : 0;
      tot += s_scan[w];
    }
    const long long first = s_first;
    long long r0 = first + (ex & 0xFFFFu), r1 = first + (tot & 0xFFFFu) + (ex >> 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!(big >> k & 1)) continue;
      const long long r = k < 4 ? r0++ : r1++;
      const long long to = n_over + r;
      if (r < p.over_cap && to < p.capO) {
        const int64_t i = t * TILE + (k >> 2) * (TILE / 2) + 4 * tid + (k & 3);
        p.over_col[to] += p.uniq[i];
        p.over_freq[to] += p.gidx[i];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.head + 1, 1) == p.n_tiles - 1;
  __syncthreads();
  if (!s_last) return;
  // the last tile to finish: every tile's counts are in
  __threadfence();
  const volatile unsigned long long* sums =
      reinterpret_cast<const volatile unsigned long long*>(p.head + 4);
  const long long n_valid = (long long)sums[0], n_big = (long long)sums[1];
  const int C = p.C, W = p.W;
  for (int c = tid; c < C; c += TT) p.stats[c] += p.counts[c];
  for (int w = tid; w < W; w += TT) {
    uint32_t a = 0;
    for (int b = 0; b < 32; ++b) a |= (uint32_t)(p.counts[32 * w + b] == n_valid) << b;
    p.stats[C + w] &= (int32_t)a;
  }
  if (tid == 0) {
    p.stats[C + W] *= (int32_t)(n_valid == (long long)p.meta[0]);
    p.stats[C + W + 1] += (int32_t)(n_big < p.over_cap ? n_big : p.over_cap);
    const long long over = n_big - p.over_cap;
    p.n_drop[0] = (int32_t)(uint32_t)(uint64_t)((over > 0 ? over : 0) + p.meta[2]);
  }
}

__global__ void __launch_bounds__(TT) tail_kernel(TailParams p) {
  if ((int64_t)blockIdx.x < p.n_gather)
    residual_rows(p);
  else
    tail_tile(p);
}

}  // namespace

// D1. key: the int32 key [P] sorted with its payloads (kernel E), the
// frequency in its low qbits (1..30); blk_s and qc_s [P] are written. key ==
// nullptr: blk_s and qc_s are read (probes sorted already). qcw [P] is
// written; every [P] stream 16-byte aligned. small: int32 [4 + P / pc +
// n_slots], set here: meta [3] (n_real, n_cov, the residual probes of the
// chunks past nch) and a pad word, the look-back's status words (zeroed),
// then the list cidx [n_slots] (-1, the first n_cov entries written by the
// kernel). P % pc == 0, pc % 4 == 0; tb_hi = n_blocks / 128 - nt.
extern "C" int stream_plan_launch(const void* key, int32_t qbits, void* blk_s, void* qc_s,
                                  void* qcw, int64_t P, int32_t pc, int32_t nt, int64_t tb_hi,
                                  int32_t nch, int32_t n_slots, void* small, void* stream) {
  const int64_t n_chunks = pc > 0 ? P / pc : 0;
  if (P < 0 || P >= (int64_t)1 << 30 || pc <= 0 || pc % 4 || P % pc || nt < 1 || nch < 0 ||
      n_slots != (nch < n_chunks ? nch : n_chunks) || (key && (qbits < 1 || qbits > 30)))
    return (int)cudaErrorInvalidValue;
  for (const void* a : {key, (const void*)blk_s, (const void*)qc_s, (const void*)qcw})
    if ((uintptr_t)a % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* meta = (int32_t*)small;
  cudaError_t e = cudaMemsetAsync(meta, 0, (4 + n_chunks) * 4, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(meta + 4 + n_chunks, 0xFF, n_slots * 4, st);
  if (e != cudaSuccess || P == 0) return (int)e;
  PlanParams p{};
  p.key = (const int32_t*)key;
  p.qbits = key ? qbits : 0;
  p.blk_s = (int32_t*)blk_s;
  p.qc_s = (int32_t*)qc_s;
  p.qcw = (int32_t*)qcw;
  p.n_chunks = n_chunks;
  p.pc = pc;
  p.nt = nt;
  p.tb_hi = tb_hi;
  p.nch = nch;
  p.n_slots = n_slots;
  p.meta = meta;
  p.status = (uint32_t*)(meta + 4);
  p.cidx = meta + 4 + n_chunks;
  plan_kernel<<<(unsigned)n_chunks, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// D2. uniq, qc_s, qcw, gidx (the overflow payload), blk_s, off_s [P], uniq
// and qc_s 16-byte aligned; counts [32 * W] and hist_out [cp, hw] from the
// probe kernel; the accumulators stats [C + W + 2], hist [C, 1024],
// over_col / over_freq [capO]; cidx [n_slots] and meta [3] from D1; blocks
// [n_blocks, 128]. out32: int32 [N * W + 2 N + 2 + TAIL_HEAD + max(1,
// ceil(P / 2048))] with N = n_slots * pc: andw [N, W], q [N], gidx [N] out,
// then n_drop, a pad word and the scratch, cleared here; out8: present and
// mask [N] out.
extern "C" int stream_tail_launch(const void* uniq, const void* qc_s, const void* qcw,
                                  const void* gidx, const void* blk_s, const void* off_s,
                                  int64_t P, int32_t hw, const void* counts,
                                  const void* hist_out, int32_t C, int32_t W, void* stats,
                                  void* hist, void* over_col, void* over_freq, int64_t capO,
                                  int64_t over_cap, const void* cidx, const void* meta,
                                  int32_t n_slots, int32_t pc, int32_t H, int32_t rpb,
                                  const void* blocks, int64_t n_blocks, void* out32, void* out8,
                                  void* stream) {
  if (P < 0 || P >= (int64_t)1 << 30 || P % 4 || hw < 1 || hw > FREQ_CAP || C < 0 || W < 1 ||
      C > 32 * W || capO < 0 || over_cap < 0 || n_slots < 0 || pc <= 0 || pc % 2 || H < 1 ||
      H > 4 || rpb < 1 || (int64_t)rpb * W > 128 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)uniq % 16 || (uintptr_t)qc_s % 16) return (int)cudaErrorMisalignedAddress;
  const int64_t N = (int64_t)n_slots * pc;
  const int64_t n_tiles = P ? (P + TILE - 1) / TILE : 1;  // one tile at least: the finisher
  TailParams p{};
  p.uniq = (const int32_t*)uniq;
  p.qc_s = (const int32_t*)qc_s;
  p.qcw = (const int32_t*)qcw;
  p.gidx = (const int32_t*)gidx;
  p.blk_s = (const int32_t*)blk_s;
  p.off_s = (const int32_t*)off_s;
  p.P = P;
  p.n_tiles = n_tiles;
  p.n_gather = (N + TT - 1) / TT;
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
  p.cidx = (const int32_t*)cidx;
  p.meta = (const int32_t*)meta;
  p.n_slots = n_slots;
  p.pc = pc;
  p.H = H;
  p.rpb = rpb;
  p.blocks = (const int32_t*)blocks;
  p.n_blocks = n_blocks;
  p.andw = (int32_t*)out32;
  p.q = p.andw + N * W;
  p.gidx_out = p.q + N;
  p.n_drop = p.gidx_out + N;  // N * W + 2 N is even: the head's 64-bit sums are aligned
  p.head = p.n_drop + 2;
  p.status = (uint32_t*)(p.head + TAIL_HEAD);
  p.present = (uint8_t*)out8;
  p.mask = p.present + N;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(p.n_drop, 0, (2 + TAIL_HEAD + n_tiles) * 4, st);
  if (e != cudaSuccess) return (int)e;
  tail_kernel<<<(unsigned)(p.n_gather + n_tiles), TT, 0, st>>>(p);
  return (int)cudaGetLastError();
}
