// The reads routes' counting glue on Hopper (sm_90a): run lengths, the -f
// filter and the compactions over value-sorted window keys (kernel F).
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU: the run starts, the reversed running minimum of the
// next start and the strictly-greater filter (kmer.rs:826-837) with
//   the pairwise selects of colorid_tpu/ops/fused_reads.py::
//     fused_search_reads (:97-128),
//   the per-chunk counts of extract_sorted_counts (:185-196),
//   the 3-key sort that puts the live entries first in compact_sorted
//     (:204-206),
//   the cross-chunk sums of fused_merge_query (:251-272),
//   the scatter compaction of colorid_tpu/ops/extract.py::extract_count
//     (:188-207) and the run lengths of count_histogram (:242-257).
// Its plain PyTorch twin is colorid_tpu_torch/ops/extract.py::
// run_counts_plain; kernel and twin agree bit for bit in every mode.
//
// Input: s int64 [P], sorted; equal keys form a run, SENT = 2^63 - 1 marks
// padding. Each slot has a weight: 1, or the int32 w[i] (the merge's partial
// counts). A run's total is the sum of its weights (its length at weight 1).
// A run is kept where its key is not SENT and total > filter_t and total > 0.
// Modes (run_counts_launch's mode):
//   0 select: q[o] for o < P >> rounds: the slots grouped by 2^rounds, each
//     group's rightmost kept start, else its first slot; q = its total where
//     kept, else 0; with rounds > 0 also out_s[o] = that slot's key. Covers
//     the single route's pairs (after its rounds of pairwise selects), chunk
//     A's counts (filter_t 0, rounds 0) and the merge's totals (weights).
//   1 compact: the kept starts first, in key order, as out_pk [P] int64
//     (the (lo, hi) limbs of the key, i.e. key ^ 2^63, as two int32) and
//     their totals q [P]; every later slot zero.
//   2 partition: a slot is live where w != 0; the live slots in key order,
//     then the dead ones in key order, the first cap of them as out_s, q.
// n_unique: the kept runs (partition: the live slots), an int32 on the card.
//
// A block takes a tile of TILE = 4,096 keys, 16 a thread (a thread's keys
// are consecutive, staged in shared memory from 16-byte loads, one pad word
// every 16 so the threads' reads do not share banks). A run may span many
// tiles (the padding's SENT run spans millions of slots): a start's total
// needs the next start, which for the tile's last start lies past the
// tile. The block finds it by reading on past its end until a key differs
// (256 keys, loaded with the tile, then twice as many a round up to a tile;
// usually the first few keys), and not at all where that run is SENT,
// which is never kept.
//   select mode: one launch (after a memset of n_unique): each tile's
//     totals, its groups' picks staged in shared memory and written with
//     16-byte stores; n_unique by one atomic a block.
//   compact mode: one launch reads the keys (after a memset of the tiles'
//     status words): each tile's kept runs, their number published at once,
//     its place by a decoupled look-back over the tiles before it, its
//     outputs staged in shared memory and written as one run with 16-byte
//     stores; the last tile writes n_unique. A second launch reads no key:
//     it zeroes [n_unique, P) from n_unique on the card.
//   partition mode: two launches (after the same memset). The first reads
//     only the weights (liveness is w != 0), 16 bytes a load, a block four
//     tiles: their live slots and, by the same look-back over the blocks,
//     the live slots before each tile; the last block writes n_live. A
//     dead slot's place, n_live + (slots before)
//     - (live before), needs n_live, which only the end of that launch
//     knows: so the second launch places the slots. A tile whose live and
//     dead slots all land at or past cap returns before it loads anything;
//     any other reads its weights, ranks them, and reads only the keys of
//     the slots it writes below cap, through each slot's place in the tile
//     staged in shared memory; its live run and its dead run go out
//     contiguously, with 16-byte stores where aligned.
// Blocks start in index order, so a look-back (csrc/look_back.cuh) waits
// only on tiles that have started, and each publishes before it waits. A
// status word is 64 bits: a flag in the top two bits over a count, which
// reaches P < 2^31 (the 30 bits of csrc/stream_tail.cu's 32-bit word would
// not hold it). Positions and sums are int64.
//
// What bounds it on an H100: bytes. The function reads the keys and the
// weights once (partition mode only the keys of the slots it writes) and
// writes its outputs once: up to 12 bytes a slot read, 4 to 12 written by
// mode. Select and compact modes read the keys once, and a few keys past
// each tile; partition mode reads the weights twice (4 bytes a slot, once
// to count and once to place). The operations are a few integer
// instructions a key.
//
// Why this shape (counts_bench.py's candidates on an H100 80GB HBM3 at
// 700 W, PERF.md): the look-back is what compact's tile launch
// waits on (0.34 ms a call at 52 M keys, 0.23 with the places faked and no
// look-back): a tile waits until every tile before it down to one that
// has its full prefix has published. More blocks an SM hide some of it
// (80 registers a thread and no weights in registers: three blocks, 0.38
// -> 0.34 ms); wider look-back rounds, a pause between reads, 64
// registers (spills), and a persistent grid that copies its next tile in
// (cp.async) while it waits were all slower. The zero tail as its own
// launch beat a memset of the outputs before the tile launch (0.57 against
// 0.58 ms a call), and a count launch a block four tiles beat one a tile
// (0.048 against 0.054 ms); a bit mask of the live slots in place of the
// second read of the weights made the placing launch slower (0.197 against
// 0.172 ms).
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "look_back.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // consecutive keys a thread
constexpr int TILE = THREADS * ITEMS;
constexpr int PADDED = TILE + TILE / 16;
constexpr size_t SMEM = PADDED * (sizeof(int64_t) + sizeof(int32_t));
constexpr int LIVE_SUB = 4;   // tiles a block of partition's count takes
constexpr int ZERO_BLOCKS = 1056;  // the zero tail's grid at most: 8 blocks an SM
constexpr int64_t SENT = INT64_MAX;
constexpr unsigned FULL = 0xffffffffu;
// a tile's status word: the flag in the top two bits over a count
using Status = LookBack<uint64_t>;
constexpr uint64_t AGG = Status::AGG, INC = Status::INC;

enum Mode : int { SELECT = 0, COMPACT = 1, PARTITION = 2 };

struct Params {
  const int64_t* s;
  const int32_t* w;  // weights, or nullptr: 1 a slot
  int64_t P;
  int64_t n_tiles;
  int64_t filter_t;
  int64_t cap;
  int64_t* out_s;
  int32_t* out_q;
  int64_t* out_pk;
  uint64_t* status;  // compact: [n_tiles]; partition: [n_tiles / LIVE_SUB, rounded up];
                     // zero before the first launch
  int64_t* live_before;  // partition: [n_tiles] the live slots of the tiles before each
  int32_t* n_unique;
};

struct Scratch {
  int64_t warp_tot[32];
  int64_t wf_pre[WARPS];  // the weight before each warp's first start
  int32_t wf_pos[WARPS];  // each warp's first start in the tile, or -1
  int64_t prev;           // the key before the tile
  int64_t last_key;       // the key of the tile's last start
  int64_t excl;           // compact: the kept runs of the tiles before this one
};

// a thread's keys and their weights, in registers
struct Items {
  int64_t key[ITEMS];
  int32_t w[ITEMS];
  uint32_t starts;   // bit i: item i starts a run
  int64_t tp;        // the weight before the thread's items in the tile
  int64_t tw;        // the thread's weight
  int64_t tile_w;    // the tile's weight
  int64_t nxt_pre;   // the weight before the next start in a later thread of the tile
  bool nxt_in;       // there is one
  int64_t peek_key;  // the key tid slots past the tile's end and its weight, loaded
  int32_t peek_w;    // with the tile for tail_weight's first round
};

__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

// exclusive sum over the block's threads (every thread calls it); total is
// the block's sum
__device__ __forceinline__ int64_t block_excl_sum(int64_t v, int64_t* warp_tot, int64_t& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int64_t t = lane < WARPS ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    if (lane < WARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  const int64_t before = wid ? warp_tot[wid - 1] : 0;
  total = warp_tot[WARPS - 1];
  __syncthreads();
  return before + x - v;
}

// the minimum over the block's threads (every thread calls it and gets it)
__device__ __forceinline__ int64_t block_min(int64_t v, int64_t* warp_tot) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t r = warp_tot[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = min(r, warp_tot[i]);
  __syncthreads();
  return r;
}

// Unit t's place among n units (tiles, or partition's groups of them), its
// own count being c: publishes c, walks back (warp 0; unit 0 waits for
// nothing), publishes c and every count before it, and the last unit
// writes the total to n_unique. Returns the counts of the units before t
// to warp 0's threads.
__device__ __forceinline__ int64_t tile_place(const Params& p, int64_t t, int64_t n, int64_t c) {
  if (threadIdx.x == 0) Status::publish(p.status, t, (t ? AGG : INC) | (uint64_t)c);
  const int64_t excl = t ? (int64_t)Status::look_back(p.status, t) : 0;
  if (threadIdx.x == 0) {
    if (t) Status::publish(p.status, t, INC | (uint64_t)(excl + c));
    if (t == n - 1) *p.n_unique = (int32_t)(excl + c);
  }
  return excl;
}

// dst[0, len) = val(0), ..., val(len - 1) by the block's threads, in 16-byte
// stores where dst is aligned
template <class F>
__device__ __forceinline__ void write_run64(int64_t* dst, int64_t len, F val) {
  if (len <= 0) return;
  const int head = (int)min(len, (int64_t)(((uintptr_t)dst >> 3) & 1));
  const int nv = (int)((len - head) >> 1);
  if ((int)threadIdx.x < head) dst[0] = val(0);
  longlong2* dv = reinterpret_cast<longlong2*>(dst + head);
  for (int v = threadIdx.x; v < nv; v += THREADS)
    dv[v] = make_longlong2(val(head + 2 * v), val(head + 2 * v + 1));
  if (threadIdx.x == 0 && head + 2 * nv < len) dst[len - 1] = val((int)len - 1);
}

template <class F>
__device__ __forceinline__ void write_run32(int32_t* dst, int64_t len, F val) {
  if (len <= 0) return;
  const int head = (int)min(len, (int64_t)((4 - (((uintptr_t)dst >> 2) & 3)) & 3));
  const int nv = (int)((len - head) >> 2), done = head + 4 * nv;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = val((int)threadIdx.x);
  int4* dv = reinterpret_cast<int4*>(dst + head);
  for (int v = threadIdx.x; v < nv; v += THREADS) {
    const int e = head + 4 * v;
    dv[v] = make_int4(val(e), val(e + 1), val(e + 2), val(e + 3));
  }
  if ((int)threadIdx.x < len - done) dst[done + threadIdx.x] = val(done + (int)threadIdx.x);
}

// Stage tile t in shared memory, take the thread's items into registers,
// and find where the runs start and the weights before them. Every thread
// calls it; sk and sw may be written after the next __syncthreads. W: the
// call may have weights (p.w, where not nullptr); without, every slot
// weighs 1 and the weights take no registers.
template <bool W>
__device__ __forceinline__ void load_items(const Params& p, int64_t t, int n, int64_t* sk,
                                           int32_t* sw, Scratch& sc, Items& it) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, i0 = tid * ITEMS;
  const int32_t* const pw = W ? p.w : nullptr;
  const int64_t base = t * TILE;
  const int64_t* ks = p.s + base;
  if (n == TILE && !((uintptr_t)ks & 15)) {
#pragma unroll
    for (int r = 0; r < TILE / 2 / THREADS; ++r) {
      const int v = r * THREADS + tid;
      const longlong2 x = reinterpret_cast<const longlong2*>(ks)[v];
      sk[pad(2 * v)] = x.x;
      sk[pad(2 * v) + 1] = x.y;
    }
  } else {
    for (int e = tid; e < TILE; e += THREADS) sk[pad(e)] = e < n ? ks[e] : SENT;
  }
  if (pw) {
    const int32_t* ws = pw + base;
    if (n == TILE && !((uintptr_t)ws & 15)) {
#pragma unroll
      for (int r = 0; r < TILE / 4 / THREADS; ++r) {
        const int v = r * THREADS + tid;
        const int4 x = reinterpret_cast<const int4*>(ws)[v];
        const int e = pad(4 * v);
        sw[e] = x.x;
        sw[e + 1] = x.y;
        sw[e + 2] = x.z;
        sw[e + 3] = x.w;
      }
    } else {
      for (int e = tid; e < TILE; e += THREADS) sw[pad(e)] = e < n ? ws[e] : 0;
    }
  }
  if (tid == 0) sc.prev = base ? p.s[base - 1] : SENT;
  {  // the first keys past the tile, for tail_weight
    const int64_t e = base + TILE + tid;
    it.peek_key = e < p.P ? p.s[e] : SENT;
    it.peek_w = pw && e < p.P ? pw[e] : 0;
  }
  __syncthreads();
  int64_t prev = i0 ? sk[pad(i0 - 1)] : sc.prev;
  it.starts = 0;
  it.tw = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = i0 + i;
    const bool valid = e < n;
    it.key[i] = sk[pad(e)];
    it.w[i] = valid ? (pw ? sw[pad(e)] : 1) : 0;
    const bool st = valid && (base + e == 0 || it.key[i] != prev);
    prev = it.key[i];
    it.starts |= (uint32_t)st << i;
    it.tw += it.w[i];
  }
  if (pw) {
    it.tp = block_excl_sum(it.tw, sc.warp_tot, it.tile_w);
  } else {  // a slot weighs 1: the weight before the thread is its first slot
    it.tp = min(i0, n);
    it.tile_w = n;
  }
  // the thread's first start and the weight before it
  const int f = it.starts ? __ffs(it.starts) - 1 : ITEMS;
  int64_t pre_f = it.tp;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (i < f) pre_f += it.w[i];
  const unsigned m = __ballot_sync(FULL, it.starts != 0);
  if (lane == (m ? __ffs(m) - 1 : 0)) {
    sc.wf_pos[wid] = m ? i0 + f : -1;
    sc.wf_pre[wid] = pre_f;
  }
  const unsigned later = m & ~((2u << lane) - 1u);  // lanes after this one with a start
  const int64_t pre_later = __shfl_sync(FULL, pre_f, later ? __ffs(later) - 1 : lane);
  __syncthreads();
  it.nxt_in = later != 0;
  it.nxt_pre = pre_later;
  for (int v = wid + 1; !it.nxt_in && v < WARPS; ++v)
    if (sc.wf_pos[v] >= 0) {
      it.nxt_in = true;
      it.nxt_pre = sc.wf_pre[v];
    }
}

// The weight from the tile's first slot to the first run start past the
// tile (or to P). Only the run that the tile's last start opens can cross
// the tile's end: the block reads on from the end, 256 keys (loaded with the
// tile, so that the common case waits for no load here) and then twice as
// many a round up to a tile, until a key differs from that run's. A SENT
// run is never kept, so its end is not looked for (it may span millions of
// slots); a long run of another key costs its length in reads, once, in
// the block of its start. Every thread calls it and gets the same value.
template <bool W>
__device__ int64_t tail_weight(const Params& p, int64_t end, const Items& it, Scratch& sc) {
  const int32_t* const pw = W ? p.w : nullptr;
  if (it.starts && !it.nxt_in) {  // the key of this thread's last start (no dynamic index:
    int64_t k = 0;                  // the items stay in registers)
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if ((it.starts >> i) & 1) k = it.key[i];
    sc.last_key = k;
  }
  __syncthreads();
  bool has = false;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) has |= sc.wf_pos[v] >= 0;
  if (!has || sc.last_key == SENT) return it.tile_w;
  const int64_t K = sc.last_key;
  int64_t extra = 0;
  for (int chunk = THREADS; end < p.P; chunk = min(2 * chunk, TILE)) {
    const bool peeked = chunk == THREADS;  // the first round: the keys in registers
    const int64_t m = min((int64_t)chunk, p.P - end);
    int64_t stop;  // the first slot of [end, end + m) whose key is not K, else m
    if (peeked) {  // the keys are sorted: those equal to K come first
      stop = __syncthreads_count(threadIdx.x < m && it.peek_key == K);
    } else {
      int64_t first = m;
      for (int64_t e = threadIdx.x; e < m; e += THREADS)
        if (p.s[end + e] != K) {
          first = e;
          break;
        }
      stop = block_min(first, sc.warp_tot);
    }
    if (pw) {
      int64_t ws = peeked && threadIdx.x < stop ? it.peek_w : 0, tot;
      for (int64_t e = threadIdx.x + (peeked ? THREADS : 0); e < stop; e += THREADS)
        ws += pw[end + e];
      block_excl_sum(ws, sc.warp_tot, tot);
      extra += tot;
    } else {
      extra += stop;
    }
    if (stop < m) break;
    end += m;
  }
  return it.tile_w + extra;
}

// Each start's total, from the weight before the next start (in the tile,
// or tail_w past it) less the weight before it: q[i] the total where the
// run is kept, else 0. Returns the kept bits.
__device__ __forceinline__ uint32_t run_totals(const Params& p, const Items& it, int64_t tail_w,
                                               int32_t (&q)[ITEMS]) {
  int64_t nxt_pre = it.nxt_in ? it.nxt_pre : tail_w, suf = 0;
  uint32_t kept = 0;
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    suf += it.w[i];
    q[i] = 0;
    if ((it.starts >> i) & 1) {
      const int64_t pre = it.tp + it.tw - suf;
      const int64_t tot = nxt_pre - pre;
      if (it.key[i] != SENT && tot > p.filter_t && tot > 0) {
        kept |= 1u << i;
        q[i] = (int32_t)tot;
      }
      nxt_pre = pre;
    }
  }
  return kept;
}

#define TILE_SETUP                                                      \
  extern __shared__ __align__(16) unsigned char smem[];                 \
  int64_t* sk = reinterpret_cast<int64_t*>(smem);                       \
  int32_t* sw = reinterpret_cast<int32_t*>(sk + PADDED);                \
  __shared__ Scratch sc;                                                \
  const int tid = threadIdx.x;                                          \
  const int64_t t = blockIdx.x, base = t * TILE;                        \
  const int n = (int)min((int64_t)TILE, p.P - base);                    \
  Items it

// select mode, one launch: a block a tile; each group of G = 2^LG slots
// gives its rightmost kept start, else its first slot (LG rounds of the
// pairwise selects); n_unique by one atomic a block (zeroed before)
template <int LG>
__global__ void __launch_bounds__(THREADS) run_counts_select_kernel(Params p) {
  TILE_SETUP;
  load_items<true>(p, t, n, sk, sw, sc, it);
  int32_t q[ITEMS];
  const uint32_t kept = run_totals(p, it, tail_weight<true>(p, base + n, it, sc), q);
  constexpr int G = 1 << LG, NO = ITEMS / G;
#pragma unroll
  for (int g = 0; g < NO; ++g) {
    int64_t ks = it.key[g * G];
    int32_t qs = q[g * G];
#pragma unroll
    for (int i = 1; i < G; ++i)
      if ((kept >> (g * G + i)) & 1) {
        ks = it.key[g * G + i];
        qs = q[g * G + i];
      }
    const int o = tid * NO + g;
    if (LG) sk[pad(o)] = ks;
    sw[pad(o)] = qs;
  }
  int64_t kt;
  block_excl_sum(__popc(kept), sc.warp_tot, kt);  // its syncs also order sk, sw
  if (tid == 0 && kt) atomicAdd(p.n_unique, (int)kt);
  const int no = n >> LG;
  const int64_t ob = t * (TILE >> LG);
  int32_t* oq = p.out_q + ob;
  if (no == TILE >> LG && !((uintptr_t)oq & 15)) {
    for (int v = tid; v < no / 4; v += THREADS) {
      const int e = pad(4 * v);
      reinterpret_cast<int4*>(oq)[v] = make_int4(sw[e], sw[e + 1], sw[e + 2], sw[e + 3]);
    }
  } else {
    for (int e = tid; e < no; e += THREADS) oq[e] = sw[pad(e)];
  }
  if (LG) {
    int64_t* os = p.out_s + ob;
    if (no == TILE >> LG && !((uintptr_t)os & 15)) {
      for (int v = tid; v < no / 2; v += THREADS) {
        const int e = pad(2 * v);
        reinterpret_cast<longlong2*>(os)[v] = make_longlong2(sk[e], sk[e + 1]);
      }
    } else {
      for (int e = tid; e < no; e += THREADS) os[e] = sk[pad(e)];
    }
  }
}

// compact mode, the launch that reads the keys (no weights): the tile's
// kept runs, their place by the look-back, and their limbs and totals
// written at it; three blocks an SM, so that two compute while one waits
// on its look-back.
__global__ void __launch_bounds__(THREADS, 3) run_counts_compact_kernel(Params p) {
  TILE_SETUP;
  load_items<false>(p, t, n, sk, sw, sc, it);
  int32_t q[ITEMS];
  const uint32_t kept = run_totals(p, it, tail_weight<false>(p, base + n, it, sc), q);
  int64_t kt;
  int r = (int)block_excl_sum(__popc(kept), sc.warp_tot, kt);  // its syncs free sk, sw
  if (tid < 32) {
    const int64_t excl = tile_place(p, t, p.n_tiles, kt);
    if (tid == 0) sc.excl = excl;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if ((kept >> i) & 1) {
      sk[r] = it.key[i] ^ INT64_MIN;  // the (lo, hi) limbs: hi is the key's top word + 2^31
      sw[r] = q[i];
      ++r;
    }
  __syncthreads();
  write_run64(p.out_pk + sc.excl, kt, [&](int e) { return sk[e]; });
  write_run32(p.out_q + sc.excl, kt, [&](int e) { return sw[e]; });
}

// compact mode, second launch (no key read): out_pk and out_q zero on
// [n_unique, P), the grid's threads in turn, 16-byte stores from the first
// 16-byte boundary
template <class T, class V>
__device__ __forceinline__ void zero_range(T* a, int64_t lo, int64_t hi, int64_t g,
                                           int64_t stride) {
  constexpr int K = sizeof(V) / sizeof(T);
  const int64_t mis = (int64_t)(((uintptr_t)(a + lo) / sizeof(T)) % K);
  const int64_t v_lo = min(hi, lo + (mis ? K - mis : 0));  // the first 16-byte boundary
  const int64_t nv = (hi - v_lo) / K, v_hi = v_lo + nv * K;
  for (int64_t e = lo + g; e < v_lo; e += stride) a[e] = 0;
  for (int64_t e = v_hi + g; e < hi; e += stride) a[e] = 0;
  V* av = reinterpret_cast<V*>(a + v_lo);
  const V z = {};
  for (int64_t v0 = (int64_t)blockIdx.x * THREADS * 4 + threadIdx.x; v0 < nv;
       v0 += (int64_t)gridDim.x * THREADS * 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (v0 + k * THREADS < nv) av[v0 + k * THREADS] = z;
  }
}

__global__ void __launch_bounds__(THREADS) run_counts_zero_kernel(Params p) {
  const int64_t nu = *p.n_unique;
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x,
                stride = (int64_t)gridDim.x * THREADS;
  zero_range<int64_t, longlong2>(p.out_pk, nu, p.P, g, stride);
  zero_range<int32_t, int4>(p.out_q, nu, p.P, g, stride);
}

// partition mode, first launch (no key read): the live slots of LIVE_SUB
// tiles from their weights, 16 bytes a load, the group's place by the
// look-back, and each tile's live slots before it
__global__ void __launch_bounds__(THREADS) run_counts_live_kernel(Params p) {
  __shared__ int32_t warp_cnt[WARPS][LIVE_SUB];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int64_t g = blockIdx.x, t0 = g * LIVE_SUB;
  constexpr int R = TILE / 4 / THREADS;  // 16-byte loads a thread a tile
  int c[LIVE_SUB];
  const int4* w4 = reinterpret_cast<const int4*>(p.w + t0 * TILE);
  if ((t0 + LIVE_SUB) * TILE <= p.P && !((uintptr_t)w4 & 15)) {  // every load in flight at once
    int4 x[LIVE_SUB * R];
#pragma unroll
    for (int r = 0; r < LIVE_SUB * R; ++r) x[r] = __ldg(w4 + r * THREADS + tid);
#pragma unroll
    for (int k = 0; k < LIVE_SUB; ++k) {
      c[k] = 0;
#pragma unroll
      for (int r = k * R; r < (k + 1) * R; ++r)
        c[k] += (x[r].x != 0) + (x[r].y != 0) + (x[r].z != 0) + (x[r].w != 0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < LIVE_SUB; ++k) {
      c[k] = 0;
      const int64_t base = (t0 + k) * TILE;
      for (int64_t e = base + tid; e < min(base + TILE, p.P); e += THREADS) c[k] += p.w[e] != 0;
    }
  }
#pragma unroll
  for (int k = 0; k < LIVE_SUB; ++k) {
#pragma unroll
    for (int o = 16; o; o >>= 1) c[k] += __shfl_xor_sync(FULL, c[k], o);
    if (lane == 0) warp_cnt[wid][k] = c[k];
  }
  __syncthreads();
  if (wid) return;
  int64_t own = 0;  // lane k < LIVE_SUB: tile t0 + k's live slots
  if (lane < LIVE_SUB)
#pragma unroll
    for (int v = 0; v < WARPS; ++v) own += warp_cnt[v][lane];
  int64_t pre = own;  // inclusive over the group's tiles
#pragma unroll
  for (int d = 1; d < LIVE_SUB; d <<= 1) {
    const int64_t y = __shfl_up_sync(FULL, pre, d);
    if (lane >= d) pre += y;
  }
  const int64_t total = __shfl_sync(FULL, pre, LIVE_SUB - 1);
  const int64_t excl = tile_place(p, g, (p.n_tiles + LIVE_SUB - 1) / LIVE_SUB, total);
  if (lane < LIVE_SUB && t0 + lane < p.n_tiles) p.live_before[t0 + lane] = excl + pre - own;
}

// partition mode, second launch: the tile's live slots at the live ones
// before it, its dead ones at n_live + its dead ones before it, the first
// cap places of them
__global__ void __launch_bounds__(THREADS) run_counts_partition_kernel(Params p) {
  __shared__ __align__(16) int32_t sw[PADDED];  // the weights, then the live ones in order
  __shared__ uint16_t src[TILE];                // each place's slot in the tile
  __shared__ int64_t warp_tot[32];
  const int tid = threadIdx.x, i0 = tid * ITEMS;
  const int64_t t = blockIdx.x, base = t * TILE;
  const int n = (int)min((int64_t)TILE, p.P - base);
  const int64_t n_live = *p.n_unique, excl = p.live_before[t];
  const int64_t nl = (t + 1 < p.n_tiles ? p.live_before[t + 1] : n_live) - excl;
  const int64_t dead0 = n_live + base - excl;
  const int64_t n_lw = min(nl, p.cap - excl), n_dw = min(n - nl, p.cap - dead0);
  if (n_lw <= 0 && n_dw <= 0) return;  // nothing below cap: no load
  const int32_t* ws = p.w + base;
  if (n == TILE && !((uintptr_t)ws & 15)) {
#pragma unroll
    for (int r = 0; r < TILE / 4 / THREADS; ++r) {
      const int v = r * THREADS + tid;
      const int4 x = __ldg(reinterpret_cast<const int4*>(ws) + v);
      const int e = pad(4 * v);
      sw[e] = x.x;
      sw[e + 1] = x.y;
      sw[e + 2] = x.z;
      sw[e + 3] = x.w;
    }
  } else {
    for (int e = tid; e < TILE; e += THREADS) sw[pad(e)] = e < n ? ws[e] : 0;
  }
  __syncthreads();
  int32_t w[ITEMS];
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    w[i] = sw[pad(i0 + i)];
    live |= (uint32_t)(w[i] != 0) << i;
  }
  int64_t nl_b;
  int l = (int)block_excl_sum(__popc(live), warp_tot, nl_b);  // its syncs free sw
  int d = (int)nl_b + i0 - l;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (i0 + i < n) {
      if ((live >> i) & 1) {
        sw[l] = w[i];
        src[l++] = (uint16_t)(i0 + i);
      } else {
        src[d++] = (uint16_t)(i0 + i);
      }
    }
  __syncthreads();
  const int64_t* ks = p.s + base;
  write_run64(p.out_s + excl, n_lw, [&](int k) { return ks[src[k]]; });
  write_run32(p.out_q + excl, n_lw, [&](int k) { return sw[k]; });
  write_run64(p.out_s + dead0, n_dw, [&](int k) { return ks[src[nl + k]]; });
  write_run32(p.out_q + dead0, n_dw, [](int) { return 0; });  // a dead slot's w is 0
}

// the tile kernels take SMEM bytes of dynamic shared memory, past the 48 KB
// a launch gets without asking: ask once a kernel and card
template <class F>
cudaError_t opt_in(F* fn, int dev, int slot) {
  static bool opted[64][8];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (opted[dev][slot]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e == cudaSuccess) opted[dev][slot] = true;
  return e;
}

template <class F>
cudaError_t launch_tiles(F* fn, int slot, const Params& p, cudaStream_t st, int dev) {
  const cudaError_t e = opt_in(fn, dev, slot);
  if (e != cudaSuccess) return e;
  fn<<<(unsigned)p.n_tiles, THREADS, SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// s int64 [P] sorted, 0 < P < 2^31; w int32 [P] or nullptr (mode 2 needs
// it); mode 0 select (0 <= rounds <= 3, P a multiple of 2^rounds; out_q
// int32 [P >> rounds], out_s int64 [P >> rounds] where rounds > 0), 1
// compact (out_pk int64 [P], out_q int32 [P]), 2 partition (cap >= 0;
// out_s int64 and out_q int32 [min(cap, P)], none at cap 0); n_unique
// int32 [1]; scratch 8 bytes (mode 1) or 16 bytes (mode 2) a tile of 4,096
// keys.
extern "C" int run_counts_launch(const void* s, const void* w, int64_t P, int32_t mode,
                                 int64_t filter_t, int32_t rounds, int64_t cap, void* out_s,
                                 void* out_q, void* out_pk, void* n_unique, void* scratch,
                                 void* stream) {
  if (P <= 0 || P >= ((int64_t)1 << 31) || mode < SELECT || mode > PARTITION || rounds < 0 ||
      rounds > 3 || (mode != SELECT && rounds) || P % ((int64_t)1 << rounds) || !s ||
      (mode != PARTITION && !out_q) || !n_unique || (mode != SELECT && !scratch) ||
      (mode == SELECT && rounds && !out_s) || (mode == COMPACT && !out_pk) ||
      (mode == PARTITION && (!w || cap < 0 || (cap && (!out_s || !out_q)))))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)s % 8 || (uintptr_t)w % 4 || (uintptr_t)scratch % 8 || (uintptr_t)out_s % 8 ||
      (uintptr_t)out_q % 4 || (uintptr_t)out_pk % 8 || (uintptr_t)n_unique % 4)
    return (int)cudaErrorMisalignedAddress;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  Params p{};
  p.s = (const int64_t*)s;
  p.w = (const int32_t*)w;
  p.P = P;
  p.n_tiles = (P + TILE - 1) / TILE;
  p.filter_t = filter_t;
  p.cap = cap;
  p.out_s = (int64_t*)out_s;
  p.out_q = (int32_t*)out_q;
  p.out_pk = (int64_t*)out_pk;
  p.status = (uint64_t*)scratch;
  p.live_before = (int64_t*)scratch + p.n_tiles;
  p.n_unique = (int32_t*)n_unique;
  if (mode == SELECT) {
    if ((e = cudaMemsetAsync(n_unique, 0, sizeof(int32_t), st)) != cudaSuccess) return (int)e;
    switch (rounds) {
      case 0: return (int)launch_tiles(run_counts_select_kernel<0>, 0, p, st, dev);
      case 1: return (int)launch_tiles(run_counts_select_kernel<1>, 1, p, st, dev);
      case 2: return (int)launch_tiles(run_counts_select_kernel<2>, 2, p, st, dev);
      default: return (int)launch_tiles(run_counts_select_kernel<3>, 3, p, st, dev);
    }
  }
  const int64_t n_units = mode == COMPACT ? p.n_tiles : (p.n_tiles + LIVE_SUB - 1) / LIVE_SUB;
  if ((e = cudaMemsetAsync(scratch, 0, n_units * sizeof(uint64_t), st)) != cudaSuccess)
    return (int)e;
  if (mode == COMPACT) {
    if ((e = launch_tiles(run_counts_compact_kernel, 4, p, st, dev)) != cudaSuccess)
      return (int)e;
    const int64_t zb = min((int64_t)ZERO_BLOCKS, (P + 8 * THREADS - 1) / (8 * THREADS));
    run_counts_zero_kernel<<<(unsigned)zb, THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  run_counts_live_kernel<<<(unsigned)n_units, THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess || !cap) return (int)e;
  run_counts_partition_kernel<<<(unsigned)p.n_tiles, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
