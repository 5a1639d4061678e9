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
// (256 keys, then twice as many a round up to a tile; usually the first
// few keys), and not at all where that run is SENT, which is never kept.
//   select mode: one launch (after a memset of n_unique): each tile's
//     totals, its groups' picks staged in shared memory and written with
//     16-byte stores; n_unique by one atomic a block.
//   compact and partition modes: three launches: each tile's kept runs (or
//     live slots) and its tail weight; one block's exclusive sum of them,
//     each tile's base and n_unique; each tile's outputs staged in shared
//     memory and written in contiguous runs at its base (compact mode also
//     zeroes its part of [n_unique, P)).
// Positions and sums are int64.
//
// What bounds it on an H100: bytes. The function reads the keys and the
// weights once (partition mode only the keys of the slots it writes) and
// writes its outputs once: up to 12 bytes a slot read, 4 to 12 written by
// mode. Select mode reads them once, and a few keys past each
// tile; compact and partition read them twice, because a tile's place
// depends on every tile before it and the counts come from the keys. The
// operations are a few integer instructions a key. An earlier design
// scanned the tiles' summaries for where runs end (an affine recurrence
// over the tiles, one block): 0.06-0.08 ms of the 0.46 ms at 52 M keys,
// and the keys read twice in every mode (PERF.md §6, kernel F).
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // consecutive keys a thread
constexpr int TILE = THREADS * ITEMS;
constexpr int PADDED = TILE + TILE / 16;
constexpr size_t SMEM = PADDED * (sizeof(int64_t) + sizeof(int32_t));
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;  // tiles a scan thread takes a round
constexpr int64_t SENT = INT64_MAX;
constexpr unsigned FULL = 0xffffffffu;

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
  int64_t* kept;    // [n_tiles] compact: each tile's kept runs; partition: its live slots
  int64_t* tail_w;  // [n_tiles] compact: the weight from each tile's first slot to the
                    // first run start past it (or to P)
  int64_t* base;    // [n_tiles] the kept runs (live slots) of the tiles before each
  int32_t* n_unique;
};

struct Scratch {
  int64_t warp_tot[32];
  int64_t wf_pre[WARPS];  // the weight before each warp's first start
  int32_t wf_pos[WARPS];  // each warp's first start in the tile, or -1
  int64_t prev;           // the key before the tile
  int64_t last_key;       // the key of the tile's last start
};

// a thread's keys and their weights, in registers
struct Items {
  int64_t key[ITEMS];
  int32_t w[ITEMS];
  uint32_t starts;   // bit i: item i starts a run (partition: is live)
  int64_t tp;        // the weight before the thread's items in the tile
  int64_t tw;        // the thread's weight
  int64_t tile_w;    // the tile's weight
  int64_t nxt_pre;   // the weight before the next start in a later thread of the tile
  bool nxt_in;       // there is one
  int64_t peek_key;  // the key tid slots past the tile's end and its weight, loaded
  int32_t peek_w;    // with the tile for tail_weight's first round
};

__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

// exclusive sum over the block's NT threads (every thread calls it); total
// is the block's sum
template <int NT>
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
    int64_t t = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    if (lane < NT / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  const int64_t before = wid ? warp_tot[wid - 1] : 0;
  total = warp_tot[NT / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// the minimum over the block's NT threads (every thread calls it and gets it)
template <int NT>
__device__ __forceinline__ int64_t block_min(int64_t v, int64_t* warp_tot) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t r = warp_tot[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = min(r, warp_tot[i]);
  __syncthreads();
  return r;
}

// Stage tile t in shared memory, take the thread's items into registers,
// and (but in partition mode) find where the runs start and the weights
// before them. Every thread calls it; sk and sw may be written after the
// next __syncthreads (in every mode but partition, before it returns).
template <int MODE>
__device__ __forceinline__ void load_items(const Params& p, int64_t t, int n, int64_t* sk,
                                           int32_t* sw, Scratch& sc, Items& it) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, i0 = tid * ITEMS;
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
  if (p.w) {
    const int32_t* ws = p.w + base;
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
  if (MODE != PARTITION) {  // the first keys past the tile, for tail_weight
    const int64_t e = base + TILE + tid;
    it.peek_key = e < p.P ? p.s[e] : SENT;
    it.peek_w = p.w && e < p.P ? p.w[e] : 0;
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
    it.w[i] = valid ? (p.w ? sw[pad(e)] : 1) : 0;
    const bool st = MODE == PARTITION ? valid && it.w[i] != 0
                                      : valid && (base + e == 0 || it.key[i] != prev);
    prev = it.key[i];
    it.starts |= (uint32_t)st << i;
    it.tw += it.w[i];
  }
  if (MODE == PARTITION) return;
  it.tp = block_excl_sum<THREADS>(it.tw, sc.warp_tot, it.tile_w);
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
__device__ int64_t tail_weight(const Params& p, int64_t end, const Items& it, Scratch& sc) {
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
    int64_t first = m;  // the first slot of [end, end + m) whose key is not K
    if (peeked) {
      if (threadIdx.x < m && it.peek_key != K) first = threadIdx.x;
    } else {
      for (int64_t e = threadIdx.x; e < m; e += THREADS)
        if (p.s[end + e] != K) {
          first = e;
          break;
        }
    }
    const int64_t stop = block_min<THREADS>(first, sc.warp_tot);
    if (p.w) {
      int64_t ws = peeked && threadIdx.x < stop ? it.peek_w : 0, tot;
      for (int64_t e = threadIdx.x + (peeked ? THREADS : 0); e < stop; e += THREADS)
        ws += p.w[end + e];
      block_excl_sum<THREADS>(ws, sc.warp_tot, tot);
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
  load_items<SELECT>(p, t, n, sk, sw, sc, it);
  int32_t q[ITEMS];
  const uint32_t kept = run_totals(p, it, tail_weight(p, base + n, it, sc), q);
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
  block_excl_sum<THREADS>(__popc(kept), sc.warp_tot, kt);  // its syncs also order sk, sw
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

// compact and partition modes, first launch: each tile's kept runs (with
// its tail_w) or live slots
template <int MODE>
__global__ void __launch_bounds__(THREADS) run_counts_summary_kernel(Params p) {
  TILE_SETUP;
  load_items<MODE>(p, t, n, sk, sw, sc, it);
  int64_t mine;
  int64_t tail_w = 0;
  if (MODE == PARTITION) {
    mine = __popc(it.starts);
  } else {
    int32_t q[ITEMS];
    tail_w = tail_weight(p, base + n, it, sc);
    mine = __popc(run_totals(p, it, tail_w, q));
  }
  int64_t kt;
  block_excl_sum<THREADS>(mine, sc.warp_tot, kt);
  if (tid == 0) {
    p.kept[t] = kt;
    if (MODE == COMPACT) p.tail_w[t] = tail_w;
  }
}

// second launch, one block: the exclusive sum of the tiles' counts (each
// thread SCAN_ITEMS consecutive tiles a round), and n_unique
__global__ void __launch_bounds__(SCAN_THREADS) run_counts_scan_kernel(Params p) {
  __shared__ int64_t warp_tot[32];
  constexpr int CH = SCAN_THREADS * SCAN_ITEMS;
  int64_t run = 0;
  for (int64_t lo = 0; lo < p.n_tiles; lo += CH) {
    const int64_t u0 = lo + (int64_t)threadIdx.x * SCAN_ITEMS;
    int64_t kept[SCAN_ITEMS], mine = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      kept[k] = u0 + k < p.n_tiles ? p.kept[u0 + k] : 0;
      mine += kept[k];
    }
    int64_t round_total;
    int64_t b = run + block_excl_sum<SCAN_THREADS>(mine, warp_tot, round_total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
      if (u0 + k < p.n_tiles) {
        p.base[u0 + k] = b;
        b += kept[k];
      }
    run += round_total;
  }
  if (threadIdx.x == 0) *p.n_unique = (int32_t)run;
}

// compact and partition modes, third launch: the tile's outputs at its base
template <int MODE>
__global__ void __launch_bounds__(THREADS) run_counts_write_kernel(Params p) {
  TILE_SETUP;
  const int i0 = tid * ITEMS;
  load_items<MODE>(p, t, n, sk, sw, sc, it);
  const int64_t tb = p.base[t];
  if (MODE == PARTITION) {
    // the tile's live slots, then its dead ones, staged in order
    int64_t nl;
    int l = (int)block_excl_sum<THREADS>(__popc(it.starts), sc.warp_tot, nl);
    int d = (int)nl + i0 - l;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (i0 + i < n) {
        const int at = ((it.starts >> i) & 1) ? l++ : d++;
        sk[at] = it.key[i];
        sw[at] = it.w[i];
      }
    __syncthreads();
    const int64_t dead0 = (int64_t)*p.n_unique + base - tb;  // the tile's first dead slot
    for (int e = tid; e < n; e += THREADS) {
      const int64_t dst = e < nl ? tb + e : dead0 + (e - nl);
      if (dst < p.cap) {
        p.out_s[dst] = sk[e];
        p.out_q[dst] = sw[e];
      }
    }
    return;
  }
  int32_t q[ITEMS];
  const uint32_t kept = run_totals(p, it, p.tail_w[t], q);
  int64_t kt;
  int r = (int)block_excl_sum<THREADS>(__popc(kept), sc.warp_tot, kt);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if ((kept >> i) & 1) {
      sk[r] = it.key[i] ^ INT64_MIN;  // the (lo, hi) limbs: hi is the key's top word + 2^31
      sw[r] = q[i];
      ++r;
    }
  __syncthreads();
  for (int e = tid; e < kt; e += THREADS) {
    p.out_pk[tb + e] = sk[e];
    p.out_q[tb + e] = sw[e];
  }
  // this tile's part of the zero tail [n_unique, P)
  for (int64_t z = max((int64_t)*p.n_unique, base) + tid; z < base + n; z += THREADS) {
    p.out_pk[z] = 0;
    p.out_q[z] = 0;
  }
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
// int32 [1]; scratch (modes 1 and 2) 24 bytes a tile of 4,096 keys.
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
  p.kept = (int64_t*)scratch;
  p.tail_w = p.kept + p.n_tiles;
  p.base = p.tail_w + p.n_tiles;
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
  e = mode == COMPACT ? launch_tiles(run_counts_summary_kernel<COMPACT>, 4, p, st, dev)
                      : launch_tiles(run_counts_summary_kernel<PARTITION>, 5, p, st, dev);
  if (e != cudaSuccess) return (int)e;
  run_counts_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)(mode == COMPACT ? launch_tiles(run_counts_write_kernel<COMPACT>, 6, p, st, dev)
                               : launch_tiles(run_counts_write_kernel<PARTITION>, 7, p, st, dev));
}
