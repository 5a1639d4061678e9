// The reads routes' value sort on Hopper (sm_90a): a stable LSD radix sort
// of the int64 k-mer sort keys over their own 2k bits, keys only or with
// one int32 payload (kernel G).
//
// Replaces what the JAX package leaves to XLA's sort: jax.lax.sort((hi, lo),
// num_keys=2) of the canonical windows in colorid_tpu/ops/extract.py:188
// (extract_count) and :242 (count_histogram), colorid_tpu/ops/
// fused_reads.py:97 (the single fused dispatch) and :185 (a chunk), and
// the merges lax.sort((hi, lo, qc), num_keys=2) at fused_reads.py:251 and
// colorid_tpu/parallel/sharded.py:497. Its plain PyTorch twin is
// colorid_tpu_torch/ops/extract.py::value_sort_plain, which runs the same
// passes with the same digit widths; a stable sort's output is unique, so
// kernel and twin agree bit for bit.
//
// What it computes: the keys, and the payload with them, in the stable
// order of the low `bits` bits of key ^ 2^63. The callers' keys are
// ops/extract.py::_sort_key values of canonical k-mers of length k (the
// 2k-bit value with the sign bit flipped) or SENT_KEY, and bits = 2k: no
// canonical value has all ones in its low 2k bits (the all-T k-mer's
// canonical form is all A), so this order is torch.sort's, SENT last.
//
// The passes: npass = ceil(bits / dmax) digits of equal width (the first
// bits % npass one bit wider; dmax from the wrapper, 8 to 11, 9 by
// default: 62 bits are 9, 9, 9, 9, 9, 9, 8), low digit first, over tiles of
// 8,192 keys (512 threads x 16):
//   upsweep, once: one read of the keys counts every pass's digits (the
//     digits' bases, an exclusive scan) and, a chunk of 8 tiles a block in
//     order, each tile's first digits and the tiles' before it in its
//     chunk; a scan over the chunks gives each chunk's first place of each
//     digit. A key whose flipped low bits are all ones (SENT, about 8 % of
//     the single route's keys, often in runs) has the top digit in every
//     pass: it is counted by one ballot a warp, not by atomics on one
//     address;
//   one kernel a pass: each warp ranks its 512 keys of the tile in rounds
//     of 32 (the lanes of equal digit by __match_any_sync; warp-private
//     16-bit counters), the block finds each digit's start in the tile,
//     stages the keys in shared memory in digit order (over the counters,
//     once they are read), and thread i writes staged key i to its digit's
//     place + (i - the digit's start in the tile): a digit's keys go out as
//     one contiguous run (at 512 digits and 8,192-key tiles, 16 keys, 128
//     bytes, on average). The payload then
//     comes in through the same tile places and goes out to the same
//     places. The first pass takes its digits' places from the upsweep and
//     waits for nothing; a later pass takes the next tile in order from an
//     atomic counter, publishes its digit counts at once, and for each
//     digit walks back over the tiles before it (a decoupled look-back,
//     csrc/look_back.cuh) until a tile whose count covers every tile
//     before it. A tile's status words are 32-bit below 2^30 keys, 64-bit
//     above.
// Tiles are in key order, warps in tile order, rounds in warp order, lanes
// in round order, so the sort is stable. Passes ping-pong between the
// outputs and the wrapper's scratch buffers so that the last pass lands in
// the outputs and the inputs are never written. Every launch is fixed on
// the host: nothing waits for the device.
//
// Why this shape, against kernel E (csrc/radix_sort.cu), from which it
// differs in the key: E's int32 keys carry an index; here no index is made
// (five of the six sites want the keys alone, the merges one int32 that
// goes through the same places), and only the key's own 2k bits are looked
// at (torch.sort makes 8 passes over 64 bits and carries an int64 index
// through them: about 272 bytes a key against 120 here). What pays on this
// card is the length of a digit's run in a tile, against the number of
// passes (sort_bench.py on 52,002,816 keys of the main cell, H100 80GB HBM3
// at 700 W, PERF.md): 7 passes of at most 9 bits 3.40 ms, 6 of at most 11
// bits 3.89, 8 of at most 8 bits 3.68 (a pass over 2,048 digits 0.49-0.89
// ms, over 512 0.37-0.57, over 256 0.35-0.53; the later passes are the
// faster, their input holding a k-mer's duplicates side by side: fewer
// digits a tile, longer runs, not measured apart). __match_any_sync ranks a round in one instruction where
// E's rank takes one ballot a digit bit: with the ballots (a build of this
// kernel that had both) 3.58, 4.28 and 3.87 ms. A thread's 16 keys stay
// in registers (32 of its 64) from the load to the staging; its places in
// the tile go through shared memory (uint16), so that two blocks share an
// SM.
//
// What bounds it on an H100: the bytes (chip_smoke.py::value_sort_bytes
// counts each input read once and each output written once: 16 bytes a
// key, 24 with the payload; each pass reads and writes the key and the
// payload), then the rank's instructions, the look-back's latency and the
// scattered runs.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches every kernel on the caller's stream and
// returns cudaGetLastError(); the wrapper allocates the outputs, the
// ping-pong buffers and the scratch (histograms, tile counters, tile status
// words, the first pass's tile and chunk counts).

#include <cstdint>
#include <cuda_runtime.h>

#include "look_back.cuh"

namespace {

constexpr int DMAX = 11;          // widest digit
constexpr int DMIN = 8;           // narrowest widest digit the wrapper may ask for
constexpr int RMAX = 1 << DMAX;   // most digits: 2,048
constexpr int MAX_PASSES = 8;     // 64 bits at dmax 8
constexpr int THREADS = 512;      // the pass kernel's block
constexpr int WARPS = THREADS / 32;
constexpr int KPT = 16;           // keys a thread a tile
constexpr int KPW = 32 * KPT;     // keys a warp a tile
constexpr int TILE = THREADS * KPT;  // 8,192 keys
constexpr int CHUNK = 8;          // tiles an upsweep block counts in order
constexpr int SWEEP_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t FLIP = 1ull << 63;
// the pass kernel's staging area: the tile's keys in digit order, over the
// warps' 16-bit counters
constexpr int STAGE = TILE * 8;
static_assert(WARPS * RMAX * 2 <= STAGE, "the counters fit the staging area");

struct PassParams {
  const int64_t* key_in;
  int64_t* key_out;
  const int32_t* pay_in;  // nullptr: keys only
  int32_t* pay_out;
  int32_t P;
  int32_t shift, dbits;
  // the first pass: each tile's counts of the tiles before it in its chunk,
  // each chunk's places ([n_tiles | n_chunks, 2^dbits])
  const int32_t* tile_pre;
  const int32_t* chunk_base;
  // a later pass: the digits' places, the tiles' status words ([n_tiles,
  // 2^dbits], zero before the pass) and the tile counter
  const int32_t* bases;
  void* status;
  int32_t* counter;
};

struct SweepParams {
  const int64_t* key;
  int32_t P;
  int32_t shift, dbits;  // the first pass's digit
  int32_t* tile_pre;     // [n_tiles, 2^dbits] out
  int32_t* chunk_sum;    // [n_chunks, 2^dbits] out
  // every pass's digits over all keys: pass q's in ghist[q * RMAX ...], in
  // shared memory at hoff[q]
  int32_t npass;
  int32_t hshift[MAX_PASSES], hdbits[MAX_PASSES], hoff[MAX_PASSES];
  int32_t* ghist;  // [MAX_PASSES, RMAX]
  uint64_t low;    // the sort's bits: a key whose flipped bits there are all ones is SENT
};

// The exclusive scan of v over the block in thread order; *total gets the
// sum. s_tmp holds one int a warp.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_tmp, int* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) s_tmp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int s = s_tmp[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

__device__ __forceinline__ uint32_t digit_of(uint64_t key, int shift, uint32_t mask) {
  return (uint32_t)((key ^ FLIP) >> shift) & mask;
}

// The upsweep, from one read of the keys: each block counts the first
// pass's digits of CHUNK tiles in order (shared-memory atomics), writing
// each tile's counts of the tiles before it in the chunk and the chunk's
// counts, and every pass's digits of those tiles (one global atomic a block
// and bucket). SENT keys are counted apart, one ballot a warp.
__global__ void __launch_bounds__(SWEEP_THREADS) vsort_upsweep_kernel(SweepParams p) {
  extern __shared__ int s_sweep[];
  __shared__ int s_sent, s_sent_all;
  const int R = 1 << p.dbits;
  const uint32_t mask = R - 1;
  const int hsize = p.hoff[p.npass - 1] + (1 << p.hdbits[p.npass - 1]);
  int* s_cnt = s_sweep;       // [R]
  int* s_run = s_cnt + R;     // [R]
  int* s_hist = s_run + R;    // [hsize]
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = (int)(((int64_t)p.P + TILE - 1) / TILE);
  for (int i = tid; i < R; i += SWEEP_THREADS) s_run[i] = 0;
  for (int i = tid; i < hsize; i += SWEEP_THREADS) s_hist[i] = 0;
  if (tid == 0) s_sent_all = 0;
  auto count = [&](uint64_t k, bool valid) {
    const bool sent = ((k ^ FLIP) & p.low) == p.low;
    const unsigned m = __ballot_sync(FULL, valid && sent);
    if (lane == 0 && m) atomicAdd(&s_sent, __popc(m));
    if (valid && !sent) {
      atomicAdd(&s_cnt[digit_of(k, p.shift, mask)], 1);
#pragma unroll
      for (int q = 0; q < MAX_PASSES; ++q) {
        if (q >= p.npass) break;
        atomicAdd(&s_hist[p.hoff[q] + digit_of(k, p.hshift[q], (1u << p.hdbits[q]) - 1)], 1);
      }
    }
  };
  const int t_end = min(n_tiles, (int)(blockIdx.x + 1) * CHUNK);
  for (int t = blockIdx.x * CHUNK; t < t_end; ++t) {
    for (int i = tid; i < R; i += SWEEP_THREADS) s_cnt[i] = 0;
    if (tid == 0) s_sent = 0;
    __syncthreads();
    const int64_t t0 = (int64_t)t * TILE;
    const int n = (int)min((int64_t)TILE, p.P - t0);
    const int64_t* k = p.key + t0;
    const bool vec = (reinterpret_cast<uintptr_t>(k) & 15) == 0;
    const int n2 = vec ? n / 2 : 0;
    // every thread of the block runs the same rounds: the ballot needs the warp
    for (int j0 = 0; j0 < n2; j0 += SWEEP_THREADS) {
      const int j = j0 + tid;
      longlong2 v = make_longlong2(0, 0);
      if (j < n2) v = __ldg(reinterpret_cast<const longlong2*>(k) + j);
      count((uint64_t)v.x, j < n2);
      count((uint64_t)v.y, j < n2);
    }
    for (int j0 = 2 * n2; j0 < n; j0 += SWEEP_THREADS) {
      const int j = j0 + tid;
      count(j < n ? (uint64_t)__ldg(reinterpret_cast<const long long*>(k) + j) : 0ull, j < n);
    }
    __syncthreads();
    if (tid == 0) {
      s_cnt[R - 1] += s_sent;
      s_sent_all += s_sent;
    }
    __syncthreads();
    for (int i = tid; i < R; i += SWEEP_THREADS) {
      p.tile_pre[(int64_t)t * R + i] = s_run[i];
      s_run[i] += s_cnt[i];
    }
    __syncthreads();
  }
  for (int i = tid; i < R; i += SWEEP_THREADS) p.chunk_sum[(int64_t)blockIdx.x * R + i] = s_run[i];
  for (int q = 0; q < p.npass; ++q) {
    const int Rq = 1 << p.hdbits[q];
    for (int i = tid; i < Rq; i += SWEEP_THREADS) {
      const int v = s_hist[p.hoff[q] + i] + (i == Rq - 1 ? s_sent_all : 0);
      if (v) atomicAdd(&p.ghist[q * RMAX + i], v);
    }
  }
}

// Each pass's digit bases: the exclusive scan of its histogram, in place
// (one block a pass, two digits a thread).
__global__ void __launch_bounds__(RMAX / 2) vsort_bases_kernel(int32_t* ghist) {
  __shared__ int s_tmp[RMAX / 2 / 32];
  int32_t* h = ghist + blockIdx.x * RMAX;
  const int a = h[2 * threadIdx.x], b = h[2 * threadIdx.x + 1];
  int all;
  const int ex = block_exclusive_scan<RMAX / 2>(a + b, s_tmp, &all);
  h[2 * threadIdx.x] = ex;
  h[2 * threadIdx.x + 1] = ex + a;
}

// Each chunk's first place of each digit, in place over the chunks'
// counts: the digit's base + the counts of the chunks before. A block takes
// 32 digits (a lane each), its 8 warps a range of chunks each.
__global__ void __launch_bounds__(256) vsort_chunk_scan_kernel(int32_t* chunk, int n_chunks,
                                                               int dbits, const int32_t* bases) {
  __shared__ int s_part[8][32];
  const int R = 1 << dbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int c0 = warp * n_chunks / 8, c1 = (warp + 1) * n_chunks / 8;
  int sum = 0;
  if (d < R)
    for (int c = c0; c < c1; ++c) sum += chunk[(int64_t)c * R + d];
  s_part[warp][lane] = sum;
  __syncthreads();
  if (d >= R) return;
  int run = bases[d];
  for (int w = 0; w < warp; ++w) run += s_part[w][lane];
  for (int c = c0; c < c1; ++c) {
    const int v = chunk[(int64_t)c * R + d];
    chunk[(int64_t)c * R + d] = run;
    run += v;
  }
}

// The pass kernel's dynamic shared memory for a digit of dbits bits: the
// staging area, each key's place in the tile (uint16), the digits' starts
// in the tile and their places in the output.
constexpr int pass_smem(int dbits) { return STAGE + TILE * 2 + (8 << dbits) + 16; }

// One pass over a tile: the warps rank its keys by the digit, the block
// finds each digit's start in the tile and its place in the output (the
// first pass: the chunk's place + the tiles before in the chunk, from the
// upsweep; LOOK, a later pass: the tiles before, by look-back over status
// words W), stages the keys in digit order, and writes the keys, then the
// payload, in digit runs.
template <bool LOOK, class W>
__global__ void __launch_bounds__(THREADS, 2) vsort_pass_kernel(PassParams p) {
  using Status = LookBack<W>;
  const int R = 1 << p.dbits;
  const uint32_t mask = R - 1;
  const int E = R > THREADS ? R / THREADS : 1;  // digits a thread, contiguous
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int s_tmp[WARPS];
  __shared__ int s_tile;
  uint64_t* s_key = reinterpret_cast<uint64_t*>(s_raw);              // [TILE], staged
  int32_t* s_pay = reinterpret_cast<int32_t*>(s_raw);                // [TILE], staged
  uint16_t* s_wc = reinterpret_cast<uint16_t*>(s_raw);               // [WARPS, R]
  uint16_t* s_pos = reinterpret_cast<uint16_t*>(s_raw + STAGE);      // [TILE]
  int* s_start = reinterpret_cast<int*>(s_pos + TILE);               // [R + 1]
  int* s_run = s_start + R + 1;                                      // [R]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  // a later pass takes the next tile in order (an atomic counter, so that
  // a tile only waits on tiles whose blocks already run)
  if (LOOK) {
    if (tid == 0) s_tile = atomicAdd(p.counter, 1);
    __syncthreads();
  }
  const int t = LOOK ? s_tile : blockIdx.x;
  const int t0 = t * TILE;
  const int n = min(TILE, p.P - t0);
  uint32_t* wc32 = reinterpret_cast<uint32_t*>(s_wc);
  for (int i = tid; i < WARPS * R / 2; i += THREADS) wc32[i] = 0;
  uint64_t key[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int slot = warp * KPW + r * 32 + lane;
    key[r] = slot < n ? (uint64_t)p.key_in[t0 + slot] : 0ull;
  }
  __syncthreads();
  // rank: each warp its KPW keys, in rounds of 32, chained through the
  // warp's counters; a key's rank among its warp's keys of its digit goes
  // to s_pos
  uint16_t* wc = s_wc + warp * R;
  const bool full = (warp + 1) * KPW <= n;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int slot = warp * KPW + r * 32 + lane;
    const bool ok = full || slot < n;
    const uint32_t d = digit_of(key[r], p.shift, mask);
    const unsigned peers = __match_any_sync(FULL, ok ? d : 0xffffffffu);
    const int c = ok ? wc[d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) wc[d] = (uint16_t)(c + __popc(peers));
    __syncwarp();
    if (ok) s_pos[slot] = (uint16_t)(c + __popc(peers & below));
  }
  __syncthreads();
  // per digit: the warps' offsets among the tile's keys of that digit and
  // the digits' starts in the tile; the first pass's places from its chunk
  // and the tiles before it there, while a later pass publishes the tile's
  // counts at once for the tiles after it
  int local = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = tid * E + e;
    if (d < R) {
      int cnt = 0;
#pragma unroll 4
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_wc[w * R + d];
        s_wc[w * R + d] = (uint16_t)cnt;
        cnt += c;
      }
      if (LOOK)
        Status::publish(static_cast<W*>(p.status), (int64_t)t * R + d,
                        (t == 0 ? Status::INC : Status::AGG) | (W)cnt);
      s_start[d] = local;
      local += cnt;
    }
  }
  int all;
  const int ex = block_exclusive_scan<THREADS>(local, s_tmp, &all);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = tid * E + e;
    if (d < R) {
      const int start = s_start[d] + ex;
      s_start[d] = start;
      if (!LOOK)
        s_run[d] = p.chunk_base[(int64_t)(t / CHUNK) * R + d] + p.tile_pre[(int64_t)t * R + d] -
                   start;
    }
  }
  if (tid == 0) s_start[R] = n;
  __syncthreads();
  // each key's place in the tile: its digit's start, its warp's offset
  // there, its rank in the warp
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int slot = warp * KPW + r * 32 + lane;
    if (slot < n) {
      const uint32_t d = digit_of(key[r], p.shift, mask);
      s_pos[slot] = (uint16_t)(s_pos[slot] + s_start[d] + wc[d]);
    }
  }
  __syncthreads();  // the counters are read: the staging area takes the keys
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int slot = warp * KPW + r * 32 + lane;
    if (slot < n) s_key[s_pos[slot]] = key[r];
  }
  if (LOOK) {
    // a later pass's places: per digit (a thread's digits in flight
    // together), the counts of the tiles before this one, walked back over
    // until a tile whose count holds every tile before it
    constexpr int DPT = RMAX / THREADS;
    W excl[DPT];
    int tp[DPT];
    unsigned todo = 0;
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      excl[k] = 0;
      tp[k] = t - 1;
      if (t > 0 && k * THREADS + tid < R) todo |= 1u << k;
    }
    const W* status = static_cast<const W*>(p.status);
    while (todo) {
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        if (todo >> k & 1) {
          const W v = Status::read(status, (int64_t)tp[k] * R + k * THREADS + tid);
          const W flag = v & ~Status::CNT;
          if (flag) {
            excl[k] += v & Status::CNT;
            if (flag == Status::INC)
              todo &= ~(1u << k);
            else
              --tp[k];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      const int d = k * THREADS + tid;
      if (d < R) {
        const int start = s_start[d];
        if (t > 0)
          Status::publish(static_cast<W*>(p.status), (int64_t)t * R + d,
                          Status::INC | (excl[k] + (W)(s_start[d + 1] - start)));
        s_run[d] = p.bases[d] + (int)excl[k] - start;
      }
    }
  }
  __syncthreads();
  // staged key i goes to its digit's place + (i - its start in the tile):
  // a digit's keys go out as one contiguous run
  int dst[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = j * THREADS + tid;
    if (i < n) {
      const uint64_t k = s_key[i];
      dst[j] = s_run[digit_of(k, p.shift, mask)] + i;
      p.key_out[dst[j]] = (int64_t)k;
    }
  }
  if (p.pay_in) {
    __syncthreads();  // the staged keys are read: the area takes the payload
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int slot = warp * KPW + r * 32 + lane;
      if (slot < n) s_pay[s_pos[slot]] = p.pay_in[t0 + slot];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int i = j * THREADS + tid;
      if (i < n) p.pay_out[dst[j]] = s_pay[i];
    }
  }
}

template <bool LOOK, class W>
cudaError_t launch_pass(const PassParams& p, int n_tiles, cudaStream_t st, int dev) {
  static bool opted[64];
  cudaError_t e;
  if (!opted[dev]) {
    if ((e = cudaFuncSetAttribute(vsort_pass_kernel<LOOK, W>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  pass_smem(DMAX))) != cudaSuccess)
      return e;
    opted[dev] = true;
  }
  vsort_pass_kernel<LOOK, W><<<n_tiles, THREADS, pass_smem(p.dbits), st>>>(p);
  return cudaGetLastError();
}

// The upsweep's dynamic shared memory: the first digit's tile and chunk
// counts and every pass's histogram (at most 6 x 2,048 at dmax 11).
constexpr int SWEEP_SMEM_MAX = (2 * RMAX + 6 * RMAX) * 4;

}  // namespace

// key_in int64 [P], P < 2^31 (< 2^30 unless wide); key_out int64 [P];
// key_tmp int64 [P] (unused with one pass). pay_in / pay_out / pay_tmp:
// int32 [P], all nullptr for keys only (pay_tmp unused with one pass).
// 1 <= bits <= 64; 8 <= dmax <= 11, the widest digit; wide: 64-bit tile
// status words.
// scratch: int32, at least the wrapper's _value_sort_scratch. Inputs are
// never written.
extern "C" int value_sort_launch(const void* key_in, void* key_out, void* key_tmp,
                                 const void* pay_in, void* pay_out, void* pay_tmp, int64_t P,
                                 int32_t bits, int32_t dmax, int32_t wide,
                                 void* scratch, int64_t scratch_ints, void* stream) {
  if (P < 0 || P >= (1ll << 31) || (!wide && P >= (1ll << 30)) || bits < 1 || bits > 64 ||
      dmax < DMIN || dmax > DMAX || !key_in || !key_out || (!pay_in) != (!pay_out))
    return (int)cudaErrorInvalidValue;
  const int npass = (bits + dmax - 1) / dmax;
  if (npass > 1 && (!key_tmp || (pay_in && !pay_tmp))) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int n_tiles = (int)((P + TILE - 1) / TILE);
  const int n_chunks = (n_tiles + CHUNK - 1) / CHUNK;
  SweepParams sw{};
  sw.P = (int32_t)P;
  sw.npass = npass;
  sw.low = bits == 64 ? ~0ull : (1ull << bits) - 1;
  int shift = 0, hoff = 0;
  for (int q = 0; q < npass; ++q) {  // equal digits, the first bits % npass one bit wider
    sw.hdbits[q] = bits / npass + (q < bits % npass);
    sw.hshift[q] = shift;
    sw.hoff[q] = hoff;
    shift += sw.hdbits[q];
    hoff += 1 << sw.hdbits[q];
  }
  const int sweep_smem = (2 << sw.hdbits[0]) * 4 + hoff * 4;
  if (sweep_smem > SWEEP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the scratch: the histograms and the later passes' tile counters and
  // status words (zeroed at once), then the first pass's counts of the
  // tiles before each tile in its chunk and each chunk's counts
  int64_t status_words = 0;
  for (int q = 1; q < npass; ++q) status_words += (int64_t)n_tiles << sw.hdbits[q];
  const int64_t head = MAX_PASSES * RMAX + 32 * MAX_PASSES;
  const int64_t zeroed = head + status_words * (wide ? 2 : 1);
  const int64_t need = zeroed + ((int64_t)(n_tiles + n_chunks) << sw.hdbits[0]);
  if (scratch_ints < need) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  static bool sweep_opted[64];
  if (!sweep_opted[dev]) {
    if ((e = cudaFuncSetAttribute(vsort_upsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SWEEP_SMEM_MAX)) != cudaSuccess)
      return (int)e;
    sweep_opted[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* ghist = static_cast<int32_t*>(scratch);
  int32_t* counters = ghist + MAX_PASSES * RMAX;
  char* status = reinterpret_cast<char*>(static_cast<int32_t*>(scratch) + head);
  int32_t* tile_pre = static_cast<int32_t*>(scratch) + zeroed;
  int32_t* chunk = tile_pre + ((int64_t)n_tiles << sw.hdbits[0]);
  if ((e = cudaMemsetAsync(scratch, 0, zeroed * 4, st)) != cudaSuccess) return (int)e;
  // the first pass's digit: each tile's and each chunk's counts, and every
  // pass's histogram, from one read of the keys; the digits' bases; the
  // chunks' places
  sw.key = static_cast<const int64_t*>(key_in);
  sw.shift = sw.hshift[0];
  sw.dbits = sw.hdbits[0];
  sw.ghist = ghist;
  sw.tile_pre = tile_pre;
  sw.chunk_sum = chunk;
  vsort_upsweep_kernel<<<n_chunks, SWEEP_THREADS, sweep_smem, st>>>(sw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  vsort_bases_kernel<<<npass, RMAX / 2, 0, st>>>(ghist);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  vsort_chunk_scan_kernel<<<((1 << sw.dbits) + 31) / 32, 256, 0, st>>>(chunk, n_chunks, sw.dbits,
                                                                       ghist);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  PassParams p{};
  p.P = (int32_t)P;
  p.tile_pre = tile_pre;
  p.chunk_base = chunk;
  const void* cur_key = key_in;
  const void* cur_pay = pay_in;
  for (int pass = 0; pass < npass; ++pass) {
    const bool to_out = (npass - 1 - pass) % 2 == 0;  // the last pass lands in the outputs
    p.key_in = static_cast<const int64_t*>(cur_key);
    p.key_out = static_cast<int64_t*>(to_out ? key_out : key_tmp);
    p.pay_in = static_cast<const int32_t*>(cur_pay);
    p.pay_out = pay_in ? static_cast<int32_t*>(to_out ? pay_out : pay_tmp) : nullptr;
    p.shift = sw.hshift[pass];
    p.dbits = sw.hdbits[pass];
    p.bases = ghist + pass * RMAX;
    p.status = status;
    p.counter = counters + 32 * pass;
    if (pass) status += ((int64_t)n_tiles << p.dbits) * (wide ? 8 : 4);
    e = pass == 0 ? launch_pass<false, uint32_t>(p, n_tiles, st, dev)
        : wide    ? launch_pass<true, uint64_t>(p, n_tiles, st, dev)
                  : launch_pass<true, uint32_t>(p, n_tiles, st, dev);
    if (e != cudaSuccess) return (int)e;
    cur_key = p.key_out;
    cur_pay = p.pay_out;
  }
  return 0;
}
