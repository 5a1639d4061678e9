// The probe streams' key sort with its payload operands on Hopper (sm_90a):
// a stable LSD radix sort of a non-negative int32 key, cut to the key's own
// bit width, that carries up to three int32 operand streams (kernel E).
//
// Replaces what the JAX package leaves to XLA's sort: the multi-operand
// jax.lax.sort((key, *operands), num_keys=1) of the blocked stream
// (colorid_tpu/ops/stream_query.py:623, :627, :678, :682) and of the
// classic stream (:815, the rows with their probe index). Its plain
// PyTorch twin is colorid_tpu_torch/ops/stream_query.py::
// sort_payloads_plain, which runs the same passes with the same digit
// widths; a stable sort's output is unique, so kernel and twin (and
// torch.sort(key, stable=True) with the operands gathered through its
// permutation) agree bit for bit.
//
// What it computes: key_out and each operand's output in the stable order
// of the key's low `bits` bits. An operand is a tensor or the index: the
// first pass generates base + i for probe i (int32, wrapping as uint32), so
// that no iota is read, and with idx64 the last pass writes it widened to
// int64 (the classic route's permutation, which the epilogue takes as
// int64).
//
// The passes: npass = ceil(bits / 10) digits of equal width (30 bits: 10,
// 10, 10; 26: 9, 9, 8; 21: 7, 7, 7), low digit first, over tiles of 8,192
// keys (512 threads x 16):
//   upsweep, once: one read of the keys counts every pass's digits (the
//     digits' bases, an exclusive scan), and, a chunk of 4 tiles a block in
//     order, each tile's first digits and the tiles' before it in its chunk;
//     a scan over the chunks gives each chunk's first place of each digit;
//   one kernel a pass: each warp ranks its 512 keys of the tile in rounds of
//     32 (the lanes of equal digit by one ballot a digit bit, warp-private
//     16-bit counters), the block finds each digit's start in the tile,
//     stages the keys in shared memory in digit order with their local
//     index, and thread i writes staged key i to its digit's place + (i -
//     the digit's start in the tile): a digit's keys go out as one
//     contiguous run. Each operand then comes into the keys' space
//     (cp.async) and goes out through the local index to the same places;
//     the index is made there. The first pass takes its digits' places from
//     the upsweep and waits for nothing; a later pass takes the next tile
//     in order from an atomic counter, publishes its digit counts at once,
//     and for each digit walks back over the tiles before it (a decoupled
//     look-back, onesweep), adding their counts until a tile whose count
//     covers every tile before it.
// Tiles are in key order, warps in tile order, rounds in warp order, lanes
// in round order, so the sort is stable. Passes ping-pong between the
// outputs and the wrapper's scratch buffers so that the last pass lands in
// the outputs and the inputs are never written. Every launch is fixed on
// the host: nothing waits for the device.
//
// Why this shape (sort_bench.py's runs of each candidate on an H100 80GB
// HBM3 at 700 W, PERF.md): on this card a tile's rank round costs
// about as much as a whole onesweep pass, so what pays is fewer rounds,
// not fewer bytes. A hybrid MSD shape (one partition on the top 10-12 bits,
// then each bucket sorted in shared memory) moves half the bytes of the
// 8-bit design before this one (four passes over 4,096-key tiles) but ranks
// five rounds where that ranked four, and its buckets over capacity (the
// padding's hot keys) take passes of their own: 0.68-0.78 ms on the
// blocked batch against 0.47. 10-bit digits take three rounds for the
// 30-bit blocked key and the 26-bit classic rows; tiles of 8,192 keys keep
// a digit's run in a tile at 8 keys or more (a 32-byte sector of int32).
// The look-back at 1,024 digits a tile costs a later pass some 0.04 ms on
// the blocked batch, so the first pass, whose counts the histogram's read
// can give, does without it; a reduce-then-scan for every pass reads the
// keys once more a pass, which costs the classic batch more than the
// look-back. At 512 threads two blocks share an SM within 64 registers a
// thread: the digit loop stays a loop (unrolled by width it spilled
// hundreds of bytes), and one block an SM without spills was slower.
//
// What bounds it on an H100: the rank's instructions (a ballot a key and
// digit bit), the look-back's latency and the scattered runs; the byte
// bound (chip_smoke.py::sort_bytes) counts each input read once and each
// output written once (16 bytes a probe for the blocked exact key +
// offsets, and for the classic rows + int64 index), where each pass reads
// and writes the key and each operand.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches every kernel on the caller's stream and
// returns cudaGetLastError(); the wrapper allocates outputs, ping-pong
// buffers and the scratch (histograms, tile counters, tile status words,
// the first pass's tile and chunk counts).

#include <cstdint>
#include <cuda_runtime.h>

#include "look_back.cuh"

namespace {

constexpr int MAX_OPS = 3;
constexpr int DMAX = 10;         // widest digit
constexpr int RMAX = 1 << DMAX;  // most digits: 1,024
constexpr int MAX_PASSES = 4;    // 31 bits at most
constexpr int THREADS = 512;     // the pass kernel's block
constexpr int KPT = 16;          // keys a thread a tile
constexpr int TILE = THREADS * KPT;  // 8,192 keys
constexpr int CHUNK = 4;         // tiles an upsweep block counts in order
constexpr int SWEEP_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// a tile's status word for one digit in a later pass (csrc/look_back.cuh):
// a flag in the top two bits (0: not yet, AGG: the tile's own count, INC:
// the count of every tile up to this one) over a 30-bit count
using Status = LookBack<uint32_t>;
constexpr uint32_t AGG = Status::AGG, INC = Status::INC, CNT = Status::CNT;

struct PassParams {
  const int32_t* key_in;
  int32_t* key_out;
  const int32_t* op_in[MAX_OPS];  // the generated index: nullptr in the first pass
  void* op_out[MAX_OPS];
  int32_t n_ops;
  int32_t idx_slot;  // the operand that is the index, or -1
  int32_t gen_idx;   // this pass generates the index
  int32_t idx64;     // this pass writes the index as int64
  int64_t base;      // the index's first value
  int32_t P;
  int32_t shift, dbits;
  // the first pass: each tile's counts of the tiles before it in its chunk,
  // each chunk's places ([n_tiles | n_chunks, 2^dbits])
  const int32_t* tile_pre;
  const int32_t* chunk_base;
  // a later pass: the digits' places, the tiles' status words ([n_tiles,
  // 2^dbits], zero before the pass) and the tile counter
  const int32_t* bases;
  uint32_t* status;
  int32_t* counter;
};

struct SweepParams {
  const int32_t* key;
  int32_t P;
  int32_t shift, dbits;  // the first pass's digit
  int32_t* tile_pre;     // [n_tiles, 2^dbits] out
  int32_t* chunk_sum;    // [n_chunks, 2^dbits] out
  // every pass's digits over all keys
  int32_t npass;
  int32_t hshift[MAX_PASSES], hdbits[MAX_PASSES];
  int32_t* ghist;  // [MAX_PASSES, RMAX]
};

// The exclusive scan of v over the block in thread order; *total gets the
// sum. s_tmp holds one int a warp.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_tmp, int* total) {
  constexpr int WARPS = NT / 32;
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
  for (int w = 0; w < WARPS; ++w) {
    const int s = s_tmp[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// cp.async: copies from global to shared memory that hold no register
// while in flight (16 bytes, or 4); wait for all of this thread's.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// Copy n int32 from global to shared memory (16-byte aligned) with
// cp.async: 16 bytes a thread at a time where `from` is 16-byte aligned,
// else 4; then wait for them.
__device__ __forceinline__ void copy_in(int32_t* to, const int32_t* from, int n) {
  if ((reinterpret_cast<uintptr_t>(from) & 15) == 0) {
    for (int c = threadIdx.x; c * 4 < n; c += THREADS) {
      if (c * 4 + 4 <= n)
        cp_async16(to + c * 4, from + c * 4);
      else
        for (int q = c * 4; q < n; ++q) cp_async4(to + q, from + q);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) cp_async4(to + i, from + i);
  }
  cp_async_wait_all();
}
__device__ __forceinline__ uint32_t digit_of(uint32_t key, int shift, uint32_t mask) {
  return (key >> shift) & mask;
}
// The lanes of the warp whose digit equals this lane's, among the lanes
// with ok set (all of them where full): one ballot a digit bit.
__device__ __forceinline__ unsigned warp_peers(uint32_t d, bool ok, int dbits, bool full) {
  unsigned peers = FULL;
  if (!full) {
    peers = __ballot_sync(FULL, ok);
    peers = ok ? peers : ~peers;
  }
  for (int b = 0; b < dbits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned v = __ballot_sync(FULL, bit);
    peers &= bit ? v : ~v;
  }
  return peers;
}

// The upsweep, from one read of the keys: each block counts the first
// pass's digits of CHUNK tiles in order (shared-memory atomics), writing
// each tile's counts of the tiles before it in the chunk and the chunk's
// counts, and every pass's digits of those tiles (one global atomic a block
// and bucket).
__global__ void __launch_bounds__(SWEEP_THREADS) sort_upsweep_kernel(SweepParams p) {
  __shared__ int s_cnt[RMAX], s_run[RMAX];
  __shared__ int s_hist[MAX_PASSES * RMAX];
  const int R = 1 << p.dbits;
  const uint32_t mask = R - 1;
  const int tid = threadIdx.x;
  const int n_tiles = (p.P + TILE - 1) / TILE;
  for (int i = tid; i < R; i += SWEEP_THREADS) s_run[i] = 0;
  for (int i = tid; i < p.npass * RMAX; i += SWEEP_THREADS) s_hist[i] = 0;
  const int t_end = min(n_tiles, (int)(blockIdx.x + 1) * CHUNK);
  for (int t = blockIdx.x * CHUNK; t < t_end; ++t) {
    for (int i = tid; i < R; i += SWEEP_THREADS) s_cnt[i] = 0;
    __syncthreads();
    const int t0 = t * TILE;
    const int n = min(TILE, p.P - t0);
    const int32_t* k = p.key + t0;
    const bool vec = (reinterpret_cast<uintptr_t>(k) & 15) == 0;
    const int n4 = vec ? n / 4 : 0;
    for (int j = tid; j < n4; j += SWEEP_THREADS) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(k) + j);
      const uint32_t kk[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        atomicAdd(&s_cnt[digit_of(kk[u], p.shift, mask)], 1);
#pragma unroll
        for (int q = 0; q < MAX_PASSES; ++q) {
          if (q >= p.npass) break;
          atomicAdd(&s_hist[q * RMAX + digit_of(kk[u], p.hshift[q], (1u << p.hdbits[q]) - 1)], 1);
        }
      }
    }
    for (int j = n4 * 4 + tid; j < n; j += SWEEP_THREADS) {
      const uint32_t kk = (uint32_t)k[j];
      atomicAdd(&s_cnt[digit_of(kk, p.shift, mask)], 1);
#pragma unroll
      for (int q = 0; q < MAX_PASSES; ++q) {
        if (q >= p.npass) break;
        atomicAdd(&s_hist[q * RMAX + digit_of(kk, p.hshift[q], (1u << p.hdbits[q]) - 1)], 1);
      }
    }
    __syncthreads();
    for (int i = tid; i < R; i += SWEEP_THREADS) {
      p.tile_pre[(size_t)t * R + i] = s_run[i];
      s_run[i] += s_cnt[i];
    }
    __syncthreads();
  }
  for (int i = tid; i < R; i += SWEEP_THREADS) p.chunk_sum[(size_t)blockIdx.x * R + i] = s_run[i];
  for (int i = tid; i < p.npass * RMAX; i += SWEEP_THREADS)
    if (s_hist[i]) atomicAdd(&p.ghist[i], s_hist[i]);
}

// Each pass's digit bases: the exclusive scan of its histogram, in place
// (one block a pass).
__global__ void __launch_bounds__(RMAX) sort_bases_kernel(int32_t* ghist) {
  __shared__ int s_tmp[RMAX / 32];
  int32_t* h = ghist + blockIdx.x * RMAX;
  int all;
  const int ex = block_exclusive_scan<RMAX>(h[threadIdx.x], s_tmp, &all);
  h[threadIdx.x] = ex;
}

// Each chunk's first place of each digit, in place over the chunks'
// counts: the digit's base + the counts of the chunks before. A block takes
// 32 digits (a lane each), its 8 warps a range of chunks each.
__global__ void __launch_bounds__(256) sort_chunk_scan_kernel(int32_t* chunk, int n_chunks,
                                                              int dbits, const int32_t* bases) {
  __shared__ int s_part[8][32];
  const int R = 1 << dbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int c0 = warp * n_chunks / 8, c1 = (warp + 1) * n_chunks / 8;
  int sum = 0;
  if (d < R)
    for (int c = c0; c < c1; ++c) sum += chunk[(size_t)c * R + d];
  s_part[warp][lane] = sum;
  __syncthreads();
  if (d >= R) return;
  int run = bases[d];
  for (int w = 0; w < warp; ++w) run += s_part[w][lane];
  for (int c = c0; c < c1; ++c) {
    const int v = chunk[(size_t)c * R + d];
    chunk[(size_t)c * R + d] = run;
    run += v;
  }
}

// The pass kernel's dynamic shared memory for a digit of dbits bits: the
// keys (then each operand), the local index, the warps' counters, the
// digits' starts in the tile and their places in the output.
constexpr int pass_smem(int dbits) {
  return TILE * 6 + (THREADS / 32) * (2 << dbits) + (8 << dbits) + 16;
}

// One pass over a tile: the warps rank its keys by the digit, the block
// finds each digit's start in the tile and its place in the output (the
// first pass: the chunk's place + the tiles before in the chunk, from the
// upsweep; LOOK, a later pass: the tiles before, by look-back), stages the
// keys in digit order, and writes the keys, then each operand, in digit
// runs.
template <bool LOOK>
__global__ void __launch_bounds__(THREADS, 2) sort_pass_kernel(PassParams p) {
  constexpr int WARPS = THREADS / 32, KPW = 32 * KPT;
  const int R = 1 << p.dbits;
  const uint32_t mask = R - 1;
  const int E = R > THREADS ? R / THREADS : 1;  // digits a thread, contiguous
  extern __shared__ __align__(16) int32_t s_dyn[];
  __shared__ int s_tmp[WARPS];
  __shared__ int s_tile;
  int32_t* s_key = s_dyn;                                        // [TILE]
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_key + TILE);  // [TILE]
  uint16_t* s_wc = s_idx + TILE;                                 // [WARPS, R]
  int* s_start = reinterpret_cast<int*>(s_wc + WARPS * R);      // [R + 1]
  int* s_run = s_start + R + 1;                                  // [R]
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
  for (int i = tid; i < WARPS * R; i += THREADS) s_wc[i] = 0;
  uint32_t key[KPT], pos[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int slot = warp * KPW + r * 32 + lane;
    key[r] = slot < n ? (uint32_t)p.key_in[t0 + slot] : 0u;
  }
  __syncthreads();
  // rank: each warp its KPW keys, in rounds of 32; the rounds' peers first
  // (independent), then the chain through the warp's counters
  uint16_t* wc = s_wc + warp * R;
  const bool full = (warp + 1) * KPW <= n;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const bool ok = full || warp * KPW + r * 32 + lane < n;
    pos[r] = warp_peers(digit_of(key[r], p.shift, mask), ok, p.dbits, full);
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const bool ok = full || warp * KPW + r * 32 + lane < n;
    const uint32_t d = digit_of(key[r], p.shift, mask);
    const unsigned peers = pos[r];
    const int c = ok ? wc[d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) wc[d] = (uint16_t)(c + __popc(peers));
    __syncwarp();
    pos[r] = c + __popc(peers & below);
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
        Status::publish(p.status, (int64_t)t * R + d, (t == 0 ? INC : AGG) | (uint32_t)cnt);
      s_start[d] = local;
      local += cnt;
    }
  }
  int all;
  const int ex = block_exclusive_scan<THREADS>(local, s_tmp, &all);
  if (!LOOK) {
    const int* pre = p.tile_pre + (size_t)t * R;
    const int* cbase = p.chunk_base + (size_t)(t / CHUNK) * R;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = tid * E + e;
      if (d < R) {
        const int start = s_start[d] + ex;
        s_start[d] = start;
        s_run[d] = cbase[d] + pre[d] - start;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = tid * E + e;
      if (d < R) s_start[d] += ex;
    }
    if (tid == 0) s_start[R] = n;
  }
  __syncthreads();
  // stage the keys and their local index in the tile's digit order
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int slot = warp * KPW + r * 32 + lane;
    if (slot < n) {
      const uint32_t d = digit_of(key[r], p.shift, mask);
      const int at = (int)pos[r] + s_start[d] + wc[d];
      s_key[at] = (int32_t)key[r];
      s_idx[at] = (uint16_t)slot;
    }
  }
  if (!LOOK) __syncthreads();
  if (LOOK) {
    // a later pass's places: per digit (a thread's digits in flight
    // together), the counts of the tiles before this one, walked back over
    // until a tile whose count holds every tile before it
    constexpr int DPT = RMAX / THREADS;
    int excl[DPT], tp[DPT];
    unsigned todo = 0;
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      excl[k] = 0;
      tp[k] = t - 1;
      if (t > 0 && k * THREADS + tid < R) todo |= 1u << k;
    }
    while (todo) {
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        if (todo >> k & 1) {
          const uint32_t v = Status::read(p.status, (int64_t)tp[k] * R + k * THREADS + tid);
          const uint32_t flag = v & ~CNT;
          if (flag) {
            excl[k] += (int)(v & CNT);
            if (flag == INC) todo &= ~(1u << k);
            else --tp[k];
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
          Status::publish(p.status, (int64_t)t * R + d,
                          INC | (uint32_t)(excl[k] + s_start[d + 1] - start));
        s_run[d] = p.bases[d] + excl[k] - start;
      }
    }
    __syncthreads();
  }
  // staged key i goes to its digit's place + (i - its start in the tile):
  // a digit's keys go out as one contiguous run
  int dst[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = j * THREADS + tid;
    if (i < n) {
      const int32_t k = s_key[i];
      dst[j] = s_run[digit_of((uint32_t)k, p.shift, mask)] + i;
      p.key_out[dst[j]] = k;
    }
  }
  // each operand through the keys' space, in the same order (every loop
  // over the operands is unrolled, so that p.op_in[s] and p.op_out[s] are
  // constant offsets into the parameters)
#pragma unroll
  for (int s = 0; s < MAX_OPS; ++s) {
    if (s >= p.n_ops) break;
    const bool gen = s == p.idx_slot && p.gen_idx;
    if (!gen) {
      __syncthreads();  // the keys (or the operand before) are written out
      copy_in(s_key, p.op_in[s] + t0, n);
      __syncthreads();
    }
    if (s == p.idx_slot && p.idx64) {
      int64_t* out = static_cast<int64_t*>(p.op_out[s]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int i = j * THREADS + tid;
        if (i < n) {
          const int src = s_idx[i];
          out[dst[j]] = gen ? p.base + t0 + src : (int64_t)s_key[src];
        }
      }
    } else {
      int32_t* out = static_cast<int32_t*>(p.op_out[s]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int i = j * THREADS + tid;
        if (i < n) {
          const int src = s_idx[i];
          out[dst[j]] = gen ? (int32_t)(uint32_t)(uint64_t)(p.base + t0 + src) : s_key[src];
        }
      }
    }
  }
}

template <bool LOOK>
cudaError_t launch_pass(const PassParams& p, int n_tiles, cudaStream_t st, int dev) {
  static bool opted[64];
  cudaError_t e;
  if (!opted[dev]) {
    if ((e = cudaFuncSetAttribute(sort_pass_kernel<LOOK>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, pass_smem(DMAX))) !=
        cudaSuccess)
      return e;
    opted[dev] = true;
  }
  sort_pass_kernel<LOOK><<<n_tiles, THREADS, pass_smem(p.dbits), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// key_in int32 [P], every key in [0, 2^bits), 1 <= bits <= 31, P < 2^30;
// key_out int32 [P]; key_tmp int32 [P] (unused with one pass). n_ops
// operands: op_in[s] int32 [P] (nullptr for the index slot idx_slot,
// generated as base + i), op_out[s] int32 [P] (int64 [P] for the index
// where idx64; base + P <= 2^31 then), op_tmp: int32 [n_ops * P] (unused
// with one pass). scratch: scratch_ints int32, at least the wrapper's
// _sort_scratch. Inputs are never written.
extern "C" int radix_sort_launch(const void* key_in, void* key_out, void* key_tmp,
                                 const void* op_in0, const void* op_in1, const void* op_in2,
                                 void* op_out0, void* op_out1, void* op_out2, void* op_tmp,
                                 int32_t n_ops, int32_t idx_slot, int64_t base, int32_t idx64,
                                 int64_t P, int32_t bits, void* scratch, int64_t scratch_ints,
                                 void* stream) {
  const void* op_in[MAX_OPS] = {op_in0, op_in1, op_in2};
  void* op_out[MAX_OPS] = {op_out0, op_out1, op_out2};
  if (P < 0 || P >= (1 << 30) || bits < 1 || bits > 31 || n_ops < 0 || n_ops > MAX_OPS ||
      idx_slot < -1 || idx_slot >= n_ops || (idx64 && idx_slot < 0) || !key_in || !key_out)
    return (int)cudaErrorInvalidValue;
  const int npass = (bits + DMAX - 1) / DMAX;
  for (int s = 0; s < n_ops; ++s)
    if (!op_out[s] || (s != idx_slot && !op_in[s])) return (int)cudaErrorInvalidValue;
  if (npass > 1 && (!key_tmp || (n_ops && !op_tmp))) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int n_tiles = (int)((P + TILE - 1) / TILE);
  const int n_chunks = (n_tiles + CHUNK - 1) / CHUNK;
  SweepParams sw{};
  sw.P = (int32_t)P;
  sw.npass = npass;
  int shift = 0, widest = 0;
  for (int q = 0; q < npass; ++q) {  // equal digits, the first bits % npass one bit wider
    sw.hdbits[q] = bits / npass + (q < bits % npass);
    sw.hshift[q] = shift;
    shift += sw.hdbits[q];
    widest = sw.hdbits[q] > widest ? sw.hdbits[q] : widest;
  }
  // the scratch: the histograms and the later passes' tile counters and
  // status words (zeroed at once), then the first pass's counts of the
  // tiles before each tile in its chunk and each chunk's counts
  int64_t status_ints = 0;
  for (int q = 1; q < npass; ++q) status_ints += (int64_t)n_tiles << sw.hdbits[q];
  const int64_t zeroed = MAX_PASSES * RMAX + 32 * MAX_PASSES + status_ints;
  const int64_t need = zeroed + ((int64_t)(n_tiles + n_chunks) << sw.hdbits[0]);
  if (scratch_ints < need) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* ghist = static_cast<int32_t*>(scratch);
  int32_t* counters = ghist + MAX_PASSES * RMAX;
  uint32_t* status = reinterpret_cast<uint32_t*>(counters + 32 * MAX_PASSES);
  int32_t* tile_pre = static_cast<int32_t*>(scratch) + zeroed;
  int32_t* chunk = tile_pre + ((int64_t)n_tiles << sw.hdbits[0]);
  if ((e = cudaMemsetAsync(scratch, 0, zeroed * 4, st)) != cudaSuccess) return (int)e;
  // the first pass's digit: each tile's and each chunk's counts, and every
  // pass's histogram, from one read of the keys; the digits' bases; the
  // chunks' places
  sw.key = static_cast<const int32_t*>(key_in);
  sw.shift = sw.hshift[0];
  sw.dbits = sw.hdbits[0];
  sw.ghist = ghist;
  sw.tile_pre = tile_pre;
  sw.chunk_sum = chunk;
  sort_upsweep_kernel<<<n_chunks, SWEEP_THREADS, 0, st>>>(sw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sort_bases_kernel<<<npass, RMAX, 0, st>>>(ghist);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sort_chunk_scan_kernel<<<((1 << sw.dbits) + 31) / 32, 256, 0, st>>>(chunk, n_chunks, sw.dbits,
                                                                      ghist);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  PassParams p{};
  p.P = (int32_t)P;
  p.n_ops = n_ops;
  p.idx_slot = idx_slot;
  p.base = base;
  p.tile_pre = tile_pre;
  p.chunk_base = chunk;
  const void* cur_key = key_in;
  const void* cur_op[MAX_OPS] = {op_in[0], op_in[1], op_in[2]};
  for (int pass = 0; pass < npass; ++pass) {
    const bool to_out = (npass - 1 - pass) % 2 == 0;  // the last pass lands in the outputs
    p.key_in = static_cast<const int32_t*>(cur_key);
    p.key_out = static_cast<int32_t*>(to_out ? key_out : key_tmp);
    for (int s = 0; s < MAX_OPS; ++s) {
      p.op_in[s] = s < n_ops ? static_cast<const int32_t*>(cur_op[s]) : nullptr;
      p.op_out[s] = s < n_ops ? (to_out ? op_out[s] : static_cast<int32_t*>(op_tmp) + s * P)
                              : nullptr;
    }
    p.gen_idx = pass == 0;
    p.idx64 = idx64 && pass == npass - 1;
    p.shift = sw.hshift[pass];
    p.dbits = sw.hdbits[pass];
    p.bases = ghist + pass * RMAX;
    p.status = status;
    p.counter = counters + 32 * pass;
    if (pass) status += (int64_t)n_tiles << p.dbits;
    e = pass ? launch_pass<true>(p, n_tiles, st, dev) : launch_pass<false>(p, n_tiles, st, dev);
    if (e != cudaSuccess) return (int)e;
    cur_key = p.key_out;
    for (int s = 0; s < n_ops; ++s) cur_op[s] = p.op_out[s];
  }
  return 0;
}
