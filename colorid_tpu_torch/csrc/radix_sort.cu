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
// The passes: npass = ceil(bits / 8) digits of equal width (30 bits: 8, 8,
// 7, 7; 26: 7, 7, 6, 6), low digit first, over tiles of 4,096 keys:
//   histogram, once: every pass's digit counts from one read of the keys,
//     then each pass's digit bases (an exclusive scan);
//   one kernel a pass (a chained scan with decoupled look-back, onesweep):
//     each block takes the next tile in order from an atomic counter, and
//     each of its 8 warps ranks its 512 keys in rounds of 32 (the lanes of
//     equal digit from one ballot a digit bit, warp-private 16-bit
//     counters); the tile publishes its digit counts, then for each digit
//     walks back over the tiles before it, adding their counts until a
//     tile whose count already covers every tile before it, and publishes
//     that sum; the keys and then each operand are staged in shared memory
//     in the tile's digit order, and thread i writes staged element i to
//     its digit's base + the tiles before + (i - the digit's start in the
//     tile): a digit's keys go out as one contiguous run. The operands
//     that are read come into shared memory by cp.async while the keys
//     are ranked.
// Tiles are in key order, warps in tile order, rounds in warp order, lanes
// in round order, so the sort is stable. Passes ping-pong between the
// outputs and the wrapper's scratch buffers so that the last pass lands in
// the outputs and the inputs are never written.
//
// Why this shape, from the design's runs on an H100 (chip_smoke.py's
// [kernel] sort times the result):
// - The look-back waits only on tiles taken before it, whose blocks are
//   already running and publish before they wait themselves, so it always
//   ends. Against a reduce-then-scan design (an upsweep a pass, blocks over
//   contiguous spans) it reads the keys once less a pass, and the tiles in
//   flight are neighbours, so a digit's runs from them fill the same lines
//   of L2 at about the same time; the scattered runs were what bounded the
//   spans' design.
// - 8-bit digits: at 10 bits a digit's run in a tile of 4,096 keys is 4
//   keys (half a sector) and the per-digit bookkeeping of a tile rivals its
//   keys'; each pass took about twice as long, more than the pass it saves.
// - Ballots, not __match_any_sync, for the lanes of equal digit: the match
//   instruction was slower at this size.
//
// What bounds it on an H100: bytes, and the instructions of the rank. Per
// probe and pass the key and each operand are read once and written once;
// the byte bound counts each input read once and each output written once
// over the whole sort (16 bytes a probe for the blocked exact key + offsets,
// and for the classic rows + int64 index). What the design saves against
// torch.sort: passes over the key's own bits only, and int32 operands
// carried in the sort instead of an int64 permutation that a gather then
// follows.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches every pass on the caller's stream and returns
// cudaGetLastError(); the wrapper allocates outputs, ping-pong buffers and
// the scratch (tile status words, the tile counter, the histograms).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KPT = 16;              // keys a thread a tile
constexpr int KPW = 32 * KPT;        // keys a warp a tile
constexpr int TILE = THREADS * KPT;  // 4,096 keys
constexpr int DMAX = 8;              // widest digit
constexpr int RMAX = 1 << DMAX;      // most buckets: 256, one a thread in the digit steps
constexpr int MAX_OPS = 3;
constexpr int MAX_PASSES = 4;        // 31 bits at most
constexpr int HIST_BLOCKS = 264;     // the histogram kernel's grid
constexpr unsigned FULL = 0xffffffffu;
// a tile's status word for one digit: a flag in the top two bits (0: not
// yet, AGG: the tile's own count, INC: the count of every tile up to this
// one) over a 30-bit count
constexpr uint32_t AGG = 1u << 30, INC = 2u << 30, CNT = (1u << 30) - 1;

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
  int64_t P;
  int32_t shift, dbits;
  uint32_t* status;      // [n_tiles, RMAX], zero before the pass
  int32_t* counter;      // the next tile to take, zero before the pass
  const int32_t* bases;  // [RMAX] the digits' first places in the output
};

struct HistParams {
  const int32_t* key;
  int64_t P;
  int32_t npass;
  int32_t shift[MAX_PASSES], dbits[MAX_PASSES];
  int32_t* ghist;  // [MAX_PASSES, RMAX]
};

// The exclusive scan of v over the block in thread order; *total gets the
// sum. s_tmp holds one int a warp.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_tmp, int* total) {
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

// cp.async: a 16-byte copy from global to shared memory that holds no
// register while it is in flight; commit groups; wait until at most N of
// this thread's groups are in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift, uint32_t mask) {
  return ((uint32_t)key >> shift) & mask;
}
// Copy n <= TILE int32 from global to shared memory with cp.async, 16
// bytes a thread at a time (from and to 16-byte aligned), the ragged end
// by plain stores.
__device__ __forceinline__ void copy_tile(int32_t* to, const int32_t* from, int n) {
  for (int c = threadIdx.x; c * 4 < n; c += THREADS) {
    if (c * 4 + 4 <= n)
      cp_async16(to + c * 4, from + c * 4);
    else
      for (int q = c * 4; q < n; ++q) to[q] = from[q];
  }
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

// Every pass's digit histogram, from one read of the keys (shared-memory
// atomics, then one global atomic a block and bucket).
__global__ void __launch_bounds__(THREADS) sort_hist_kernel(HistParams p) {
  __shared__ int s_hist[MAX_PASSES * RMAX];
  for (int i = threadIdx.x; i < MAX_PASSES * RMAX; i += THREADS) s_hist[i] = 0;
  __syncthreads();
  const bool vec = (reinterpret_cast<uintptr_t>(p.key) & 15) == 0;
  const int64_t n4 = vec ? p.P / 4 : 0;
  const int4* k4 = reinterpret_cast<const int4*>(p.key);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < n4; j += stride) {
    const int4 v = __ldg(k4 + j);
#pragma unroll
    for (int q = 0; q < MAX_PASSES; ++q) {  // unrolled: p.shift[q] a constant offset
      if (q >= p.npass) break;
      const uint32_t m = (1u << p.dbits[q]) - 1;
      int* h = s_hist + q * RMAX;
      atomicAdd(&h[digit_of(v.x, p.shift[q], m)], 1);
      atomicAdd(&h[digit_of(v.y, p.shift[q], m)], 1);
      atomicAdd(&h[digit_of(v.z, p.shift[q], m)], 1);
      atomicAdd(&h[digit_of(v.w, p.shift[q], m)], 1);
    }
  }
  for (int64_t j = n4 * 4 + (int64_t)blockIdx.x * THREADS + threadIdx.x; j < p.P; j += stride) {
#pragma unroll
    for (int q = 0; q < MAX_PASSES; ++q) {
      if (q >= p.npass) break;
      atomicAdd(&s_hist[q * RMAX + digit_of(p.key[j], p.shift[q], (1u << p.dbits[q]) - 1)], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.npass * RMAX; i += THREADS)
    if (s_hist[i]) atomicAdd(&p.ghist[i], s_hist[i]);
}

// Each pass's digit bases: the exclusive scan of its histogram, in place
// (one block).
__global__ void __launch_bounds__(THREADS) sort_bases_kernel(int32_t* ghist, int npass) {
  __shared__ int s_tmp[WARPS];
  int all;
  for (int q = 0; q < npass; ++q) {
    const int d = threadIdx.x;
    const int v = d < RMAX ? ghist[q * RMAX + d] : 0;
    const int ex = block_exclusive_scan(v, s_tmp, &all);
    if (d < RMAX) ghist[q * RMAX + d] = ex;
  }
}

// The pass kernel's dynamic shared memory for n_ops operands: the stage,
// the digit starts and output places, the warps' counters and a tile of
// each operand, copied in early.
constexpr int pass_smem(int n_ops) {
  return TILE * 4 + 2 * RMAX * 4 + WARPS * RMAX * 2 + n_ops * TILE * 4;
}

// One pass: each block takes the next tile in order (an atomic counter, so
// that a tile only waits on tiles whose blocks already run), ranks its keys
// by the digit, publishes its digit counts, looks back over the tiles
// before it for each digit's first place, and scatters the tile's keys and
// operands through shared memory in digit order.
__global__ void __launch_bounds__(THREADS, 3) sort_pass_kernel(PassParams p) {
  extern __shared__ __align__(16) int32_t s_dyn[];
  int32_t* s_stage = s_dyn;          // [TILE]
  int32_t* s_start = s_stage + TILE;  // [RMAX] the digit's first place in the tile
  int32_t* s_run = s_start + RMAX;    // [RMAX] the digit's first place in the output
  uint16_t* s_wcnt = reinterpret_cast<uint16_t*>(s_run + RMAX);  // [WARPS, RMAX]: count, then offset
  int32_t* s_pref = reinterpret_cast<int32_t*>(s_wcnt + WARPS * RMAX);  // [n_ops, TILE] operands
  __shared__ int s_tmp[WARPS];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int R = 1 << p.dbits;
  const uint32_t mask = R - 1;
  if (tid == 0) s_tile = atomicAdd(p.counter, 1);
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t t0 = t * TILE;
  const int n = p.P - t0 < TILE ? (int)(p.P - t0) : TILE;
  // the operands that are read (not the generated index) and 16-byte
  // aligned are copied into shared memory while the keys are ranked, a
  // commit group each (waited for one by one)
  // (every loop over the operands is unrolled, so that p.op_in[s] and
  // p.op_out[s] are constant offsets into the parameters: indexed at run
  // time they would be copied to the stack)
  unsigned pre = 0;  // bit s: operand s comes from s_pref
#pragma unroll
  for (int s = 0; s < MAX_OPS; ++s)
    if (s < p.n_ops && !(s == p.idx_slot && p.gen_idx) &&
        (reinterpret_cast<uintptr_t>(p.op_in[s]) & 15) == 0)
      pre |= 1u << s;
#pragma unroll
  for (int s = 0; s < MAX_OPS; ++s) {
    if (pre >> s & 1) copy_tile(s_pref + s * TILE, p.op_in[s] + t0, n);
    cp_async_commit();
  }
  int32_t key[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int local = warp * KPW + r * 32 + lane;
    key[r] = local < n ? p.key_in[t0 + local] : 0;
  }
  {
    // zero the warps' counters of this digit width, two at a time
    const int hb = p.dbits - 1;  // R / 2 = 1 << hb
    uint32_t* wc32 = reinterpret_cast<uint32_t*>(s_wcnt);
    for (int i = tid; i < (WARPS << hb); i += THREADS)
      wc32[(i >> hb) * (RMAX / 2) + (i & ((1 << hb) - 1))] = 0;
  }
  __syncthreads();
  // rank: each warp its KPW keys, in rounds of 32; the rounds' peers
  // first (independent ballots), then the chain through the counters
  uint16_t* wc = s_wcnt + warp * RMAX;
  int pos[KPT];  // the rank among the warp's keys of the same digit, then the place in the tile
  unsigned peers[KPT];
  const bool full = n == TILE;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const bool ok = full || warp * KPW + r * 32 + lane < n;
    peers[r] = warp_peers(digit_of(key[r], p.shift, mask), ok, p.dbits, full);
  }
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const bool ok = full || warp * KPW + r * 32 + lane < n;
    const uint32_t d = digit_of(key[r], p.shift, mask);
    const int c = ok ? wc[d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers[r]) - 1) wc[d] = (uint16_t)(c + __popc(peers[r]));
    __syncwarp();
    pos[r] = c + __popc(peers[r] & ((1u << lane) - 1));
  }
  __syncthreads();
  // per digit (thread d): the warps' offsets among the tile's keys of that
  // digit and the tile's count, published at once for the tiles after it
  const int d = tid;
  int cnt = 0;
  if (d < R) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_wcnt[w * RMAX + d];
      s_wcnt[w * RMAX + d] = (uint16_t)cnt;
      cnt += c;
    }
    volatile uint32_t* st = p.status + t * RMAX + d;
    *st = (t == 0 ? INC : AGG) | (uint32_t)cnt;
  }
  int all;
  const int ex = block_exclusive_scan(cnt, s_tmp, &all);
  if (d < R) {
    s_start[d] = ex;
    // look back over the tiles before this one: their counts until one
    // that holds the count of every tile up to it
    int excl = 0;
    for (int64_t tp = t - 1; tp >= 0;) {
      const uint32_t v = *(volatile uint32_t*)(p.status + tp * RMAX + d);
      const uint32_t flag = v & ~CNT;
      if (!flag) continue;
      excl += (int)(v & CNT);
      if (flag == INC) break;
      --tp;
    }
    if (t > 0) *(volatile uint32_t*)(p.status + t * RMAX + d) = INC | (uint32_t)(excl + cnt);
    s_run[d] = p.bases[d] + excl;
  }
  __syncthreads();
  // stage the keys in the tile's digit order
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int local = warp * KPW + r * 32 + lane;
    if (local < n) {
      const uint32_t dd = digit_of(key[r], p.shift, mask);
      pos[r] += s_start[dd] + wc[dd];
      s_stage[pos[r]] = key[r];
    }
  }
  __syncthreads();
  // staged element i goes to its digit's first place + (i - its start in
  // the tile): a digit's keys go out as one contiguous run
  int dst[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = j * THREADS + tid;
    if (i < n) {
      const int32_t k = s_stage[i];
      const uint32_t dd = digit_of(k, p.shift, mask);
      dst[j] = s_run[dd] + i - s_start[dd];
      p.key_out[dst[j]] = k;
    }
  }
#pragma unroll
  for (int s = 0; s < MAX_OPS; ++s) {
    if (s >= p.n_ops) break;
    const bool gen = s == p.idx_slot && p.gen_idx;
    const bool from_smem = pre >> s & 1;
    const int32_t* in = p.op_in[s];
    if (from_smem) {  // operand s's group and those before it have landed
      if (s == 0) cp_async_wait<MAX_OPS - 1>();
      else if (s == 1) cp_async_wait<MAX_OPS - 2>();
      else cp_async_wait<0>();
    }
    __syncthreads();  // the stage's readers are done (and the copy has landed)
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int local = warp * KPW + r * 32 + lane;
      const int64_t g = t0 + local;
      if (local < n)
        s_stage[pos[r]] = from_smem ? s_pref[s * TILE + local]
                          : gen     ? (int32_t)(uint32_t)(uint64_t)(p.base + g)
                                    : in[g];
    }
    __syncthreads();
    if (s == p.idx_slot && p.idx64) {
      int64_t* out = static_cast<int64_t*>(p.op_out[s]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int i = j * THREADS + tid;
        if (i < n) out[dst[j]] = (int64_t)s_stage[i];
      }
    } else {
      int32_t* out = static_cast<int32_t*>(p.op_out[s]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int i = j * THREADS + tid;
        if (i < n) out[dst[j]] = s_stage[i];
      }
    }
  }
  cp_async_wait<0>();  // nothing is left in flight
}

}  // namespace

// key_in int32 [P], every key in [0, 2^bits), 1 <= bits <= 31, P < 2^30;
// key_out int32 [P]; key_tmp int32 [P] (unused with one pass). n_ops
// operands: op_in[s] int32 [P] (nullptr for the index slot idx_slot,
// generated as base + i), op_out[s] int32 [P] (int64 [P] for the index
// where idx64; base + P <= 2^31 then), op_tmp[s] int32 [P]. scratch:
// scratch_ints int32, at least ceil(P / 4096) * 256 + 32 + 4 * 256. Inputs
// are never written.
extern "C" int radix_sort_launch(const void* key_in, void* key_out, void* key_tmp,
                                 const void* op_in0, const void* op_in1, const void* op_in2,
                                 void* op_out0, void* op_out1, void* op_out2, void* op_tmp0,
                                 void* op_tmp1, void* op_tmp2, int32_t n_ops, int32_t idx_slot,
                                 int64_t base, int32_t idx64, int64_t P, int32_t bits,
                                 void* scratch, int64_t scratch_ints, void* stream) {
  const void* op_in[MAX_OPS] = {op_in0, op_in1, op_in2};
  void* op_out[MAX_OPS] = {op_out0, op_out1, op_out2};
  void* op_tmp[MAX_OPS] = {op_tmp0, op_tmp1, op_tmp2};
  if (P < 0 || P > CNT || bits < 1 || bits > 31 || n_ops < 0 || n_ops > MAX_OPS ||
      idx_slot < -1 || idx_slot >= n_ops || (idx64 && idx_slot < 0) || !key_in || !key_out)
    return (int)cudaErrorInvalidValue;
  const int npass = (bits + DMAX - 1) / DMAX;
  for (int s = 0; s < n_ops; ++s)
    if (!op_out[s] || (s != idx_slot && !op_in[s]) || (npass > 1 && !op_tmp[s]))
      return (int)cudaErrorInvalidValue;
  if (npass > 1 && !key_tmp) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int64_t n_tiles = (P + TILE - 1) / TILE;
  const int64_t need = n_tiles * RMAX + 32 + MAX_PASSES * RMAX;
  if (scratch_ints < need) return (int)cudaErrorInvalidValue;
  // the pass kernel's shared memory may pass 48 KB: opt in once a device
  static bool opted[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    if ((e = cudaFuncSetAttribute(sort_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  pass_smem(MAX_OPS))) != cudaSuccess)
      return (int)e;
    opted[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* status = static_cast<uint32_t*>(scratch);
  int32_t* counter = static_cast<int32_t*>(scratch) + n_tiles * RMAX;
  int32_t* ghist = counter + 32;
  HistParams h{};
  h.key = static_cast<const int32_t*>(key_in);
  h.P = P;
  h.npass = npass;
  int shift = 0;
  for (int q = 0; q < npass; ++q) {  // equal digits, the first bits % npass one bit wider
    h.dbits[q] = bits / npass + (q < bits % npass);
    h.shift[q] = shift;
    shift += h.dbits[q];
  }
  h.ghist = ghist;
  if ((e = cudaMemsetAsync(ghist, 0, MAX_PASSES * RMAX * 4, st)) != cudaSuccess) return (int)e;
  const int64_t hb = (P + 4 * THREADS - 1) / (4 * THREADS);
  sort_hist_kernel<<<(unsigned)(hb < HIST_BLOCKS ? hb : HIST_BLOCKS), THREADS, 0, st>>>(h);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sort_bases_kernel<<<1, THREADS, 0, st>>>(ghist, npass);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  PassParams p{};
  p.P = P;
  p.n_ops = n_ops;
  p.idx_slot = idx_slot;
  p.base = base;
  p.status = status;
  p.counter = counter;
  const void* cur_key = key_in;
  const void* cur_op[MAX_OPS] = {op_in[0], op_in[1], op_in[2]};
  for (int pass = 0; pass < npass; ++pass) {
    const bool to_out = (npass - 1 - pass) % 2 == 0;  // the last pass lands in the outputs
    p.key_in = static_cast<const int32_t*>(cur_key);
    p.key_out = static_cast<int32_t*>(to_out ? key_out : key_tmp);
    for (int s = 0; s < MAX_OPS; ++s) {
      p.op_in[s] = s < n_ops ? static_cast<const int32_t*>(cur_op[s]) : nullptr;
      p.op_out[s] = s < n_ops ? (to_out ? op_out[s] : op_tmp[s]) : nullptr;
    }
    p.gen_idx = pass == 0;
    p.idx64 = idx64 && pass == npass - 1;
    p.shift = h.shift[pass];
    p.dbits = h.dbits[pass];
    p.bases = ghist + pass * RMAX;
    if ((e = cudaMemsetAsync(status, 0, (n_tiles * RMAX + 32) * 4, st)) != cudaSuccess) return (int)e;
    sort_pass_kernel<<<(unsigned)n_tiles, THREADS, pass_smem(n_ops), st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cur_key = p.key_out;
    for (int s = 0; s < n_ops; ++s) cur_op[s] = p.op_out[s];
  }
  return 0;
}
