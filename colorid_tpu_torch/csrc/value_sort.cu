// The reads routes' value sort on Hopper (sm_90a): a stable sort of the
// int64 k-mer sort keys over their own 2k bits, keys only or with one int32
// payload (kernel G): LSD radix passes for keys in any order, or, where the
// caller hints that the keys come as a few sorted runs, a merge of the runs.
//
// Replaces what the JAX package leaves to XLA's sort: jax.lax.sort((hi, lo),
// num_keys=2) of the canonical windows in colorid_tpu/ops/extract.py:188
// (extract_count) and :242 (count_histogram), colorid_tpu/ops/
// fused_reads.py:97 (the single fused dispatch) and :185 (a chunk), and
// the merges lax.sort((hi, lo, qc), num_keys=2) at fused_reads.py:251 and
// colorid_tpu/parallel/sharded.py:497. Its plain PyTorch twins are
// colorid_tpu_torch/ops/extract.py::value_sort_plain, which runs the same
// passes with the same digit widths, and value_merge_plain, which runs the
// same merge rounds; a stable sort's output is unique, so kernel and twins
// agree bit for bit.
//
// What it computes: the keys, and the payload with them, in the stable
// order of the low `bits` bits of key ^ 2^63. The callers' keys are
// ops/extract.py::_sort_key values of canonical k-mers of length k (the
// 2k-bit value with the sign bit flipped) or SENT_KEY, and bits = 2k: no
// canonical value has all ones in its low 2k bits (the all-T k-mer's
// canonical form is all A), so this order is torch.sort's, SENT last.
//
// The merge mode (max_rounds > 0, the two merge sites: the chunked route's
// chunk streams, each live slots then dead slots in key order; the
// data-shard merge's slices, each kept keys then SENT): one read of the
// keys (vsort_runs_kernel) counts the descents under the sort's own
// comparison (the low `bits` bits of key ^ 2^63, unsigned) and lists their
// places while there are fewer than 2^max_rounds of them. With runs <=
// 2^max_rounds the device merges: ceil(log2 runs) rounds (at least one),
// each merging run pairs (2j, 2j + 1) of the round before, a run without a
// partner copied through. A merge block writes a contiguous range of
// output tiles of 4,096 keys, 8 at a time: first its 16 warps find the 8
// tiles' starts and ends on their pairs' merge paths at once (each a
// binary search over global memory, 32 probes a step; ties go to the
// earlier run, which keeps the merge stable), then for each tile the block
// brings both input ranges into shared memory (every load of a thread in
// flight together), each thread merges 8 outputs there and notes where
// each came from, and the tile goes out with 16-byte stores where its
// place is aligned. The rounds ping-pong between the outputs and
// the scratch buffers so that the last lands in the outputs, the parity
// chosen on the device. Otherwise the LSD passes below run. The host
// launches the runs kernel, max_rounds merge kernels and every LSD launch;
// the kernels of the path the device did not take exit at once on the
// descents' count (on an H100, 12 LSD launches that exit cost 0.057 ms,
// 6 merge rounds 0.008). The wrapper sets max_rounds from its path rule
// (ops/extract.py::value_sort_merge_max_rounds): the most rounds r with r
// x 0.01076 < 0.00556 + npass x 0.01154 ms a million keys with a payload,
// a round's, the upsweep's and a pass's time measured on an H100 80GB HBM3
// at 700 W (sort_bench.py, PERF.md), at most 8: 8 at 62 and 64 bits, 6 at
// 54. On the chunked route's merge (4 runs, 33,554,432 keys) the merge
// takes 0.90 ms where the LSD passes took 3.79.
//
// The passes: npass = ceil(bits / dmax) digits of equal width (the first
// bits % npass one bit wider; dmax from the wrapper, 8 to 11, 9 by
// default: 62 bits are 9, 9, 9, 9, 9, 9, 8), low digit first, over tiles of
// 8,192 keys (512 threads x 16):
//   upsweep, once: one read of the keys counts every pass's digits (the
//     digits' bases, an exclusive scan) and, a chunk of 8 tiles a block in
//     order, each tile's first digits and the tiles' before it in its
//     chunk; a scan over the chunks gives each chunk's first place of each
//     digit. A SENT key (flipped low bits all ones: about 8 % of the single
//     route's keys, often in runs) is counted by one ballot a warp, apart
//     from the digits of the later passes; a key that is not SENT but whose
//     first digit is all ones (one in 2^dbits) is counted by how many of its
//     low digits are;
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
//     waits for nothing. A later pass takes the next tile in order from an
//     atomic counter, publishes its digit counts at once, and for each
//     digit walks back over the tiles before it (a decoupled look-back,
//     csrc/look_back.cuh) until a tile whose count covers every tile
//     before it. A tile's status words are 32-bit below 2^30 keys, 64-bit
//     above. SENT keys out of the later passes: once no key that is not
//     SENT has the low digits sorted so far all ones (from the third pass
//     on at k 31, in practice), the passes before have put every SENT key
//     at [P - n_sent, P) in input order, its final place, and the later
//     passes sort only [0, P - n_sent), a tile past it exiting before its
//     look-back, so that no tile waits on it; a last launch copies that
//     tail to the outputs where the last pass to sort it wrote the scratch
//     buffer.
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
// SM. At a merge site the input is already a few sorted runs: a merge
// round moves each key and payload once (24 bytes a key), where the LSD
// path moves 8 bytes in the upsweep and 24 a pass.
//
// What bounds it on an H100: the bytes (chip_smoke.py::value_sort_bytes
// counts each input read once and each output written once: 16 bytes a
// key, 24 with the payload; each pass or round reads and writes the key and
// the payload), then the rank's instructions, the look-back's latency and
// the scattered runs.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches every kernel on the caller's stream and
// returns cudaGetLastError(); the wrapper allocates the outputs, the
// ping-pong buffers and the scratch (histograms, tile counters, the runs
// and SENT counts, tile status words, the first pass's tile and chunk
// counts).

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
// the merge mode
constexpr int MAX_ROUNDS = 8;              // the most merge rounds the wrapper may allow
constexpr int MAX_RUNS = 1 << MAX_ROUNDS;  // 256 runs: 255 descents listed
constexpr int RUNS_THREADS = 256;
constexpr int MTHREADS = 512;              // a merge block
constexpr int MTILE = 4096;                // output keys a merge tile
constexpr int MPT = MTILE / MTHREADS;      // outputs a thread merges
constexpr int MBATCH = MTHREADS / 64;      // tiles whose splits a block's warps find together
// the stats words in the scratch: [0] the descents found, [1] the SENT
// keys, [ONES + i] the keys not SENT whose low i bits (and no more) are all
// ones, counted where i >= the first digit's width, [TAILS + q] the SENT
// keys pass q leaves at the tail, [DESC, DESC + MAX_RUNS) the descents'
// places (in no order)
constexpr int ONES = 2, TAILS = ONES + 64, DESC = TAILS + MAX_PASSES;
// padded to 128 bytes: the status words that follow stay aligned (one
// 40-byte offset cost the later passes 4 %)
constexpr int STATS = (DESC + MAX_RUNS + 31) / 32 * 32;

struct PassParams {
  const int64_t* key_in;
  int64_t* key_out;
  const int32_t* pay_in;  // nullptr: keys only
  int32_t* pay_out;
  int32_t P;
  int32_t pass, shift, dbits;
  // the first pass: each tile's counts of the tiles before it in its chunk,
  // each chunk's places ([n_tiles | n_chunks, 2^dbits])
  const int32_t* tile_pre;
  const int32_t* chunk_base;
  // a later pass: the digits' places, the tiles' status words ([n_tiles,
  // 2^dbits], zero before the pass) and the tile counter
  const int32_t* bases;
  void* status;
  int32_t* counter;
  const int32_t* stats;
  int32_t max_rounds;     // the merge mode's; 0: no merge
};

struct SweepParams {
  const int64_t* key;
  int32_t P;
  int32_t shift, dbits;  // the first pass's digit
  int32_t* tile_pre;     // [n_tiles, 2^dbits] out
  int32_t* chunk_sum;    // [n_chunks, 2^dbits] out
  // every pass's digits over the keys that are not SENT (the first pass's
  // with them): pass q's in ghist[q * RMAX ...], in shared memory at hoff[q]
  int32_t npass;
  int32_t hshift[MAX_PASSES], hdbits[MAX_PASSES], hoff[MAX_PASSES];
  int32_t* ghist;  // [MAX_PASSES, RMAX]
  uint64_t low;    // the sort's bits: a key whose flipped bits there are all ones is SENT
  int32_t* stats;
  int32_t max_rounds;
};

struct MergeParams {
  const int64_t* key_in;
  int64_t* key_out;
  int64_t* key_tmp;
  const int32_t* pay_in;  // nullptr: keys only
  int32_t* pay_out;
  int32_t* pay_tmp;
  int32_t P;
  uint64_t low;
  int32_t round, max_rounds;
  const int32_t* stats;
};

// The device's choice: the merge rounds run where the runs kernel found
// fewer than 2^max_rounds descents; the LSD launches exit then.
__device__ __forceinline__ bool merge_taken(const int32_t* stats, int max_rounds) {
  return max_rounds > 0 && stats[0] < (1 << max_rounds);
}

__device__ __forceinline__ uint64_t sort_bits(int64_t key, uint64_t low) {
  return ((uint64_t)key ^ FLIP) & low;
}

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


// The runs, from one read of the keys: each warp finds the places i where
// key i sorts below key i - 1 (a descent: a run starts at i), the block
// lists its own in shared memory, then takes its places in the stats list
// with one atomic. Past MAX_RUNS - 1 descents only the count matters (the
// LSD passes run): a block stops reading once the count passes it.
__global__ void __launch_bounds__(RUNS_THREADS) vsort_runs_kernel(const int64_t* key, int P,
                                                                  uint64_t low, int32_t* stats) {
  __shared__ int s_n, s_base;
  __shared__ int s_list[MAX_RUNS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const int64_t n_warps = (int64_t)gridDim.x * (RUNS_THREADS / 32);
  int step = 0;
  for (int64_t j0 = ((int64_t)blockIdx.x * (RUNS_THREADS / 32) + warp) * 64; j0 < P;
       j0 += n_warps * 64, ++step) {
    const int64_t i = j0 + 2 * lane;  // this lane: the descents at i and i + 1
    const bool in0 = i < P, in1 = i + 1 < P;
    const uint64_t k0 = in0 ? sort_bits(key[i], low) : 0;
    const uint64_t k1 = in1 ? sort_bits(key[i + 1], low) : 0;
    const uint64_t kp = in0 && i > 0 ? sort_bits(key[i - 1], low) : 0;
    const bool d0 = in0 && i > 0 && kp > k0, d1 = in1 && k0 > k1;
    const unsigned m0 = __ballot_sync(FULL, d0), m1 = __ballot_sync(FULL, d1);
    if (m0 | m1) {
      int b = 0;
      if (lane == 0) b = atomicAdd(&s_n, __popc(m0) + __popc(m1));
      b = __shfl_sync(FULL, b, 0);
      if (d0 && b + __popc(m0 & below) < MAX_RUNS) s_list[b + __popc(m0 & below)] = (int)i;
      const int b1 = b + __popc(m0) + __popc(m1 & below);
      if (d1 && b1 < MAX_RUNS) s_list[b1] = (int)(i + 1);
    }
    if ((step & 15) == 15) {  // enough descents for the LSD path: stop reading
      int over = 0;
      if (lane == 0)
        over = *(volatile int*)&s_n >= MAX_RUNS || *(volatile int32_t*)&stats[0] >= MAX_RUNS;
      if (__shfl_sync(FULL, over, 0)) break;
    }
  }
  __syncthreads();
  const int n = s_n;
  if (threadIdx.x == 0) s_base = n ? atomicAdd(&stats[0], n) : 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n && s_base + j < MAX_RUNS - 1; j += RUNS_THREADS)
    stats[DESC + s_base + j] = s_list[j];
}

// The count of A's keys among the first d keys of the stable merge of A
// [na] and B [nb] (ties go to A), by a whole warp: the first m in [lo, hi)
// whose A[m] sorts above B[d - 1 - m], 32 probes a step.
__device__ int merge_split(const int64_t* A, int na, const int64_t* B, int nb, int d,
                           uint64_t low) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  while (true) {
    const int n = hi - lo;
    const int step = n <= 32 ? 1 : (n + 31) / 32;
    const int m = lo + lane * step;
    const bool right = m < hi && sort_bits(A[m], low) <= sort_bits(B[d - 1 - m], low);
    const int c = __popc(__ballot_sync(FULL, right));
    if (step == 1) return lo + c;
    if (c == 0) return lo;
    const int mc = lo + c * step;  // probed and not right, where below hi
    lo += (c - 1) * step + 1;
    hi = min(hi, mc);
  }
}

// Copies n staged values out to dst with 16-byte stores where dst is
// aligned, each value v(i) taken from shared memory by the caller's rule.
template <class T, class F>
__device__ __forceinline__ void store_tile(T* dst, int n, F v) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(T)));
  if ((int)threadIdx.x < head) dst[threadIdx.x] = v(threadIdx.x);
  const int body = (n - head) / V;
  for (int q = threadIdx.x; q < body; q += MTHREADS) {
    const int i = head + q * V;
    if constexpr (V == 2) {
      longlong2 w;
      w.x = v(i);
      w.y = v(i + 1);
      *reinterpret_cast<longlong2*>(dst + i) = w;
    } else {
      int4 w;
      w.x = v(i);
      w.y = v(i + 1);
      w.z = v(i + 2);
      w.w = v(i + 3);
      *reinterpret_cast<int4*>(dst + i) = w;
    }
  }
  for (int i = head + body * V + threadIdx.x; i < n; i += MTHREADS) dst[i] = v(i);
}

// One merge round: the runs' starts from the descents (each one's rank
// among them), then, a tile of MTILE outputs at a time, the pairs of runs
// of the round before merged (see the file's note).
__global__ void __launch_bounds__(MTHREADS, 3) vsort_merge_kernel(MergeParams p) {
  const int n_desc = p.stats[0];
  if (!merge_taken(p.stats, p.max_rounds)) return;
  const int n_runs = n_desc + 1;
  int rounds = 1;
  while ((1 << rounds) < n_runs) ++rounds;
  if (p.round >= rounds) return;
  extern __shared__ __align__(16) unsigned char s_raw[];
  int64_t* s_key = reinterpret_cast<int64_t*>(s_raw);         // [MTILE]: A's range, then B's
  int32_t* s_pay = reinterpret_cast<int32_t*>(s_key + MTILE);  // [MTILE]
  uint16_t* s_src = reinterpret_cast<uint16_t*>(s_pay + MTILE);  // [MTILE]: output i's staged place
  __shared__ int s_start[MAX_RUNS + 1];
  __shared__ int s_tiles[MAX_RUNS / 2 + 1];  // the tiles of the pairs before each pair
  __shared__ int s_split[2 * MBATCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* s_desc = reinterpret_cast<int*>(s_raw);
  for (int j = tid; j < n_desc; j += MTHREADS) s_desc[j] = p.stats[DESC + j];
  if (tid == 0) {
    s_start[0] = 0;
    s_start[n_runs] = p.P;
  }
  __syncthreads();
  for (int j = tid; j < n_desc; j += MTHREADS) {
    const int v = s_desc[j];
    int r = 0;
    for (int i = 0; i < n_desc; ++i) r += s_desc[i] < v;
    s_start[r + 1] = v;
  }
  __syncthreads();
  const int span = 1 << p.round;  // runs of the input merged into one so far
  const int n_pairs = (n_runs + 2 * span - 1) / (2 * span);
  auto start = [&](int run) { return s_start[min(run, n_runs)]; };
  if (warp == 0) {
    int carry = 0;
    for (int j0 = 0; j0 < n_pairs; j0 += 32) {
      const int j = j0 + lane;
      const int len = j < n_pairs ? start((2 * j + 2) * span) - start(2 * j * span) : 0;
      const int nt = (len + MTILE - 1) / MTILE;
      int incl = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (j < n_pairs) s_tiles[j + 1] = carry + incl;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) s_tiles[0] = 0;
  }
  __syncthreads();
  const int n_tiles = s_tiles[n_pairs];
  // round r writes the outputs where rounds - 1 - r is even
  const bool to_out = ((rounds - 1 - p.round) & 1) == 0;
  const int64_t* src_key = p.round == 0 ? p.key_in : to_out ? p.key_tmp : p.key_out;
  const int32_t* src_pay = p.round == 0 ? p.pay_in : to_out ? p.pay_tmp : p.pay_out;
  int64_t* dst_key = to_out ? p.key_out : p.key_tmp;
  int32_t* dst_pay = to_out ? p.pay_out : p.pay_tmp;
  // the tile's pair (the last whose tiles start at or before b), its runs'
  // bounds and the tile's diagonals on its merge path
  auto locate = [&](int b, int& a0, int& a1, int& b1, int& d0, int& d1) {
    int j = 0;
    for (int hi = n_pairs - 1; j < hi;) {
      const int mid = (j + hi + 1) >> 1;
      if (s_tiles[mid] <= b) j = mid;
      else hi = mid - 1;
    }
    a0 = start(2 * j * span);
    a1 = start((2 * j + 1) * span);
    b1 = start((2 * j + 2) * span);
    d0 = (b - s_tiles[j]) * MTILE;
    d1 = min(d0 + MTILE, b1 - a0);
  };
  // a block takes a contiguous range of tiles, MBATCH at a time: first
  // every warp finds one of the batch's splits (warp 2i the start of tile
  // i, warp 2i + 1 its end), then the tiles go one by one
  const int b_lo = (int)((int64_t)n_tiles * blockIdx.x / gridDim.x);
  const int b_hi = (int)((int64_t)n_tiles * (blockIdx.x + 1) / gridDim.x);
  for (int bb = b_lo; bb < b_hi; bb += MBATCH) {
    if (bb + (warp >> 1) < b_hi) {
      int a0, a1, b1, d0, d1;
      locate(bb + (warp >> 1), a0, a1, b1, d0, d1);
      const int sp = merge_split(src_key + a0, a1 - a0, src_key + a1, b1 - a1,
                                 warp & 1 ? d1 : d0, p.low);
      if (lane == 0) s_split[warp] = sp;
    }
    __syncthreads();
    for (int q = 0; q < MBATCH && bb + q < b_hi; ++q) {
      int a0, a1, b1, d0, d1;
      locate(bb + q, a0, a1, b1, d0, d1);
      const int i0 = s_split[2 * q], n = d1 - d0, ca = s_split[2 * q + 1] - i0, cb = n - ca;
      const int64_t* ga = src_key + a0 + i0;
      const int64_t* gb = src_key + a1 + (d0 - i0);
      const int32_t* pa = src_pay ? src_pay + a0 + i0 : nullptr;
      const int32_t* pb = src_pay ? src_pay + a1 + (d0 - i0) : nullptr;
      // both ranges in, the keys, then the payload: every load of the
      // thread in flight before its stores
      {
        int64_t kv[MPT];
#pragma unroll
        for (int r = 0; r < MPT; ++r) {
          const int i = r * MTHREADS + tid;
          kv[r] = i < n ? (i < ca ? ga[i] : gb[i - ca]) : 0;
        }
#pragma unroll
        for (int r = 0; r < MPT; ++r)
          if (r * MTHREADS + tid < n) s_key[r * MTHREADS + tid] = kv[r];
      }
      if (pa) {
        int32_t pv[MPT];
#pragma unroll
        for (int r = 0; r < MPT; ++r) {
          const int i = r * MTHREADS + tid;
          pv[r] = i < n ? (i < ca ? pa[i] : pb[i - ca]) : 0;
        }
#pragma unroll
        for (int r = 0; r < MPT; ++r)
          if (r * MTHREADS + tid < n) s_pay[r * MTHREADS + tid] = pv[r];
      }
      __syncthreads();
      const int e0 = tid * MPT;
      if (e0 < n) {
        int lo = max(0, e0 - cb), hi = min(e0, ca);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sort_bits(s_key[mid], p.low) <= sort_bits(s_key[ca + e0 - 1 - mid], p.low))
            lo = mid + 1;
          else
            hi = mid;
        }
        int ia = lo, ib = e0 - lo;
        uint64_t va = ia < ca ? sort_bits(s_key[ia], p.low) : 0;
        uint64_t vb = ib < cb ? sort_bits(s_key[ca + ib], p.low) : 0;
        const int e1 = min(e0 + MPT, n);
        for (int e = e0; e < e1; ++e) {
          if (ib >= cb || (ia < ca && va <= vb)) {
            s_src[e] = (uint16_t)ia;
            if (++ia < ca) va = sort_bits(s_key[ia], p.low);
          } else {
            s_src[e] = (uint16_t)(ca + ib);
            if (++ib < cb) vb = sort_bits(s_key[ca + ib], p.low);
          }
        }
      }
      __syncthreads();
      const int64_t o = (int64_t)a0 + d0;
      store_tile(dst_key + o, n, [&](int i) { return (long long)s_key[s_src[i]]; });
      if (src_pay) store_tile(dst_pay + o, n, [&](int i) { return s_pay[s_src[i]]; });
      __syncthreads();  // the next tile takes the shared memory
    }
  }
}

// The upsweep, from one read of the keys: each block counts the first
// pass's digits of CHUNK tiles in order (shared-memory atomics), writing
// each tile's counts of the tiles before it in the chunk and the chunk's
// counts, and every pass's digits of those tiles (one global atomic a block
// and bucket). SENT keys are counted apart, one ballot a warp, into the
// first pass's top digit and stats[1]; no later pass's histogram holds
// them. A key that is not SENT but whose first digit is all ones (about
// one in 2^dbits) is counted by how many of its low bits are (stats[ONES +
// i]): the later passes' tails, below.
__global__ void __launch_bounds__(SWEEP_THREADS) vsort_upsweep_kernel(SweepParams p) {
  if (merge_taken(p.stats, p.max_rounds)) return;
  extern __shared__ int s_sweep[];
  __shared__ int s_sent, s_sent_all;
  __shared__ int s_ones[64];
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
  if (tid < 64) s_ones[tid] = 0;
  auto count = [&](uint64_t k, bool valid) {
    const bool sent = ((k ^ FLIP) & p.low) == p.low;
    const unsigned m = __ballot_sync(FULL, valid && sent);
    if (lane == 0 && m) atomicAdd(&s_sent, __popc(m));
    if (valid && !sent) {
      const uint32_t d = digit_of(k, p.shift, mask);
      atomicAdd(&s_cnt[d], 1);
      if (d == mask) atomicAdd(&s_ones[__ffsll(~(long long)(k ^ FLIP)) - 1], 1);  // rare
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
      const int v = s_hist[p.hoff[q] + i] + (q == 0 && i == Rq - 1 ? s_sent_all : 0);
      if (v) atomicAdd(&p.ghist[q * RMAX + i], v);
    }
  }
  if (tid == 0 && s_sent_all) atomicAdd(&p.stats[1], s_sent_all);
  if (tid < 64 && s_ones[tid]) atomicAdd(&p.stats[ONES + tid], s_ones[tid]);
}

// Each pass's digit bases: the exclusive scan of its histogram, in place
// (one block a pass, two digits a thread). A later pass q leaves the SENT
// keys at the tail where no key that is not SENT has its q low digits all
// ones (the passes before it then put every SENT key behind every other
// key, in input order: their final places), and sorts them along with the
// rest otherwise: its tail, stats[TAILS + q], is n_sent or 0, and its top
// digit counts the SENT keys where the tail is 0.
__global__ void __launch_bounds__(RMAX / 2) vsort_bases_kernel(int32_t* ghist, int32_t* stats,
                                                              int max_rounds, int npass,
                                                              unsigned top_bits) {
  if (merge_taken(stats, max_rounds)) return;
  __shared__ int s_tmp[RMAX / 2 / 32];
  const int q = blockIdx.x;
  int32_t* h = ghist + q * RMAX;
  if (q > 0 && threadIdx.x == 0) {
    int low = 0;  // the bits of the digits before pass q
    for (int j = 0; j < q; ++j) low += (top_bits >> (4 * j)) & 15;
    int mixed = 0;  // keys not SENT whose q low digits are all ones
    for (int i = low; i < 64; ++i) mixed += stats[ONES + i];
    const int tail = mixed ? 0 : stats[1];
    stats[TAILS + q] = tail;
    h[(1 << ((top_bits >> (4 * q)) & 15)) - 1] += stats[1] - tail;
  }
  __syncthreads();
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
                                                               int dbits, const int32_t* bases,
                                                               const int32_t* stats,
                                                               int max_rounds) {
  if (merge_taken(stats, max_rounds)) return;
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
// upsweep; LOOK, a later pass over [0, P - its tail): the tiles before, by
// look-back over status words W), stages the keys in digit order, and
// writes the keys, then the payload, in digit runs.
template <bool LOOK, class W>
__global__ void __launch_bounds__(THREADS, 2) vsort_pass_kernel(PassParams p) {
  if (merge_taken(p.stats, p.max_rounds)) return;
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
  // a later pass leaves its tail of SENT keys be; it takes the next tile in
  // order (an atomic counter, so that a tile only waits on tiles whose
  // blocks already run), and a tile past the rest exits before its
  // look-back, so that no tile waits on it
  const int P = LOOK ? p.P - p.stats[TAILS + p.pass] : p.P;
  if (LOOK) {
    if (tid == 0) s_tile = atomicAdd(p.counter, 1);
    __syncthreads();
  }
  const int t = LOOK ? s_tile : blockIdx.x;
  const int t0 = t * TILE;
  if (LOOK && t0 >= P) return;
  const int n = min(TILE, P - t0);
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


// The SENT keys' final places: the last pass to sort them left them at [P
// - n_sent, P) of its output, which no later pass writes; where that is the
// scratch buffer, they (and their payload) are copied to the outputs.
__global__ void __launch_bounds__(256) vsort_tail_kernel(const int64_t* key_tmp, int64_t* key_out,
                                                         const int32_t* pay_tmp, int32_t* pay_out,
                                                         int P, int npass, const int32_t* stats,
                                                         int max_rounds) {
  if (merge_taken(stats, max_rounds)) return;
  int q = 1;  // the first pass that leaves them at the tail
  while (q < npass && stats[TAILS + q] == 0) ++q;
  // none does, or pass q - 1 wrote the outputs ((npass - 1 - (q - 1)) even)
  if (q == npass || ((npass - q) & 1) == 0) return;
  const int n = stats[TAILS + q];
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    key_out[P - n + i] = key_tmp[P - n + i];
    if (pay_out) pay_out[P - n + i] = pay_tmp[P - n + i];
  }
}

// The upsweep's dynamic shared memory: the first digit's tile and chunk
// counts and every pass's histogram (at most 6 x 2,048 at dmax 11).
constexpr int SWEEP_SMEM_MAX = (2 * RMAX + 6 * RMAX) * 4;
// The merge kernel's: the tile's keys, payload and each output's place.
constexpr int MERGE_SMEM = MTILE * (8 + 4 + 2);

}  // namespace

// key_in int64 [P], P < 2^31 (< 2^30 unless wide); key_out int64 [P];
// key_tmp int64 [P] (unused with one pass and no merge). pay_in / pay_out /
// pay_tmp: int32 [P], all nullptr for keys only (pay_tmp unused with one
// pass and no merge). 1 <= bits <= 64; 8 <= dmax <= 11, the widest digit;
// wide: 64-bit tile status words; max_rounds, 0 to 8: with a hint that the
// keys are a few sorted runs, the most merge rounds (the device merges
// where runs <= 2^max_rounds), 0 for no merge.
// scratch: int32, at least the wrapper's _value_sort_scratch; its stats
// words (the descents found, the SENT keys) start at int MAX_PASSES * RMAX
// + 32 * MAX_PASSES. Inputs are never written.
extern "C" int value_sort_launch(const void* key_in, void* key_out, void* key_tmp,
                                 const void* pay_in, void* pay_out, void* pay_tmp, int64_t P,
                                 int32_t bits, int32_t dmax, int32_t wide, int32_t max_rounds,
                                 void* scratch, int64_t scratch_ints, void* stream) {
  if (P < 0 || P >= (1ll << 31) || (!wide && P >= (1ll << 30)) || bits < 1 || bits > 64 ||
      dmax < DMIN || dmax > DMAX || max_rounds < 0 || max_rounds > MAX_ROUNDS || !key_in ||
      !key_out || (!pay_in) != (!pay_out))
    return (int)cudaErrorInvalidValue;
  const int npass = (bits + dmax - 1) / dmax;
  if ((npass > 1 || max_rounds) && (!key_tmp || (pay_in && !pay_tmp)))
    return (int)cudaErrorInvalidValue;
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
  // the scratch: the histograms, the later passes' tile counters, the stats
  // words and the status words (zeroed at once), then the first pass's
  // counts of the tiles before each tile in its chunk and each chunk's
  // counts
  int64_t status_words = 0;
  for (int q = 1; q < npass; ++q) status_words += (int64_t)n_tiles << sw.hdbits[q];
  const int64_t head = MAX_PASSES * RMAX + 32 * MAX_PASSES + STATS;
  const int64_t zeroed = head + status_words * (wide ? 2 : 1);
  const int64_t need = zeroed + ((int64_t)(n_tiles + n_chunks) << sw.hdbits[0]);
  if (scratch_ints < need) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  static bool sweep_opted[64];
  static int merge_grid[64];
  if (!sweep_opted[dev]) {
    if ((e = cudaFuncSetAttribute(vsort_upsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SWEEP_SMEM_MAX)) != cudaSuccess)
      return (int)e;
    if ((e = cudaFuncSetAttribute(vsort_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MERGE_SMEM)) != cudaSuccess)
      return (int)e;
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vsort_merge_kernel, MTHREADS,
                                                           MERGE_SMEM)) != cudaSuccess)
      return (int)e;
    merge_grid[dev] = sms * (per_sm > 0 ? per_sm : 1);
    sweep_opted[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* ghist = static_cast<int32_t*>(scratch);
  int32_t* counters = ghist + MAX_PASSES * RMAX;
  int32_t* stats = counters + 32 * MAX_PASSES;
  char* status = reinterpret_cast<char*>(static_cast<int32_t*>(scratch) + head);
  int32_t* tile_pre = static_cast<int32_t*>(scratch) + zeroed;
  int32_t* chunk = tile_pre + ((int64_t)n_tiles << sw.hdbits[0]);
  if ((e = cudaMemsetAsync(scratch, 0, zeroed * 4, st)) != cudaSuccess) return (int)e;
  if (max_rounds) {
    // the merge mode: the runs, then the rounds (those the device did not
    // choose exit at once)
    const int64_t runs_blocks = (P + 2 * RUNS_THREADS - 1) / (2 * RUNS_THREADS);
    const int runs_grid = (int)(runs_blocks < merge_grid[dev] * 2 ? runs_blocks
                                                                  : merge_grid[dev] * 2);
    vsort_runs_kernel<<<runs_grid, RUNS_THREADS, 0, st>>>(static_cast<const int64_t*>(key_in),
                                                          (int)P, sw.low, stats);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    MergeParams mp{};
    mp.key_in = static_cast<const int64_t*>(key_in);
    mp.key_out = static_cast<int64_t*>(key_out);
    mp.key_tmp = static_cast<int64_t*>(key_tmp);
    mp.pay_in = static_cast<const int32_t*>(pay_in);
    mp.pay_out = static_cast<int32_t*>(pay_out);
    mp.pay_tmp = static_cast<int32_t*>(pay_tmp);
    mp.P = (int32_t)P;
    mp.low = sw.low;
    mp.max_rounds = max_rounds;
    mp.stats = stats;
    const int64_t tiles_max = (P + MTILE - 1) / MTILE + MAX_RUNS / 2;
    const int grid = (int)(tiles_max < merge_grid[dev] ? tiles_max : merge_grid[dev]);
    for (int r = 0; r < max_rounds; ++r) {
      mp.round = r;
      vsort_merge_kernel<<<grid, MTHREADS, MERGE_SMEM, st>>>(mp);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  // the first pass's digit: each tile's and each chunk's counts, and every
  // pass's histogram, from one read of the keys; the digits' bases; the
  // chunks' places
  sw.key = static_cast<const int64_t*>(key_in);
  sw.shift = sw.hshift[0];
  sw.dbits = sw.hdbits[0];
  sw.ghist = ghist;
  sw.tile_pre = tile_pre;
  sw.chunk_sum = chunk;
  sw.stats = stats;
  sw.max_rounds = max_rounds;
  vsort_upsweep_kernel<<<n_chunks, SWEEP_THREADS, sweep_smem, st>>>(sw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  unsigned top_bits = 0;  // each pass's digit width, four bits a pass
  for (int q = 0; q < npass; ++q) top_bits |= (unsigned)sw.hdbits[q] << (4 * q);
  vsort_bases_kernel<<<npass, RMAX / 2, 0, st>>>(ghist, stats, max_rounds, npass, top_bits);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  vsort_chunk_scan_kernel<<<((1 << sw.dbits) + 31) / 32, 256, 0, st>>>(chunk, n_chunks, sw.dbits,
                                                                       ghist, stats, max_rounds);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  PassParams p{};
  p.P = (int32_t)P;
  p.tile_pre = tile_pre;
  p.chunk_base = chunk;
  p.stats = stats;
  p.max_rounds = max_rounds;
  const void* cur_key = key_in;
  const void* cur_pay = pay_in;
  for (int pass = 0; pass < npass; ++pass) {
    const bool to_out = (npass - 1 - pass) % 2 == 0;  // the last pass lands in the outputs
    p.key_in = static_cast<const int64_t*>(cur_key);
    p.key_out = static_cast<int64_t*>(to_out ? key_out : key_tmp);
    p.pay_in = static_cast<const int32_t*>(cur_pay);
    p.pay_out = pay_in ? static_cast<int32_t*>(to_out ? pay_out : pay_tmp) : nullptr;
    p.pass = pass;
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
  if (npass > 1) {
    vsort_tail_kernel<<<merge_grid[dev], 256, 0, st>>>(
        static_cast<const int64_t*>(key_tmp), static_cast<int64_t*>(key_out),
        static_cast<const int32_t*>(pay_tmp), static_cast<int32_t*>(pay_out), (int)P, npass,
        stats, max_rounds);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
