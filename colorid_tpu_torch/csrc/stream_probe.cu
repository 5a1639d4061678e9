// Sorted-stream probe kernels for blocked (split-lane) indexes on Hopper
// (sm_90a): the folding kernel of the single-device stream and the raw
// kernel of the color-sharded stream (second half of this file).
//
// stream_probe_kernel replaces
// colorid_tpu/ops/stream_query.py::_stream_kernel in normal mode (reached
// through _stream_call), the Pallas kernel of the JAX package's blocked
// stream.
//
// What it computes, per probe i of P probes sorted ascending by block
// (one probe = one query k-mer; its H Bloom rows share the 512-byte block
// blk[i] of the [Rb, 128] u32 matrix, row h at in-block offset
// (off[i] >> 8h) & 0xFF, each row W = wpad words wide):
//   and_w[w] = AND over h of matrix[blk, off_h * W + w]
//   present  = every row h has some nonzero word
//   nhits    = popcount of and_w over all 32 * W bits
//   uniq[i]  = the one set bit's index (the color) when qc[i] > 0, present
//              and nhits == 1; -1 when qc[i] > 0 and present otherwise;
//              -2 when qc[i] == 0 (padding, or a probe the caller keeps
//              for its residual pass) or some row is absent
//   counts[c] += 1 for every set bit c of and_w, when qc[i] > 0
//   hist[color * hw + qc[i]] += 1 for a unique hit with qc[i] < hw
// counts [32 * W] and hist [cp, hw] are ADDED INTO. The plain PyTorch twin
// (ops/stream_query.py::stream_probe_plain) has the same contract, and both
// agree bit for bit with the JAX kernel's uniq / counts / hist outputs.
//
// What bounds it on an H100: bytes. Each probe reads 12 bytes and writes 4,
// plus the 32-byte sectors of the blocks the probes touch (at most the
// whole matrix once), against 3.35 TB/s of HBM; per probe it does a few
// ANDs, one popcount per word and a handful of integer atomics.
//
// What the design does about that: one thread per probe with direct global
// loads. The TPU kernel's int8 byte planes, its one-hot MXU row select, the
// lane-gather AND trees and the one-hot histogram contraction exist only
// because that device cannot index rows dynamically and has no atomics;
// here the H rows are read as they are, __popc/__ffs give nhits and the
// color, and the two small accumulators take integer atomics (exact, and
// identical from run to run). Probes arrive sorted by block, so a warp's
// loads fall into few blocks. Per-color counts go through a shared-memory
// copy that is flushed with one global atomic per color and thread block;
// histogram hits are merged across the warp first (__match_any_sync), since
// a dense query sends most of its probes to a few (color, frequency) cells.
// The tile window of the TPU kernel is not carried over: any block can be
// read, and the result does not depend on it.
//
// The folding kernel's per-probe gather/AND is a __device__ function of
// its own (probe_and); the raw kernel has its own lane-group gather.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain
// C entry point per kernel that launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

// and_w[0..W) = AND over the H rows' words; returns the presence mask (bit
// h set iff row h has a nonzero word). A block index outside the matrix
// reads as all-zero rows.
template <int W>
__device__ __forceinline__ uint32_t probe_and(
    const uint32_t* __restrict__ matrix, int64_t n_words, int64_t blk,
    uint32_t off, int H, uint32_t (&and_w)[W]) {
#pragma unroll
  for (int w = 0; w < W; w++) and_w[w] = 0xFFFFFFFFu;
  const int64_t base = blk * 128;
  if (blk < 0 || base + 128 > n_words) {
#pragma unroll
    for (int w = 0; w < W; w++) and_w[w] = 0u;
    return 0u;
  }
  uint32_t pres = 0u;
  for (int h = 0; h < H; h++) {
    const uint32_t o = (off >> (8 * h)) & 0xFFu;
    uint32_t any = 0u;
    if (o * W + W <= 128u) {
      const uint32_t* row = matrix + base + o * W;
#pragma unroll
      for (int w = 0; w < W; w++) {
        const uint32_t v = __ldg(row + w);
        any |= v;
        and_w[w] &= v;
      }
    } else {
#pragma unroll
      for (int w = 0; w < W; w++) and_w[w] = 0u;
    }
    pres |= (any != 0u ? 1u : 0u) << h;
  }
  return pres;
}

template <int W>
__global__ void stream_probe_kernel(
    const uint32_t* __restrict__ matrix, int64_t n_words,
    const int32_t* __restrict__ blk, const int32_t* __restrict__ off,
    const int32_t* __restrict__ qc, int32_t* __restrict__ uniq,
    int32_t* __restrict__ counts, int32_t* __restrict__ hist, int64_t P,
    int32_t H, int32_t cp, int32_t hw) {
  __shared__ int32_t s_counts[32 * W];
  for (int c = threadIdx.x; c < 32 * W; c += blockDim.x) s_counts[c] = 0;
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t hidx = -1;  // histogram cell of a unique hit, else none
  if (i < P) {
    const int32_t q = qc[i];
    int32_t u = -2;
    if (q > 0) {
      uint32_t and_w[W];
      const uint32_t pres =
          probe_and<W>(matrix, n_words, blk[i], (uint32_t)off[i], H, and_w);
      int nhits = 0;
      int color = 0;
#pragma unroll
      for (int w = 0; w < W; w++) {
        uint32_t v = and_w[w];
        if (v) {
          nhits += __popc(v);
          color = 32 * w + __ffs(v) - 1;
          while (v) {
            const int b = __ffs(v) - 1;
            atomicAdd(&s_counts[32 * w + b], 1);
            v &= v - 1;
          }
        }
      }
      if (pres == (1u << H) - 1u) {
        u = -1;
        if (nhits == 1) {
          u = color;
          if (q < hw && color < cp) hidx = (int64_t)color * hw + q;
        }
      }
    }
    uniq[i] = u;
  }

  // one global atomic per distinct histogram cell in the warp
  const unsigned hitters = __ballot_sync(0xFFFFFFFFu, hidx >= 0);
  if (hidx >= 0) {
    const unsigned peers = __match_any_sync(hitters, hidx);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[hidx], __popc(peers));
  }

  __syncthreads();
  for (int c = threadIdx.x; c < 32 * W; c += blockDim.x) {
    const int32_t v = s_counts[c];
    if (v) atomicAdd(&counts[c], v);
  }
}

template <int W>
static int launch(const void* matrix, int64_t n_words, const void* blk,
                  const void* off, const void* qc, void* uniq, void* counts,
                  void* hist, int64_t P, int32_t H, int32_t cp, int32_t hw,
                  void* stream) {
  const int threads = 256;
  const int64_t blocks = (P + threads - 1) / threads;
  stream_probe_kernel<W><<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, (const int32_t*)blk,
      (const int32_t*)off, (const int32_t*)qc, (int32_t*)uniq,
      (int32_t*)counts, (int32_t*)hist, P, H, cp, hw);
  return (int)cudaGetLastError();
}

extern "C" int stream_probe_launch(
    const void* matrix, int64_t n_words, const void* blk, const void* off,
    const void* qc, void* uniq, void* counts, void* hist, int64_t P,
    int32_t num_hash, int32_t wpad, int32_t cp, int32_t hw, void* stream) {
  if (P <= 0) return 0;
  if (num_hash < 1 || num_hash > 4) return (int)cudaErrorInvalidValue;
#define COLORID_STREAM_CASE(W)                                              \
  case W:                                                                   \
    return launch<W>(matrix, n_words, blk, off, qc, uniq, counts, hist, P,  \
                     num_hash, cp, hw, stream)
  switch (wpad) {
    COLORID_STREAM_CASE(1);
    COLORID_STREAM_CASE(2);
    COLORID_STREAM_CASE(4);
    COLORID_STREAM_CASE(8);
    COLORID_STREAM_CASE(16);
    COLORID_STREAM_CASE(32);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef COLORID_STREAM_CASE
}

// --- raw mode ----------------------------------------------------------------
//
// stream_probe_raw_kernel replaces
// colorid_tpu/ops/stream_query.py::_stream_kernel in raw mode (raw=True,
// reached through _stream_call_raw), the local pass of the color-sharded
// stream: the matrix is ONE color shard's slice of every row (32 * W
// colors), so uniqueness and presence cannot be decided here. Per probe the
// facts come OUT instead of being folded, and the caller merges them across
// the color shards (parallel/sharded.py::stream_batch_colorshard):
//   nhits[i]    = popcount of and_w over the shard's 32 * W bits
//   colorsum[i] = sum of the indices of and_w's set bits (shard-local; the
//                 color itself where nhits == 1)
//   presmask[i] = bit h set iff hash row h has a nonzero word in this shard
//   counts[c]  += 1 for every set bit c of and_w
// all for qc[i] > 0; a probe with qc[i] == 0 (padding, or left to the
// caller's residual pass) writes three zeros and counts nothing. A block
// outside the matrix, or a row that would leave its block, reads as an
// all-zero row. A row that is absent here ANDs to zero and so masks
// itself; it may be present in another shard. counts [32 * W] is ADDED
// INTO. The plain PyTorch twin is ops/stream_query.py::stream_probe_raw_plain;
// both agree bit for bit with the JAX kernel's four outputs.
//
// What bounds it on an H100: bytes: 12 bytes in and 12 out per probe plus
// the 32-byte sectors of the rows the counted probes touch (a W = 32 row is
// four sectors, and the color-sharded path touches nearly every row),
// against 3.35 TB/s.
//
// What the design does about that:
// - Lane groups. G = W / 8 lanes serve one probe (one lane for W <= 8):
//   each lane loads its 8 words of a row as two 16-byte vectors (W <= 4:
//   the whole row in one load of 4, 8 or 16 bytes), and a vector load of
//   the group covers 4 * G contiguous words, so at W = 32 one warp
//   instruction moves 8 rows x 64 bytes in whole sectors; a lane holds 8
//   and-words, not 32. Groups of 4 words a lane coalesce as well but spend
//   twice the rounds, shuffles and reductions per probe, and the kernel
//   runs close to the rate at which the SMs dispatch instructions.
// - The probe streams are read one probe per lane, coalesced; each group
//   takes its probe from them by shuffle, in G rounds of 32 / G probes, and
//   the facts go back by shuffle to the probe's own lane, so the three
//   outputs are stored coalesced too. With one lane per probe there is no
//   shuffle at all.
// - nhits is a popcount per lane; colorsum is summed in the loop over the
//   set bits that feeds the shared counts (one add per set bit: the
//   popcount identity sum = 32w * popc(v) + sum_k 2^k * popc(v & M_k) costs
//   some 17 instructions per word whether or not a bit is set, where most
//   probes have one set bit or none). Both ride in one int32 (nhits
//   <= 1,024 in the low 11 bits, colorsum <= 523,776 above), so the group
//   sums them with one chain of xor shuffles; presmask is the group's OR
//   of its lanes' "nonzero part of row h" bits.
// - Per-color counts take one shared-memory atomic per set bit; the grid
//   is persistent (as many blocks as stay resident on every SM) with a
//   grid-stride loop, so each block flushes its shared counts to the global
//   ones once: at most (resident blocks) * 32 * W global atomics in all.
// - W and H are template parameters: the H row loads of a lane go out
//   together, and the loops unroll.
// The tile window of the TPU kernel is not carried over: any block can be
// read, and the caller zeroes qc outside the window.

namespace {

constexpr int RAW_THREADS = 256;
constexpr int LANE_WORDS = 8;  // words of a row per lane (rows of >= 8 words)

// VEC consecutive words (16-, 8- or 4-byte aligned) into v[0..VEC)
template <int VEC>
__device__ __forceinline__ void load_vec(const uint32_t* __restrict__ p,
                                         uint32_t* v) {
  if constexpr (VEC == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (VEC == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W, int H>
__global__ void __launch_bounds__(RAW_THREADS) stream_probe_raw_kernel(
    const uint32_t* __restrict__ matrix, int64_t n_words,
    const int32_t* __restrict__ blk, const int32_t* __restrict__ off,
    const int32_t* __restrict__ qc, int32_t* __restrict__ nhits,
    int32_t* __restrict__ colorsum, int32_t* __restrict__ presmask,
    int32_t* __restrict__ counts, int64_t P) {
  constexpr int VEC = W < 4 ? W : 4;  // words per vector load
  constexpr int LW = W < LANE_WORDS ? W : LANE_WORDS;  // words per lane
  constexpr int NV = LW / VEC;        // vector loads per row and lane
  constexpr int G = W / LW;           // lanes per probe
  constexpr int NG = 32 / G;          // probes per round of a warp
  constexpr unsigned FULL = 0xFFFFFFFFu;
  __shared__ int32_t s_counts[32 * W];
  for (int c = threadIdx.x; c < 32 * W; c += RAW_THREADS) s_counts[c] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / G;  // the lane's group within the warp
  const int sub = lane % G;  // the lane's place within its group
  const int64_t n_warps = ((int64_t)gridDim.x * RAW_THREADS) >> 5;
  // P % 32 == 0: every lane of a warp takes the same trip count
  for (int64_t t = (((int64_t)blockIdx.x * RAW_THREADS + threadIdx.x) >> 5) * 32;
       t < P; t += n_warps * 32) {
    const int32_t my_blk = blk[t + lane];
    const int32_t my_off = off[t + lane];
    const int32_t my_qc = qc[t + lane];
    int32_t facts_out = 0, pres_out = 0;
#pragma unroll
    for (int r = 0; r < G; r++) {
      int32_t b32 = my_blk, o32 = my_off, q = my_qc;
      if constexpr (G > 1) {  // the probe this group serves in round r
        const int src = r * NG + grp;
        b32 = __shfl_sync(FULL, my_blk, src);
        o32 = __shfl_sync(FULL, my_off, src);
        q = __shfl_sync(FULL, my_qc, src);
      }
      const int64_t b = b32;
      const bool live = q > 0 && b >= 0 && b * 128 + 128 <= n_words;
      // lane word j * VEC + e is row word j * G * VEC + sub * VEC + e
      uint32_t aw[LW];
      int32_t pres = 0;  // bit h: this lane's part of row h is nonzero
#pragma unroll
      for (int h = 0; h < H; h++) {
        const uint32_t o = ((uint32_t)o32 >> (8 * h)) & 0xFFu;
        uint32_t v[LW];
        if (live && o * W + W <= 128u) {
          const uint32_t* row = matrix + b * 128 + o * W + sub * VEC;
#pragma unroll
          for (int j = 0; j < NV; j++) load_vec<VEC>(row + j * G * VEC, v + j * VEC);
        } else {
#pragma unroll
          for (int k = 0; k < LW; k++) v[k] = 0u;
        }
        uint32_t any = 0u;
#pragma unroll
        for (int k = 0; k < LW; k++) {
          any |= v[k];
          aw[k] = h ? aw[k] & v[k] : v[k];
        }
        pres |= (any != 0u ? 1 : 0) << h;
      }
      int nh = 0, cs = 0;
#pragma unroll
      for (int k = 0; k < LW; k++) {
        nh += __popc(aw[k]);
        const int c0 = 32 * ((k / VEC) * G * VEC + sub * VEC + k % VEC);
        for (uint32_t v = aw[k]; v; v &= v - 1) {
          const int c = c0 + __ffs(v) - 1;
          cs += c;
          atomicAdd(&s_counts[c], 1);
        }
      }
      int32_t facts = (cs << 11) | nh;
      if constexpr (G > 1) {
#pragma unroll
        for (int d = G / 2; d > 0; d >>= 1) {
          facts += __shfl_xor_sync(FULL, facts, d);
          pres |= __shfl_xor_sync(FULL, pres, d);
        }
        // lane l keeps probe t + l's facts: group l % NG served it in
        // round l / NG
        const int from = (lane % NG) * G;
        const int32_t f = __shfl_sync(FULL, facts, from);
        const int32_t p = __shfl_sync(FULL, pres, from);
        if (lane / NG == r) {
          facts_out = f;
          pres_out = p;
        }
      } else {
        facts_out = facts;
        pres_out = pres;
      }
    }
    nhits[t + lane] = facts_out & 2047;
    colorsum[t + lane] = facts_out >> 11;
    presmask[t + lane] = pres_out;
  }

  __syncthreads();
  for (int c = threadIdx.x; c < 32 * W; c += RAW_THREADS) {
    const int32_t v = s_counts[c];
    if (v) atomicAdd(&counts[c], v);
  }
}

template <int W, int H>
int launch_raw(const void* matrix, int64_t n_words, const void* blk,
               const void* off, const void* qc, void* nhits, void* colorsum,
               void* presmask, void* counts, int64_t P, void* stream) {
  // a persistent grid: as many blocks as stay resident, no more than needed
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_probe_raw_kernel<W, H>, RAW_THREADS, 0);
  const int64_t needed = (P + RAW_THREADS - 1) / RAW_THREADS;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = needed < resident ? needed : resident;
  stream_probe_raw_kernel<W, H><<<(unsigned int)blocks, RAW_THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, (const int32_t*)blk,
      (const int32_t*)off, (const int32_t*)qc, (int32_t*)nhits,
      (int32_t*)colorsum, (int32_t*)presmask, (int32_t*)counts, P);
  return (int)cudaGetLastError();
}

template <int W>
int launch_raw_h(const void* matrix, int64_t n_words, const void* blk,
                 const void* off, const void* qc, void* nhits, void* colorsum,
                 void* presmask, void* counts, int64_t P, int32_t H,
                 void* stream) {
  switch (H) {
    case 1:
      return launch_raw<W, 1>(matrix, n_words, blk, off, qc, nhits, colorsum,
                              presmask, counts, P, stream);
    case 2:
      return launch_raw<W, 2>(matrix, n_words, blk, off, qc, nhits, colorsum,
                              presmask, counts, P, stream);
    case 4:
      return launch_raw<W, 4>(matrix, n_words, blk, off, qc, nhits, colorsum,
                              presmask, counts, P, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// matrix must be 16-byte aligned and P a multiple of 32 (the wrapper
// checks both, with P a multiple of PC = 2048).
extern "C" int stream_probe_raw_launch(
    const void* matrix, int64_t n_words, const void* blk, const void* off,
    const void* qc, void* nhits, void* colorsum, void* presmask, void* counts,
    int64_t P, int32_t num_hash, int32_t wpad, void* stream) {
  if (P <= 0) return 0;
  if (P % 32 || ((uintptr_t)matrix & 15u)) return (int)cudaErrorInvalidValue;
#define COLORID_STREAM_RAW_CASE(W)                                          \
  case W:                                                                   \
    return launch_raw_h<W>(matrix, n_words, blk, off, qc, nhits, colorsum,  \
                           presmask, counts, P, num_hash, stream)
  switch (wpad) {
    COLORID_STREAM_RAW_CASE(1);
    COLORID_STREAM_RAW_CASE(2);
    COLORID_STREAM_RAW_CASE(4);
    COLORID_STREAM_RAW_CASE(8);
    COLORID_STREAM_RAW_CASE(16);
    COLORID_STREAM_RAW_CASE(32);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef COLORID_STREAM_RAW_CASE
}
