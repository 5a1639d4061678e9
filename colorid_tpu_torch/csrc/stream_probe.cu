// Sorted-stream probe kernels for blocked (split-lane) indexes on Hopper
// (sm_90a): one gather, two epilogues, as the TPU kernel is one body with a
// raw flag.
//
// Which TPU kernel each entry point replaces:
// - stream_probe_launch (stream_probe_kernel) replaces
//   colorid_tpu/ops/stream_query.py::_stream_kernel in normal mode (reached
//   through _stream_call), the probe kernel of the single-device blocked
//   stream and of each shard of the row mesh;
// - stream_probe_raw_launch (stream_probe_raw_kernel) replaces the same
//   _stream_kernel in raw mode (reached through _stream_call_raw), the local
//   pass of the color-sharded stream.
//
// What both gather, per probe i of P probes sorted ascending by block (one
// probe = one query k-mer; its H Bloom rows share the 512-byte block blk[i]
// of the [Rb, 128] u32 matrix, row h at in-block offset (off[i] >> 8h) &
// 0xFF, each row W = wpad words wide), for qc[i] > 0:
//   and_w[w] = AND over h of matrix[blk, off_h * W + w]
//   nhits    = popcount of and_w over all 32 * W bits
//   colorsum = the sum of the indices of and_w's set bits (the color itself
//              where nhits == 1)
//   presmask = bit h set iff row h has a nonzero word
//   counts[c] += 1 for every set bit c of and_w
// A probe with qc[i] == 0 (padding, or a probe the caller keeps for its
// residual pass) reads nothing and counts nothing. A block outside the
// matrix, or a row that would leave its block, reads as an all-zero row.
//
// Normal mode folds the facts (the color count of the single-device or
// row-sharded matrix is the whole index's, so presence and uniqueness are
// decided here):
//   uniq[i] = colorsum when present (presmask == 2^H - 1) and nhits == 1;
//             -1 when present otherwise; -2 when absent or qc[i] == 0
//   hist[color * hw + qc[i]] += 1 for a unique hit with qc[i] < hw
// counts [32 * W] and hist [cp, hw] are ADDED INTO. The plain PyTorch twin
// is ops/stream_query.py::stream_probe_plain.
//
// Raw mode: the matrix is ONE color shard's slice of every row, so
// uniqueness and presence span the shards and are decided by the caller
// (parallel/sharded.py::stream_batch_colorshard); nhits, colorsum and
// presmask come out per probe (three zeros where qc[i] == 0), and counts is
// added into. Its twin is ops/stream_query.py::stream_probe_raw_plain. Both
// twins agree bit for bit with the JAX kernel's outputs.
//
// What bounds them on an H100: bytes (chip_smoke.py::probe_bytes): 12 bytes
// of probe streams in per probe, 4 bytes out (normal: uniq) or 12 (raw:
// three facts), the accumulators in and out, and the 32-byte sectors of the
// rows that the counted probes read (a row of W <= 8 words lies in one
// sector, a wider one covers W / 8), against 3.35 TB/s.
//
// The gather (gather_step, shared by both kernels):
// - Lane groups. G = W / 8 lanes serve one probe (one lane for W <= 8):
//   each lane loads its 8 words of a row as two 16-byte vectors (W <= 4:
//   the whole row in one load of 4, 8 or 16 bytes), and a vector load of
//   the group covers 4 * G contiguous words, so at W = 32 one warp
//   instruction moves 8 rows x 64 bytes in whole sectors.
// - The probe streams are read one probe per lane, coalesced; each group
//   takes its probe from them by shuffle, in G rounds of 32 / G probes, and
//   the facts go back by shuffle to the probe's own lane, so the outputs
//   are stored coalesced too.
// - nhits is a popcount per lane; colorsum is summed in the loop over the
//   set bits that feeds the shared counts. Both ride in one int32 (nhits
//   <= 1,024 in the low 11 bits, colorsum <= 523,776 above), so the group
//   sums them with one chain of xor shuffles; presmask is the group's OR.
// - Per-color counts take one shared-memory atomic per set bit; the grid
//   is persistent (as many blocks as stay resident) with a grid-stride
//   loop, so each block flushes its shared counts once.
//
// What held the first normal-mode kernel back, and what this one does
// about it. It ran one thread per probe on a grid of P / 256 blocks
// (32,768 on the main path), and (1) sent every warp's unique hits to the
// global histogram, one atomic per distinct (color, frequency) cell of the
// warp: on a real query nearly every k-mer is a unique hit on one of a few
// source colors with a small frequency, so some 262,000 warps hammered a
// few dozen histogram words in three cache lines, and same-line atomics
// serialize in one L2 slice; (2) zeroed and flushed its shared counts in
// every one of those blocks, up to 32 more global atomics each onto one
// line. At the main path's shape (8,388,608 probes, W 1, H 4) it took 0.39
// ms on an H100 80GB HBM3 where the raw kernel, the same gather with three
// times the bytes out, took 0.14. Now the gather is the raw kernel's, on its
// persistent grid, and
// each block keeps a band of the histogram in shared memory: the cells of
// frequency q < hf (hf a power of two <= hw, chosen by the wrapper so that
// cp * hf int32 stay within a small per-block budget:
// ops/stream_query.py::_hist_band). A unique hit with q < hf takes one
// shared atomic; one with hf <= q < hw is merged across its warp
// (__match_any_sync) and takes one global atomic per distinct cell, as
// before (such cells are cold); q >= hw adds nothing (the caller's overflow
// list). Which of the two a hit takes depends on q alone, so no hit is
// counted twice. At the end each block flushes only its nonzero band cells:
// at most (resident blocks) x (nonzero cells) global atomics per launch.
// Integer atomics give the same sums in any order: run to run identical.
//
// The tile window of the TPU kernel is not carried over: any block can be
// read, and the caller zeroes qc outside the window. The TPU kernel's byte
// planes, one-hot MXU row select, lane-gather AND trees and one-hot
// histogram contraction exist because that device cannot index rows
// dynamically and has no atomics; none of them is needed here.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain
// C entry point per kernel that launches on the caller's stream and returns
// cudaGetLastError(). Both take a 16-byte aligned matrix and P % 32 == 0
// (the wrappers check both; P is a multiple of PC = 2048).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANE_WORDS = 8;  // words of a row per lane (rows of >= 8 words)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t BAND_BYTES_MAX = 48 * 1024;  // dynamic shared memory, no opt-in

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

// One warp step of the gather: lane l holds probe t + l's stream values;
// returns that probe's facts ((colorsum << 11) | nhits) and presmask, and
// adds its set bits into the shared counts. All 32 lanes must call it.
template <int W, int H>
__device__ __forceinline__ void gather_step(
    const uint32_t* __restrict__ matrix, int64_t n_words, int32_t my_blk,
    int32_t my_off, int32_t my_qc, int32_t* s_counts, int32_t& facts_out,
    int32_t& pres_out) {
  constexpr int VEC = W < 4 ? W : 4;                   // words per vector load
  constexpr int LW = W < LANE_WORDS ? W : LANE_WORDS;  // words per lane
  constexpr int NV = LW / VEC;  // vector loads per row and lane
  constexpr int G = W / LW;     // lanes per probe
  constexpr int NG = 32 / G;    // probes per round of a warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;  // the lane's group within the warp
  const int sub = lane % G;  // the lane's place within its group
  facts_out = 0;
  pres_out = 0;
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
      // lane l keeps probe t + l's facts: group l % NG served it in round
      // l / NG
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
}

template <int W>
__device__ __forceinline__ void flush_counts(const int32_t* s_counts,
                                             int32_t* __restrict__ counts) {
  for (int c = threadIdx.x; c < 32 * W; c += THREADS) {
    const int32_t v = s_counts[c];
    if (v) atomicAdd(&counts[c], v);
  }
}

// The grid-stride loop over warp steps: P % 32 == 0, so every lane of a warp
// takes the same trip count and the warp stays converged for the shuffles.
#define FOR_EACH_WARP_STEP(t, P)                                              \
  for (int64_t t = (((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5) * 32; \
       t < (P); t += (((int64_t)gridDim.x * THREADS) >> 5) * 32)

template <int W, int H>
__global__ void __launch_bounds__(THREADS) stream_probe_kernel(
    const uint32_t* __restrict__ matrix, int64_t n_words,
    const int32_t* __restrict__ blk, const int32_t* __restrict__ off,
    const int32_t* __restrict__ qc, int32_t* __restrict__ uniq,
    int32_t* __restrict__ counts, int32_t* __restrict__ hist, int64_t P,
    int32_t cp, int32_t hw, int32_t hf) {
  __shared__ int32_t s_counts[32 * W];
  extern __shared__ int32_t s_band[];  // [cp, hf]: hist's cells of q < hf
  for (int c = threadIdx.x; c < 32 * W; c += THREADS) s_counts[c] = 0;
  for (int c = threadIdx.x; c < cp * hf; c += THREADS) s_band[c] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  FOR_EACH_WARP_STEP(t, P) {
    const int32_t q = qc[t + lane];
    int32_t facts, pres;
    gather_step<W, H>(matrix, n_words, blk[t + lane], off[t + lane], q,
                      s_counts, facts, pres);
    // pres is 0 for a probe that does not count (qc == 0, or its block
    // outside the matrix), so such a probe is absent: -2
    int32_t u = -2;
    int32_t cold = -1;  // a global cell hf <= q < hw of a unique hit
    if (pres == (1 << H) - 1) {
      u = -1;
      if ((facts & 2047) == 1) {
        u = facts >> 11;  // the color (< 32 * W <= cp)
        if (q < hf)
          atomicAdd(&s_band[u * hf + q], 1);
        else if (q < hw)
          cold = u * hw + q;
      }
    }
    uniq[t + lane] = u;
    // one global atomic per distinct cold cell of the warp; the ballot and
    // the match run with the whole warp converged (same trip count)
    const unsigned hitters = __ballot_sync(FULL, cold >= 0);
    if (cold >= 0) {
      const unsigned peers = __match_any_sync(hitters, cold);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[cold], __popc(peers));
    }
  }

  __syncthreads();
  flush_counts<W>(s_counts, counts);
  for (int c = threadIdx.x; c < cp * hf; c += THREADS) {
    const int32_t v = s_band[c];
    if (v) atomicAdd(&hist[(c / hf) * hw + c % hf], v);
  }
}

template <int W, int H>
__global__ void __launch_bounds__(THREADS) stream_probe_raw_kernel(
    const uint32_t* __restrict__ matrix, int64_t n_words,
    const int32_t* __restrict__ blk, const int32_t* __restrict__ off,
    const int32_t* __restrict__ qc, int32_t* __restrict__ nhits,
    int32_t* __restrict__ colorsum, int32_t* __restrict__ presmask,
    int32_t* __restrict__ counts, int64_t P) {
  __shared__ int32_t s_counts[32 * W];
  for (int c = threadIdx.x; c < 32 * W; c += THREADS) s_counts[c] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  FOR_EACH_WARP_STEP(t, P) {
    int32_t facts, pres;
    gather_step<W, H>(matrix, n_words, blk[t + lane], off[t + lane],
                      qc[t + lane], s_counts, facts, pres);
    nhits[t + lane] = facts & 2047;
    colorsum[t + lane] = facts >> 11;
    presmask[t + lane] = pres;
  }

  __syncthreads();
  flush_counts<W>(s_counts, counts);
}

#undef FOR_EACH_WARP_STEP

// a persistent grid: as many blocks as stay resident, no more than needed
template <typename Kernel>
unsigned int persistent_blocks(Kernel kernel, size_t smem, int64_t P) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const int64_t needed = (P + THREADS - 1) / THREADS;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned int)(needed < resident ? needed : resident);
}

struct Probes {
  const void *matrix, *blk, *off, *qc;
  int64_t n_words, P;
  cudaStream_t stream;
};

struct FoldLaunch {
  Probes p;
  void *uniq, *counts, *hist;
  int32_t cp, hw, hf;
  template <int W, int H>
  int run() const {
    const size_t smem = (size_t)cp * hf * sizeof(int32_t);
    if (cp < 32 * W || smem > BAND_BYTES_MAX) return (int)cudaErrorInvalidValue;
    const unsigned int blocks =
        persistent_blocks(stream_probe_kernel<W, H>, smem, p.P);
    stream_probe_kernel<W, H><<<blocks, THREADS, smem, p.stream>>>(
        (const uint32_t*)p.matrix, p.n_words, (const int32_t*)p.blk,
        (const int32_t*)p.off, (const int32_t*)p.qc, (int32_t*)uniq,
        (int32_t*)counts, (int32_t*)hist, p.P, cp, hw, hf);
    return (int)cudaGetLastError();
  }
};

struct RawLaunch {
  Probes p;
  void *nhits, *colorsum, *presmask, *counts;
  template <int W, int H>
  int run() const {
    const unsigned int blocks =
        persistent_blocks(stream_probe_raw_kernel<W, H>, 0, p.P);
    stream_probe_raw_kernel<W, H><<<blocks, THREADS, 0, p.stream>>>(
        (const uint32_t*)p.matrix, p.n_words, (const int32_t*)p.blk,
        (const int32_t*)p.off, (const int32_t*)p.qc, (int32_t*)nhits,
        (int32_t*)colorsum, (int32_t*)presmask, (int32_t*)counts, p.P);
    return (int)cudaGetLastError();
  }
};

template <int W, class Launch>
int by_hashes(const Launch& f, int32_t num_hash) {
  switch (num_hash) {
    case 1:
      return f.template run<W, 1>();
    case 2:
      return f.template run<W, 2>();
    case 4:
      return f.template run<W, 4>();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the instance for (wpad, num_hash), after the checks both entry points share
template <class Launch>
int dispatch(const Launch& f, int32_t wpad, int32_t num_hash) {
  const Probes& p = f.p;
  if (p.P <= 0) return 0;
  if (p.P % 32 || ((uintptr_t)p.matrix & 15u)) return (int)cudaErrorInvalidValue;
  switch (wpad) {
    case 1:
      return by_hashes<1>(f, num_hash);
    case 2:
      return by_hashes<2>(f, num_hash);
    case 4:
      return by_hashes<4>(f, num_hash);
    case 8:
      return by_hashes<8>(f, num_hash);
    case 16:
      return by_hashes<16>(f, num_hash);
    case 32:
      return by_hashes<32>(f, num_hash);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// hf: the histogram band kept in shared memory (a power of two <= hw, cp *
// hf * 4 bytes <= 48 KB; the wrapper picks it)
extern "C" int stream_probe_launch(
    const void* matrix, int64_t n_words, const void* blk, const void* off,
    const void* qc, void* uniq, void* counts, void* hist, int64_t P,
    int32_t num_hash, int32_t wpad, int32_t cp, int32_t hw, int32_t hf,
    void* stream) {
  if (hf < 1 || hf > hw || (hf & (hf - 1))) return (int)cudaErrorInvalidValue;
  const FoldLaunch f{{matrix, blk, off, qc, n_words, P, (cudaStream_t)stream},
                     uniq, counts, hist, cp, hw, hf};
  return dispatch(f, wpad, num_hash);
}

extern "C" int stream_probe_raw_launch(
    const void* matrix, int64_t n_words, const void* blk, const void* off,
    const void* qc, void* nhits, void* colorsum, void* presmask, void* counts,
    int64_t P, int32_t num_hash, int32_t wpad, void* stream) {
  const RawLaunch f{{matrix, blk, off, qc, n_words, P, (cudaStream_t)stream},
                    nhits, colorsum, presmask, counts};
  return dispatch(f, wpad, num_hash);
}
