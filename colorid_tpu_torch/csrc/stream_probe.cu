// Sorted-stream probe kernel for blocked (split-lane) indexes on Hopper
// (sm_90a).
//
// Replaces colorid_tpu/ops/stream_query.py::_stream_kernel in normal mode
// (reached through _stream_call), the Pallas kernel of the JAX package's
// blocked stream.
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
// The per-probe gather/AND is a __device__ function of its own
// (probe_and), so that an entry point with other outputs can reuse it.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain
// C entry point that launches on the caller's stream and returns
// cudaGetLastError().

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
