// Classic sorted-row word gather for Hopper (sm_90a).
//
// Replaces colorid_tpu/ops/stream_query.py::_classic_word_kernel, the
// Pallas kernel of the JAX package's classic (reference-placement) stream.
//
// What it computes, per probe i of P probes sorted ascending by Bloom row
// (one u32 word per row: <= 32 colors; row = blk * 128 + off in the TPU
// kernel's terms):
//   chunk j = i / PC covers probes [PC*j, PC*j + PC); the chunk's window
//   is the NT * 128 blocks starting at block tb[j] * 128, i.e. the rows
//   [tb[j] * TILE_ROWS, (tb[j] + NT) * TILE_ROWS). A probe whose row lies
//   in its chunk's window gets the matrix word at that row, masked to its
//   low 8 * planes bits (bits >= n_colors are never set); any other probe
//   gets the constant `deoff` (the JAX kernel's byte-plane de-offset sum),
//   which the caller's residual pass overwrites. This is the TPU kernel's
//   chunk/window contract, kept exactly so that this kernel, its plain
//   PyTorch twin (ops/stream_query.py::classic_words_plain) and the JAX
//   kernel agree bit for bit.
//
// What bounds it on an H100: bytes. Each probe reads its 4-byte row and
// writes its 4-byte word, plus tb and the 32-byte sectors of the matrix
// that the in-window rows lie in (at the main path's density nearly the
// whole matrix), against 3.35 TB/s of HBM; it does no arithmetic to speak
// of.
//
// What the design does about that:
// - The sorted row itself is the probe (4 bytes, not a block and a lane
//   index of 4 bytes each): the window test is one compare on the row.
// - PC and NT are compile-time constants, so the chunk of a warp's probes
//   is a shift, with no integer division per probe.
// - A warp takes 256 consecutive probes per step: each lane loads two
//   16-byte vectors of rows (the warp's two loads are 512 contiguous bytes
//   each) and stores two vectors of words the same way. All 256 lie in one
//   chunk (PC % 256 == 0), so the warp reads tb once per step.
// - The matrix words are direct read-only loads. The probes are sorted, so
//   a warp's 256 rows fall into a few hundred contiguous words: a handful
//   of 32-byte sectors, each fetched from HBM about once. Staging the TPU
//   kernel's whole 2-tile window (128 KB per chunk) in shared memory would
//   read some six times the bytes the chunk's rows touch.
// - The row and word streams use streaming loads and stores (read or
//   written once) so that they do not evict the matrix's sectors from L1.
// - A persistent grid (as many blocks as stay resident on every SM) walks
//   the probes with a grid-stride loop.
// The TPU kernel's int8 byte planes and one-hot MXU contraction existed
// only because that device cannot index rows dynamically; here the word is
// read as it is.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain
// C entry point that launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PC = 4096;                // probes per chunk (PC_CL)
constexpr int NT = 2;                   // tiles per chunk window (NT_CL)
constexpr int64_t TILE_ROWS = 128 * 128;  // one tile: 128 blocks of 128 rows
constexpr int THREADS = 256;
constexpr int STEP = 32 * 2 * 4;        // probes per warp step: 2 int4 a lane
static_assert(PC % STEP == 0, "a warp step must lie in one chunk");

__device__ __forceinline__ int32_t word_at(const uint32_t* __restrict__ matrix,
                                           int64_t n_words, int32_t row,
                                           int64_t lo, uint32_t mask,
                                           int32_t deoff) {
  const int64_t l = (int64_t)row - lo;
  if (l >= 0 && l < NT * TILE_ROWS && row < n_words)
    return (int32_t)(__ldg(matrix + row) & mask);
  return deoff;
}

__global__ void __launch_bounds__(THREADS) classic_word_kernel(
    const uint32_t* __restrict__ matrix, int64_t n_words,
    const int4* __restrict__ rows, const int32_t* __restrict__ tb,
    int4* __restrict__ out, int64_t n_steps, uint32_t mask, int32_t deoff) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * THREADS) >> 5;
  for (int64_t s = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
       s < n_steps; s += n_warps) {
    const int64_t lo = (int64_t)__ldg(&tb[s / (PC / STEP)]) * TILE_ROWS;
    const int64_t v = s * (STEP / 4) + lane;  // this lane's first int4
    const int4 a = __ldcs(rows + v);
    const int4 b = __ldcs(rows + v + 32);
    int4 wa, wb;
    wa.x = word_at(matrix, n_words, a.x, lo, mask, deoff);
    wa.y = word_at(matrix, n_words, a.y, lo, mask, deoff);
    wa.z = word_at(matrix, n_words, a.z, lo, mask, deoff);
    wa.w = word_at(matrix, n_words, a.w, lo, mask, deoff);
    wb.x = word_at(matrix, n_words, b.x, lo, mask, deoff);
    wb.y = word_at(matrix, n_words, b.y, lo, mask, deoff);
    wb.z = word_at(matrix, n_words, b.z, lo, mask, deoff);
    wb.w = word_at(matrix, n_words, b.w, lo, mask, deoff);
    __stcs(out + v, wa);
    __stcs(out + v + 32, wb);
  }
}

}  // namespace

// rows and out must be 16-byte aligned and P a multiple of PC (the wrapper
// checks both).
extern "C" int classic_word_launch(const void* matrix, int64_t n_words,
                                   const void* rows, const void* tb, void* out,
                                   int64_t P, uint32_t word_mask, int32_t deoff,
                                   void* stream) {
  if (P <= 0) return 0;
  if (P % PC) return (int)cudaErrorInvalidValue;
  const int64_t n_steps = P / STEP;
  // a persistent grid: as many blocks as stay resident, no more than needed
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, classic_word_kernel,
                                                THREADS, 0);
  const int64_t needed = (n_steps + THREADS / 32 - 1) / (THREADS / 32);
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = needed < resident ? needed : resident;
  classic_word_kernel<<<(unsigned int)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, (const int4*)rows,
      (const int32_t*)tb, (int4*)out, n_steps, word_mask, deoff);
  return (int)cudaGetLastError();
}
