// Canonical k-mer window keys of 2-bit packed reads on Hopper (sm_90a).
//
// Replaces code that the JAX package leaves to XLA, which fuses it into one
// loop on the TPU: the window extraction of colorid_tpu/ops/extract.py
// (_unpack_codes, _window_limbs, _window_valid_ok and the sort-key
// construction in extract_count). Its plain PyTorch twin is
// colorid_tpu_torch/ops/extract.py::_window_keys, which unpacks every base
// and adds k shifted code planes, four int64 limbs each, one launch per
// limb operation on the card; the two agree bit for bit.
//
// What it computes, per read r of R and window position p of NW = L - k + 1:
//   f  = the 2k-bit forward value of bases p .. p + k - 1 (base p most
//        significant; the read's words hold base j of word w at bits
//        2 * (15 - j), first base in the most significant pair)
//   rc = the reverse complement's value: sum_j (3 - code[p + j]) << 2j
//   key[r, p] = min(f, rc) ^ 2^63 (the int64 whose signed order is the
//        unsigned order of the canonical value: extract.py::_sort_key)
// or SENT_KEY (2^63 - 1) where the window does not fit the read's true
// length lens[r], p is off the stride d, or (with a validity bitplane,
// bit s of word w = base 32 * w + s, least significant first) a base of
// the window is invalid.
//
// What bounds it on an H100: bytes. Each window writes its 8-byte key
// (52 M windows on the main path: 416 MB) against 3.35 TB/s; the read words
// and the bitplane are 1/32 and 1/64 of that. The arithmetic is some tens
// of instructions a window (chip_smoke.py counts them from the SASS).
//
// What the design does about that:
// - One warp per read (a grid-stride loop over reads), one lane per window:
//   a warp's 32 keys are one 256-byte store.
// - A window spans at most three consecutive words: the lane loads them
//   (the warp's loads of one read hit the same few L1 lines), lines them up
//   as a 96-bit string and shifts out the 2k bits it needs. No base is
//   unpacked and nothing is staged in shared memory.
// - The reverse complement is the bitwise NOT of f with its 2-bit fields
//   reversed (bit reverse, then swap the bits of each pair), shifted down
//   by 64 - 2k.
// - The validity test takes the k bits of the bitplane at p from two
//   words: one compare against 2^k - 1.
// - Whether there is a bitplane and whether d > 1 are template parameters,
//   so the loop body is straight code.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t SENT_KEY = 0x7FFFFFFFFFFFFFFFll;

struct Params {
  const uint32_t* words;  // [R, Lw]
  const int32_t* lens;    // [R]
  const uint32_t* vbits;  // [R, Lv] or nullptr
  int64_t* out;           // [R, NW]
  int64_t R;
  int Lw, Lv, NW, k, d;
};

__device__ __forceinline__ uint64_t rev_fields(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

template <bool VALID, bool STRIDE>
__global__ void __launch_bounds__(THREADS) window_keys_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * THREADS) >> 5;
  const int down = 64 - 2 * p.k;
  const uint64_t kbits = (1ull << p.k) - 1;  // k <= 32
#pragma unroll 1
  for (int64_t r = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5; r < p.R;
       r += n_warps) {
    const uint32_t* w = p.words + r * p.Lw;
    const int len = __ldg(p.lens + r);
    int64_t* o = p.out + r * p.NW;
#pragma unroll 1
    for (int q = lane; q < p.NW; q += 32) {
      const int j = q >> 4;
      const int s2 = 2 * (q & 15);
      const uint32_t a = __ldg(w + j);
      const uint32_t b = j + 1 < p.Lw ? __ldg(w + j + 1) : 0u;
      const uint32_t c = j + 2 < p.Lw ? __ldg(w + j + 2) : 0u;
      const uint64_t hi = ((uint64_t)a << 32) | b;
      // the 64 bits of the string from bit s2 on (s2 = 0: hi itself)
      const uint64_t top = s2 ? (hi << s2) | ((uint64_t)c >> (32 - s2)) : hi;
      const uint64_t f = top >> down;
      const uint64_t rc = rev_fields(~f) >> down;
      const uint64_t canon = f < rc ? f : rc;
      bool ok = q + p.k <= len;
      if constexpr (STRIDE) ok = ok && q % p.d == 0;
      if constexpr (VALID) {
        const uint32_t* v = p.vbits + r * p.Lv;
        const int jv = q >> 5;
        const uint64_t lo = __ldg(v + jv);
        const uint64_t up = jv + 1 < p.Lv ? __ldg(v + jv + 1) : 0u;
        ok = ok && (((lo | (up << 32)) >> (q & 31)) & kbits) == kbits;
      }
      o[q] = ok ? (int64_t)(canon ^ 0x8000000000000000ull) : SENT_KEY;
    }
  }
}

template <bool VALID, bool STRIDE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, window_keys_kernel<VALID, STRIDE>, THREADS, 0);
  const int64_t needed = (p.R + THREADS / 32 - 1) / (THREADS / 32);
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = needed < resident ? needed : resident;
  window_keys_kernel<VALID, STRIDE><<<(unsigned int)blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// words [R, Lw] with Lw >= ceil(L / 16), lens [R], vbits [R, Lv] with
// Lv >= ceil(L / 32) or null, out [R, L - k + 1]; 1 <= k <= 32, k <= L,
// d >= 1 (the wrapper checks all of it).
extern "C" int window_keys_launch(const void* words, const void* lens, const void* vbits,
                                  void* out, int64_t R, int32_t Lw, int32_t Lv,
                                  int32_t L, int32_t k, int32_t d, void* stream) {
  if (k < 1 || k > 32 || L < k || d < 1 || Lw * 16 < L || (vbits && Lv * 32 < L))
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return 0;
  Params p{};
  p.words = (const uint32_t*)words;
  p.lens = (const int32_t*)lens;
  p.vbits = (const uint32_t*)vbits;
  p.out = (int64_t*)out;
  p.R = R;
  p.Lw = Lw;
  p.Lv = Lv;
  p.NW = L - k + 1;
  p.k = k;
  p.d = d;
  cudaStream_t st = (cudaStream_t)stream;
  if (vbits)
    return (int)(d > 1 ? launch<true, true>(p, st) : launch<true, false>(p, st));
  return (int)(d > 1 ? launch<false, true>(p, st) : launch<false, false>(p, st));
}
