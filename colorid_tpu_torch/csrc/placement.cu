// Bloom-row placement of 2-bit packed canonical k-mers on Hopper (sm_90a).
//
// Replaces code that the JAX package leaves to XLA, which fuses it into a
// few loops on the TPU: colorid_tpu/ops/hash_jax.py::bloom_rows_device
// (_xxh3_device over 16-bit limbs, _mod_barrett) for the classic layout, and
// colorid_tpu/ops/query.py::_device_blkoff (the XXH3 placements v1/v2 and
// hash_jax.py::_v3_blkoff for the value-addressed v3/v4) for the blocked
// layouts of colorid_tpu/ops/blocked.py. Its plain PyTorch twin, which runs
// the same arithmetic as int64-limb tensor ops (one launch per limb
// operation on the card), is colorid_tpu_torch/ops/hash_torch.py::
// placement_plain; the two agree bit for bit.
//
// What it computes, per k-mer i of n (src[i] ^ flip is its 64-bit 2-bit
// value v, base 0 in the top pair of the low 2k bits: a packed (lo, hi)
// int32 pair read as one u64 with flip 0, or an ops/extract.py sort key with
// flip 2^63):
//   classic (PATH_CL_*):  row_h = XXH3_64(ascii(v), seed h) % bloom_size
//   v1/v2  (PATH_BL_*):   block = XXH3(seed 0) % n_blocks,
//                         off_0 = (XXH3(seed 0) >> 32) & gmask,
//                         off_h = h * gstep + (XXH3(seed h) & gmask)
//                         (v1: gmask rpb - 1, gstep 0; v2: grp - 1, grp)
//   v3/v4  (PATH_V3/V4):  x = v << (64 - 2k), v4: x = ~sqr_hi(~x),
//                         block = (x * n_blocks) >> 64, m = fmix64(v),
//                         off_h = h * grp + ((m >> (g_bits * h)) & (grp - 1))
// written as rows int32 [n, H] (classic row_h, or block * rpb + off_h), or
// (BLKOFF) as int64 [H + 1, n]: the block, then each hash's offset, or
// (KEYOFF, the blocked probe stream's packed mode) as a sort key [n] and
// the offsets packed 8 bits a hash into one int32 [n] (the probe kernel's
// encoding, ops/hash_torch.py::pack_offsets): the key is the block, or with
// qbits > 0 block << qbits | clamp(q[i], qlo, qhi), int32 (the caller
// knows every key is below 2^31).
//
// What bounds it on an H100: at H = 4 both sides are close. Bytes: 8 in and
// 16 (rows), 40 (BLKOFF) or 8 to 16 (KEYOFF, with the frequency read) out
// per k-mer against 3.35 TB/s. Operations: the
// XXH3 of four seeds is some hundreds of integer instructions per k-mer
// (64-bit products are several 32-bit IMADs), against one warp instruction
// per clock on each of the SM's four schedulers (chip_smoke.py counts the
// instructions of the loop body from the SASS and reports both bounds).
//
// What the design does about that:
// - Native 64-bit integers: the 128-bit fold is a * b ^ __umul64hi(a, b);
//   no 16-bit limbs (the JAX package's TPU has no 64-bit integers).
// - The ASCII bytes of the k-mer are never stored: the 2-bit fields of v
//   are reversed once (bit reverse, swap of bit pairs), so base j sits in
//   field j; any 8 bytes of the string at offset o are then the 16 bits at
//   2o, spread to one nibble a base and turned into 'A', 'C', 'G', 'T' by
//   two byte permutes (PRMT with the table "ACGT"). No local array, nothing
//   spills.
// - The modulo by bloom_size (or n_blocks, both < 2^31) is a multiply by
//   the reciprocal floor((2^64 - 1) / m) that the wrapper passes in, and at
//   most two corrections; a 64-bit % would call a slow subroutine.
// - The XXH3 length class, the placement and H (1, 2 or 4; any other H
//   takes a loop) are template parameters, so the loop body is straight
//   code and the seeds' secret sums fold into registers before the loop.
// - A persistent grid walks the k-mers with a grid-stride loop; src loads
//   and the outputs are coalesced (rows as one vector store when H is 2 or
//   4).
//
// The device code of one k-mer's placement (XXH3, the modulo, the v3/v4
// maps, place_fixed) lives in csrc/placement.cuh, which the read
// classifier's kernel (csrc/readid.cu) includes too.
//
// The secret words, primes and fmix64 constants come from the wrapper
// (hashing/xxh3.py::KSECRET and ops/blocked.py's), so this file and the
// Python copy cannot drift apart.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "placement.cuh"

namespace {

constexpr int THREADS = 256;

enum Out : int { OUT_ROWS = 0, OUT_BLKOFF = 1, OUT_KEYOFF = 2 };

struct Params {
  const uint64_t* src;
  uint64_t flip;
  int64_t n;
  int32_t* rows;    // [n, H] or nullptr
  int64_t* blkoff;  // [H + 1, n] or nullptr
  int32_t* key;     // [n] or nullptr
  int32_t* offp;    // [n] with key
  const int32_t* q; // [n] with qbits > 0
  int qbits;
  int32_t qlo, qhi;
  int k, H;
  uint64_t mod, mod_inv;  // bloom_size (classic) or n_blocks (v1/v2)
  uint64_t n_blocks;      // v3/v4
  int64_t rpb;
  uint32_t gmask, gstep;  // v1/v2 offsets; v3/v4: grp - 1 and grp
  int g_bits;             // v3/v4
  Consts c;
};

// KEYOFF: k-mer i's sort key, and its offsets packed 8 bits a hash.
__device__ __forceinline__ void put_keyoff(const Params& p, int64_t i, uint64_t block,
                                           uint64_t offs) {
  int64_t kv = (int64_t)block;
  if (p.qbits) {
    const int32_t q = min(max(p.q[i], p.qlo), p.qhi);
    kv = (kv << p.qbits) | (int64_t)q;
  }
  p.key[i] = (int32_t)kv;
  p.offp[i] = (int32_t)(uint32_t)offs;
}

// Writes the HT outputs of k-mer i: rows (block * rpb already added for a
// blocked layout), the block and the offsets, or the key and packed offsets.
template <int HT, int OUT>
__device__ __forceinline__ void put(const Params& p, int64_t i, const uint32_t* vals,
                                    uint64_t block) {
  if constexpr (OUT == OUT_KEYOFF) {
    uint64_t o = 0;
#pragma unroll
    for (int h = 0; h < HT; ++h) o |= (uint64_t)vals[h] << (8 * h);
    put_keyoff(p, i, block, o);
  } else if constexpr (OUT == OUT_BLKOFF) {
    p.blkoff[i] = (int64_t)block;
#pragma unroll
    for (int h = 0; h < HT; ++h) p.blkoff[(1 + h) * p.n + i] = vals[h];
  } else if constexpr (HT == 4) {
    reinterpret_cast<int4*>(p.rows)[i] =
        make_int4((int)vals[0], (int)vals[1], (int)vals[2], (int)vals[3]);
  } else if constexpr (HT == 2) {
    reinterpret_cast<int2*>(p.rows)[i] = make_int2((int)vals[0], (int)vals[1]);
  } else {
#pragma unroll
    for (int h = 0; h < HT; ++h) p.rows[i * HT + h] = (int32_t)vals[h];
  }
}
template <int PATH, int HT, int OUT>
__global__ void __launch_bounds__(THREADS) placement_kernel(const Params p) {
  constexpr int CLS = xxh_class<PATH>();
  constexpr bool BLKOFF = OUT == OUT_BLKOFF;
  constexpr bool ROW_BLOCKS = PATH > PATH_CL_17_32 && OUT == OUT_ROWS;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  if constexpr (HT > 0) {
    SeedConsts sc[HT];
#pragma unroll
    for (int h = 0; h < HT; ++h) sc[h] = seed_consts<CLS>(p.c, (uint64_t)h);
#pragma unroll 1
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < p.n; i += stride) {
      const uint64_t v = __ldcs(reinterpret_cast<const unsigned long long*>(p.src) + i) ^ p.flip;
      uint32_t vals[HT];
      const uint64_t block = place_fixed<PATH, HT>(p, v, sc, vals);
      if constexpr (ROW_BLOCKS) {
        const uint32_t base = (uint32_t)(block * (uint64_t)p.rpb);
#pragma unroll
        for (int h = 0; h < HT; ++h) vals[h] += base;
      }
      put<HT, OUT>(p, i, vals, block);
    }
  } else {
    // any other H: one hash at a time, each output written as it is made
#pragma unroll 1
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < p.n; i += stride) {
      const uint64_t v = __ldcs(reinterpret_cast<const unsigned long long*>(p.src) + i) ^ p.flip;
      uint64_t block = 0;
      uint32_t base = 0;
      uint64_t f = 0, m = 0;
      if constexpr (PATH == PATH_V3 || PATH == PATH_V4) {
        uint64_t x = v << (64 - 2 * p.k);
        if constexpr (PATH == PATH_V4) {
          const uint64_t y = ~x;
          x = ~__umul64hi(y, y);
        }
        block = __umul64hi(x, p.n_blocks);
        m = fmix64(v, p.c);
      } else {
        f = base_fields(v, p.k);
        if constexpr (PATH > PATH_CL_17_32)
          block = mod_u64(xxh3<CLS>(f, p.k, seed_consts<CLS>(p.c, 0), p.c), p.mod,
                          p.mod_inv);
      }
      if constexpr (ROW_BLOCKS) base = (uint32_t)(block * (uint64_t)p.rpb);
      if constexpr (BLKOFF) p.blkoff[i] = (int64_t)block;
      uint64_t offs = 0;  // KEYOFF
#pragma unroll 1
      for (int h = 0; h < p.H; ++h) {
        uint32_t val;
        if constexpr (PATH == PATH_V3 || PATH == PATH_V4) {
          val = (uint32_t)h * p.gstep + ((uint32_t)shr(m, p.g_bits * h) & p.gmask);
        } else {
          const uint64_t hv = xxh3<CLS>(f, p.k, seed_consts<CLS>(p.c, (uint64_t)h), p.c);
          if constexpr (PATH <= PATH_CL_17_32)
            val = (uint32_t)mod_u64(hv, p.mod, p.mod_inv);
          else
            val = h == 0 ? (uint32_t)(hv >> 32) & p.gmask
                         : (uint32_t)h * p.gstep + ((uint32_t)hv & p.gmask);
        }
        if constexpr (OUT == OUT_KEYOFF)
          offs |= (uint64_t)val << (8 * h);
        else if constexpr (BLKOFF)
          p.blkoff[(1 + h) * p.n + i] = val;
        else
          p.rows[i * p.H + h] = (int32_t)(val + base);
      }
      if constexpr (OUT == OUT_KEYOFF) put_keyoff(p, i, block, offs);
    }
  }
}

template <int PATH, int HT, int OUT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, placement_kernel<PATH, HT, OUT>, THREADS, 0);
  const int64_t needed = (p.n + THREADS - 1) / THREADS;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = needed < resident ? needed : resident;
  placement_kernel<PATH, HT, OUT><<<(unsigned int)blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int PATH, int OUT>
cudaError_t launch_h(const Params& p, cudaStream_t stream) {
  switch (p.H) {
    case 1: return launch<PATH, 1, OUT>(p, stream);
    case 2: return launch<PATH, 2, OUT>(p, stream);
    case 4: return launch<PATH, 4, OUT>(p, stream);
    default: return launch<PATH, 0, OUT>(p, stream);
  }
}

template <int PATH>
cudaError_t launch_out(const Params& p, cudaStream_t stream) {
  if constexpr (PATH <= PATH_CL_17_32) {
    return launch_h<PATH, OUT_ROWS>(p, stream);
  } else {
    return p.key      ? launch_h<PATH, OUT_KEYOFF>(p, stream)
           : p.blkoff ? launch_h<PATH, OUT_BLKOFF>(p, stream)
                      : launch_h<PATH, OUT_ROWS>(p, stream);
  }
}

// The envelope every output takes: fills p's placement fields and launches
// the path they name.
int place(Params& p, int32_t k, int32_t H, int32_t version, int64_t bloom_size, int64_t rpb,
          const void* consts, cudaStream_t st) {
  switch (place_fields(p, k, H, version, bloom_size, rpb, consts)) {
    case PATH_CL_4_8: return (int)launch_out<PATH_CL_4_8>(p, st);
    case PATH_CL_9_16: return (int)launch_out<PATH_CL_9_16>(p, st);
    case PATH_CL_17_32: return (int)launch_out<PATH_CL_17_32>(p, st);
    case PATH_BL_4_8: return (int)launch_out<PATH_BL_4_8>(p, st);
    case PATH_BL_9_16: return (int)launch_out<PATH_BL_9_16>(p, st);
    case PATH_BL_17_32: return (int)launch_out<PATH_BL_17_32>(p, st);
    case PATH_V3: return (int)launch_out<PATH_V3>(p, st);
    case PATH_V4: return (int)launch_out<PATH_V4>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// src: n u64 values (16-byte aligned when rows are stored as vectors);
// rows [n, H] int32 or blkoff [H + 1, n] int64 (exactly one non-null;
// classic takes rows). version 0 = classic, 1..4 = the blocked layouts.
// consts: the 12 u64 of struct Consts. The wrapper checks the envelope
// (4 <= k <= 32, H >= 1, 0 < bloom_size < 2^31, rpb a power of two).
extern "C" int placement_launch(const void* src, uint64_t flip, int64_t n, void* rows,
                                void* blkoff, int32_t k, int32_t H, int32_t version,
                                int64_t bloom_size, int64_t rpb, const void* consts,
                                void* stream) {
  if (n <= 0) return 0;
  if ((rows == nullptr) == (blkoff == nullptr) || (version == 0 && rows == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.src = (const uint64_t*)src;
  p.flip = flip;
  p.n = n;
  p.rows = (int32_t*)rows;
  p.blkoff = (int64_t*)blkoff;
  return place(p, k, H, version, bloom_size, rpb, consts, (cudaStream_t)stream);
}

// The KEYOFF output of a blocked layout (version 1..4, H <= 4): key int32
// [n] and offp int32 [n]; with qbits > 0 the key carries clamp(q[i], qlo,
// qhi) in its low qbits (q int32 [n]), every key below 2^31.
extern "C" int placement_keyoff_launch(const void* src, uint64_t flip, int64_t n, void* key,
                                       void* offp, const void* q, int32_t qbits,
                                       int32_t qlo, int32_t qhi, int32_t k, int32_t H,
                                       int32_t version, int64_t bloom_size, int64_t rpb,
                                       const void* consts, void* stream) {
  if (n <= 0) return 0;
  if (!key || !offp || version < 1 || H > 4 || qbits < 0 || qbits > 31 || (qbits && !q))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.src = (const uint64_t*)src;
  p.flip = flip;
  p.n = n;
  p.key = (int32_t*)key;
  p.offp = (int32_t*)offp;
  p.q = (const int32_t*)q;
  p.qbits = qbits;
  p.qlo = qlo;
  p.qhi = qhi;
  return place(p, k, H, version, bloom_size, rpb, consts, (cudaStream_t)stream);
}
