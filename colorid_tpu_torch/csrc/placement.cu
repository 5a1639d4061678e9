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
// The secret words, primes and fmix64 constants come from the wrapper
// (hashing/xxh3.py::KSECRET and ops/blocked.py's), so this file and the
// Python copy cannot drift apart.
//
// Bound to Python with ctypes (colorid_tpu_torch/ops/kernels.py): a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

enum Path : int {
  PATH_CL_4_8 = 0,    // classic rows, XXH3 of 4..8 bytes
  PATH_CL_9_16 = 1,   // 9..16 bytes
  PATH_CL_17_32 = 2,  // 17..32 bytes
  PATH_BL_4_8 = 3,    // v1/v2 placement, the same three classes
  PATH_BL_9_16 = 4,
  PATH_BL_17_32 = 5,
  PATH_V3 = 6,        // value-addressed, linear block map
  PATH_V4 = 7,        // value-addressed, through the canonical CDF
};

// The constants that hashing/xxh3.py and ops/blocked.py define, in this
// order (the wrapper's hash_torch.py::_KERNEL_CONSTS).
struct Consts {
  uint64_t sec[7];  // KSECRET as little-endian u64 at bytes 0, 8, ..., 48
  uint64_t p64_1, pmx1, pmx2, fmix1, fmix2;
};

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

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fold(uint64_t a, uint64_t b) {
  return (a * b) ^ __umul64hi(a, b);
}

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return ((uint64_t)__byte_perm((uint32_t)x, 0u, 0x0123) << 32) |
         __byte_perm((uint32_t)(x >> 32), 0u, 0x0123);
}

// x >> s, 0 for s >= 64 (the twin's limb shift)
__device__ __forceinline__ uint64_t shr(uint64_t x, int s) {
  return s < 64 ? x >> s : 0;
}

__device__ __forceinline__ uint64_t avalanche(uint64_t h, uint64_t pmx1) {
  h ^= h >> 37;
  h *= pmx1;
  return h ^ (h >> 32);
}

// x mod m for m < 2^31, with inv = floor((2^64 - 1) / m): the quotient
// estimate is at most 2 short, so r < 3m before the corrections.
__device__ __forceinline__ uint64_t mod_u64(uint64_t x, uint64_t m, uint64_t inv) {
  uint64_t r = x - __umul64hi(x, inv) * m;
  r = r >= m ? r - m : r;
  return r >= m ? r - m : r;
}

// the 2-bit fields of v in reverse order, shifted so that base j of the
// k-mer is field j (bits 2j, 2j + 1)
__device__ __forceinline__ uint64_t base_fields(uint64_t v, int k) {
  uint64_t r = __brevll(v);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r >> (64 - 2 * k);
}

// 4 bases (base j in bits 2j of c) -> their ASCII bytes, little-endian
__device__ __forceinline__ uint32_t ascii4(uint32_t c) {
  uint32_t t = (c | (c << 4)) & 0x0F0Fu;
  t = (t | (t << 2)) & 0x3333u;
  return __byte_perm(0x54474341u, 0u, t);  // bytes 'A' 'C' 'G' 'T'
}

// little-endian reads of the ASCII string at byte offset o (o + 8 <= k)
__device__ __forceinline__ uint64_t rd64(uint64_t f, int o) {
  const uint64_t c = f >> (2 * o);
  return (uint64_t)ascii4((uint32_t)c & 0xFFu) |
         ((uint64_t)ascii4((uint32_t)(c >> 8) & 0xFFu) << 32);
}

__device__ __forceinline__ uint32_t rd32(uint64_t f, int o) {
  return ascii4((uint32_t)(f >> (2 * o)) & 0xFFu);
}

// The seed-dependent constants of one length class, folded before the loop.
struct SeedConsts {
  uint64_t a, b, c, d;
};

template <int CLS>  // 0: 4..8, 1: 9..16, 2: 17..32
__device__ __forceinline__ SeedConsts seed_consts(const Consts& c, uint64_t seed) {
  SeedConsts s{};
  if constexpr (CLS == 2) {
    s.a = c.sec[0] + seed;
    s.b = c.sec[1] - seed;
    s.c = c.sec[2] + seed;
    s.d = c.sec[3] - seed;
  } else if constexpr (CLS == 1) {
    s.a = (c.sec[3] ^ c.sec[4]) + seed;
    s.b = (c.sec[5] ^ c.sec[6]) - seed;
  } else {
    const uint32_t lo = (uint32_t)seed;
    const uint64_t seed2 = seed ^ ((uint64_t)__byte_perm(lo, 0u, 0x0123) << 32);
    s.a = (c.sec[1] ^ c.sec[2]) - seed2;
  }
  return s;
}

// XXH3_64 of the k ASCII bytes (f = base_fields(v, k)) with one seed
template <int CLS>
__device__ __forceinline__ uint64_t xxh3(uint64_t f, int k, const SeedConsts& s,
                                         const Consts& c) {
  if constexpr (CLS == 2) {
    uint64_t acc = (uint64_t)k * c.p64_1;
    acc += fold(rd64(f, 0) ^ s.a, rd64(f, 8) ^ s.b);
    acc += fold(rd64(f, k - 16) ^ s.c, rd64(f, k - 8) ^ s.d);
    return avalanche(acc, c.pmx1);
  } else if constexpr (CLS == 1) {
    const uint64_t in_lo = rd64(f, 0) ^ s.a;
    const uint64_t in_hi = rd64(f, k - 8) ^ s.b;
    const uint64_t acc = (uint64_t)k + bswap64(in_lo) + in_hi + fold(in_lo, in_hi);
    return avalanche(acc, c.pmx1);
  } else {
    const uint64_t in64 = (uint64_t)rd32(f, k - 4) + ((uint64_t)rd32(f, 0) << 32);
    uint64_t h = in64 ^ s.a;
    h ^= rotl(h, 49) ^ rotl(h, 24);
    h *= c.pmx2;
    h ^= (h >> 35) + (uint64_t)k;
    h *= c.pmx2;
    return h ^ (h >> 28);
  }
}

__device__ __forceinline__ uint64_t fmix64(uint64_t v, const Consts& c) {
  v ^= v >> 33;
  v *= c.fmix1;
  v ^= v >> 33;
  v *= c.fmix2;
  return v ^ (v >> 33);
}

template <int PATH>
__host__ __device__ constexpr int xxh_class() {
  return PATH == PATH_CL_4_8 || PATH == PATH_BL_4_8     ? 0
         : PATH == PATH_CL_9_16 || PATH == PATH_BL_9_16 ? 1
                                                        : 2;
}

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

// One k-mer's placement for a compile-time H (HT > 0): vals[h] is the row
// (ROWS) or the offset of hash h; the return value is the block.
template <int PATH, int HT>
__device__ __forceinline__ uint64_t place_fixed(const Params& p, uint64_t v,
                                                const SeedConsts* sc,
                                                uint32_t* vals) {
  if constexpr (PATH == PATH_V3 || PATH == PATH_V4) {
    uint64_t x = v << (64 - 2 * p.k);
    if constexpr (PATH == PATH_V4) {
      const uint64_t y = ~x;
      x = ~__umul64hi(y, y);
    }
    const uint64_t block = __umul64hi(x, p.n_blocks);
    const uint64_t m = fmix64(v, p.c);
#pragma unroll
    for (int h = 0; h < HT; ++h)
      vals[h] = (uint32_t)h * p.gstep + ((uint32_t)shr(m, p.g_bits * h) & p.gmask);
    return block;
  } else {
    constexpr int CLS = xxh_class<PATH>();
    const uint64_t f = base_fields(v, p.k);
    uint64_t h0 = 0;
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      const uint64_t hv = xxh3<CLS>(f, p.k, sc[h], p.c);
      if constexpr (PATH <= PATH_CL_17_32) {
        vals[h] = (uint32_t)mod_u64(hv, p.mod, p.mod_inv);
      } else if (h == 0) {
        h0 = hv;
        vals[0] = (uint32_t)(hv >> 32) & p.gmask;
      } else {
        vals[h] = (uint32_t)h * p.gstep + ((uint32_t)hv & p.gmask);
      }
    }
    if constexpr (PATH <= PATH_CL_17_32)
      return 0;
    else
      return mod_u64(h0, p.mod, p.mod_inv);
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

// The envelope every output takes; on success fills p's placement fields.
// version 0 = classic, 1..4 = the blocked layouts.
int place(Params& p, int32_t k, int32_t H, int32_t version, int64_t bloom_size, int64_t rpb,
          const void* consts, cudaStream_t st) {
  if (k < 4 || k > 32 || H < 1 || version < 0 || version > 4 || bloom_size <= 0 ||
      bloom_size >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  p.k = k;
  p.H = H;
  p.rpb = rpb;
  const uint64_t* cs = (const uint64_t*)consts;
  for (int j = 0; j < 7; ++j) p.c.sec[j] = cs[j];
  p.c.p64_1 = cs[7];
  p.c.pmx1 = cs[8];
  p.c.pmx2 = cs[9];
  p.c.fmix1 = cs[10];
  p.c.fmix2 = cs[11];
  const int cls = k <= 8 ? 0 : k <= 16 ? 1 : 2;
  if (version == 0) {
    p.mod = (uint64_t)bloom_size;
    p.mod_inv = ~0ull / p.mod;
    return (int)(cls == 0   ? launch_out<PATH_CL_4_8>(p, st)
                 : cls == 1 ? launch_out<PATH_CL_9_16>(p, st)
                            : launch_out<PATH_CL_17_32>(p, st));
  }
  if (rpb <= 0 || (rpb & (rpb - 1)) || bloom_size / rpb < 1 || (version > 1 && rpb < H))
    return (int)cudaErrorInvalidValue;
  const uint64_t n_blocks = (uint64_t)(bloom_size / rpb);
  const uint32_t grp = (uint32_t)(rpb / H);
  if (version <= 2) {
    p.mod = n_blocks;
    p.mod_inv = ~0ull / n_blocks;
    p.gmask = version == 1 ? (uint32_t)rpb - 1 : grp - 1;
    p.gstep = version == 1 ? 0 : grp;
    return (int)(cls == 0   ? launch_out<PATH_BL_4_8>(p, st)
                 : cls == 1 ? launch_out<PATH_BL_9_16>(p, st)
                            : launch_out<PATH_BL_17_32>(p, st));
  }
  p.n_blocks = n_blocks;
  p.gmask = grp - 1;
  p.gstep = grp;
  int g_bits = 0;
  while ((2u << g_bits) <= grp) ++g_bits;  // grp.bit_length() - 1
  p.g_bits = g_bits;
  return (int)(version == 3 ? launch_out<PATH_V3>(p, st) : launch_out<PATH_V4>(p, st));
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
