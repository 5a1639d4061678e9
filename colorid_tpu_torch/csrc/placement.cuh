// Device code of the Bloom-row placement (csrc/placement.cu, kernel A),
// shared with the read classifier's kernel (csrc/readid.cu, kernel H):
// XXH3_64 of a k-mer's ASCII bytes from its 2-bit value, the reciprocal
// modulo, the value-addressed v3/v4 maps, and one k-mer's placement
// under each layout. placement.cu's header comment says what each
// computes and why it is written so.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// One k-mer's placement for a compile-time H (HT > 0): vals[h] is the row
// (classic) or the offset of hash h; the return value is the block. P is
// any parameter struct with placement.cu's placement fields (k, mod,
// mod_inv, n_blocks, gmask, gstep, g_bits, c), filled by place_fields.
template <int PATH, int HT, class P>
__device__ __forceinline__ uint64_t place_fixed(const P& p, uint64_t v,
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

// Fills p's placement fields for k, H, the layout (version 0 = classic,
// 1..4 = the blocked layouts of ops/blocked.py) and the 12 u64 of struct
// Consts; returns the Path to launch, or -1 outside the envelope (4 <= k
// <= 32, H >= 1, 0 < bloom_size < 2^31, rpb a power of two, v2-v4 with H
// <= rpb).
template <class P>
int place_fields(P& p, int32_t k, int32_t H, int32_t version, int64_t bloom_size,
                 int64_t rpb, const void* consts) {
  if (k < 4 || k > 32 || H < 1 || version < 0 || version > 4 || bloom_size <= 0 ||
      bloom_size >= (1ll << 31))
    return -1;
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
    return PATH_CL_4_8 + cls;
  }
  if (rpb <= 0 || (rpb & (rpb - 1)) || bloom_size / rpb < 1 || (version > 1 && rpb < H))
    return -1;
  const uint64_t n_blocks = (uint64_t)(bloom_size / rpb);
  const uint32_t grp = (uint32_t)(rpb / H);
  if (version <= 2) {
    p.mod = n_blocks;
    p.mod_inv = ~0ull / n_blocks;
    p.gmask = version == 1 ? (uint32_t)rpb - 1 : grp - 1;
    p.gstep = version == 1 ? 0 : grp;
    return PATH_BL_4_8 + cls;
  }
  p.n_blocks = n_blocks;
  p.gmask = grp - 1;
  p.gstep = grp;
  int g_bits = 0;
  while ((2u << g_bits) <= grp) ++g_bits;  // grp.bit_length() - 1
  p.g_bits = g_bits;
  return version == 3 ? PATH_V3 : PATH_V4;
}

}  // namespace
