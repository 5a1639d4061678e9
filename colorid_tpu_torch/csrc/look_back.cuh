// The tiles' status words and the decoupled look-back (Merrill and
// Garland's single-pass prefix scan) that kernels D (stream_tail.cu), E
// (radix_sort.cu) and F (run_counts.cu) use to place a tile after the
// tiles before it without a launch between them.
//
// A status word of type W (uint32_t or uint64_t) holds a flag in its top two
// bits over a count in the bits below: 0, not yet published; AGG, the
// tile's own count; INC, the count of the tile and every tile before it. A
// 32-bit word counts to 2^30 - 1, a 64-bit word to 2^62 - 1. The wrapper
// zeroes the words before the launch.
//
// A walker spins on tiles that have not published, so it ends only if every
// tile before it has started and publishes before it waits: a kernel that
// uses it takes its tiles in order from a counter (radix_sort.cu) or relies
// on the blocks of a 1-D grid starting in index order (stream_tail.cu,
// run_counts.cu). Status words are read and written through volatile
// pointers, so each read reaches the memory the other blocks write.

#pragma once

#include <cstdint>

template <class W>
struct LookBack {
  static constexpr int TOP = 8 * (int)sizeof(W) - 2;
  static constexpr W AGG = W(1) << TOP;  // the tile's own count
  static constexpr W INC = W(2) << TOP;  // the count of the tile and every tile before it
  static constexpr W CNT = AGG - 1;

  static __device__ __forceinline__ void publish(W* status, int64_t t, W v) {
    *(volatile W*)(status + t) = v;
  }

  static __device__ __forceinline__ W read(const W* status, int64_t t) {
    return *(const volatile W*)(status + t);
  }

  // The sum of the counts of the tiles before tile t > 0, by a whole warp,
  // 32 tiles a round (every lane returns it): a round waits until the tiles
  // up to the nearest one flagged INC have published, and stops there.
  // Wider rounds (64 to 256 tiles, a lane reading 2 to 8 words) measured
  // slower in run_counts.cu, with or without a pause between reads
  // (PERF.md).
  static __device__ W look_back(const W* status, int64_t t) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    W excl = 0;
    for (int64_t hi = t - 1; hi >= 0;) {
      const int64_t j = hi - lane;
      const W v = j >= 0 ? read(status, j) : INC;
      const unsigned inc = __ballot_sync(FULL, (v & ~CNT) == INC);
      const unsigned waiting = __ballot_sync(FULL, (v & ~CNT) == 0);
      const int stop = inc ? __ffs(inc) - 1 : 31;  // the lanes up to stop count
      const unsigned need = stop == 31 ? FULL : (2u << stop) - 1;
      if (waiting & need) continue;  // read the round again
      W part = lane <= stop ? (v & CNT) : W(0);
#pragma unroll
      for (int o = 16; o; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
      excl += part;
      if (inc) break;
      hi -= 32;
    }
    return excl;
  }
};
