// Device code of the row gather: a k-mer's H Bloom rows, their words read
// from the matrix and ANDed, and the presence test (every row has a nonzero
// word). Shared by the read classifier's kernel (csrc/readid.cu, kernel H)
// and the search epilogue's gather mode (csrc/epilogue.cu, kernel C).
//
// The matrix is the int32 [n_blocks, 128] block layout of
// ops/query.py::pack_matrix_blocks, read here as n_words uint32 words. Row r
// of a k-mer starts at word r * wpad in the classic layout; in the blocked
// one (rpb rows a block, a power of two) the k-mer's H rows share the block
// of its hash-0 row r0 and row r starts at lane (r % rpb) * wpad of it, as
// ops/query.py::_gather_rows_blocked reads them. A word outside the matrix
// reads as 0.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum RowLoad : int {
  ROW_LOAD_L1 = 0,  // through L1 (ld.global.nc)
  ROW_LOAD_L2 = 1,  // through L2 only (ld.global.cg): a word read once
};

struct RowGeo {
  const uint32_t* blocks;  // the matrix, n_words words
  int64_t n_words;
  int32_t wpad;
  int64_t rpb;       // 0: classic rows; else rows a block, a power of two
  int32_t rpb_log2;  // log2(rpb)
};

template <int LD>
__device__ __forceinline__ uint32_t row_word(const RowGeo& g, int64_t w) {
  if ((uint64_t)w >= (uint64_t)g.n_words) return 0u;
  return LD == ROW_LOAD_L2 ? __ldcg(g.blocks + w) : __ldg(g.blocks + w);
}

// The first word of row r of a k-mer whose hash-0 row is r0.
__device__ __forceinline__ int64_t row_start(const RowGeo& g, int64_t r0, int64_t r) {
  if (!g.rpb) return r * g.wpad;
  return ((r0 >> g.rpb_log2) << 7) + (r & (g.rpb - 1)) * g.wpad;
}

// The first words of rows[0..n) (n <= NH) of a k-mer whose hash-0 row is r0.
template <typename RowT, int NH>
__device__ __forceinline__ void row_starts(const RowGeo& g, const RowT* rows, int n, int64_t r0,
                                           int64_t (&off)[NH]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) off[h] = h < n ? row_start(g, r0, (int64_t)rows[h]) : 0;
}

// Word w of the AND of the n <= NH rows that start at off, every load issued
// before any is used. Bit h of nz is set where row h's word is nonzero, and
// for every h >= n.
template <int LD, int NH>
__device__ __forceinline__ uint32_t and_word(const RowGeo& g, const int64_t (&off)[NH], int n,
                                             int64_t w, uint32_t& nz) {
  uint32_t x[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) x[h] = h < n ? row_word<LD>(g, off[h] + w) : ~0u;
  uint32_t a = ~0u;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    a &= x[h];
    nz |= (uint32_t)(x[h] != 0) << h;
  }
  return a;
}

// The rows h < H of an nz built from and_word calls (bit h: row h had a
// nonzero word) all present; H <= 32.
__device__ __forceinline__ bool rows_present(uint32_t nz, int H) {
  return (nz | (H >= 32 ? 0u : ~0u << H)) == ~0u;
}

// Word w of the AND of a k-mer's H <= 32 rows (rows[0..H), hash-0 row r0),
// four rows' loads at a time; bit h of nz is set where row h's word is
// nonzero.
template <int LD, typename RowT>
__device__ __forceinline__ uint32_t kmer_word(const RowGeo& g, const RowT* rows, int H, int64_t r0,
                                              int64_t w, uint32_t& nz) {
  uint32_t a = ~0u;
  for (int h0 = 0; h0 < H; h0 += 4) {
    const int n = H - h0 < 4 ? H - h0 : 4;
    int64_t off[4];
    row_starts<RowT, 4>(g, rows + h0, n, r0, off);
    uint32_t z = 0;
    a &= and_word<LD, 4>(g, off, n, w, z);
    nz |= (z & ((1u << n) - 1u)) << h0;
  }
  return a;
}

}  // namespace
