// The FM backward search's reads of the occ32 table and of the read
// codes, shared by the search (fm_search.cu, K1) and its floor
// (measure.cu's dsb_occ_chase).
#pragma once

#include <cstdint>

namespace dsb {

// The occ32 block of BWT row r, with JAX gather semantics for an index
// into n_blk blocks: a negative index counts from the end, then the index
// is clamped into range.
__device__ __forceinline__ long long occ_block(int r, long long n_blk) {
  long long q = static_cast<long long>(r >> 5);
  if (q < 0) q += n_blk;
  return q < 0 ? 0 : (q >= n_blk ? n_blk - 1 : q);
}

// Count of a char in BWT rows [0, r) from occ32[r >> 5, c], the pair of
// the count before the 32-row block and the block's bit word for c.
__device__ __forceinline__ int occ_count(uint2 p, int r) {
  const unsigned m = (1u << (r & 31)) - 1u;
  return static_cast<int>(p.x + static_cast<unsigned>(__popc(p.y & m)));
}

// The read code at ptr of a row of W codes, 255 (no char) outside it.
__device__ __forceinline__ int read_code(const int* row, int ptr, int W) {
  return (ptr >= 0 && ptr < W) ? row[ptr] : 255;
}

// The occ32 column of a read code: codes above 5 and below 0 clamp, as
// the JAX search clamps them, and 5 counts as 4.
__device__ __forceinline__ int occ_column(int ch) {
  const int cc = ch < 0 ? 0 : (ch > 5 ? 5 : ch);
  return cc > 4 ? 4 : cc;
}

}  // namespace dsb
