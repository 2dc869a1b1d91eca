// Device code shared by the two exist-filter probes: stage 1's grid probe
// (stage1.cu) and the validation engine's probe of every e-kmer
// (probe.cu). Each is the get_exist_kmer test (cly.c:951-967) of one
// e-kmer: its window passes the base-count filter of store_kmers
// (cly.c:359-397), it is not the zero k-mer, and both bloom bits are set
// (hash64_1 into bitmap 0, hash64_2 into bitmap 1, idx.c:1014-1025).
#pragma once

#include <cstdint>

namespace dsb {

// lib/utils.c:1067-1077
__device__ __forceinline__ uint64_t hash64_1(uint64_t k) {
  k = ~k + (k << 21);
  k = k ^ (k >> 24);
  k = (k + (k << 3)) + (k << 8);
  k = k ^ (k >> 14);
  k = (k + (k << 2)) + (k << 4);
  k = k ^ (k >> 28);
  k = k + (k << 31);
  return k;
}

// lib/utils.c:1080-1091
__device__ __forceinline__ uint64_t hash64_2(uint64_t k) {
  k += ~(k << 32);
  k ^= k >> 22;
  k += ~(k << 13);
  k ^= k >> 8;
  k += k << 3;
  k ^= k >> 15;
  k += ~(k << 27);
  k ^= k >> 31;
  return k;
}

// Bit h of a bitmap: byte h >> 3, bit 7 - (h & 7) of it (idx.c:1019),
// the bytes held as little-endian 32-bit words.
__device__ __forceinline__ unsigned bloom_bit(const unsigned* __restrict__ w,
                                              uint64_t h) {
  const unsigned word = __ldg(w + (h >> 5));
  return (word >> static_cast<unsigned>(((h >> 3) & 3) * 8 + 7 - (h & 7))) &
         1u;
}

// Both bloom bits of k, each hash masked to the filter's mask bits.
__device__ __forceinline__ unsigned bloom_hit(const unsigned* __restrict__ w0,
                                              const unsigned* __restrict__ w1,
                                              uint64_t k, uint64_t hmask) {
  return bloom_bit(w0, hash64_1(k) & hmask) &
         bloom_bit(w1, hash64_2(k) & hmask);
}

// The e-kmer of the lek codes at offset p of a code row, in native 64
// bits (codes past the read's length enter it as they are), and its last
// 13 bases in *prefix. Returns false where the window fails the
// base-count filter: a base 0-3 at sbm or more of the window's positions
// that lie before len.
__device__ __forceinline__ bool ekmer(const unsigned char* row, int p,
                                      int len, int lek, int sbm,
                                      uint64_t* kmer, unsigned* prefix) {
  uint64_t k = 0;
  unsigned pre = 0;
  unsigned counts = 0;  // one byte per base: counts in [p, p + lek)
  for (int j = 0; j < lek; ++j) {
    const unsigned c = row[p + j];
    k = (k << 2) | c;
    if (j >= lek - 13) pre = (pre << 2) | c;
    if (c < 4 && p + j < len) counts += 1u << (8 * c);
  }
  *kmer = k;
  *prefix = pre;
  for (int b = 0; b < 4; ++b)
    if (static_cast<int>((counts >> (8 * b)) & 0xFFu) >= sbm) return false;
  return true;
}

}  // namespace dsb
