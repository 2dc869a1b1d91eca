// The validation engine's exist-filter probe: every e-kmer of every code
// row, one thread a (row, offset).
//
// Replaces desamba_tpu/ops/ekmer.py:probe_reads, which runs _probe_reads
// at stride 1 (with u64emu.hash64_1, hash64_2, _addr and _probe_both) on
// the forward and reverse-complement rows of a sub-batch
// (desamba_tpu/engine/tpu_engine.py:121-141). Output column p is 1 where
// the e-kmer at read offset p passes the base-count filter, is not the
// zero k-mer, lies in the read (p + lek <= length) and hits both bloom
// bitmaps; padding rows (length 0), reads shorter than lek and offsets
// past a read's end give 0. The e-kmer, its filter and the bloom test are
// bloom.cuh's, the code stage 1 runs on its stride-3 grid.
//
// What bounds it on this card: each point that passes the filter reads
// two random 4-byte words of bitmaps far larger than L2 (a 32-byte sector
// each), and the codes come in and one byte a point goes out. The JAX and
// plain versions emulate the 64-bit hashes on (hi, lo) pairs through
// [rows, points] temporaries; here each thread builds its k-mer and both
// hashes in uint64 registers and writes one byte. A thread reads its lek
// codes from global memory; neighbouring threads read overlapping codes,
// which L1 serves.
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom.cuh"

namespace {

__global__ void probe_reads_kernel(const unsigned* __restrict__ w01,
                                   long long n_words0,
                                   const unsigned char* __restrict__ codes,
                                   const int* __restrict__ lengths,
                                   long long B, int W, int n_k, int lek,
                                   int sbm, uint64_t hmask,
                                   unsigned char* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= B * n_k) return;
  const long long row = t / n_k;
  const int p = static_cast<int>(t - row * n_k);
  const int len = lengths[row];
  unsigned hit = 0;
  uint64_t k;
  unsigned prefix;
  if (p + lek <= len &&
      dsb::ekmer(codes + row * W, p, len, lek, sbm, &k, &prefix) && k != 0)
    hit = dsb::bloom_hit(w01, w01 + n_words0, k, hmask);
  out[t] = static_cast<unsigned char>(hit);
}

}  // namespace

extern "C" int dsb_probe_reads(const void* w01, long long n_words0,
                               const void* codes, const void* lengths,
                               long long B, int W, int lek, int sbm,
                               int mask_bits, void* out, void* stream) {
  const int n_k = W - lek + 1;
  const long long n = B * n_k;
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    probe_reads_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(w01), n_words0,
        static_cast<const unsigned char*>(codes),
        static_cast<const int*>(lengths), B, W, n_k, lek, sbm,
        (uint64_t{1} << mask_bits) - 1, static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
