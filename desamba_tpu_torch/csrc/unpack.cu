// Stage 0: decode of the 2-bit wire format, one thread per 16-code word.
//
// Replaces desamba_tpu/engine/fast_engine.py:stage0_unpack and
// _read_words, with the int32 copy of the codes that _build_full makes
// for stage 2 (`codes2.astype(int32)`). The wire format holds, per read
// row, W/4 bytes of forward codes and then W/4 bytes of reverse-complement
// codes, 4 codes a byte, LSB first. Output row r < Bp is read row r's
// forward half, row Bp + r its reverse-complement half. Each thread reads
// the 4 bytes of one 16-code word and writes that word to all three code
// outputs: the little-endian 32-bit word itself (read_w2), its 16 codes as
// bytes (codes2, one 16-byte store) and as int32 (codes_i, four 16-byte
// stores). The first 2Bp threads also write lengths2 (lens twice). Every
// row is decoded whatever its length, padding rows too.
//
// What bounds it on this card: bytes. It reads W/2 bytes a read row and
// writes 2 x (W + 4W + W/4) bytes, most of it codes_i; a few integer
// operations a code. The design reads each input byte once, writes each
// output once with stores as wide as the layout allows, and keeps
// neighbouring threads on neighbouring words.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the 4 codes of one wire byte as 4 bytes, code 0 lowest
__device__ __forceinline__ unsigned spread(unsigned b) {
  return (b & 3u) | (((b >> 2) & 3u) << 8) | (((b >> 4) & 3u) << 16) |
         (((b >> 6) & 3u) << 24);
}

__global__ void unpack_kernel(const unsigned char* __restrict__ packed,
                              const int* __restrict__ lens, long long Bp,
                              long long W, long long n_words,
                              long long n_threads,
                              unsigned char* __restrict__ codes2,
                              int* __restrict__ codes_i,
                              unsigned* __restrict__ read_w2,
                              int* __restrict__ lengths2) {
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (g >= n_threads) return;
  if (g < 2 * Bp) lengths2[g] = __ldg(lens + (g % Bp));
  if (g >= n_words) return;
  const long long wq = W / 16;  // words a row
  const long long r = g / wq, w = g % wq;
  // forward half of read row r, or the rc half of read row r - Bp
  const unsigned char* src = packed + (r % Bp) * (W / 2) + (r / Bp) * (W / 4)
                             + 4 * w;
  const unsigned b0 = __ldg(src), b1 = __ldg(src + 1), b2 = __ldg(src + 2),
                 b3 = __ldg(src + 3);
  read_w2[g] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  const uint4 c8 = make_uint4(spread(b0), spread(b1), spread(b2), spread(b3));
  *reinterpret_cast<uint4*>(codes2 + r * W + 16 * w) = c8;
  int4* ci = reinterpret_cast<int4*>(codes_i + r * W + 16 * w);
  const unsigned bs[4] = {b0, b1, b2, b3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int b = static_cast<int>(bs[k]);
    ci[k] = make_int4(b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3);
  }
}

}  // namespace

extern "C" int dsb_unpack(const void* packed, const void* lens, long long Bp,
                          long long W, void* codes2, void* codes_i,
                          void* read_w2, void* lengths2, void* stream) {
  const long long n_words = 2 * Bp * (W / 16);
  const long long n = n_words > 2 * Bp ? n_words : 2 * Bp;
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    unpack_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(packed),
        static_cast<const int*>(lens), Bp, W, n_words, n,
        static_cast<unsigned char*>(codes2), static_cast<int*>(codes_i),
        static_cast<unsigned*>(read_w2), static_cast<int*>(lengths2));
  }
  return static_cast<int>(cudaGetLastError());
}
