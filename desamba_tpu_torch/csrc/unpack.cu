// Stage 0: decode of the 2-bit wire format, a warp a tile of 128 words.
//
// Replaces desamba_tpu/engine/fast_engine.py:stage0_unpack and
// _read_words, with the int32 copy of the codes that _build_full makes
// for stage 2 (`codes2.astype(int32)`). The wire format holds, per read
// row, W/4 bytes of forward codes and then W/4 bytes of reverse-complement
// codes, 4 codes a byte, LSB first. Output row r < Bp is read row r's
// forward half, row Bp + r its reverse-complement half. Every row is
// decoded whatever its length, padding rows too; lengths2 is lens twice.
//
// The outputs, read as flat arrays, are in the order of a flat index g
// over the 2 Bp W/16 words of 16 codes (row g / (W/16), word g % (W/16)):
// word g is read_w2[g], codes2[16g, 16g + 16) and codes_i[16g, 16g + 16).
// A warp takes a tile of kTileWords consecutive g (grid-stride over the
// tiles), so each of its stores covers one contiguous span:
// - a lane loads its 4 words (16 wire bytes, 64 codes) with one 16-byte
//   load where they lie in one row, 16-byte aligned (W % 64 == 0), else
//   byte by byte (the ragged edge where W/16 is not a multiple of 4, or
//   packed at any byte offset), and its words of the warp's next tile
//   before it stores this one's;
// - it stores them to read_w2 as one 16-byte piece (lane i, piece i);
// - the tile's 512 wire bytes go to shared memory; then store k (0..3) of
//   codes2 has lane i expand word 32k + i into 16 code bytes, and store k
//   (0..15) of codes_i has lane i expand byte 32k + i into 4 int32 codes:
//   consecutive lanes write consecutive 16-byte pieces, so each store
//   instruction of a warp fills 16 whole 32-byte sectors.
// codes_i (4 bytes a code, 73% of the bytes) is written with evict-first
// stores (__stcs), so that it does not push codes2, which stage 1 reads
// next, out of L2. The grid is sized to the blocks the card holds at
// once; the first threads also write lengths2.
//
// What bounds it on this card: bytes. It reads W/2 bytes a read row and
// writes 2 x (W + 4W + W/4) bytes; a few integer operations a code. The
// earlier design (a thread a word, four 1-byte loads, four int4 stores
// at a 64-byte stride across the warp) wrote each sector in two halves
// from two instructions and ran at about half the byte rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileWords = 128;  // words a warp's tile: 4 a lane
constexpr int kMinBlocks = 4;    // blocks an SM holds: at most 64 registers

// the 4 codes of one wire byte as 4 bytes, code 0 lowest
__device__ __forceinline__ unsigned spread(unsigned b) {
  return (b & 3u) | (((b >> 2) & 3u) << 8) | (((b >> 4) & 3u) << 16) |
         (((b >> 6) & 3u) << 24);
}

// the wire bytes of flat word g: row r = g / Wq, the forward half of
// read row r (r < Bp) or the rc half of read row r - Bp; Wq = W / 16
__device__ __forceinline__ const unsigned char* wire_word(
    const unsigned char* packed, long long g, long long Bp, long long Wq) {
  const long long r = g / Wq, w = g - r * Wq;
  return packed + (r % Bp) * (8 * Wq) + (r / Bp) * (4 * Wq) + 4 * w;
}

// lane's 4 wire words from flat word g0 on: one 16-byte load (vec), else
// byte by byte, little-endian, at any alignment; zeros past the last word
__device__ __forceinline__ uint4 load_words(const unsigned char* packed,
                                           long long g0, long long Bp,
                                           long long Wq, long long n_words,
                                           bool vec) {
  if (vec) {
    return g0 < n_words ? __ldg(reinterpret_cast<const uint4*>(
                              wire_word(packed, g0, Bp, Wq)))
                        : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = 0u;
    if (g0 + k < n_words) {
      const unsigned char* b = wire_word(packed, g0 + k, Bp, Wq);
      x[k] = static_cast<unsigned>(__ldg(b)) |
             static_cast<unsigned>(__ldg(b + 1)) << 8 |
             static_cast<unsigned>(__ldg(b + 2)) << 16 |
             static_cast<unsigned>(__ldg(b + 3)) << 24;
    }
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) unpack_kernel(
    const unsigned char* __restrict__ packed, const int* __restrict__ lens,
    long long Bp, long long Wq, long long n_words, long long n_tiles,
    bool vec, unsigned char* __restrict__ codes2, int* __restrict__ codes_i,
    unsigned* __restrict__ read_w2, int* __restrict__ lengths2) {
  __shared__ uint4 stage[kWarps][32];  // a warp's tile of wire bytes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       j < 2 * Bp; j += stride) {
    lengths2[j] = __ldg(lens + (j < Bp ? j : j - Bp));
  }
  const unsigned* sw = reinterpret_cast<const unsigned*>(stage[warp]);
  const unsigned char* sb =
      reinterpret_cast<const unsigned char*>(stage[warp]);
  const long long t_stride = static_cast<long long>(gridDim.x) * kWarps;
  long long t = blockIdx.x * static_cast<long long>(kWarps) + warp;
  uint4 v = load_words(packed, t * kTileWords + 4 * lane, Bp, Wq, n_words,
                       vec);
  for (; t < n_tiles; t += t_stride) {
    const long long base = t * kTileWords;  // the tile's first word
    const long long g0 = base + 4 * lane;   // the lane's first word
    // the next tile's words, in flight while this tile is stored
    const uint4 next = load_words(packed, g0 + t_stride * kTileWords, Bp, Wq,
                                  n_words, vec);
    if (vec) {  // W % 64 == 0: the lane's 4 words as one piece
      if (g0 < n_words) *reinterpret_cast<uint4*>(read_w2 + g0) = v;
    } else {
      const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (g0 + k < n_words) read_w2[g0 + k] = x[k];
      }
    }
    stage[warp][lane] = v;
    __syncwarp();
    // the tile's words (kTileWords but in the last, ragged tile)
    const int rem = n_words - base < kTileWords
                        ? static_cast<int>(n_words - base) : kTileWords;
    uint4* c2 = reinterpret_cast<uint4*>(codes2) + base + lane;
    int4* ci = reinterpret_cast<int4*>(codes_i) + 4 * base + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // codes2: word 32k + lane of the tile
      if (32 * k + lane < rem) {
        const unsigned x = sw[32 * k + lane];
        c2[32 * k] = make_uint4(spread(x & 255u), spread((x >> 8) & 255u),
                                spread((x >> 16) & 255u), spread(x >> 24));
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // codes_i: byte 32k + lane of the tile
      if (((32 * k + lane) >> 2) < rem) {
        const int x = sb[32 * k + lane];
        __stcs(ci + 32 * k,
               make_int4(x & 3, (x >> 2) & 3, (x >> 4) & 3, (x >> 6) & 3));
      }
    }
    __syncwarp();  // the tile's bytes are read before the next overwrites
    v = next;
  }
}

// blocks of kThreads that the card holds at once (cached per device)
int resident_blocks() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, unpack_kernel, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

}  // namespace

extern "C" int dsb_unpack(const void* packed, const void* lens, long long Bp,
                          long long W, void* codes2, void* codes_i,
                          void* read_w2, void* lengths2, void* stream) {
  const long long Wq = W / 16;
  const long long n_words = 2 * Bp * Wq;
  const long long n_tiles = (n_words + kTileWords - 1) / kTileWords;
  long long blocks = (n_tiles + kWarps - 1) / kWarps;
  const long long len_blocks = (2 * Bp + kThreads - 1) / kThreads;
  if (len_blocks > blocks) blocks = len_blocks;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const int most = resident_blocks();
  if (most <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks > most) blocks = most;
  const bool vec = Wq % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(read_w2) % 16 == 0;
  unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(packed),
      static_cast<const int*>(lens), Bp, Wq, n_words, n_tiles, vec,
      static_cast<unsigned char*>(codes2), static_cast<int*>(codes_i),
      static_cast<unsigned*>(read_w2), static_cast<int*>(lengths2));
  return static_cast<int>(cudaGetLastError());
}
