// Stage 1 of the fast path in one launch: the exist-filter probe on the
// STEP_EK grid, each probed k-mer's 13-base prefix, the top seed of each
// window and each row's hit count. One warp per strand row.
//
// Replaces desamba_tpu/ops/ekmer.py:_probe_reads (with u64emu.hash64_1,
// hash64_2, _addr and _probe_both) and kmer_lo26, and
// desamba_tpu/ops/seeds.py:run_lengths and top_seeds, which
// desamba_tpu/engine/fast_engine.py:203-212 composes into stage 1.
//
// What bounds it on this card: every in-read grid point that passes the
// base-count filter reads a random 4-byte word of bloom bitmap 1, and
// where its bit is set one of bitmap 2 (a 32-byte sector each, from
// bitmaps larger than L2); the row's codes come in and its prefixes go
// out once. The arithmetic is the two 64-bit hashes a probed point.
//
// Design: a warp owns a row and stages its codes in shared memory. Lane l
// takes the contiguous run of grid points [l * per, (l + 1) * per), per
// the smallest run >= ceil(n_g / 32) at which the 32 lanes' code reads,
// 3 * per bytes apart, fall at most two words to a shared-memory bank
// (lane_run, looked up in a table made at load; at per = 32 they would
// fall eight to a bank, a measured loss at W = 3072). It builds the first
// k-mer and the per-base counts of its window in full, then rolls both by
// STEP_EK codes a point (shift in three codes and mask to 2 * lek bits;
// add the three codes that enter the window to the counts and take off
// the three that leave it). The
// rolled k-mer equals the full build only for codes 0-3, which is stage
// 1's contract. Points go in batches of kBatch: all hashes first, then all
// bitmap-1 loads in flight at once, then the bitmap-2 loads of the points
// whose first bit is set. Base counts include positions at or past the
// row's length; the probe needs p + lek <= len, so a window that reaches
// past len is never probed and its counts do not matter. Each point's
// prefix, with its hit in bit 31, goes to shared memory, padded one word
// in 32 (pad) so that the lanes' stores spread over the banks. Then lane
// w takes window w (and w + 32, ...): its hits as a bit mask, the last
// miss before it by a max-scan over the lanes, the longest run end,
// earliest on ties, by the plain version's encoding runlen * 2w + (w - 1
// - position in window). n_exist is a warp sum. No block-wide barrier:
// the warps of a block are independent rows.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom.cuh"

namespace {

constexpr int kWarps = 4;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = 3;  // STEP_EK: the grid step the k-mers roll by
constexpr int kBatch = 8;   // points a lane probes with their loads in flight
constexpr unsigned kPrefixMask = 0x3FFFFFFu;  // 13 bases (idx.h:59)
constexpr unsigned kFull = 0xffffffffu;

// Index of grid point g in the staged points: one word of padding in 32.
__device__ __forceinline__ int pad(int g) { return g + (g >> 5); }

// Points a lane takes (see the design note): the smallest run >= first =
// ceil(n_g / 32) at which lanes 3 * run bytes apart read at most two
// distinct words of one bank, at each byte offset. A lane's word is never
// below the lane before's, so a word is new where it differs from that.
int lane_run(int first) {
  for (int run = first; run < first + 8; ++run) {
    int worst = 0;
    for (int off = 0; off < 4; ++off) {
      int per_bank[32] = {};
      for (int l = 0; l < 32; ++l) {
        const int w = (off + kStride * run * l) / 4;
        if (l == 0 || w != (off + kStride * run * (l - 1)) / 4)
          worst = std::max(worst, ++per_bank[w % 32]);
      }
    }
    if (worst <= 2) return run;
  }
  return first;
}

// lane_run of every first below kRunTable (n_g < 4,096: W up to ~12,300),
// made once when the library loads, so that a launch only looks it up.
constexpr int kRunTable = 128;
struct RunTable {
  int run[kRunTable];
  RunTable() {
    for (int f = 0; f < kRunTable; ++f) run[f] = lane_run(f);
  }
};
const RunTable kRuns;

int run_of(int n_g) {
  const int first = n_g > 0 ? (n_g + 31) / 32 : 0;
  return first < kRunTable ? kRuns.run[first] : lane_run(first);
}

// Word index and bit shift of bloom bit h: byte h >> 3, bit 7 - (h & 7)
// (idx.c:1019), the bytes held as little-endian 32-bit words.
__device__ __forceinline__ void bloom_addr(uint64_t h, unsigned& word,
                                           unsigned& shift) {
  word = static_cast<unsigned>(h >> 5);
  shift = static_cast<unsigned>(((h >> 3) & 3) * 8 + 7 - (h & 7));
}

__global__ void __launch_bounds__(kThreads) stage1_kernel(
    const unsigned* __restrict__ w01, long long n_words0,
    const unsigned char* __restrict__ codes, const int* __restrict__ lengths,
    long long B2, int W, int vec, int lek, int sbm, uint64_t hmask,
    int window, int n_g, int n_win, int per, int warp_bytes,
    int* __restrict__ lo26,
    int* __restrict__ kidx, int* __restrict__ runlen,
    int* __restrict__ n_exist) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= B2) return;
  unsigned char* s_codes = smem + warp * warp_bytes;            // [W]
  unsigned* s_pt = reinterpret_cast<unsigned*>(  // [pad(n_g)]
      s_codes + ((W + 15) & ~15));

  const int len = lengths[row];
  const unsigned char* crow = codes + row * W;
  if (vec) {
    for (int i = lane; i < W / 16; i += 32)
      reinterpret_cast<uint4*>(s_codes)[i] =
          reinterpret_cast<const uint4*>(crow)[i];
  } else {
    for (int i = lane; i < W; i += 32) s_codes[i] = crow[i];
  }
  __syncwarp();

  // ---- probe: a contiguous run of grid points a lane, rolled
  // the filter fails where a base's count (a byte of counts, at most lek
  // <= 31) is >= sbm: that byte + (128 - sbm) reaches bit 7; sbm <= 0
  // fails every window and sbm > 31 none
  const int sbm_c = min(max(sbm, 0), 32);
  const unsigned bias = static_cast<unsigned>(128 - sbm_c) * 0x01010101u;
  const uint64_t kmask = (uint64_t{1} << (2 * lek)) - 1;
  const unsigned* w1 = w01 + n_words0;
  const int g0 = min(n_g, lane * per), g1 = min(n_g, g0 + per);
  int hits = 0;
  if (g0 < g1) {
    int p = kStride - 1 + kStride * g0;
    uint64_t k = 0;
    unsigned counts = 0;  // one byte a base: its count in [p, p + lek)
    for (int j = 0; j < lek; ++j) {
      const unsigned c = s_codes[p + j];
      k = (k << 2) | c;
      counts += 1u << (8 * c);
    }
    for (int gb = g0; gb < g1; gb += kBatch) {
      unsigned lo[kBatch], wa[kBatch], sa[kBatch], wb[kBatch], sb[kBatch];
      unsigned want = 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int g = gb + j;
        lo[j] = wa[j] = sa[j] = wb[j] = sb[j] = 0;
        if (g >= g1) continue;
        if (g > g0) {  // roll from point g - 1 to point g
          p += kStride;
#pragma unroll
          for (int t = 0; t < kStride; ++t) {
            const unsigned cin = s_codes[p + lek - kStride + t];
            const unsigned cout = s_codes[p - kStride + t];
            k = (k << 2) | cin;
            counts += (1u << (8 * cin)) - (1u << (8 * cout));
          }
          k &= kmask;
        }
        lo[j] = static_cast<unsigned>(k) & kPrefixMask;
        if (sbm_c > 0 && ((counts + bias) & 0x80808080u) == 0 && k != 0 &&
            p + lek <= len) {
          want |= 1u << j;
          bloom_addr(dsb::hash64_1(k) & hmask, wa[j], sa[j]);
          bloom_addr(dsb::hash64_2(k) & hmask, wb[j], sb[j]);
        }
      }
      // every bitmap-1 load of the batch in flight, then bitmap 2 only
      // where bitmap 1's bit is set
      unsigned v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = (want >> j) & 1u ? __ldg(w01 + wa[j]) : 0u;
      unsigned want2 = 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) want2 |= ((v[j] >> sa[j]) & 1u) << j;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = (want2 >> j) & 1u ? __ldg(w1 + wb[j]) : 0u;
      unsigned hit = 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) hit |= ((v[j] >> sb[j]) & 1u) << j;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (gb + j < g1)
          s_pt[pad(gb + j)] = lo[j] | (((hit >> j) & 1u) << 31);
      hits += __popc(hit);
    }
  }
  __syncwarp();

  // ---- top seed of each window: a window a lane
  int carry = -1;  // the last miss before this group of 32 windows
  for (int wg = 0; wg < n_win; wg += 32) {
    const int wi = wg + lane;
    const int base = wi * window;
    const int end = wi < n_win ? min(window, n_g - base) : 0;
    uint64_t m = 0;  // bit j: point base + j hit
    for (int j = 0; j < end; ++j)
      m |= static_cast<uint64_t>(s_pt[pad(base + j)] >> 31) << j;
    const uint64_t miss = ~m & ((uint64_t{1} << end) - 1);
    int incl = miss ? base + 63 - __clzll(static_cast<long long>(miss)) : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = -1;
    before = max(before, carry);
    carry = max(carry, __shfl_sync(kFull, incl, 31));
    if (wi < n_win) {
      int best = -1;
      for (int j = 0; j < end; ++j) {
        if ((m >> j) & 1u)
          best = max(best,
                     (base + j - before) * 2 * window + (window - 1 - j));
        else
          before = base + j;
      }
      const long long o = row * n_win + wi;
      kidx[o] = best >= 0 ? base + (window - 1) - best % (2 * window) : 0;
      runlen[o] = best >= 0 ? best / (2 * window) : 0;
    }
  }
  const int total = __reduce_add_sync(kFull, hits);
  if (lane == 0) n_exist[row] = total;
  int* out = lo26 + row * n_g;
  for (int g = lane; g < n_g; g += 32)
    out[g] = static_cast<int>(s_pt[pad(g)] & kPrefixMask);
}

}  // namespace

extern "C" int dsb_stage1(const void* w01, long long n_words0,
                          const void* codes, const void* lengths,
                          long long B2, int W, int lek, int sbm,
                          int mask_bits, int stride, int window, void* lo26,
                          void* kidx, void* runlen, void* n_exist,
                          void* stream) {
  if (stride != kStride || lek < 13 || lek > 31 || window < 1 ||
      window > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_g = (W - lek + 1 - stride) / stride + 1;
  const int n_win = (n_g + window - 1) / window;
  const int warp_bytes = ((W + 15) & ~15) + ((4 * (n_g + n_g / 32 + 1) + 15)
                                            & ~15);
  const size_t smem = static_cast<size_t>(kWarps) * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec =
      W % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const uint64_t hmask = (uint64_t{1} << mask_bits) - 1;
  if (B2 > 0) {
    const long long blocks = (B2 + kWarps - 1) / kWarps;
    stage1_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(w01), n_words0,
        static_cast<const unsigned char*>(codes),
        static_cast<const int*>(lengths), B2, W, vec, lek, sbm, hmask,
        window, n_g, n_win, run_of(n_g), warp_bytes,
        static_cast<int*>(lo26),
        static_cast<int*>(kidx), static_cast<int*>(runlen),
        static_cast<int*>(n_exist));
  }
  return static_cast<int>(cudaGetLastError());
}
