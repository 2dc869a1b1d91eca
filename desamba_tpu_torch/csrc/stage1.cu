// Stage 1 of the fast path in one launch: the exist-filter probe on the
// STEP_EK grid, each probed k-mer's 13-base prefix, the top seed of each
// window and each row's hit count. One thread block per strand row.
//
// Replaces desamba_tpu/ops/ekmer.py:_probe_reads (with u64emu.hash64_1,
// hash64_2, _addr and _probe_both) and kmer_lo26, and
// desamba_tpu/ops/seeds.py:run_lengths and top_seeds, which
// desamba_tpu/engine/fast_engine.py:203-212 composes into stage 1.
//
// What bounds it on this card: every in-read grid point that passes the
// base-count filter reads two random 4-byte bloom words from bitmaps far
// larger than L2 (two 32-byte sectors), and the row's codes come in and
// its prefixes go out once: bytes, not operations. The JAX and plain
// versions emulate the 64-bit hashes on (hi, lo) 32-bit pairs through
// [rows, grid] temporaries; here each thread hashes in native uint64
// registers and nothing but the outputs reaches device memory.
//
// Design: the block stages its row's codes in shared memory once. Each
// thread takes grid points g = tid, tid + blockDim, ... (so the prefix
// stores coalesce), builds the k-mer while counting bases in the window
// (positions past the row's length do not count, but still enter the
// k-mer), and makes both bitmap reads only for a point that can hit; the
// hit goes to shared memory. Then each thread takes a contiguous chunk of
// the grid: a block-wide max-scan of "last miss at or before i" gives the
// run length ending at each point; one thread per window picks the
// longest run, the earliest on ties, by the plain version's encoding
// runlen * 2w + (w - 1 - position in window); the chunk hit counts add up
// to n_exist. The e-kmer, its filter and the bloom test are bloom.cuh's,
// which the validation engine's probe (probe.cu) shares.
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kPrefixMask = 0x3FFFFFFu;  // 13 bases (idx.h:59)

__global__ void __launch_bounds__(kThreads) stage1_kernel(
    const unsigned* __restrict__ w01, long long n_words0,
    const unsigned char* __restrict__ codes, const int* __restrict__ lengths,
    int W, int vec, int lek, int sbm, uint64_t hmask, int stride, int window,
    int n_g, int n_win, int* __restrict__ lo26, int* __restrict__ kidx,
    int* __restrict__ runlen, int* __restrict__ n_exist) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rl = reinterpret_cast<int*>(smem);             // [n_g] run lengths
  unsigned char* hit = smem + 4 * n_g;                // [n_g] probe hits
  unsigned char* s_codes = smem + ((5 * n_g + 15) & ~15);  // [W]
  __shared__ int s_warp_last[kThreads / 32];
  __shared__ int s_count;

  const long long row = blockIdx.x;
  const int len = lengths[row];
  const unsigned char* crow = codes + row * W;
  if (vec) {
    for (int i = threadIdx.x; i < W / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(s_codes)[i] =
          reinterpret_cast<const uint4*>(crow)[i];
  } else {
    for (int i = threadIdx.x; i < W; i += blockDim.x) s_codes[i] = crow[i];
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  // ---- probe: k-mer, base-count filter, both bloom bits, prefix
  const unsigned* w1 = w01 + n_words0;
  const int p0 = stride - 1;
  for (int g = threadIdx.x; g < n_g; g += blockDim.x) {
    const int p = p0 + stride * g;
    uint64_t k;
    unsigned prefix;
    const bool pass = dsb::ekmer(s_codes, p, len, lek, sbm, &k, &prefix);
    unsigned h = 0;
    if (pass && k != 0 && p + lek <= len)
      h = dsb::bloom_hit(w01, w1, k, hmask);
    hit[g] = static_cast<unsigned char>(h);
    lo26[row * n_g + g] = static_cast<int>(prefix & kPrefixMask);
  }
  __syncthreads();

  // ---- run lengths: max-scan of the last miss, one contiguous chunk a
  // thread
  const int chunk = (n_g + blockDim.x - 1) / blockDim.x;
  const int i0 = min(n_g, static_cast<int>(threadIdx.x) * chunk);
  const int i1 = min(n_g, i0 + chunk);
  int last = -1, hits = 0;
  for (int i = i0; i < i1; ++i) {
    if (hit[i]) ++hits; else last = i;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = last;  // inclusive max over this warp's threads up to lane
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = max(incl, o);
  }
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = -1;
  if (lane == 31) s_warp_last[warp] = incl;
  if (hits) atomicAdd(&s_count, hits);
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, s_warp_last[w]);
  for (int i = i0; i < i1; ++i) {
    if (hit[i]) {
      rl[i] = i - before;
    } else {
      rl[i] = 0;
      before = i;
    }
  }
  __syncthreads();

  // ---- top seed of each window: longest run end, earliest on ties
  for (int wi = threadIdx.x; wi < n_win; wi += blockDim.x) {
    const int base = wi * window;
    const int end = min(window, n_g - base);
    int best = -1;
    for (int j = 0; j < end; ++j) {
      const int r = rl[base + j];
      if (r > 0) best = max(best, r * 2 * window + (window - 1 - j));
    }
    const long long o = row * n_win + wi;
    kidx[o] = best >= 0 ? base + (window - 1) - best % (2 * window) : 0;
    runlen[o] = best >= 0 ? best / (2 * window) : 0;
  }
  if (threadIdx.x == 0) n_exist[row] = s_count;
}

}  // namespace

extern "C" int dsb_stage1(const void* w01, long long n_words0,
                          const void* codes, const void* lengths,
                          long long B2, int W, int lek, int sbm,
                          int mask_bits, int stride, int window, void* lo26,
                          void* kidx, void* runlen, void* n_exist,
                          void* stream) {
  const int n_g = (W - lek + 1 - stride) / stride + 1;
  const int n_win = (n_g + window - 1) / window;
  const size_t smem = ((5 * static_cast<size_t>(n_g) + 15) & ~size_t{15}) +
                      static_cast<size_t>(W);
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
    stage1_kernel<<<static_cast<unsigned>(B2), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(w01), n_words0,
        static_cast<const unsigned char*>(codes),
        static_cast<const int*>(lengths), W, vec, lek, sbm, hmask, stride,
        window, n_g, n_win, static_cast<int*>(lo26), static_cast<int*>(kidx),
        static_cast<int*>(runlen), static_cast<int*>(n_exist));
  }
  return static_cast<int>(cudaGetLastError());
}
