// SWAR banded match scorer on 2-bit packed words, one block per row.
//
// Replaces desamba_tpu/ops/matchblock.py:band_score_packed (with _pairmask
// and _hibit): the device get_score_M2 analog. For each read word w and
// band offset k = 16 j + m, the window is funnel-shifted by m codes,
// XNORed with the read word and pair-ANDed down to one bit per code,
// masked to the valid window range [rel_lo, rel_hi) and the read length;
// eight more funnel-shifted ANDs (across into word w + 1) leave the bits
// that start a >= 9-code exact run. OR over all band offsets gives acc[w].
// Shifting acc by 8 codes (carrying across words) marks run ends; the
// score is their popcount and q_st / q_ed come from the lowest and
// highest set bits.
//
// What bounds it on this card: integer ALU work, about K/16 * 16 * 2 word
// compares of ~25 instructions per read word; the inputs are a few KB per
// row and stay in L1/L2. The design maps the SWAR steps onto Hopper's
// __funnelshift_r, __popc, __ffs and __clz, gives each thread whole read
// words so nothing crosses threads until acc is done, then reduces the
// row in shared memory with integer atomics (min, max and sum do not
// depend on order, so the result is exact).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kEven = 0x55555555u;
constexpr int kRun = 9;  // S_A_KMER_L

// Mask of the first n 2-bit code slots, n in [0, 16]; never shifts by 32.
__device__ __forceinline__ unsigned pairmask(int n) {
  return n >= 16 ? 0xFFFFFFFFu : ((1u << (2 * n)) - 1u);
}

__device__ __forceinline__ int clamp16(int v) {
  return v < 0 ? 0 : (v > 16 ? 16 : v);
}

// One bit per code (at the even bit 2t) where read code 16 w + t equals
// window code 16 (w + j) + m + t and both are valid.
__device__ __forceinline__ unsigned eq_word(
    const unsigned* __restrict__ rw, const unsigned* __restrict__ ww, int w,
    int j, int m, int rel_lo, int rel_hi, int rlen) {
  const unsigned a = __funnelshift_r(ww[j + w], ww[j + w + 1], 2 * m);
  const unsigned x = ~(rw[w] ^ a);
  const int base = 16 * (w + j) + m;
  const unsigned valid = pairmask(clamp16(rel_hi - base)) &
                         ~pairmask(clamp16(rel_lo - base)) &
                         pairmask(clamp16(rlen - 16 * w));
  return x & (x >> 1) & kEven & valid;
}

__global__ void band_score_kernel(
    const unsigned* __restrict__ read_w, const int* __restrict__ rlen,
    const unsigned* __restrict__ win_w, const int* __restrict__ rel_lo,
    const int* __restrict__ rel_hi, int Wq, int NW, int nj,
    int* __restrict__ score, int* __restrict__ q_st,
    int* __restrict__ q_ed) {
  extern __shared__ unsigned acc[];  // [Wq]
  __shared__ int s_score, s_qst, s_qed;
  const long long b = blockIdx.x;
  const unsigned* rw = read_w + b * Wq;
  const unsigned* ww = win_w + b * NW;
  const int lo = rel_lo[b], hi = rel_hi[b], rl = rlen[b];
  const int W = 16 * Wq;
  if (threadIdx.x == 0) {
    s_score = 0;
    s_qst = W;
    s_qed = -1;
  }
  for (int w = threadIdx.x; w < Wq; w += blockDim.x) {
    unsigned a = 0;
    for (int j = 0; j < nj; ++j) {
      for (int m = 0; m < 16; ++m) {
        const unsigned e0 = eq_word(rw, ww, w, j, m, lo, hi, rl);
        const unsigned e1 =
            w + 1 < Wq ? eq_word(rw, ww, w + 1, j, m, lo, hi, rl) : 0u;
        unsigned r9 = e0;
#pragma unroll
        for (int i = 1; i < kRun; ++i) r9 &= __funnelshift_r(e0, e1, 2 * i);
        a |= r9;
      }
    }
    acc[w] = a;
  }
  __syncthreads();
  int my_score = 0, my_qst = W, my_qed = -1;
  for (int w = threadIdx.x; w < Wq; w += blockDim.x) {
    // run-start bit at q -> run-end bit at q + 8
    const unsigned prev = w > 0 ? acc[w - 1] : 0u;
    const unsigned e = __funnelshift_l(prev, acc[w], 2 * (kRun - 1));
    if (e != 0u) {
      my_score += __popc(e);
      const int q0 = 16 * w + ((__ffs(e) - 1) >> 1);
      const int q1 = 16 * w + ((31 - __clz(e)) >> 1);
      my_qst = q0 < my_qst ? q0 : my_qst;
      my_qed = q1 > my_qed ? q1 : my_qed;
    }
  }
  if (my_score) {
    atomicAdd(&s_score, my_score);
    atomicMin(&s_qst, my_qst);
    atomicMax(&s_qed, my_qed);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool has = s_score > 0;
    score[b] = s_score;
    q_st[b] = has ? s_qst : W;
    q_ed[b] = has ? s_qed : -1;
  }
}

}  // namespace

extern "C" int dsb_band_score(const void* read_w, const void* rlen,
                              const void* win_w, const void* rel_lo,
                              const void* rel_hi, long long B, int Wq, int NW,
                              int K, void* score, void* q_st, void* q_ed,
                              void* stream) {
  if (B > 0) {
    const int threads = Wq < 128 ? 64 : 128;
    band_score_kernel<<<static_cast<unsigned>(B), threads,
                        Wq * sizeof(unsigned),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(read_w), static_cast<const int*>(rlen),
        static_cast<const unsigned*>(win_w), static_cast<const int*>(rel_lo),
        static_cast<const int*>(rel_hi), Wq, NW, K / 16,
        static_cast<int*>(score), static_cast<int*>(q_st),
        static_cast<int*>(q_ed));
  }
  return static_cast<int>(cudaGetLastError());
}
