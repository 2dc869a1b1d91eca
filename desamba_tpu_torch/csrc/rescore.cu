// Stage 4 around the band scorer: the candidate-window gather before it
// (band_windows, one block per candidate) and the strand and candidate
// combine after it (combine, one thread per read).
//
// Replaces the plain parts of desamba_tpu/engine/fast_engine.py's stage4:
// - band_windows: the 16-aligned word gather from ref_words_lsb, the
//   reference bounds rel_lo / rel_hi of each candidate, and the per-
//   candidate copies of the read words and length that band_score_packed
//   takes (lines 433-449);
// - combine: the fold of the [B2, C] candidates into [B, 2C] (forward
//   strand first), the -1 mask of candidates without a reference, the
//   best score and the reference's odd/even tie order (an odd best takes
//   the highest tied ref, an even one the lowest, cly.c:62), the first
//   candidate of that ref, and score, ref, direction, cov, pos and the
//   best other-ref score (lines 450-490), written as int32[6, B] in the
//   order score, ref, direction, cov, pos, score_alt.
//
// Every output element equals the plain version's, rows without a hit
// included. The plain version's int32 arithmetic wraps (diag_c of a row
// with no valid anchor can be any int32), so these kernels add and
// subtract in uint32 and shift the aligned start arithmetically; every
// gather index is clamped as the plain version clamps it.
//
// What bounds them on this card: bytes. band_windows writes
// B2*C*(W/16 + nw + 3) int32 and reads one window of ref_words_lsb a
// candidate; combine reads 5 int32 a candidate and writes 6 a read. Both
// do a few integer operations an element. band_windows gives each
// candidate a block whose threads copy consecutive words; combine keeps a
// read's 2C candidates in registers across its passes.
#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace {

using dsb::add_wrap;
using dsb::sub_wrap;

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void band_windows_kernel(
    const int* __restrict__ ref_c, const int* __restrict__ diag_c,
    const int* __restrict__ read_w2, const int* __restrict__ lengths2,
    const int* __restrict__ ref_words, long long total_w,
    const int* __restrict__ ref_offset, const int* __restrict__ ref_len,
    long long n_ref, long long C, long long Wq, long long nw, int band,
    int* __restrict__ rw_f, int* __restrict__ rl_f, int* __restrict__ win_w,
    int* __restrict__ rel_lo, int* __restrict__ rel_hi) {
  const long long f = blockIdx.x;  // candidate b * C + c
  const long long lane = f / C;
  // the band's start aligned down to a 16-code word: (diag - band) & ~15
  const int g0a = static_cast<int>(
      (static_cast<unsigned>(diag_c[f]) - static_cast<unsigned>(band)) &
      ~15u);
  const long long w0 = g0a >> 4;  // arithmetic: a floor division by 16
  for (long long j = threadIdx.x; j < nw; j += blockDim.x) {
    win_w[f * nw + j] = __ldg(ref_words + clamp_index(w0 + j, total_w));
  }
  for (long long j = threadIdx.x; j < Wq; j += blockDim.x) {
    rw_f[f * Wq + j] = __ldg(read_w2 + lane * Wq + j);
  }
  if (threadIdx.x == 0) {
    rl_f[f] = __ldg(lengths2 + lane);
    const int r = ref_c[f];
    const long long rc = clamp_index(r, n_ref);
    const int lo = __ldg(ref_offset + rc);
    const int hi = add_wrap(lo, __ldg(ref_len + rc));
    rel_lo[f] = r >= 0 ? sub_wrap(lo, g0a) : 0;
    rel_hi[f] = r >= 0 ? sub_wrap(hi, g0a) : 0;
  }
}

__global__ void combine_kernel(
    const int* __restrict__ score, const int* __restrict__ q_st,
    const int* __restrict__ q_ed, const int* __restrict__ ref_c,
    const int* __restrict__ diag_c, const int* __restrict__ ref_offset,
    long long n_ref, long long B, int C, int* __restrict__ out) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (b >= B) return;
  const int n = 2 * C;
  // candidate k < C is row b's k-th, k >= C row B + b's (k - C)-th
  auto at = [&](int k) -> long long {
    return k < C ? b * C + k : (B + b) * C + (k - C);
  };
  auto score4 = [&](int k) -> int {
    const long long f = at(k);
    return ref_c[f] >= 0 ? score[f] : -1;
  };
  int s_max = score4(0);
  for (int k = 1; k < n; ++k) s_max = max(s_max, score4(k));
  // the tie order: odd (s_max & 1, so also s_max = -1) the highest tied
  // ref, even the lowest; the first candidate holding it, else 0
  int r_hi = -1;
  long long r_lo = n_ref + 1;
  for (int k = 0; k < n; ++k) {
    if (score4(k) == s_max) {
      const int r = ref_c[at(k)];
      r_hi = max(r_hi, r);
      r_lo = min(r_lo, static_cast<long long>(r));
    }
  }
  const long long r_best = (s_max & 1) ? r_hi : r_lo;
  int cb = 0;
  for (int k = 0; k < n; ++k) {
    if (score4(k) == s_max && ref_c[at(k)] == r_best) {
      cb = k;
      break;
    }
  }
  const long long fb = at(cb);
  const int ref_b = s_max > 0 ? ref_c[fb] : -1;
  const int pos = sub_wrap(add_wrap(diag_c[fb], q_st[fb]),
                           __ldg(ref_offset + clamp_index(ref_b, n_ref)));
  int alt = -1;
  for (int k = 0; k < n; ++k) {
    const int r = ref_c[at(k)];
    if (r != ref_b && r >= 0) alt = max(alt, score4(k));
  }
  out[b] = max(s_max, 0);
  out[B + b] = ref_b;
  out[2 * B + b] = cb >= C ? 0 : 1;  // 1 = forward
  out[3 * B + b] = max(sub_wrap(q_ed[fb], q_st[fb]), 0);
  out[4 * B + b] = ref_b >= 0 ? pos : -1;
  out[5 * B + b] = max(alt, 0);
}

}  // namespace

extern "C" int dsb_band_windows(
    const void* ref_c, const void* diag_c, const void* read_w2,
    const void* lengths2, const void* ref_words, long long total_w,
    const void* ref_offset, const void* ref_len, long long n_ref,
    long long n_cand, long long C, long long Wq, long long nw, int band,
    void* rw_f, void* rl_f, void* win_w, void* rel_lo, void* rel_hi,
    void* stream) {
  if (n_cand > 0) {
    band_windows_kernel<<<static_cast<unsigned>(n_cand), 128, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ref_c), static_cast<const int*>(diag_c),
        static_cast<const int*>(read_w2), static_cast<const int*>(lengths2),
        static_cast<const int*>(ref_words), total_w,
        static_cast<const int*>(ref_offset), static_cast<const int*>(ref_len),
        n_ref, C, Wq, nw, band, static_cast<int*>(rw_f),
        static_cast<int*>(rl_f), static_cast<int*>(win_w),
        static_cast<int*>(rel_lo), static_cast<int*>(rel_hi));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_combine(const void* score, const void* q_st,
                           const void* q_ed, const void* ref_c,
                           const void* diag_c, const void* ref_offset,
                           long long n_ref, long long B, int C, void* out,
                           void* stream) {
  if (B > 0) {
    const int threads = 128;
    const long long blocks = (B + threads - 1) / threads;
    combine_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(score), static_cast<const int*>(q_st),
        static_cast<const int*>(q_ed), static_cast<const int*>(ref_c),
        static_cast<const int*>(diag_c), static_cast<const int*>(ref_offset),
        n_ref, B, C, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
