// Stage 4 around the band scorer: the candidate-window gather before it
// (band_windows, a warp a read row) and the strand and candidate combine
// after it (combine, one thread per read).
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
// What bounds them on this card: band_windows moves bytes (it writes
// B2*C*(W/16 + nw + 3) int32 and reads the read words once and one window
// of ref_words_lsb a candidate) but a call is short enough that its
// dependent loads show: the candidate's diagonal before its window, its
// ref before the bounds. The earlier design (a block of 128 threads a
// candidate) loaded the read row once a candidate, left most threads of
// its second window pass idle and ended every block with one thread's
// chain of dependent loads. Here a warp takes a read row and its C
// candidates (kRows rows a block): lanes 0..C-1 load the candidates
// first, then every lane loads its pieces of the read row, so the
// candidates' loads and the bounds' dependent loads overlap the row's;
// the row is stored C times from registers, VR words a store; the C
// windows, contiguous in win_w, are one span of C*nw words that the warp
// gathers (each lane all its loads of a batch before its stores, the
// window start of candidate c from lane c by a shuffle) and stores VW
// words a store. Two variants: VR = 4, VW = 2 (16-byte row pieces,
// 8-byte window pieces), which every width of the path takes (W/16 a
// multiple of 4, nw = W/16 + K/16 + 1 even: 138 at W = 2048), and
// VR = VW = 1 for any other width or alignment.
// combine reads 5 int32 a candidate and writes 6 a read: a few hundred KB
// a chunk, ~0.2 us of bytes, so its time is its launch and its rounds of
// dependent loads. The earlier design (a thread a read, 128 a block)
// looped over the candidates with a runtime count, loading each
// candidate's ref before its score, then the chosen candidate's fields,
// then ref_offset at the chosen ref: five or more rounds of DRAM latency
// one after another. Here a block of kCombineReads reads (one warp, 128
// blocks at B = 4096) stages the block's spans of the five candidate
// arrays, both strands, and, up to kRefStageMax refs, the whole
// ref_offset table into shared memory with asynchronous copies (16-byte
// where the spans align, which they do at the path's shapes), all in
// flight at once: one round of loads. The pick then reads shared memory
// only (above kRefStageMax refs, one global load of ref_offset at the
// chosen ref). Templated on C: the path's 3, loops unrolled, and a
// generic variant for any C up to kCombineMaxC.
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "wrap.cuh"

namespace {

using dsb::add_wrap;
using dsb::sub_wrap;

constexpr int kRows = 8;     // read rows (warps) a block of band_windows
constexpr int kRowRegs = 4;  // row pieces a lane holds at once
constexpr int kWinBatch = 8; // window pieces a lane loads before storing
constexpr int kCombineReads = 32;  // reads (threads) a block of combine
constexpr int kCombineMaxC = 32;   // candidates a row of combine at most
constexpr int kRefStageMax = 1024; // ref_offset entries staged at most

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// V consecutive words as one load or store of 4V bytes
template <int V>
__device__ __forceinline__ void load_words(const int* src, unsigned (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (V == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = static_cast<unsigned>(__ldg(src));
  }
}

template <int V>
__device__ __forceinline__ void store_words(int* dst, const unsigned (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(x[0], x[1]);
  } else {
    *dst = static_cast<int>(x[0]);
  }
}

// One warp a read row b: its C candidates f = b*C + c. VR: words a store
// of the row copies (Wq % VR == 0); VW: of the windows (nw % VW == 0).
template <int VR, int VW>
__global__ void __launch_bounds__(32 * kRows) band_windows_kernel(
    const int* __restrict__ ref_c, const int* __restrict__ diag_c,
    const int* __restrict__ read_w2, const int* __restrict__ lengths2,
    const int* __restrict__ ref_words, long long total_w,
    const int* __restrict__ ref_offset, const int* __restrict__ ref_len,
    long long n_ref, long long B2, int C, long long Wq, long long nw,
    int band, int* __restrict__ rw_f, int* __restrict__ rl_f,
    int* __restrict__ win_w, int* __restrict__ rel_lo,
    int* __restrict__ rel_hi) {
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.x * static_cast<long long>(kRows) +
                      (threadIdx.x >> 5);
  if (b >= B2) return;
  const long long f0 = b * C;  // the row's first candidate
  // lane c < C: candidate c's ref, diagonal and the row's length, loaded
  // before anything else
  const bool cand = lane < C;
  int r = -1, d = 0, rl = 0;
  if (cand) {
    r = __ldg(ref_c + f0 + lane);
    d = __ldg(diag_c + f0 + lane);
    rl = __ldg(lengths2 + b);
  }
  // the row's first pieces (VR words each), lane i pieces i + 32k
  const long long n_pieces = Wq / VR;
  const int* row = read_w2 + b * Wq;
  unsigned x[kRowRegs][VR];
#pragma unroll
  for (int k = 0; k < kRowRegs; ++k) {
    const long long p = lane + 32 * k;
    if (p < n_pieces) load_words<VR>(row + p * VR, x[k]);
  }
  // the band's start aligned down to a 16-code word, (diag - band) & ~15,
  // and the bounds' loads of the candidate's ref (clamped)
  const int g0a = static_cast<int>(
      (static_cast<unsigned>(d) - static_cast<unsigned>(band)) & ~15u);
  const int w0 = g0a >> 4;  // arithmetic: a floor division by 16
  int lo = 0, len = 0;
  if (cand) {
    const long long rc = clamp_index(r, n_ref);
    lo = __ldg(ref_offset + rc);
    len = __ldg(ref_len + rc);
  }
  // the row, C times: chunks of 32 * kRowRegs pieces
  for (long long p0 = 0; p0 < n_pieces; p0 += 32 * kRowRegs) {
    if (p0 > 0) {
#pragma unroll
      for (int k = 0; k < kRowRegs; ++k) {
        const long long p = p0 + lane + 32 * k;
        if (p < n_pieces) load_words<VR>(row + p * VR, x[k]);
      }
    }
    for (int c = 0; c < C; ++c) {
      int* dst = rw_f + (f0 + c) * Wq;
#pragma unroll
      for (int k = 0; k < kRowRegs; ++k) {
        const long long p = p0 + lane + 32 * k;
        if (p < n_pieces) store_words<VR>(dst + p * VR, x[k]);
      }
    }
  }
  // the C windows: one span of C * nw words at win_w + f0 * nw, in pieces
  // of VW words; piece p is word q = p * VW of candidate q / nw
  const unsigned span = static_cast<unsigned>(C * nw / VW);
  int* wdst = win_w + f0 * nw;
  for (unsigned p0 = 0; p0 < span; p0 += 32 * kWinBatch) {
    unsigned y[kWinBatch][VW];
#pragma unroll
    for (int k = 0; k < kWinBatch; ++k) {
      const unsigned p = p0 + lane + 32 * k;
      const unsigned q = p * VW;
      const unsigned c = p < span ? q / static_cast<unsigned>(nw) : 0u;
      // every lane takes part in the shuffle; c < C <= 32
      const long long start = __shfl_sync(0xffffffffu, w0, c) +
                              static_cast<long long>(q - c * nw);
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        y[k][v] = p < span ? static_cast<unsigned>(__ldg(
                                 ref_words + clamp_index(start + v, total_w)))
                           : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kWinBatch; ++k) {
      const unsigned p = p0 + lane + 32 * k;
      if (p < span) store_words<VW>(wdst + p * VW, y[k]);
    }
  }
  if (cand) {
    const long long f = f0 + lane;
    rl_f[f] = rl;
    rel_lo[f] = r >= 0 ? sub_wrap(lo, g0a) : 0;
    rel_hi[f] = r >= 0 ? sub_wrap(add_wrap(lo, len), g0a) : 0;
  }
}

template <int VR, int VW>
void launch_band_windows(long long blocks, cudaStream_t stream,
                         const int* ref_c, const int* diag_c,
                         const int* read_w2, const int* lengths2,
                         const int* ref_words, long long total_w,
                         const int* ref_offset, const int* ref_len,
                         long long n_ref, long long B2, int C, long long Wq,
                         long long nw, int band, int* rw_f, int* rl_f,
                         int* win_w, int* rel_lo, int* rel_hi) {
  band_windows_kernel<VR, VW><<<static_cast<unsigned>(blocks), 32 * kRows,
                                0, stream>>>(
      ref_c, diag_c, read_w2, lengths2, ref_words, total_w, ref_offset,
      ref_len, n_ref, B2, C, Wq, nw, band, rw_f, rl_f, win_w, rel_lo,
      rel_hi);
}

// whether v words divide n and every pointer aligns to 4v bytes
bool fits(int v, long long n, const void* a, const void* b) {
  return n % v == 0 && reinterpret_cast<uintptr_t>(a) % (4 * v) == 0 &&
         reinterpret_cast<uintptr_t>(b) % (4 * v) == 0;
}

// Copies n words from global src to shared dst without holding them in
// registers (cp.async): 16-byte copies where kVec (src and dst 16-byte
// aligned), 4-byte ones for the rest; all of a thread's copies are in
// flight at once. The caller commits and waits.
template <bool kVec>
__device__ __forceinline__ void stage_words(int* dst, const int* src, int n) {
  int i = threadIdx.x;
  if constexpr (kVec) {
    const int n4 = n >> 2;
    for (int p = threadIdx.x; p < n4; p += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * p, src + 4 * p, 16);
    i += 4 * n4;
  }
  for (; i < n; i += blockDim.x) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// One thread a read b, kCombineReads reads a block. Round 1 stages the
// block's candidates (for each of score, q_st, q_ed, ref_c, diag_c the
// forward span [b0*C, (b0+nb)*C) and the reverse-complement span
// [(B+b0)*C, (B+b0+nb)*C), each in its own slot of shared memory) and,
// where kStageRefs, the whole ref_offset table; after it every read of
// the pick comes from shared memory, so no load depends on another. CT:
// the candidates a row, fixed (the loops unroll and the values stay in
// registers), or 0 for any C (read from shared memory as needed).
template <int CT, bool kVec, bool kStageRefs>
__global__ void __launch_bounds__(kCombineReads) combine_kernel(
    const int* __restrict__ score, const int* __restrict__ q_st,
    const int* __restrict__ q_ed, const int* __restrict__ ref_c,
    const int* __restrict__ diag_c, const int* __restrict__ ref_offset,
    int n_ref, long long B, int c_rt, int* __restrict__ out) {
  extern __shared__ __align__(16) int sm[];
  const int C = CT > 0 ? CT : c_rt;
  const int T = kCombineReads;
  const long long b0 = blockIdx.x * static_cast<long long>(T);
  const int nb = static_cast<int>(B - b0 < T ? B - b0 : T);
  const int span = T * C;  // a slot: one field of one strand
  const int* fields[5] = {score, q_st, q_ed, ref_c, diag_c};
#pragma unroll
  for (int f = 0; f < 5; ++f) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      stage_words<kVec>(sm + (2 * f + st) * span,
                        fields[f] + (st * B + b0) * C, nb * C);
    }
  }
  int* refs = sm + 10 * span;
  if constexpr (kStageRefs) stage_words<false>(refs, ref_offset, n_ref);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= nb) return;
  const long long b = b0 + t;
  const int n = 2 * C;
  // candidate k < C is row b's k-th, k >= C row B + b's (k - C)-th
  auto at = [&](int f, int k) -> int {
    return k < C ? sm[2 * f * span + t * C + k]
                 : sm[(2 * f + 1) * span + t * C + (k - C)];
  };
  auto ref_at = [&](int k) { return at(3, k); };
  auto score4 = [&](int k) { return ref_at(k) >= 0 ? at(0, k) : -1; };
  int s_max = score4(0);
#pragma unroll
  for (int k = 1; k < n; ++k) s_max = max(s_max, score4(k));
  // the tie order: odd (s_max & 1, so also s_max = -1) the highest tied
  // ref, even the lowest; the first candidate holding it, else 0
  int r_hi = -1;
  long long r_lo = static_cast<long long>(n_ref) + 1;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    if (score4(k) == s_max) {
      const int r = ref_at(k);
      r_hi = max(r_hi, r);
      r_lo = min(r_lo, static_cast<long long>(r));
    }
  }
  const long long r_best = (s_max & 1) ? r_hi : r_lo;
  int cb = -1;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    if (cb < 0 && score4(k) == s_max && ref_at(k) == r_best) cb = k;
  }
  if (cb < 0) cb = 0;
  const int ref_b = s_max > 0 ? ref_at(cb) : -1;
  const int qs = at(1, cb);
  const long long rc = clamp_index(ref_b, n_ref);
  const int off = kStageRefs ? refs[rc] : __ldg(ref_offset + rc);
  const int pos = sub_wrap(add_wrap(at(4, cb), qs), off);
  int alt = -1;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int r = ref_at(k);
    if (r != ref_b && r >= 0) alt = max(alt, score4(k));
  }
  out[b] = max(s_max, 0);
  out[B + b] = ref_b;
  out[2 * B + b] = cb >= C ? 0 : 1;  // 1 = forward
  out[3 * B + b] = max(sub_wrap(at(2, cb), qs), 0);
  out[4 * B + b] = ref_b >= 0 ? pos : -1;
  out[5 * B + b] = max(alt, 0);
}

template <int CT, bool kVec, bool kStageRefs>
void launch_combine(long long blocks, size_t smem, cudaStream_t stream,
                    const int* score, const int* q_st, const int* q_ed,
                    const int* ref_c, const int* diag_c,
                    const int* ref_offset, int n_ref, long long B, int C,
                    int* out) {
  combine_kernel<CT, kVec, kStageRefs>
      <<<static_cast<unsigned>(blocks), kCombineReads, smem, stream>>>(
          score, q_st, q_ed, ref_c, diag_c, ref_offset, n_ref, B, C, out);
}

}  // namespace

extern "C" int dsb_band_windows(
    const void* ref_c, const void* diag_c, const void* read_w2,
    const void* lengths2, const void* ref_words, long long total_w,
    const void* ref_offset, const void* ref_len, long long n_ref,
    long long n_cand, long long C, long long Wq, long long nw, int band,
    void* rw_f, void* rl_f, void* win_w, void* rel_lo, void* rel_hi,
    void* stream) {
  if (n_cand <= 0) return static_cast<int>(cudaGetLastError());
  if (C < 1 || C > 32 || n_cand % C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long B2 = n_cand / C;
  const long long blocks = (B2 + kRows - 1) / kRows;
  auto go = [&](auto launch) {
    launch(blocks, static_cast<cudaStream_t>(stream),
           static_cast<const int*>(ref_c), static_cast<const int*>(diag_c),
           static_cast<const int*>(read_w2),
           static_cast<const int*>(lengths2),
           static_cast<const int*>(ref_words), total_w,
           static_cast<const int*>(ref_offset),
           static_cast<const int*>(ref_len), n_ref, B2, static_cast<int>(C),
           Wq, nw, band, static_cast<int*>(rw_f), static_cast<int*>(rl_f),
           static_cast<int*>(win_w), static_cast<int*>(rel_lo),
           static_cast<int*>(rel_hi));
  };
  if (fits(4, Wq, read_w2, rw_f) && fits(2, nw, win_w, win_w)) {
    go(launch_band_windows<4, 2>);
  } else {
    go(launch_band_windows<1, 1>);
  }
  return static_cast<int>(cudaGetLastError());
}

// score, q_st, q_ed: int32[2B*C]; ref_c, diag_c: int32[2B, C]; ref_offset:
// int32[n_ref]; out: int32[6, B]. 1 <= C <= kCombineMaxC, n_ref >= 1.
extern "C" int dsb_combine(const void* score, const void* q_st,
                           const void* q_ed, const void* ref_c,
                           const void* diag_c, const void* ref_offset,
                           long long n_ref, long long B, int C, void* out,
                           void* stream) {
  if (C < 1 || C > kCombineMaxC || n_ref < 1 || n_ref > INT_MAX || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (B + kCombineReads - 1) / kCombineReads;
  const bool stage_refs = n_ref <= kRefStageMax;
  const size_t smem = sizeof(int) * (10 * kCombineReads * C +
                                     (stage_refs ? n_ref : 0));
  // 16-byte copies: each strand's span starts at a multiple of 4 words
  // (kCombineReads * C and B * C are) on 16-byte aligned arrays
  const void* ptrs[] = {score, q_st, q_ed, ref_c, diag_c};
  bool vec = (B * C) % 4 == 0;
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  auto go = [&](auto launch) {
    launch(blocks, smem, static_cast<cudaStream_t>(stream),
           static_cast<const int*>(score), static_cast<const int*>(q_st),
           static_cast<const int*>(q_ed), static_cast<const int*>(ref_c),
           static_cast<const int*>(diag_c),
           static_cast<const int*>(ref_offset), static_cast<int>(n_ref), B,
           C, static_cast<int*>(out));
  };
  // the path's C (3) unrolled, any other C generic
  auto variant = [&](auto ct) {
    constexpr int CT = decltype(ct)::value;
    if (vec && stage_refs) go(launch_combine<CT, true, true>);
    else if (vec) go(launch_combine<CT, true, false>);
    else if (stage_refs) go(launch_combine<CT, false, true>);
    else go(launch_combine<CT, false, false>);
  };
  if (C == 3) variant(std::integral_constant<int, 3>{});
  else variant(std::integral_constant<int, 0>{});
  return static_cast<int>(cudaGetLastError());
}
