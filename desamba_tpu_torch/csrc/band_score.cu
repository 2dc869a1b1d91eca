// Banded match scorer on 2-bit codes, bit-parallel over 32 codes a word.
//
// Replaces desamba_tpu/ops/matchblock.py:band_score_packed (with _pairmask
// and _hibit): the device get_score_M2 analog. For each read position q
// and band offset k in [0, K), e(q, k) says that read code q equals window
// code q + k, that the window code lies in [rel_lo, rel_hi) and that
// q < rlen. A read position starts a run when e(q .. q + 8, k) all hold
// for some k (S_A_KMER_L = 9); acc marks the run starts, shifting acc by
// 8 codes marks the run ends, the score is their count and q_st / q_ed the
// first and last.
//
// What bounds it on this card: int32 issue. The inputs are a few KB a row
// and stay in shared memory; the work is ~B * W * K bit tests, done 32 at
// a time by the integer ALUs (tensor cores, TMA and wgmma do not apply to
// bitwise run detection). The only way down is fewer instructions per
// (row, read word, band offset), so the design is about that count:
//
//  * Bit planes. Staging splits each row's packed words (code t at bits
//    2t, 2t + 1) into a low-bit and a high-bit plane of 32 codes a word,
//    so one 32-bit operation tests 32 codes instead of 16, and the
//    per-code equality needs no pair-AND: e = ~(rh ^ ah) & ~(rl ^ al).
//  * Each match word once. A thread owns a run of kRun plane words (and
//    one halo word) and every kGroups-th offset of each 32-offset window
//    block (kGroups threads a run, all with the same trip counts, so a
//    warp does not diverge). Per offset it walks its words from high to
//    low, so the next word's e and r3 are in registers; only the halo
//    word is computed twice, and its r3 needs no word beyond it, since
//    the run test reads only its low bits. The window words of a block
//    are loaded from shared memory once for its 32 / kGroups offsets.
//    The block's rows are cut into work items (row, run, thread of the
//    run), row-major: runs wholly past rlen and rows with nothing valid
//    have none, so the idle threads gather in whole warps at the end.
//  * e per word and offset: two funnel shifts (the window planes by k %
//    32 codes) and two LOP3s, x = (rl ^ al) | ~valid and e = ~(rh ^ ah) &
//    ~x. The read-valid mask (q < rlen) is loop-invariant and folds into
//    the first LOP3.
//  * The 9-run test by tripling: r3 = e & e>>1 & e>>2, then run starts =
//    r3 & r3>>3 & r3>>6 (shifts across into the next word), OR-ed into
//    acc: four funnel shifts and three LOP3s, against eight shifts and
//    eight ANDs for the 8-step AND.
//  * The window-range mask only where it can bite. For offset k the
//    valid window codes are the read positions [rel_lo - k, rel_hi - k);
//    when the run's positions below rlen (halo included) lie inside at
//    every offset of a window block, the block's loop runs without the
//    mask. Otherwise the window's valid plane is shifted like the window
//    (one more funnel shift and LOP3 a word). The two loops are apart,
//    so that the compiler does not merge them into the masked one. A row
//    with an empty [rel_lo, rel_hi) or rlen <= 0 scores nothing and
//    skips the loop.
//
// Per (row, 32-code word, offset) that is 2 + 2 + 4 + 3 = 11 int32
// operations (the halo adds 7 / kRun), i.e. about 6 per (row, 16-code read
// word, band offset); chip_smoke.py counts the inner loop's SASS.
//
// The run starts of the kGroups threads of a run are OR-ed into the row's
// acc in shared memory (atomicOr), then the row's threads reduce acc to
// score, q_st and q_ed with shared-memory integer atomics (sum, min and max
// do not depend on order, so the result is exact).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8;       // plane words (32 codes each) a thread walks
constexpr int kGroups = 4;    // threads that share a run's offsets
constexpr int kBlock = 128;   // threads a block (rows a block = kBlock / row)
constexpr int kMaxRowThreads = 1024;

__device__ __forceinline__ unsigned mask32(long long n) {
  return n <= 0 ? 0u : (n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u));
}

// Gathers the even bits of u into bits 0-15 and the odd bits into 16-31.
__device__ __forceinline__ unsigned unzip(unsigned x) {
  unsigned t = (x ^ (x >> 1)) & 0x22222222u;
  x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu;
  x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u;
  x ^= t ^ (t << 4);
  t = (x ^ (x >> 8)) & 0x0000FF00u;
  x ^= t ^ (t << 8);
  return x;
}

// One band offset (window shift m = k % 32 codes) over the thread's run:
// words 0..kRun-1 and the halo word kRun. Window registers hold plane words
// i .. i + kRun + 1 of the window at the run's start plus k / 32.
template <bool kMask>
__device__ __forceinline__ void offset_step(
    const unsigned (&rh)[kRun + 1], const unsigned (&rl)[kRun + 1],
    const unsigned (&rv)[kRun + 1], const unsigned (&wh)[kRun + 2],
    const unsigned (&wl)[kRun + 2], const unsigned (&wv)[kRun + 2], int m,
    unsigned (&acc)[kRun]) {
  unsigned e_n, r3_n;
  {
    unsigned v = rv[kRun];
    if (kMask) v &= __funnelshift_r(wv[kRun], wv[kRun + 1], m);
    const unsigned ah = __funnelshift_r(wh[kRun], wh[kRun + 1], m);
    const unsigned al = __funnelshift_r(wl[kRun], wl[kRun + 1], m);
    const unsigned x = (rl[kRun] ^ al) | ~v;
    e_n = ~(rh[kRun] ^ ah) & ~x;
    // only bits 0-5 of the halo's r3 are read: they need no word beyond it
    r3_n = e_n & (e_n >> 1) & (e_n >> 2);
  }
#pragma unroll
  for (int i = kRun - 1; i >= 0; --i) {
    unsigned v = rv[i];
    if (kMask) v &= __funnelshift_r(wv[i], wv[i + 1], m);
    const unsigned ah = __funnelshift_r(wh[i], wh[i + 1], m);
    const unsigned al = __funnelshift_r(wl[i], wl[i + 1], m);
    const unsigned x = (rl[i] ^ al) | ~v;
    const unsigned e = ~(rh[i] ^ ah) & ~x;
    const unsigned r3 =
        e & __funnelshift_r(e, e_n, 1) & __funnelshift_r(e, e_n, 2);
    acc[i] |= r3 & __funnelshift_r(r3, r3_n, 3) & __funnelshift_r(r3, r3_n, 6);
    e_n = e;
    r3_n = r3;
  }
}

struct Layout {
  int Wq, NW, K, Wq32, runs, Wq32p, nws, row_threads, rows, row_words;
};

// Shared memory of one row, in words: read planes rh, rl [Wq32p + 1] (the
// last is the final run's halo, zero), window planes wh, wl, wv [nws], acc
// [Wq32p], then kMeta ints: score, q_st, q_ed, rel_lo, rel_hi, rlen
// clamped to [0, W], and the row's work items.
constexpr int kMeta = 7;

__global__ void band_score_kernel(
    const unsigned* __restrict__ read_w, const int* __restrict__ rlen,
    const unsigned* __restrict__ win_w, const int* __restrict__ rel_lo,
    const int* __restrict__ rel_hi, long long B, Layout L,
    int* __restrict__ score, int* __restrict__ q_st,
    int* __restrict__ q_ed) {
  extern __shared__ unsigned smem[];
  const int W = 16 * L.Wq;
  const int meta_at = 2 * (L.Wq32p + 1) + 3 * L.nws + L.Wq32p;
  {
    // staging: the row's threads split its words into planes
    const int r = threadIdx.x / L.row_threads;
    const int tr = threadIdx.x % L.row_threads;
    const long long b = blockIdx.x * static_cast<long long>(L.rows) + r;
    unsigned* rh = smem + r * L.row_words;
    unsigned* rl = rh + L.Wq32p + 1;
    unsigned* wh = rl + L.Wq32p + 1;
    unsigned* wl = wh + L.nws;
    unsigned* wv = wl + L.nws;
    unsigned* acc_s = wv + L.nws;
    int* meta = reinterpret_cast<int*>(rh + meta_at);
    const int lo = b < B ? rel_lo[b] : 0, hi = b < B ? rel_hi[b] : 0;
    const int n = b < B ? rlen[b] : 0;
    const int rl_c = n < 0 ? 0 : (n > W ? W : n);
    if (tr == 0) {
      // a row with no valid read or window code scores nothing: no items
      const int runs = (rl_c + 32 * kRun - 1) / (32 * kRun);
      meta[0] = 0;
      meta[1] = W;
      meta[2] = -1;
      meta[3] = lo;
      meta[4] = hi;
      meta[5] = rl_c;
      meta[6] = lo < hi ? (runs < L.runs ? runs : L.runs) * kGroups : 0;
    }
    if (b < B && lo < hi && rl_c > 0) {
      const unsigned* rw = read_w + b * L.Wq;
      const unsigned* ww = win_w + b * L.NW;
      for (int i = tr; i <= L.Wq32p; i += L.row_threads) {
        const unsigned a = 2 * i < L.Wq ? unzip(rw[2 * i]) : 0u;
        const unsigned c = 2 * i + 1 < L.Wq ? unzip(rw[2 * i + 1]) : 0u;
        rl[i] = (a & 0xFFFFu) | (c << 16);
        rh[i] = (a >> 16) | (c & 0xFFFF0000u);
      }
      for (int i = tr; i < L.nws; i += L.row_threads) {
        const unsigned a = 2 * i < L.NW ? unzip(ww[2 * i]) : 0u;
        const unsigned c = 2 * i + 1 < L.NW ? unzip(ww[2 * i + 1]) : 0u;
        wl[i] = (a & 0xFFFFu) | (c << 16);
        wh[i] = (a >> 16) | (c & 0xFFFF0000u);
        const long long p = 32LL * i;
        wv[i] = mask32(hi - p) & ~mask32(lo - p);
      }
      for (int i = tr; i < L.Wq32p; i += L.row_threads) acc_s[i] = 0u;
    }
  }
  __syncthreads();
  // the work items (row, run, group) of the block's rows, row-major: runs
  // wholly past rlen and rows with nothing valid have none, and the idle
  // threads gather in whole warps at the end
  for (int item = threadIdx.x;; item += blockDim.x) {
    int r = 0, first = 0;
    for (; r < L.rows; ++r) {
      const int n = reinterpret_cast<const int*>(smem + r * L.row_words +
                                                 meta_at)[6];
      if (item < first + n) break;
      first += n;
    }
    if (r == L.rows) break;
    const unsigned* rh = smem + r * L.row_words;
    const unsigned* rl = rh + L.Wq32p + 1;
    const unsigned* wh = rl + L.Wq32p + 1;
    const unsigned* wl = wh + L.nws;
    const unsigned* wv = wl + L.nws;
    unsigned* acc_s = smem + r * L.row_words + 2 * (L.Wq32p + 1) + 3 * L.nws;
    const int* meta = reinterpret_cast<const int*>(rh + meta_at);
    const long long lo = meta[3], hi = meta[4];
    const int rl_c = meta[5];
    // offsets k = 32 jj + m, m = g, g + kGroups, ...: the threads of a
    // warp walk the same window blocks jj with the same trip counts
    const int g = (item - first) % kGroups;
    const int w0 = (item - first) / kGroups * kRun;
    unsigned rhr[kRun + 1], rlr[kRun + 1], rvr[kRun + 1], acc[kRun];
#pragma unroll
    for (int i = 0; i <= kRun; ++i) {
      rhr[i] = rh[w0 + i];
      rlr[i] = rl[w0 + i];
      rvr[i] = mask32(static_cast<long long>(rl_c) - 32LL * (w0 + i));
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = 0u;
    // the offsets [ka, kb] at which every read position of the run that
    // can match ([32 w0, min(32 (w0 + kRun + 1), rlen)), halo included)
    // meets a valid window code
    const long long q_end =
        32LL * (w0 + kRun + 1) < rl_c ? 32LL * (w0 + kRun + 1) : rl_c;
    const long long a = lo - 32LL * w0, z = hi - q_end;
    const int ka = a < 0 ? 0 : (a > L.K ? L.K : static_cast<int>(a));
    const int kb = z < 0 ? -1 : (z > L.K ? L.K : static_cast<int>(z));
    unsigned whr[kRun + 2], wlr[kRun + 2], wvr[kRun + 2];
    for (int jj = 0; 32 * jj < L.K; ++jj) {
      const int base = w0 + jj;
      const int n_m = L.K - 32 * jj < 32 ? L.K - 32 * jj : 32;
#pragma unroll
      for (int i = 0; i < kRun + 2; ++i) {
        whr[i] = wh[base + i];
        wlr[i] = wl[base + i];
      }
      if (ka <= 32 * jj && 32 * jj + n_m - 1 <= kb) {
        for (int m = g; m < n_m; m += kGroups)
          offset_step<false>(rhr, rlr, rvr, whr, wlr, wvr, m, acc);
      } else {
#pragma unroll
        for (int i = 0; i < kRun + 2; ++i) wvr[i] = wv[base + i];
        for (int m = g; m < n_m; m += kGroups)
          offset_step<true>(rhr, rlr, rvr, whr, wlr, wvr, m, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (acc[i]) atomicOr(acc_s + w0 + i, acc[i]);
  }
  __syncthreads();
  const int r = threadIdx.x / L.row_threads;
  const int tr = threadIdx.x % L.row_threads;
  const long long b = blockIdx.x * static_cast<long long>(L.rows) + r;
  const unsigned* acc_s =
      smem + r * L.row_words + 2 * (L.Wq32p + 1) + 3 * L.nws;
  int* meta = reinterpret_cast<int*>(smem + r * L.row_words + meta_at);
  if (b < B && meta[6] > 0) {
    int my_score = 0, my_qst = W, my_qed = -1;
    for (int w = tr; w < L.Wq32; w += L.row_threads) {
      // run-start bit at q -> run-end bit at q + 8
      const unsigned prev = w > 0 ? acc_s[w - 1] : 0u;
      const unsigned e = __funnelshift_l(prev, acc_s[w], 8);
      if (e != 0u) {
        my_score += __popc(e);
        const int q0 = 32 * w + __ffs(e) - 1;
        const int q1 = 32 * w + 31 - __clz(e);
        my_qst = q0 < my_qst ? q0 : my_qst;
        my_qed = q1 > my_qed ? q1 : my_qed;
      }
    }
    if (my_score) {
      atomicAdd(meta, my_score);
      atomicMin(meta + 1, my_qst);
      atomicMax(meta + 2, my_qed);
    }
  }
  __syncthreads();
  if (b < B && tr == 0) {
    const bool has = meta[0] > 0;
    score[b] = meta[0];
    q_st[b] = has ? meta[1] : W;
    q_ed[b] = has ? meta[2] : -1;
  }
}

}  // namespace

// read_w int32[B, Wq], rlen int32[B], win_w int32[B, NW], rel_lo and rel_hi
// int32[B]; K a positive multiple of 16 with NW >= Wq + K / 16 + 1.
extern "C" int dsb_band_score(const void* read_w, const void* rlen,
                              const void* win_w, const void* rel_lo,
                              const void* rel_hi, long long B, int Wq, int NW,
                              int K, void* score, void* q_st, void* q_ed,
                              void* stream) {
  if (B < 0 || Wq < 1 || K < 16 || K % 16 || NW < Wq + K / 16 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  Layout L;
  L.Wq = Wq;
  L.NW = NW;
  L.K = K;
  L.Wq32 = (Wq + 1) / 2;
  L.runs = (L.Wq32 + kRun - 1) / kRun;
  L.Wq32p = L.runs * kRun;
  L.nws = L.Wq32p + ((K - 1) >> 5) + 2;
  L.row_threads = L.runs * kGroups;
  if (L.row_threads > kMaxRowThreads) L.row_threads = kMaxRowThreads;
  L.rows = L.row_threads >= kBlock ? 1 : kBlock / L.row_threads;
  L.row_words = 2 * (L.Wq32p + 1) + 3 * L.nws + L.Wq32p + kMeta;
  const size_t smem = static_cast<size_t>(L.rows) * L.row_words * 4;
  if (smem > 48 * 1024) {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > static_cast<size_t>(most))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        band_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (B + L.rows - 1) / L.rows;
  band_score_kernel<<<static_cast<unsigned>(blocks),
                      L.rows * L.row_threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(read_w), static_cast<const int*>(rlen),
      static_cast<const unsigned*>(win_w), static_cast<const int*>(rel_lo),
      static_cast<const int*>(rel_hi), B, L, static_cast<int*>(score),
      static_cast<int*>(q_st), static_cast<int*>(q_ed));
  return static_cast<int>(cudaGetLastError());
}
