// Stage 3's windowed diagonal vote, in three launches.
//
// Replaces the vote of desamba_tpu/engine/fast_engine.py's stage3
// (:363-418; the window vote of cly.c:200-223), on the [NC, P] anchors
// that locate returns:
// - vote_fill_kernel empties the dense [B2, A] rows (A = nwR * P slots a
//   read row): ref -1, diagonal 0, weight 0;
// - vote_scatter_kernel writes lane c's P anchors into slots
//   (sel[c] % nwR) * P + p of row sel[c] / nwR: ref (-1 where not
//   pvalid), diagonal gpos - qleft for every slot, valid or not, and
//   weight total_c (0 where not pvalid); a lane whose row is B2 (stage
//   2's fill for an unused slot) is dropped;
// - vote_kernel, one block a read row: each slot i with ref >= 0 scores
//   the sum of w[j] over the row's slots j with ref[j] == ref[i] and
//   |diag[i] - diag[j]| <= tol, tol = clamp(len >> 4, 30, 160); the
//   other slots score -1. Then three argmax passes over the row in slot
//   order (the larger value wins, the smaller slot on equal values):
//   the winner (r1, d1); the best where ref != r1 or |diag - d1| >
//   2 tol; the best where ref != r1. Each candidate writes
//   (v > 0 ? ref : -1, diag, max(v, 0)).
//
// Every output equals the plain version's, rows with no valid anchor
// included: their candidates take slot 0's diagonal, which is 0 for an
// empty slot and the wrapped diagonal of an invalid anchor otherwise.
// torch's and XLA's int32 arithmetic wraps, so the differences go
// through sub_wrap, |INT_MIN| stays INT_MIN (two anchors 2^31 apart
// match and are not far), and the weights are summed in uint32 (a sum
// that passes 2^31 wraps, in any order). A slot j of weight 0 adds 0 to
// every score, so the blocks leave those out of the sum.
//
// What bounds it on this card: the pairs. A row has A slots, about a
// quarter of them with an anchor, and each pair of anchors costs a few
// integer operations; the bytes (the lanes in, three int32 a row out)
// are a few MB a chunk. The design keeps a row in one block: it stages
// the row's slots of nonzero weight kTile at a time in shared memory,
// gives each anchor of kThreads slots a thread (strided loops cover
// any A up to 2^30, which the entry point checks), and keeps the scores
// in a scratch row that the three argmax passes read back from L1.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace {

using dsb::abs_wrap;
using dsb::sub_wrap;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;  // j slots staged a pass
constexpr unsigned kFull = 0xffffffffu;

__global__ void vote_fill_kernel(int* __restrict__ ref_a,
                                 int* __restrict__ diag_a,
                                 int* __restrict__ w_a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       k < n; k += stride) {
    ref_a[k] = -1;
    diag_a[k] = 0;
    w_a[k] = 0;
  }
}

__global__ void vote_scatter_kernel(
    const int* __restrict__ ref, const int* __restrict__ gpos,
    const unsigned char* __restrict__ pvalid,
    const int* __restrict__ total_c, const int* __restrict__ qleft_c,
    const int* __restrict__ sel, long long n, int P, long long B2, int nwR,
    int* __restrict__ ref_a, int* __restrict__ diag_a,
    int* __restrict__ w_a) {
  const long long k = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (k >= n * P) return;
  const long long c = k / P;
  const int s = sel[c];
  const long long b = s / nwR;
  // B2: the fill of an unused slot; stage 2 makes no negative sel
  if (s < 0 || b >= B2) return;
  const long long o = b * nwR * P + static_cast<long long>(s % nwR) * P +
                      (k - c * P);
  const bool v = pvalid[k] != 0;
  ref_a[o] = v ? ref[k] : -1;
  diag_a[o] = sub_wrap(gpos[k], qleft_c[c]);
  w_a[o] = v ? total_c[c] : 0;
}

// (v, i) takes (v2, i2) if v2 is larger, or equal at a smaller slot
__device__ __forceinline__ void take_better(int& v, int& i, int v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// the block's best (value, slot) of each thread's (v, i), in every thread
__device__ void block_best(int& v, int& i, int* sv, int* si) {
  for (int o = 16; o > 0; o >>= 1)
    take_better(v, i, __shfl_down_sync(kFull, v, o),
                __shfl_down_sync(kFull, i, o));
  __syncthreads();  // the previous call's readers are done with sv, si
  if ((threadIdx.x & 31) == 0) {
    sv[threadIdx.x >> 5] = v;
    si[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  for (int w = 1; w < kWarps; ++w) take_better(v, i, sv[w], si[w]);
}

__global__ void __launch_bounds__(kThreads) vote_kernel(
    const int* __restrict__ ref_a, const int* __restrict__ diag_a,
    const int* __restrict__ w_a, int* __restrict__ score_a,
    const int* __restrict__ lengths2, int A, int* __restrict__ ref_c,
    int* __restrict__ diag_c, int* __restrict__ vote_c) {
  __shared__ int t_ref[kTile], t_diag[kTile], t_w[kTile];
  __shared__ int i_list[kThreads];
  __shared__ int n_i, n_j;
  __shared__ int sv[kWarps], si[kWarps];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* r_a = ref_a + b * A;
  const int* d_a = diag_a + b * A;
  const int* w_row = w_a + b * A;
  int* score = score_a + b * A;
  const int tol = min(max(lengths2[b] >> 4, 30), 160);

  // the scores, kThreads slots at a time: the slots with a ref >= 0 are
  // listed, one a thread, and each sums the matching weights over the
  // row's slots of nonzero weight, staged kTile at a time
  for (int i0 = 0; i0 < A; i0 += kThreads) {
    __syncthreads();  // the previous pass is done with n_i and i_list
    if (tid == 0) n_i = 0;
    __syncthreads();
    if (i0 + tid < A) {
      if (r_a[i0 + tid] >= 0) {
        i_list[atomicAdd(&n_i, 1)] = i0 + tid;
      } else {
        score[i0 + tid] = -1;
      }
    }
    __syncthreads();
    const int ni = n_i;
    if (ni == 0) continue;
    const bool mine = tid < ni;
    const int i = mine ? i_list[tid] : 0;
    const int ri = r_a[i];
    const int di = d_a[i];
    unsigned acc = 0u;
    for (int j0 = 0; j0 < A; j0 += kTile) {
      __syncthreads();  // the previous tile is read
      if (tid == 0) n_j = 0;
      __syncthreads();
      const int j1 = min(j0 + kTile, A);
      for (int j = j0 + tid; j < j1; j += kThreads) {
        const int w = w_row[j];
        if (w != 0) {
          const int k = atomicAdd(&n_j, 1);
          t_ref[k] = r_a[j];
          t_diag[k] = d_a[j];
          t_w[k] = w;
        }
      }
      __syncthreads();
      const int nj = n_j;
      if (mine) {
        for (int k = 0; k < nj; ++k)
          if (t_ref[k] == ri && abs_wrap(sub_wrap(di, t_diag[k])) <= tol)
            acc += static_cast<unsigned>(t_w[k]);
      }
    }
    if (mine) score[i] = static_cast<int>(acc);
  }
  __syncthreads();  // the row's scores are written

  // take 1: the winner
  int v1 = INT_MIN, i1 = INT_MAX;
  for (int i = tid; i < A; i += kThreads) take_better(v1, i1, score[i], i);
  block_best(v1, i1, sv, si);
  const int r1 = v1 > 0 ? r_a[i1] : -1;
  const int d1 = d_a[i1];
  // takes 2 and 3: the best on a far diagonal or another ref, and the
  // best on another ref; the others count -1
  int v2 = INT_MIN, i2 = INT_MAX, v3 = INT_MIN, i3 = INT_MAX;
  for (int i = tid; i < A; i += kThreads) {
    const int s = score[i];
    const bool other = r_a[i] != r1;
    const bool far = other || abs_wrap(sub_wrap(d_a[i], d1)) > 2 * tol;
    take_better(v2, i2, far ? s : -1, i);
    take_better(v3, i3, other ? s : -1, i);
  }
  block_best(v2, i2, sv, si);
  block_best(v3, i3, sv, si);
  if (tid == 0) {
    const long long o = b * 3;
    ref_c[o] = r1;
    diag_c[o] = d1;
    vote_c[o] = max(v1, 0);
    ref_c[o + 1] = v2 > 0 ? r_a[i2] : -1;
    diag_c[o + 1] = d_a[i2];
    vote_c[o + 1] = max(v2, 0);
    ref_c[o + 2] = v3 > 0 ? r_a[i3] : -1;
    diag_c[o + 2] = d_a[i3];
    vote_c[o + 2] = max(v3, 0);
  }
}

}  // namespace

// scratch: int32[4, B2, nwR * P] (the dense ref, diagonal and weight rows,
// and the scores); out: int32[3, B2, 3] (ref_c, diag_c, vote_c)
extern "C" int dsb_vote(const void* ref, const void* gpos, const void* pvalid,
                        const void* total_c, const void* qleft_c,
                        const void* sel, long long n, int P,
                        const void* lengths2, long long B2, int nwR,
                        void* scratch, void* out, void* stream) {
  const long long A = static_cast<long long>(nwR) * P;
  // the block's slot loops step past A in int
  if (P < 1 || nwR < 1 || A > (1LL << 30) || B2 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B2 > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long cells = B2 * A;
    int* ref_a = static_cast<int*>(scratch);
    int* diag_a = ref_a + cells;
    int* w_a = diag_a + cells;
    int* score_a = w_a + cells;
    int* o = static_cast<int*>(out);
    const long long fill_blocks = (cells + 255) / 256;
    vote_fill_kernel<<<static_cast<unsigned>(
                           fill_blocks < 4096 ? fill_blocks : 4096),
                       256, 0, s>>>(ref_a, diag_a, w_a, cells);
    if (n > 0) {
      vote_scatter_kernel<<<static_cast<unsigned>((n * P + 255) / 256), 256,
                            0, s>>>(
          static_cast<const int*>(ref), static_cast<const int*>(gpos),
          static_cast<const unsigned char*>(pvalid),
          static_cast<const int*>(total_c), static_cast<const int*>(qleft_c),
          static_cast<const int*>(sel), n, P, B2, nwR, ref_a, diag_a, w_a);
    }
    vote_kernel<<<static_cast<unsigned>(B2), kThreads, 0, s>>>(
        ref_a, diag_a, w_a, score_a, static_cast<const int*>(lengths2),
        static_cast<int>(A), o, o + B2 * 3, o + B2 * 6);
  }
  return static_cast<int>(cudaGetLastError());
}
