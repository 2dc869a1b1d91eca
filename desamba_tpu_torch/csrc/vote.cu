// Stage 3's windowed diagonal vote, in two launches: a slot map, then one
// warp a read row.
//
// Replaces the vote of desamba_tpu/engine/fast_engine.py's stage3
// (:363-418; the window vote of cly.c:200-223), on the [NC, P] anchors
// that locate returns. Lane c fills slots (sel[c] % nwR) * P + p of read
// row sel[c] / nwR (A = nwR * P slots a row): ref (-1 where not pvalid),
// diagonal gpos - qleft (valid or not) and weight total_c (0 where not
// pvalid); a lane with sel[c] >= B2 * nwR (stage 2's fill for an unused
// slot) is dropped. Each slot i with ref >= 0 scores the sum of w[j] over
// the row's slots j with ref[j] == ref[i] and |diag[i] - diag[j]| <= tol,
// tol = clamp(len >> 4, 30, 160); every other slot, filled or empty,
// scores -1. Then three takes over the row in slot order (the larger
// value wins, the smaller slot on equal values): the winner (r1, d1); the
// best where ref != r1 or |diag - d1| > 2 tol; the best where ref != r1
// (the others count -1). Each candidate writes (v > 0 ? ref : -1, diag,
// max(v, 0)), with r1 = v1 > 0 ? ref : -1.
//
// - vote_map_kernel writes (call << 32) | c into word sel[c] of the slot
//   map (uint64 [B2 * nwR], kept by the wrapper for each device and
//   stream, ops/vote.py). A word of another call reads as an empty
//   window, so the map needs no fill: the wrapper numbers its calls
//   1 .. 2^30 - 1 and zeroes the map when the numbers start again.
// - vote_kernel, one warp a read row. Staging: the warp reads the row's
//   nwR map words, 32 windows at a time, a lane a window; a lane whose
//   window holds lane c loads c's P anchors (P = 4: one 16-byte load of
//   ref, one of gpos, one 4-byte load of pvalid) and total_c[c],
//   qleft_c[c], and appends its anchors with a ref (pvalid and ref >= 0,
//   "listed") to the warp's list in shared memory as (ref, diag, weight,
//   slot), in slot order (a prefix over the lanes' counts). It keeps the
//   first slot that is not listed and its diagonal (0 for an empty
//   window, the wrapped gpos - qleft of an anchor without a ref): every
//   unlisted slot scores -1, so the first stands for all of them in each
//   take. Scores: a lane a listed entry, summing in a register the
//   weights of the list's entries that match it (an entry of weight 0
//   adds 0), each entry one broadcast 16-byte load from shared memory;
//   the lane keeps its entries' scores in shared memory for takes 2 and
//   3. Takes: each lane's best over its entries, then the warp's
//   (__reduce_max_sync, then __reduce_min_sync of the indices that hold
//   the maximum), then against (-1, the first unlisted slot).
//
// Every output equals the plain version's, rows with no listed anchor
// included. torch's and XLA's int32 arithmetic wraps, so the differences
// go through sub_wrap, |INT_MIN| stays INT_MIN (two anchors 2^31 apart
// match and are not far), and the weights are summed in uint32 (a sum
// that passes 2^31 wraps, in any order).
//
// What bounds it on this card: the instructions a row (~700 at W = 2048;
// 8,192 warps take several µs to issue them), two dependent rounds of
// device-memory loads a chunk of 32 windows (the map words, then the
// anchors), and the pairs (a row lists about a fifth of its A slots, ~20
// of 168 at W = 2048). The bytes (the lanes in, the map's words, three
// int32 a row out) are a few MB a chunk. The design writes no dense row
// and no score row to device memory: a row's anchors are read once into
// shared memory, its sums stay in registers and its scores in shared
// memory, and a warp a row puts a chunk's 8,192 rows on the card in about
// one wave. Writing a row's anchors dense by slot first, so that every
// window's loads are in flight at once, was measured and was slower
// (shared-memory traffic and instructions for the empty slots). A row's
// list and scores take 20 bytes a slot of shared memory, so a row holds
// at most kMaxSlots = 8,192 slots (160 KiB; A = 664 at W = 8192); the
// entry point refuses more, and the wrapper raises.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace {

using dsb::abs_wrap;
using dsb::sub_wrap;

constexpr int kWarps = 8;           // warps (read rows) a block, at most
constexpr int kMaxSlots = 1 << 13;  // VOTE_MAX_SLOTS in ops/vote.py
constexpr unsigned kFull = 0xffffffffu;

__global__ void vote_map_kernel(const int* __restrict__ sel, long long n,
                                long long slots, unsigned long long tag,
                                unsigned long long* __restrict__ map) {
  const long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (c >= n) return;
  const int s = sel[c];
  // B2 * nwR and above: the fill of an unused slot; stage 2 makes no
  // negative sel
  if (s < 0 || s >= slots) return;
  map[s] = tag | static_cast<unsigned>(c);
}

// (v, i) takes (v2, i2) if v2 is larger, or equal at a smaller index
__device__ __forceinline__ void take_better(int& v, int& i, int v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// the warp's best (value, index) of each lane's (v, i), in every lane:
// the largest value, then the smallest index that holds it
__device__ __forceinline__ void warp_best(int& v, int& i) {
  const int m = __reduce_max_sync(kFull, v);
  i = static_cast<int>(__reduce_min_sync(
      kFull, v == m ? static_cast<unsigned>(i) : 0xffffffffu));
  v = m;
}

// lane's window's anchors: ref, gpos and pvalid of anchor p of lane c
template <int kP>
struct Anchors {
  int r[kP > 0 ? kP : 1], g[kP > 0 ? kP : 1];
  unsigned pv;
  __device__ __forceinline__ void load(const int* ref, const int* gpos,
                                       const unsigned char* pvalid,
                                       long long c) {
    if constexpr (kP == 4) {
      const int4 r4 = reinterpret_cast<const int4*>(ref)[c];
      const int4 g4 = reinterpret_cast<const int4*>(gpos)[c];
      pv = reinterpret_cast<const unsigned*>(pvalid)[c];
      r[0] = r4.x; r[1] = r4.y; r[2] = r4.z; r[3] = r4.w;
      g[0] = g4.x; g[1] = g4.y; g[2] = g4.z; g[3] = g4.w;
    }
  }
  __device__ __forceinline__ bool valid(int p, const unsigned char* pvalid,
                                        long long c, int P) const {
    if constexpr (kP == 4) return ((pv >> (8 * p)) & 0xffu) != 0u;
    return pvalid[c * P + p] != 0;
  }
  __device__ __forceinline__ int ref_of(int p, const int* ref, long long c,
                                        int P) const {
    if constexpr (kP == 4) return r[p];
    return ref[c * P + p];
  }
  __device__ __forceinline__ int gpos_of(int p, const int* gpos, long long c,
                                         int P) const {
    if constexpr (kP == 4) return g[p];
    return gpos[c * P + p];
  }
};

// kP: 4 (P == 4, the anchors 16-byte aligned: vector loads) or 0 (any P)
template <int kP>
__global__ void __launch_bounds__(kWarps * 32) vote_kernel(
    const int* __restrict__ ref, const int* __restrict__ gpos,
    const unsigned char* __restrict__ pvalid,
    const int* __restrict__ total_c, const int* __restrict__ qleft_c,
    int P_arg, const int* __restrict__ lengths2, long long B2, int nwR,
    const unsigned long long* __restrict__ map, unsigned call,
    int* __restrict__ ref_c, int* __restrict__ diag_c,
    int* __restrict__ vote_c) {
  // the block's lists, A int4 a warp, then the warps' scores, A int each
  extern __shared__ int4 list_all[];
  const int P = kP > 0 ? kP : P_arg;
  const int A = nwR * P;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x * static_cast<long long>(warps) + warp;
  if (b >= B2) return;  // whole warps: no shuffle below misses a lane
  int4* list = list_all + warp * A;
  int* score = reinterpret_cast<int*>(list_all + warps * A) + warp * A;
  const int tol = min(max(lengths2[b] >> 4, 30), 160);
  const unsigned long long* row_map = map + b * nwR;

  // staging, 32 windows at a time, a lane a window: the listed anchors
  // appended to the list in slot order (a prefix of the lanes' counts),
  // and the first unlisted slot (gap) with its diagonal
  int nv = 0, gap = INT_MAX, gap_diag = 0;
  for (int w0 = 0; w0 < nwR; w0 += 32) {
    const int w = w0 + lane;
    long long c = -1;
    if (w < nwR) {
      const unsigned long long e = row_map[w];
      if (static_cast<unsigned>(e >> 32) == call)
        c = static_cast<long long>(static_cast<unsigned>(e));
    }
    Anchors<kP> an;
    int cnt = 0, my_gap = INT_MAX, my_gap_diag = 0, ql = 0, wt = 0;
    if (c >= 0) {
      an.load(ref, gpos, pvalid, c);
      ql = qleft_c[c];
      wt = total_c[c];
      for (int p = 0; p < P; ++p) {
        if (an.valid(p, pvalid, c, P) && an.ref_of(p, ref, c, P) >= 0) {
          ++cnt;
        } else if (my_gap == INT_MAX) {
          my_gap = w * P + p;
          my_gap_diag = sub_wrap(an.gpos_of(p, gpos, c, P), ql);
        }
      }
    } else if (w < nwR) {
      my_gap = w * P;  // an empty window: ref -1, diagonal 0
    }
    // the lanes' offsets in the list: an inclusive prefix of cnt
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (cnt > 0) {
      int k = nv + incl - cnt;
      for (int p = 0; p < P; ++p) {
        const int r = an.ref_of(p, ref, c, P);
        if (an.valid(p, pvalid, c, P) && r >= 0)
          list[k++] = make_int4(r, sub_wrap(an.gpos_of(p, gpos, c, P), ql),
                                wt, w * P + p);
      }
    }
    nv += __shfl_sync(kFull, incl, 31);
    const unsigned has_gap = __ballot_sync(kFull, my_gap != INT_MAX);
    if (gap == INT_MAX && has_gap != 0u) {
      const int first = __ffs(has_gap) - 1;
      gap = __shfl_sync(kFull, my_gap, first);
      gap_diag = __shfl_sync(kFull, my_gap_diag, first);
    }
  }
  __syncwarp();

  // scores: entries lane, lane + 32, ...; take 1 on the way
  int v1 = INT_MIN, k1 = INT_MAX;
  for (int k = lane; k < nv; k += 32) {
    const int4 e = list[k];
    unsigned acc = 0u;
    for (int j = 0; j < nv; ++j) {
      const int4 q = list[j];
      if (q.x == e.x && abs_wrap(sub_wrap(e.y, q.y)) <= tol)
        acc += static_cast<unsigned>(q.z);
    }
    score[k] = static_cast<int>(acc);
    take_better(v1, k1, static_cast<int>(acc), k);
  }
  warp_best(v1, k1);
  // the listed winner, or the first unlisted slot where it is better
  int r1 = -1, d1 = gap_diag;
  const bool gap1 = nv == 0 || (gap != INT_MAX &&
                                (v1 < -1 || (v1 == -1 && gap < list[k1].w)));
  if (gap1) {
    v1 = -1;
  } else {
    const int4 e = list[k1];
    r1 = v1 > 0 ? e.x : -1;
    d1 = e.y;
  }

  // takes 2 and 3: each entry's score (the lane's own), masked
  int v2 = INT_MIN, k2 = INT_MAX, v3 = INT_MIN, k3 = INT_MAX;
  for (int k = lane; k < nv; k += 32) {
    const int4 e = list[k];
    const int s = score[k];
    const bool other = e.x != r1;
    const bool far = other || abs_wrap(sub_wrap(e.y, d1)) > 2 * tol;
    take_better(v2, k2, far ? s : -1, k);
    take_better(v3, k3, other ? s : -1, k);
  }
  warp_best(v2, k2);
  warp_best(v3, k3);
  if (lane == 0) {
    const long long o = b * 3;
    ref_c[o] = r1;
    diag_c[o] = d1;
    vote_c[o] = max(v1, 0);
    const int vs[2] = {v2, v3}, ks[2] = {k2, k3};
    for (int t = 0; t < 2; ++t) {
      int v = vs[t], r = -1, d = gap_diag;
      const bool g = nv == 0 || (gap != INT_MAX &&
                                 (v < -1 || (v == -1 && gap < list[ks[t]].w)));
      if (g) {
        v = -1;
      } else {
        const int4 e = list[ks[t]];
        r = v > 0 ? e.x : -1;
        d = e.y;
      }
      ref_c[o + 1 + t] = r;
      diag_c[o + 1 + t] = d;
      vote_c[o + 1 + t] = max(v, 0);
    }
  }
}

template <int kP>
cudaError_t launch_vote(const void* ref, const void* gpos,
                        const void* pvalid, const void* total_c,
                        const void* qleft_c, int P, const void* lengths2,
                        long long B2, int nwR, const void* map,
                        unsigned call, void* out, cudaStream_t s) {
  // a warp's list of A int4 entries and A int scores; as many warps a
  // block as fit
  const long long A = static_cast<long long>(nwR) * P;
  const long long per_warp = A * static_cast<long long>(sizeof(int4) +
                                                        sizeof(int));
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int warps = static_cast<int>(
      per_warp * kWarps <= smem_max ? kWarps
                                    : (smem_max / per_warp > 0
                                           ? smem_max / per_warp
                                           : 1));
  const size_t smem = static_cast<size_t>(per_warp * warps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vote_kernel<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int* o = static_cast<int*>(out);
  vote_kernel<kP><<<static_cast<unsigned>((B2 + warps - 1) / warps),
                    warps * 32, smem, s>>>(
      static_cast<const int*>(ref), static_cast<const int*>(gpos),
      static_cast<const unsigned char*>(pvalid),
      static_cast<const int*>(total_c), static_cast<const int*>(qleft_c), P,
      static_cast<const int*>(lengths2), B2, nwR,
      static_cast<const unsigned long long*>(map), call, o, o + B2 * 3,
      o + B2 * 6);
  return cudaGetLastError();
}

}  // namespace

// map: uint64 words, at least B2 * nwR, each from an earlier call (a
// number other than call) or zero; call: 1 .. 2^30 - 1; out: int32[3,
// B2, 3] (ref_c, diag_c, vote_c)
extern "C" int dsb_vote(const void* ref, const void* gpos, const void* pvalid,
                        const void* total_c, const void* qleft_c,
                        const void* sel, long long n, int P,
                        const void* lengths2, long long B2, int nwR,
                        void* map, unsigned call, void* out, void* stream) {
  const long long A = static_cast<long long>(nwR) * P;
  if (P < 1 || nwR < 1 || A > kMaxSlots || B2 > INT_MAX || n > UINT_MAX ||
      call == 0u || call >= (1u << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B2 > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned long long tag = static_cast<unsigned long long>(call)
                                   << 32;
    if (n > 0) {
      vote_map_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
          static_cast<const int*>(sel), n, B2 * nwR, tag,
          static_cast<unsigned long long*>(map));
    }
    const bool vec = P == 4 && reinterpret_cast<uintptr_t>(ref) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(gpos) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(pvalid) % 4 == 0;
    const cudaError_t e =
        vec ? launch_vote<4>(ref, gpos, pvalid, total_c, qleft_c, P, lengths2,
                             B2, nwR, map, call, out, s)
            : launch_vote<0>(ref, gpos, pvalid, total_c, qleft_c, P, lengths2,
                             B2, nwR, map, call, out, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
