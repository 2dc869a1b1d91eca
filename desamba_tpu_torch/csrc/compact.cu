// Stage 2's capped, stable prefix compactions, as two kernels that share
// one two-launch scan.
//
// Replaces the cumsum / scatter-with-drop compactions of
// desamba_tpu/engine/fast_engine.py:_build_stages.stage2 (:237-264 for
// the interval search's two cuts, :287-313 for the row grid, :314-341 for
// the walks' two cuts) and the gathers that carry lanes into the walks.
//
//   compact   entry j of n lanes is live where done[j] == 0, and its
//             value is j; with a source list, entry j of m is live where
//             0 <= src[j] < n and done[src[j]] == 0, and its value is
//             src[j]. Output: int32[cap], the values of the first cap live
//             entries in entry order, then n in the unused slots. This is
//             JAX's sel2 over the lanes, and its s2i[s3i] where sel3 keeps
//             a slot (src is increasing, so entry order is JAX's order).
//   row_grid  entry e = s * R + k of the S * R grid of BWT rows sp + k
//             (sp, ep the lane's final interval) is live where
//             seed_ok[s] & (sp < ep) & (sp + k < ep), in int32 arithmetic
//             that wraps. It writes sel int32[NC] (fill S * R), the walks'
//             start carry int32[5, NC] (row, ptr, 0, 0, 0) and int32[4, NC]
//             (lane, walk length, match_len, s_idx), each gathered through
//             seli = min(sel, S * R - 1) as JAX gathers them; the walk
//             length is max(s_idx - match_len, 0), and 0 in unused slots.
//
// Both keep exactly the first cap live entries in entry order; a live
// entry past the cap is dropped, as JAX's scatter with mode="drop" drops
// it.
//
// The scan: launch 1 counts each block's live entries (one __ballot_sync
// and __popc a warp, a sum over the block's 32 warps). Launch 2 re-reads
// the entries; each block sums the counts of the blocks before it (and of
// all blocks, for the fill), ranks its live entries by the ballot bits
// below each lane plus an exclusive prefix over its warps in shared
// memory, writes each kept entry to its slot, and writes the fill to the
// slots past the live total with a grid-stride loop.
//
// What bounds it on this card: the bytes of the entries (4 a lane; the
// row grid reads 4 carry rows, the mask and two int32 rows a lane) and,
// at stage 2's sizes (S = 172,032 lanes, 168 blocks of 1,024), the two
// launches. The design reads each entry once a launch, keeps the prefix
// in registers and shared memory, and needs no scratch but one int32 a
// block. The caller passes that scratch and its length; the entry points
// refuse one shorter than the scan's blocks of kThreads.
#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

using dsb::add_wrap;
using dsb::sub_wrap;

// Lane indices, or the entries of a source list, whose done flag is 0.
struct Lanes {
  const int* done;
  long long n;
  const int* src;  // nullptr: entry j is lane j
  int* out;

  __device__ bool live(long long j) const {
    if (src == nullptr) return done[j] == 0;
    const int s = src[j];
    return s >= 0 && s < n && done[s] == 0;
  }
  __device__ void keep(int slot, long long j) const {
    out[slot] = src == nullptr ? static_cast<int>(j) : src[j];
  }
  __device__ void fill(int slot) const { out[slot] = static_cast<int>(n); }
};

// The S x R grid of BWT rows of the final search intervals.
struct RowGrid {
  const int* st;  // int32 [8, S] interval-search carry
  const unsigned char* seed_ok;
  const int* lane;
  const int* s_idx;
  long long S;
  int R;
  int* sel;   // [cap]
  int* walk;  // [5, cap]
  int* wl;    // [4, cap]
  int cap;

  __device__ int sp(long long s) const { return st[2 * S + s]; }
  __device__ int ep(long long s) const { return st[3 * S + s]; }

  __device__ bool live(long long e) const {
    const long long s = e / R;
    const int k = static_cast<int>(e - s * R);
    const int a = sp(s), b = ep(s);
    return seed_ok[s] != 0 && a < b && add_wrap(a, k) < b;
  }
  // slot <- grid entry e (e = S * R - 1 for the fill), whose sel is v
  __device__ void put(int slot, long long e, int v, bool valid) const {
    const long long s = e / R;
    const int k = static_cast<int>(e - s * R);
    const int ml = st[4 * S + s];
    const int rem = sub_wrap(s_idx[s], ml);
    sel[slot] = v;
    walk[slot] = add_wrap(sp(s), k);
    walk[cap + slot] = st[5 * S + s];
    walk[2 * cap + slot] = 0;
    walk[3 * cap + slot] = 0;
    walk[4 * cap + slot] = 0;
    wl[slot] = lane[s];
    wl[cap + slot] = valid && rem > 0 ? rem : 0;
    wl[2 * cap + slot] = ml;
    wl[3 * cap + slot] = s_idx[s];
  }
  __device__ void keep(int slot, long long e) const {
    put(slot, e, static_cast<int>(e), true);
  }
  __device__ void fill(int slot) const {
    put(slot, S * R - 1, static_cast<int>(S * R), false);
  }
};

// launch 1: the live entries of each block of kThreads
template <class E>
__device__ void count_block(const E& e, long long m, int* counts) {
  __shared__ int warp_n[kWarps];
  const long long j = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  const unsigned bits = __ballot_sync(kFull, j < m && e.live(j));
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = __popc(bits);
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = warp_n[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (threadIdx.x == 0) counts[blockIdx.x] = v;
  }
}

// launch 2: each live entry to its slot, then the fill
template <class E>
__device__ void scatter_block(const E& e, long long m, const int* counts,
                              int cap) {
  __shared__ int warp_off[kWarps];
  __shared__ int block_base, live_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long j = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  const bool live = j < m && e.live(j);
  const unsigned bits = __ballot_sync(kFull, live);
  if (lane == 0) warp_off[warp] = __popc(bits);
  if (warp == 0) {  // the blocks before this one, and all of them
    int before = 0, all = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32) {
      const int c = counts[b];
      all += c;
      if (b < blockIdx.x) before += c;
    }
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_down_sync(kFull, before, o);
      all += __shfl_down_sync(kFull, all, o);
    }
    if (lane == 0) {
      block_base = before;
      live_total = all;
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix over the block's warps
    const int v = warp_off[lane];
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    warp_off[lane] = incl - v;
  }
  __syncthreads();
  if (live) {
    const int slot = block_base + warp_off[warp] +
                     __popc(bits & ((1u << lane) - 1u));
    if (slot < cap) e.keep(slot, j);
  }
  const int used = live_total < cap ? live_total : cap;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       k < cap; k += stride)
    if (k >= used) e.fill(static_cast<int>(k));
}

__global__ void __launch_bounds__(kThreads)
    compact_count_kernel(Lanes e, long long m, int* counts) {
  count_block(e, m, counts);
}

__global__ void __launch_bounds__(kThreads)
    compact_scatter_kernel(Lanes e, long long m, const int* counts,
                           int cap) {
  scatter_block(e, m, counts, cap);
}

__global__ void __launch_bounds__(kThreads)
    row_grid_count_kernel(RowGrid e, long long m, int* counts) {
  count_block(e, m, counts);
}

__global__ void __launch_bounds__(kThreads)
    row_grid_scatter_kernel(RowGrid e, long long m, const int* counts,
                            int cap) {
  scatter_block(e, m, counts, cap);
}

// blocks of the scan over m entries: at least one, for the fill
unsigned scan_blocks(long long m) {
  const long long b = (m + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b > 0 ? b : 1);
}

}  // namespace

// counts: int32[n_counts] scratch, at least scan_blocks(m) long, m = n
// (src null) or m (src); a shorter one is refused with cudaErrorInvalidValue
extern "C" int dsb_compact(const void* done, long long n, const void* src,
                           long long m, int cap, void* counts,
                           long long n_counts, void* out, void* stream) {
  const Lanes e{static_cast<const int*>(done), n,
                static_cast<const int*>(src), static_cast<int*>(out)};
  const long long entries = src == nullptr ? n : m;
  const unsigned blocks = scan_blocks(entries);
  if (n_counts < blocks) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_count_kernel<<<blocks, kThreads, 0, s>>>(
      e, entries, static_cast<int*>(counts));
  compact_scatter_kernel<<<blocks, kThreads, 0, s>>>(
      e, entries, static_cast<const int*>(counts), cap);
  return static_cast<int>(cudaGetLastError());
}

// counts: int32[n_counts] scratch, at least scan_blocks(S * R) long
extern "C" int dsb_row_grid(const void* st, const void* seed_ok,
                            const void* lane, const void* s_idx, long long S,
                            int R, int cap, void* counts, long long n_counts,
                            void* sel, void* walk, void* wl, void* stream) {
  const RowGrid e{static_cast<const int*>(st),
                  static_cast<const unsigned char*>(seed_ok),
                  static_cast<const int*>(lane),
                  static_cast<const int*>(s_idx), S, R,
                  static_cast<int*>(sel), static_cast<int*>(walk),
                  static_cast<int*>(wl), cap};
  const long long entries = S * R;
  const unsigned blocks = scan_blocks(entries);
  if (n_counts < blocks) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_grid_count_kernel<<<blocks, kThreads, 0, s>>>(
      e, entries, static_cast<int*>(counts));
  row_grid_scatter_kernel<<<blocks, kThreads, 0, s>>>(
      e, entries, static_cast<const int*>(counts), cap);
  return static_cast<int>(cudaGetLastError());
}
