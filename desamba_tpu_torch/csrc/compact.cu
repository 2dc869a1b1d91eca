// Stage 2's capped, stable prefix compactions, as two kernels that share
// one single-pass scan.
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
// The scan: one launch, a single pass with decoupled look-back. Each
// block takes its index from an atomic ticket, so that it waits only on
// blocks that started before it. It counts its live entries (1,024
// threads of kItems consecutive ones: a prefix over the warp's threads,
// then over the block's 32 warps), publishes
// the count, then looks back over the flags of the blocks before it, 32
// at a time, summing counts until it meets a published inclusive prefix;
// it publishes its own inclusive prefix and writes each kept entry to its
// slot. The blocks past the scan's (fill blocks, taking the last tickets)
// wait for the last scan block's inclusive prefix, the live total, and
// write the fill to the slots past min(total, cap), kFillSpan slots a
// block. The block that takes the last ticket sets the ticket back to 0
// for the next call on the stream.
//
// Scratch: uint64 words, word 0 the ticket, word 1 + b block b's flag:
// (call << 34) | (status << 32) | value, status 1 a block's count and 2
// its inclusive prefix. The wrapper passes a call number that it
// increments each call (1 .. 2^30 - 1; ops/compact.py), so a flag left by
// an earlier call, with another m, never reads as ready, and the scratch
// needs no memset between calls.
//
// What bounds it on this card: the bytes of the entries (4 a lane; the
// row grid reads 4 carry rows, the mask and two int32 rows a lane) and,
// at stage 2's sizes (172,032 lanes, 344,064 grid entries), the launch
// and the chain of look-backs. The design reads each entry once, keeps
// the prefix in registers and shared memory, and launches once a call;
// over a dense row, four entries a thread put every block of a call (42
// or 84 of them, and the fill blocks) on the card in one wave, and the
// look-back crosses at most three windows of 32 flags; a source list
// (21,504 entries) takes one a thread, so that its random gathers of
// done spread over 21 SMs, not 6.
#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// consecutive entries a thread: four over a dense row (the mask, the row
// grid), so that a call's blocks fit the card in one wave; one over a
// source list, whose entries gather done at random and go faster spread
// over more SMs
constexpr int kDenseItems = 4;  // SCAN_BLOCK = kThreads * kDenseItems
constexpr int kListItems = 1;   // LIST_BLOCK = kThreads * kListItems
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

  // entries are below 2^31 (the wrapper checks S * R): 32-bit index math
  __device__ bool live(long long e) const {
    const unsigned s = static_cast<unsigned>(e) / static_cast<unsigned>(R);
    const int k = static_cast<int>(static_cast<unsigned>(e) - s * R);
    const int a = sp(s), b = ep(s);
    return seed_ok[s] != 0 && a < b && add_wrap(a, k) < b;
  }
  // slot <- grid entry e (e = S * R - 1 for the fill), whose sel is v
  __device__ void put(int slot, long long e, int v, bool valid) const {
    const unsigned s = static_cast<unsigned>(e) / static_cast<unsigned>(R);
    const int k = static_cast<int>(static_cast<unsigned>(e) - s * R);
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

constexpr unsigned long long kCount = 1ull << 32;   // status 1
constexpr unsigned long long kPrefix = 2ull << 32;  // status 2
constexpr int kCallShift = 34;
// slots of the fill a fill block writes (FILL_SPAN in ops/compact.py)
constexpr int kFillSpan = 4 * kThreads;

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The live total: the inclusive prefix of the last scan block, once it is
// published (it started before any fill block took its ticket).
__device__ unsigned live_total(const unsigned long long* flags,
                               unsigned last, unsigned long long tag) {
  for (;;) {
    const unsigned long long f = load_flag(flags + last);
    if ((f & ~0xffffffffull) == (tag | kPrefix))
      return static_cast<unsigned>(f);
  }
}

// Warp 0: the sum of the counts of blocks [0, b), from their flags.
__device__ unsigned look_back(const unsigned long long* flags, unsigned b,
                              unsigned long long tag, int lane) {
  unsigned excl = 0;
  long long look = static_cast<long long>(b) - 1;
  for (;;) {
    const long long idx = look - lane;  // lane 0: the nearest block
    unsigned long long f;
    for (;;) {
      f = idx >= 0 ? load_flag(flags + idx) : (tag | kPrefix);
      const bool ready = (f >> kCallShift) == (tag >> kCallShift) &&
                         (f & (3ull << 32)) != 0;
      if (__all_sync(kFull, ready)) break;
    }
    const unsigned pre = __ballot_sync(kFull, (f & kPrefix) != 0);
    // the counts up to and including the nearest inclusive prefix
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl += __reduce_add_sync(kFull,
                              lane <= stop ? static_cast<unsigned>(f) : 0u);
    if (pre) return excl;
    look -= 32;
  }
}

// One block of the scan (blockIdx ignored: the ticket orders the blocks).
// scan_blocks blocks cover the m entries, kThreads * kItems each (kItems
// consecutive entries a thread); the rest fill.
template <int kItems, class E>
__device__ void scan_block(const E& e, long long m, int cap,
                           unsigned long long* scratch, unsigned scan_blocks,
                           unsigned call) {
  __shared__ int warp_off[kWarps];
  __shared__ unsigned s_ticket, block_base, s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned t =
        static_cast<unsigned>(atomicAdd(scratch, 1ull));
    if (t == gridDim.x - 1) atomicExch(scratch, 0ull);  // the next call's
    s_ticket = t;
  }
  __syncthreads();
  const unsigned b = s_ticket;
  unsigned long long* flags = scratch + 1;
  const unsigned long long tag =
      static_cast<unsigned long long>(call) << kCallShift;
  if (b >= scan_blocks) {  // a fill block
    if (threadIdx.x == 0) s_total = live_total(flags, scan_blocks - 1, tag);
    __syncthreads();
    const long long used = s_total < static_cast<unsigned>(cap)
                               ? static_cast<long long>(s_total)
                               : cap;
    const long long lo = static_cast<long long>(b - scan_blocks) * kFillSpan;
    const long long from = lo > used ? lo : used;
    const long long to = lo + kFillSpan < cap ? lo + kFillSpan : cap;
    for (long long k = from + threadIdx.x; k < to; k += kThreads)
      e.fill(static_cast<int>(k));
    return;
  }
  // the thread's kItems entries: bit q of mine where entry j0 + q lives
  const long long j0 = b * static_cast<long long>(kThreads * kItems) +
                       threadIdx.x * kItems;
  unsigned mine = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    if (j0 + q < m && e.live(j0 + q)) mine |= 1u << q;
  // inclusive prefix of the live counts over the warp's threads
  const int c = __popc(mine);
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    // exclusive prefix over the block's warps, the block's count, and
    // the blocks before it
    const int v = warp_off[lane];
    int w_incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w_incl, o);
      if (lane >= o) w_incl += u;
    }
    warp_off[lane] = w_incl - v;
    const unsigned count =
        __shfl_sync(kFull, static_cast<unsigned>(w_incl), 31);
    unsigned excl = 0;
    if (b == 0) {
      if (lane == 0) store_flag(flags, tag | kPrefix | count);
    } else {
      if (lane == 0) store_flag(flags + b, tag | kCount | count);
      excl = look_back(flags, b, tag, lane);
      if (lane == 0) store_flag(flags + b, tag | kPrefix | (excl + count));
    }
    if (lane == 0) block_base = excl;
  }
  __syncthreads();
  const unsigned first = block_base + warp_off[warp] + (incl - c);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if ((mine >> q) & 1u) {
      const unsigned slot = first + __popc(mine & ((1u << q) - 1u));
      if (slot < static_cast<unsigned>(cap))
        e.keep(static_cast<int>(slot), j0 + q);
    }
  }
}

template <int kItems>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Lanes e, long long m, int cap,
                   unsigned long long* scratch, unsigned scan_blocks,
                   unsigned call) {
  scan_block<kItems>(e, m, cap, scratch, scan_blocks, call);
}

__global__ void __launch_bounds__(kThreads)
    row_grid_kernel(RowGrid e, long long m, int cap,
                    unsigned long long* scratch, unsigned scan_blocks,
                    unsigned call) {
  scan_block<kDenseItems>(e, m, cap, scratch, scan_blocks, call);
}

// blocks of the scan over m entries, kItems a thread (at least one block,
// whose prefix is the live total), and the fill blocks after them
unsigned scan_blocks(long long m, int items) {
  const long long per = static_cast<long long>(kThreads) * items;
  const long long b = (m + per - 1) / per;
  return static_cast<unsigned>(b > 0 ? b : 1);
}

unsigned fill_blocks(int cap) {
  return static_cast<unsigned>((cap + kFillSpan - 1) / kFillSpan);
}

constexpr unsigned kCallLimit = 1u << 30;

// scratch: n_scratch uint64 words, at least 1 + scan_blocks(entries,
// items); call: 1 .. 2^30 - 1, another than any flag the scratch holds. A
// shorter scratch, or a call number out of range, is refused with
// cudaErrorInvalidValue.
template <class K, class E>
int launch(K kernel, int items, const E& e, long long entries, int cap,
           void* scratch, long long n_scratch, unsigned call, void* stream) {
  const unsigned blocks = scan_blocks(entries, items);
  if (cap < 1 || n_scratch < 1 + static_cast<long long>(blocks) ||
      call == 0 || call >= kCallLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks + fill_blocks(cap), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      e, entries, cap, static_cast<unsigned long long*>(scratch), blocks,
      call);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsb_compact(const void* done, long long n, const void* src,
                           long long m, int cap, void* scratch,
                           long long n_scratch, unsigned call, void* out,
                           void* stream) {
  const Lanes e{static_cast<const int*>(done), n,
                static_cast<const int*>(src), static_cast<int*>(out)};
  if (src == nullptr)
    return launch(compact_kernel<kDenseItems>, kDenseItems, e, n, cap,
                  scratch, n_scratch, call, stream);
  return launch(compact_kernel<kListItems>, kListItems, e, m, cap, scratch,
                n_scratch, call, stream);
}

extern "C" int dsb_row_grid(const void* st, const void* seed_ok,
                            const void* lane, const void* s_idx, long long S,
                            int R, int cap, void* scratch,
                            long long n_scratch, unsigned call, void* sel,
                            void* walk, void* wl, void* stream) {
  const RowGrid e{static_cast<const int*>(st),
                  static_cast<const unsigned char*>(seed_ok),
                  static_cast<const int*>(lane),
                  static_cast<const int*>(s_idx), S, R,
                  static_cast<int*>(sel), static_cast<int*>(walk),
                  static_cast<int*>(wl), cap};
  return launch(row_grid_kernel, kDenseItems, e, S * R, cap, scratch,
                n_scratch, call, stream);
}
