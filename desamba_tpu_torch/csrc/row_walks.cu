// Per-row LF walks, one thread per walk lane: the fast path's variant
// without a trace (row_walks_kernel) and the validation engine's with one
// (row_walks_trace_kernel, at the end of the file).
//
// Replaces desamba_tpu/ops/fm.py:row_walks (with lf_cur), the lockstep
// bwt_single_search (cly.c:1339-1378) without the row trace: from a BWT
// row, step LF while the BWT char equals the read char at ptr, ptr
// decreasing, up to max_len steps, flagging pad chars (> 5). Lanes never
// interact, so one thread running its lane until done or trace_cap steps
// equals the JAX while_loop exactly.
//
// What bounds it on this card: each step is one dependent random 4-byte
// gather into the fused lfc table (char << 29 | LF row), so a walk is a
// serial chain of gathers and the kernel is latency-bound. The design
// keeps the 5-field carry in registers, reads char and next row from one
// 32-bit word, and retires a lane's thread as soon as its walk stops, so
// the few long walks do not hold the short ones. On the card its steps
// cost what a bare pointer chase over lfc with the same gathers costs
// (csrc/measure.cu, chip_smoke.walk_sweep): the read code, gathered
// beside each lfc word, adds nothing to the chain (loading a walk's codes
// into registers before its first step, or issuing lanes and max_lens
// with the carry, was measured and did not help).
//
// Carry layout: int32 [5, n] rows sp, ptr, n, done, bad (done/bad as 0/1).
//
// Resume through an index list: with sel (int32[m], distinct slot indices;
// entries outside [0, n) are skipped) thread j runs slot sel[j] of the
// carry in place (st_out == st_in) and writes only a slot that it walked:
// JAX's gather, resume and scatter back of the walks' two cuts
// (fast_engine.py:314-347) without moving or copying the carry.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLfcShift = 29;
constexpr unsigned kLfcRowMask = (1u << kLfcShift) - 1u;

// JAX gather semantics: negative indices count from the end, then clamp.
__device__ __forceinline__ long long jax_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One LF step of a lane (the loop body of bwt_single_search): on a match
// of the BWT char at sp with the read char at ptr, below max_len steps,
// sp moves to its LF row, ptr back one and cnt up one; a pad char met
// below max_len sets bad. Returns whether the lane stepped; a lane that
// did not is done. Both kernels below take their steps here.
__device__ __forceinline__ bool lf_step(const unsigned* __restrict__ lfc,
                                        long long n_rows, const int* row,
                                        int W, int max_len, int& sp,
                                        int& ptr, int& cnt, int& bad) {
  const unsigned w = lfc[jax_index(sp, n_rows)];
  const int c = static_cast<int>(w >> kLfcShift);
  const int want = (ptr >= 0 && ptr < W) ? row[ptr] : -1;
  const bool is_bad = c > 5;
  if (is_bad && cnt < max_len) bad = 1;
  if (c != want || cnt >= max_len || is_bad) return false;
  sp = static_cast<int>(w & kLfcRowMask);
  ptr -= 1;
  cnt += 1;
  return true;
}

// st_in and st_out alias on a resume.
__global__ void row_walks_kernel(
    const unsigned* __restrict__ lfc, long long n_rows,
    const int* __restrict__ codes, int W, const int* __restrict__ lanes,
    const int* __restrict__ max_lens, const int* st_in, int* st_out,
    long long n, const int* __restrict__ sel, long long m, int trace_cap) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= m) return;
  const long long i = sel == nullptr ? t : sel[t];
  if (i < 0 || i >= n) return;
  int sp = st_in[i], ptr = st_in[n + i], cnt = st_in[2 * n + i];
  int done = st_in[3 * n + i], bad = st_in[4 * n + i];
  const bool walk = !done && trace_cap > 0;
  if (walk) {
    const int* row = codes + static_cast<long long>(lanes[i]) * W;
    const int max_len = max_lens[i];
    for (int it = 0; it < trace_cap && !done; ++it)
      if (!lf_step(lfc, n_rows, row, W, max_len, sp, ptr, cnt, bad)) done = 1;
  }
  if (sel != nullptr && !walk) return;  // in place: the slot is unchanged
  st_out[i] = sp;
  st_out[n + i] = ptr;
  st_out[2 * n + i] = cnt;
  st_out[3 * n + i] = done;
  st_out[4 * n + i] = bad;
}

// The traced walks (desamba_tpu/ops/fm.py:row_walks with
// with_trace=True, as desamba_tpu/engine/tpu_engine.py:188-201 calls it):
// each lane starts from (start_rows, ptrs) with a zero count and takes the
// same steps (lf_step) for up to trace_cap steps. trace[lane, step] is the
// row the lane reached at that step, or -1 where it took no step, so the
// host replays the reference's sp_set dedup (cly.c:1366-1371) from the
// trace. JAX scans all trace_cap steps; a lane that stops here writes -1
// into the rest of its trace row, which is what those steps write there.
// res rows: final_sp, final_ptr, steps, bad_char, overflow (still
// walking after trace_cap steps) and stop_max (steps >= max_len).
//
// What bounds it: as above, one dependent random gather a step; and each
// lane writes its trace row of trace_cap int32 once.
__global__ void row_walks_trace_kernel(
    const unsigned* __restrict__ lfc, long long n_rows,
    const int* __restrict__ codes, int W, const int* __restrict__ lanes,
    const int* __restrict__ start_rows, const int* __restrict__ ptrs,
    const int* __restrict__ max_lens, long long n, int trace_cap,
    int* __restrict__ trace, int* __restrict__ res) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const int* row = codes + static_cast<long long>(lanes[i]) * W;
  const int max_len = max_lens[i];
  int* tr = trace + i * trace_cap;
  int sp = start_rows[i], ptr = ptrs[i], cnt = 0, bad = 0;
  bool done = false;
  int it = 0;
  for (; it < trace_cap && !done; ++it) {
    done = !lf_step(lfc, n_rows, row, W, max_len, sp, ptr, cnt, bad);
    tr[it] = done ? -1 : sp;
  }
  for (; it < trace_cap; ++it) tr[it] = -1;
  res[i] = sp;
  res[n + i] = ptr;
  res[2 * n + i] = cnt;
  res[3 * n + i] = bad;
  res[4 * n + i] = !done;
  res[5 * n + i] = cnt >= max_len;
}

}  // namespace

// st_out: a new carry without sel; st_in itself with sel (in place).
extern "C" int dsb_row_walks(const void* lfc, long long n_rows,
                             const void* codes, int W, const void* lanes,
                             const void* max_lens, const void* st_in,
                             void* st_out, long long n, const void* sel,
                             long long m, int trace_cap, void* stream) {
  // m: threads, n without a list
  if (m > 0) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    row_walks_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(lfc), n_rows,
        static_cast<const int*>(codes), W, static_cast<const int*>(lanes),
        static_cast<const int*>(max_lens), static_cast<const int*>(st_in),
        static_cast<int*>(st_out), n, static_cast<const int*>(sel), m,
        trace_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_row_walks_trace(const void* lfc, long long n_rows,
                                   const void* codes, int W,
                                   const void* lanes, const void* start_rows,
                                   const void* ptrs, const void* max_lens,
                                   long long n, int trace_cap, void* trace,
                                   void* res, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    row_walks_trace_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(lfc), n_rows,
        static_cast<const int*>(codes), W, static_cast<const int*>(lanes),
        static_cast<const int*>(start_rows), static_cast<const int*>(ptrs),
        static_cast<const int*>(max_lens), n, trace_cap,
        static_cast<int*>(trace), static_cast<int*>(res));
  }
  return static_cast<int>(cudaGetLastError());
}
