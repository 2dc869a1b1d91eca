// FM backward interval search, one thread per search lane.
//
// Replaces desamba_tpu/ops/fm.py:interval_search (with occ and popcount32):
// the lockstep bwt_MEM_search main loop (cly.c:1399-1417) that the JAX
// package runs as a while_loop over all lanes. Lanes never interact, so a
// thread that runs its own lane for up to max_steps iterations, stopping
// when the lane is done, computes exactly what the lockstep loop computes.
//
// What bounds it on this card: every step is a dependent random 8-byte
// gather into the occ32 table for sp and one for ep, then a popcount each;
// the table is far larger than L2 at real index sizes, so the kernel is
// latency-bound on those gathers. The design keeps each lane's whole
// 8-field carry in registers across its steps, loads each (base count,
// bit word) pair as one aligned uint2, issues the sp and ep gathers back
// to back so they are in flight together, and lets a done lane retire its
// thread instead of idling through later steps. On the card it runs
// within 7-15% of the same chain of gathers alone (csrc/measure.cu's
// dsb_occ_chase), so the step is kept as it was. Two changes were
// measured and made it slower: the lane's next read code loaded a step
// ahead (the burst 9-18%: most lanes stop after one step, so the code
// read for a step they never take costs a sector), and one occ load
// where sp and ep share a 32-row block (the resumes 12-14%).
//
// Carry layout: int32 [8, n] rows sp, ep, nsp, nep, match_len, ptr, done,
// status (the JAX carry's fields in order; done as 0/1).
//
// Resume through an index list: with sel (int32[m], distinct lane indices;
// entries outside [0, n) are skipped) thread j runs lane sel[j] of the
// carry in place (st_out == st_in) and writes only a lane that it ran:
// JAX's gather of the compacted carry, resume and scatter back
// (fast_engine.py:245-275) without moving or copying the carry.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_occ.cuh"

namespace {

// st_in and st_out alias on a resume.
__global__ void interval_search_kernel(
    const uint2* __restrict__ occ32, long long n_blk,
    const int* __restrict__ rank, const int* __restrict__ codes, int W,
    const int* __restrict__ lanes, const int* __restrict__ max_rst,
    const int* __restrict__ l_min, const int* __restrict__ l_max,
    const int* st_in, int* st_out, long long n,
    const int* __restrict__ sel, long long m, int max_steps) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= m) return;
  const long long i = sel == nullptr ? t : sel[t];
  if (i < 0 || i >= n) return;
  int sp = st_in[i], ep = st_in[n + i];
  int nsp = st_in[2 * n + i], nep = st_in[3 * n + i];
  int ml = st_in[4 * n + i], ptr = st_in[5 * n + i];
  int done = st_in[6 * n + i], status = st_in[7 * n + i];
  const bool run = !done && max_steps > 0;
  if (run) {
    const int* row = codes + static_cast<long long>(lanes[i]) * W;
    const int mr = max_rst[i], lmin = l_min[i], lmax = l_max[i];
    for (int it = 0; it < max_steps && !done; ++it) {
      const int ch = dsb::read_code(row, ptr, W);
      const bool valid_c = ch <= 5;
      const int cc = ch < 0 ? 0 : (ch > 5 ? 5 : ch);
      const int c_occ = cc > 4 ? 4 : cc;
      const uint2 p_sp = occ32[dsb::occ_block(sp, n_blk) * 5 + c_occ];
      const uint2 p_ep = occ32[dsb::occ_block(ep, n_blk) * 5 + c_occ];
      const int s = valid_c ? rank[cc] + dsb::occ_count(p_sp, sp) : 0;
      const int e = valid_c ? rank[cc] + dsb::occ_count(p_ep, ep) : 0;
      const bool brk1 = (ml >= lmin - 1) && (s + mr >= e);
      const bool ret0 = (ml >= lmin - 1) && !brk1 && (ml >= lmax);
      const bool brk2 = !brk1 && !ret0 && (s + 1 >= e);
      if (brk1 || ret0 || brk2) {
        nsp = s;
        nep = e;
        done = 1;
        if (ret0) status = 1;
      } else {
        sp = s;
        ep = e;
        ml += 1;
      }
      ptr -= 1;  // also on the stopping step (fm.py:234)
    }
  }
  if (sel != nullptr && !run) return;  // in place: the lane is unchanged
  st_out[i] = sp;
  st_out[n + i] = ep;
  st_out[2 * n + i] = nsp;
  st_out[3 * n + i] = nep;
  st_out[4 * n + i] = ml;
  st_out[5 * n + i] = ptr;
  st_out[6 * n + i] = done;
  st_out[7 * n + i] = status;
}

}  // namespace

extern "C" int dsb_interval_search(
    const void* occ32, long long n_blk, const void* rank, const void* codes,
    int W, const void* lanes, const void* max_rst, const void* l_min,
    const void* l_max, const void* st_in, void* st_out, long long n,
    const void* sel, long long m, int max_steps, void* stream) {
  // m: threads, n without a list
  if (m > 0) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    interval_search_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(occ32), n_blk,
        static_cast<const int*>(rank), static_cast<const int*>(codes), W,
        static_cast<const int*>(lanes), static_cast<const int*>(max_rst),
        static_cast<const int*>(l_min), static_cast<const int*>(l_max),
        static_cast<const int*>(st_in), static_cast<int*>(st_out), n,
        static_cast<const int*>(sel), m, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
