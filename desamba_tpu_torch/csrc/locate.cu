// SA-sample locate and reference-position expansion of stage 3's anchors,
// one thread per lane.
//
// Replaces desamba_tpu/ops/locate.py:resolve_rows followed by
// expand_refpos (the get_uni analog, cly.c:466-491, with the SA-sample
// walk of bwt_single_search, cly.c:1353-1359, and map_seed's occurrence
// expansion, cly.c:698-741). Per lane: LF-step from a BWT row until it
// reaches a sampled row (row % 8 == 0), at most max_lf steps; a sentinel
// or pad char on the way fails the lane. The sample's (unitig, offset)
// plus the step count gives a position p in the concatenated unitig
// string; searchsorted over the unitig starts finds its unitig, and the
// unitig's first P reference occurrences give (ref id, global position)
// pairs. Lanes never interact. The device code is in locate.cuh.
//
// Every output element equals the plain version's, failed and invalid
// lanes included: their positions come from the same clamped gathers,
// because stage 3 scatters gpos unmasked. Every index is clamped as the
// JAX gathers clamp it, so no read leaves its table. uni_start must be
// non-decreasing, as searchsorted requires (LocArrays builds it as a
// cumulative sum).
//
// What bounds it on this card: a lane is a serial chain of dependent
// random gathers, so the kernel is latency-bound, and every lane of the
// grid is resident at once, so it lasts about as long as its longest
// chain: the walk (up to max_lf + 1 = 25 LF steps into the fused lfc
// table, char << 29 | LF row; about 3.5% of lanes take all 25), then the
// sample, then the search, then the occurrences. A blind search over
// all of uni_start would add ~log2(n_unitigs) dependent probes after the
// walk. This kernel verifies the unitig the sample names (tail_guess: its
// start, the next start and its reflist pair in one round of loads),
// which holds for nearly every lane, and gallops forward from it where a
// walk ran past its unitig's end; the chain after the walk is three
// rounds of loads for a lane whose guess holds. The walk alone runs at
// the speed of a bare pointer chase with the same gathers
// (chip_smoke.locate_split), so what is left is the walk and the tables'
// DRAM sectors. Tables are read through the read-only path.
#include "locate.cuh"

namespace {

__global__ void locate_kernel(dsb::LocTables t,
                              const int* __restrict__ rows,
                              const unsigned char* __restrict__ valid,
                              long long n, int max_lf, int P,
                              int* __restrict__ ref_out,
                              int* __restrict__ gpos_out,
                              unsigned char* __restrict__ pvalid_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const bool in = i < n;  // every lane stays for the warp's search
  int r = in ? rows[i] : 0, k = 0;
  const bool ok = in && dsb::walk(t, valid[i] != 0, max_lf, r, k);
  dsb::tail_guess(t, i, in, r, k, ok, P, ref_out, gpos_out, pvalid_out);
}

}  // namespace

extern "C" int dsb_locate(const void* lfc, long long n_lfc, long long n_pad,
                          const void* sa_uni, const void* sa_off,
                          long long n_sa, const void* uni_start,
                          long long n_us, long long n_ul, const void* reflist,
                          long long n_rl, const void* refpos_global,
                          const void* refpos_refid, long long n_rp,
                          const void* rows, const void* valid, long long n,
                          int max_lf, int P, void* ref_out, void* gpos_out,
                          void* pvalid_out, void* stream) {
  if (n > 0) {
    const dsb::LocTables t{static_cast<const unsigned*>(lfc), n_lfc, n_pad,
                           static_cast<const int*>(sa_uni),
                           static_cast<const int*>(sa_off), n_sa,
                           static_cast<const int*>(uni_start), n_us, n_ul,
                           static_cast<const int*>(reflist), n_rl,
                           static_cast<const int*>(refpos_global),
                           static_cast<const int*>(refpos_refid), n_rp};
    const int threads = 256;  // whole warps: the search's vote needs them
    const long long blocks = (n + threads - 1) / threads;
    locate_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const int*>(rows),
        static_cast<const unsigned char*>(valid), n, max_lf, P,
        static_cast<int*>(ref_out), static_cast<int*>(gpos_out),
        static_cast<unsigned char*>(pvalid_out));
  }
  return static_cast<int>(cudaGetLastError());
}
