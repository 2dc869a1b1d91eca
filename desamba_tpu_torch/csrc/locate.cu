// SA-sample locate and reference-position expansion of stage 3's anchors,
// one thread per lane.
//
// Replaces desamba_tpu/ops/locate.py:resolve_rows followed by
// expand_refpos (the get_uni analog, cly.c:466-491, with the SA-sample
// walk of bwt_single_search, cly.c:1353-1359, and map_seed's occurrence
// expansion, cly.c:698-741). Per lane: LF-step from a BWT row until it
// reaches a sampled row (row % 8 == 0), at most max_lf steps; a sentinel
// or pad char on the way fails the lane. The sample's (unitig, offset)
// plus the step count gives a position in the concatenated unitig string;
// an upper-bound binary search over the unitig starts finds its unitig,
// and the unitig's first P reference occurrences give (ref id, global
// position) pairs. Lanes never interact.
//
// Every output element equals the plain version's, failed and invalid
// lanes included: their positions come from the same clamped gathers,
// because stage 3 scatters gpos unmasked. Every index is clamped as the
// JAX gathers clamp it, so no read leaves its table.
//
// What bounds it on this card: each LF step is one dependent random
// 4-byte gather into the fused lfc table (char << 29 | LF row), and the
// search is ~log2(n_unitigs) dependent probes, so a lane is a serial
// chain of gathers and the kernel is latency-bound. The design keeps the
// walk and the search in registers, reads the tables through the
// read-only path, stops a lane's walk at its sample or its sentinel, and
// writes the P slots of a lane from the same thread.
#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace {

constexpr int kLfcShift = 29;
constexpr unsigned kLfcRowMask = (1u << kLfcShift) - 1u;

// JAX gather semantics: negative indices count from the end, then clamp.
__device__ __forceinline__ long long jax_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

using dsb::add_wrap;
using dsb::sub_wrap;

__global__ void locate_kernel(
    const unsigned* __restrict__ lfc, long long n_lfc, long long n_pad,
    const int* __restrict__ sa_uni, const int* __restrict__ sa_off,
    long long n_sa, const int* __restrict__ uni_start, long long n_us,
    long long n_ul, const int* __restrict__ reflist, long long n_rl,
    const int* __restrict__ refpos_global,
    const int* __restrict__ refpos_refid, long long n_rp,
    const int* __restrict__ rows, const unsigned char* __restrict__ valid,
    long long n, int max_lf, int P, int* __restrict__ ref_out,
    int* __restrict__ gpos_out, unsigned char* __restrict__ pvalid_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  // the walk: max_lf + 1 rounds, each first testing for a sample; an
  // invalid lane never steps and is never ok
  int r = rows[i];
  int k = 0;
  bool ok = false;
  if (valid[i]) {
    for (int it = 0; it <= max_lf; ++it) {
      if ((r & 7) == 0) {
        ok = true;
        break;
      }
      const unsigned w = __ldg(lfc + jax_index(clamp_index(r, n_pad), n_lfc));
      if ((w >> kLfcShift) >= 4u) break;  // '#', '$' or pad: fails
      r = static_cast<int>(w & kLfcRowMask);
      ++k;
    }
  }
  // the sample's unitig-string position (text pos = sa_off + steps + 1)
  const long long s = clamp_index(r >> 3, n_sa);
  const long long uni0 = jax_index(__ldg(sa_uni + s), n_us);
  const int p = add_wrap(add_wrap(__ldg(uni_start + uni0), __ldg(sa_off + s)),
                         k + 1);
  // searchsorted(uni_start, p, right) - 1: the last start <= p
  long long lo = 0, hi = n_us;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(uni_start + mid) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long u = clamp_index(lo - 1, n_ul);
  const int u_off = sub_wrap(p, __ldg(uni_start + u));
  // the unitig's first P reference occurrences
  const int rp_s = __ldg(reflist + jax_index(u, n_rl));
  const int rp_e = __ldg(reflist + clamp_index(u + 1, n_rl));
  const long long o = i * P;
  for (int j = 0; j < P; ++j) {
    const int rp = add_wrap(rp_s, j);
    const long long rc = clamp_index(rp, n_rp);
    ref_out[o + j] = __ldg(refpos_refid + rc);
    gpos_out[o + j] = add_wrap(__ldg(refpos_global + rc), u_off);
    pvalid_out[o + j] = (ok && rp < rp_e) ? 1 : 0;
  }
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
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    locate_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(lfc), n_lfc, n_pad,
        static_cast<const int*>(sa_uni), static_cast<const int*>(sa_off), n_sa,
        static_cast<const int*>(uni_start), n_us, n_ul,
        static_cast<const int*>(reflist), n_rl,
        static_cast<const int*>(refpos_global),
        static_cast<const int*>(refpos_refid), n_rp,
        static_cast<const int*>(rows),
        static_cast<const unsigned char*>(valid), n, max_lf, P,
        static_cast<int*>(ref_out), static_cast<int*>(gpos_out),
        static_cast<unsigned char*>(pvalid_out));
  }
  return static_cast<int>(cudaGetLastError());
}
