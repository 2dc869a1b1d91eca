// Device code of stage 3's locate (K6), shared by csrc/locate.cu (the
// path's kernel) and csrc/measure.cu (its parts alone, for measurement).
//
// A lane's work: the walk (LF steps to a sampled row), the sample's
// unitig-string position p, the unitig u that holds p (searchsorted over
// the unitig starts), and P reference occurrences of u. Every index is
// clamped as the JAX gathers clamp it, so no read leaves its table; every
// output element equals the plain version's, failed and invalid lanes
// included, because stage 3 scatters gpos unmasked.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "wrap.cuh"

namespace dsb {

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

// The locate tables, as the C entry points take them.
struct LocTables {
  const unsigned* lfc;
  long long n_lfc, n_pad;
  const int* sa_uni;
  const int* sa_off;
  long long n_sa;
  const int* uni_start;
  long long n_us, n_ul;
  const int* reflist;
  long long n_rl;
  const int* refpos_global;
  const int* refpos_refid;
  long long n_rp;
};

// The walk: max_lf + 1 rounds, each first testing for a sample. Returns
// the row it stopped at (r) and its steps (k); ok where it reached a
// sample. An invalid lane never steps and is never ok.
__device__ __forceinline__ bool walk(const LocTables& t, bool valid,
                                     int max_lf, int& r, int& k) {
  k = 0;
  if (!valid) return false;
  for (int it = 0; it <= max_lf; ++it) {
    if ((r & 7) == 0) return true;
    const unsigned w =
        __ldg(t.lfc + jax_index(clamp_index(r, t.n_pad), t.n_lfc));
    if ((w >> kLfcShift) >= 4u) return false;  // '#', '$' or pad: fails
    r = static_cast<int>(w & kLfcRowMask);
    ++k;
  }
  return false;
}

// The P occurrences of unitig u (its reflist pair rp_s, rp_e) at offset
// u_off, written to slot i.
__device__ __forceinline__ void expand(const LocTables& t, long long i,
                                       int P, bool ok, int rp_s, int rp_e,
                                       int u_off, int* __restrict__ ref_out,
                                       int* __restrict__ gpos_out,
                                       unsigned char* __restrict__ pv_out) {
  const long long o = i * P;
  for (int j = 0; j < P; ++j) {
    const int rp = add_wrap(rp_s, j);
    const long long rc = clamp_index(rp, t.n_rp);
    ref_out[o + j] = __ldg(t.refpos_refid + rc);
    gpos_out[o + j] = add_wrap(__ldg(t.refpos_global + rc), u_off);
    pv_out[o + j] = (ok && rp < rp_e) ? 1 : 0;
  }
}

// Search and expansion from a verified guess. The sample names a unitig,
// uni0; its start, the next start and uni0's reflist pair are read at
// once. Where uni_start[uni0] <= p < uni_start[uni0 + 1] the answer is
// uni0: uni_start is non-decreasing (a cumulative sum of unitig lengths,
// and searchsorted's precondition), so every start up to uni0 is <= p and
// every later one is > p. Otherwise the search runs on what the two
// loads proved: past the next start it gallops forward from uni0 + 2 (a
// position a little past its unitig's end, as a walk that ran out of
// steps leaves, is found in a few probes), below uni0's start it bisects
// [0, uni0). The loop runs while any lane of the warp searches, each
// probe one load for the lanes still searching. A lane in [n) (in false)
// reads nothing and writes nothing; every lane of the warp must call it.
__device__ __forceinline__ void tail_guess(const LocTables& t, long long i,
                                           bool in, int r, int k, bool ok,
                                           int P, int* ref_out,
                                           int* gpos_out,
                                           unsigned char* pv_out) {
  long long lo = 0, hi = 0, step = 0, uni0 = 0;
  int p = 0, a0 = 0, rp_s = 0, rp_e = 0;
  if (in) {
    const long long s = clamp_index(r >> 3, t.n_sa);
    uni0 = jax_index(__ldg(t.sa_uni + s), t.n_us);
    const int off = __ldg(t.sa_off + s);
    const long long ug = uni0 < t.n_ul ? uni0 : t.n_ul - 1;
    a0 = __ldg(t.uni_start + uni0);
    const int a1 = __ldg(t.uni_start + (uni0 + 1 < t.n_us ? uni0 + 1 : uni0));
    rp_s = __ldg(t.reflist + jax_index(ug, t.n_rl));
    rp_e = __ldg(t.reflist + clamp_index(ug + 1, t.n_rl));
    p = add_wrap(add_wrap(a0, off), k + 1);
    // the answer (the count of starts <= p) lies in [lo, hi]
    if (a0 <= p) {
      lo = uni0 + 1;
      hi = t.n_us;
      if (uni0 + 1 < t.n_us) {
        if (p < a1) {
          hi = uni0 + 1;
        } else {
          lo = uni0 + 2;
          step = 1;
        }
      }
    } else {
      hi = uni0;
    }
  }
  while (__any_sync(0xffffffffu, lo < hi)) {
    if (lo < hi) {
      const long long mid =
          step ? (lo + step - 1 < hi ? lo + step - 1 : hi - 1)
               : (lo + hi) >> 1;
      if (__ldg(t.uni_start + mid) <= p) {
        lo = mid + 1;
        step <<= 1;
      } else {
        hi = mid;
        step = 0;
      }
    }
  }
  if (!in) return;
  const long long u = clamp_index(lo - 1, t.n_ul);
  int u_start = a0;
  if (u != uni0) {  // the guess's loads were uni0's
    u_start = __ldg(t.uni_start + u);
    rp_s = __ldg(t.reflist + jax_index(u, t.n_rl));
    rp_e = __ldg(t.reflist + clamp_index(u + 1, t.n_rl));
  }
  expand(t, i, P, ok, rp_s, rp_e, sub_wrap(p, u_start), ref_out, gpos_out,
         pv_out);
}

}  // namespace dsb
