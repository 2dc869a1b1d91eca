// Floors for measurement only: kernels that do a part of a path kernel's
// work and nothing else, so that the path kernel's time can be set beside
// what that part alone costs on the card. No path calls them; chip_smoke.py
// and tools/kernel_ab.py build this file with kernels.build_all(extra=...)
// and load its entry points with ctypes.
//
// dsb_bloom_gather: stage 1's bloom reads alone (csrc/stage1.cu). Point i
// of a list reads word a1[i] of bitmap 1 and, where its bit (sh[i] & 31)
// is set, word a2[i] (bit sh[i] >> 8), as stage1_kernel does for each
// probed point; each warp writes its hit count to warp_hits.
//
// dsb_lf_chase: K2's chain alone (csrc/row_walks.cu). Lane i takes
// loads[i] dependent gathers over lfc from row start[i], as a walk that
// takes those steps does, with no compare.
//
// dsb_occ_chase: K1's chain alone (csrc/fm_search.cu). Lane j runs
// carry lane sel[j] (or j, with no list) for steps[j] steps of the
// backward search's two uint2 occ32 gathers, at sp and at ep, each for
// the read's code at ptr, ptr falling by one a step, with no stop test
// and nothing else: the gathers a lane of the search makes in those
// steps (its stopping step included), in the same dependent chain.
//
// K6's parts (csrc/locate.cu, device code in locate.cuh), each alone:
// dsb_locate_walk, the walk on the lanes' own rows (each lane's final row,
// steps and ok out); and dsb_locate_tail, the search and the expansion
// from those (tail_guess, as the path's kernel runs it).
//
// The floors of a short kernel (K9b combine, K11 shard_merge), at the
// path kernel's grid: dsb_empty_launch, a launch of an empty kernel; and
// dsb_one_round, one round of independent 16-byte loads of the call's
// input bytes, laid end to end in one buffer by the caller (each thread
// all its loads of a batch of kRoundBatch before it uses one), and one
// round of 4-byte stores of as many words as the call writes. The least
// time a kernel of that grid, reading those bytes once with no dependent
// load, can take.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_occ.cuh"
#include "locate.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRoundBatch = 8;  // 16-byte loads a thread issues before using one

__global__ void empty_kernel() {}

__global__ void one_round_kernel(const uint4* __restrict__ in, long long n16,
                                 unsigned* __restrict__ out, long long n_out) {
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long G = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned acc = 0;
  for (long long base = 0; base < n16; base += kRoundBatch * G) {
    uint4 v[kRoundBatch];
#pragma unroll
    for (int k = 0; k < kRoundBatch; ++k) {
      const long long p = base + k * G + g;
      v[k] = p < n16 ? __ldg(in + p) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kRoundBatch; ++k)
      acc ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
  }
  for (long long i = g; i < n_out; i += G) out[i] = acc;
}

__global__ void bloom_gather_kernel(const unsigned* __restrict__ w01,
                                    const unsigned* __restrict__ a1,
                                    const unsigned* __restrict__ a2,
                                    const unsigned* __restrict__ sh,
                                    long long m, int* __restrict__ warp_hits) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  unsigned h = 0;
  if (i < m) {
    const unsigned s = sh[i];
    h = (__ldg(w01 + a1[i]) >> (s & 31u)) & 1u;
    if (h) h = (__ldg(w01 + a2[i]) >> (s >> 8)) & 1u;
  }
  h = __reduce_add_sync(kFull, h);
  if ((threadIdx.x & 31) == 0 && i < m) warp_hits[i >> 5] = h;
}

__global__ void lf_chase_kernel(const unsigned* __restrict__ lfc,
                                long long n_rows,
                                const int* __restrict__ start,
                                const int* __restrict__ loads, long long n,
                                int* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  int sp = start[i];
  const int k = loads[i];
  for (int it = 0; it < k; ++it)
    sp = static_cast<int>(__ldg(lfc + dsb::jax_index(sp, n_rows)) &
                           dsb::kLfcRowMask);
  out[i] = sp;
}

__global__ void occ_chase_kernel(const uint2* __restrict__ occ32,
                                 long long n_blk,
                                 const int* __restrict__ rank,
                                 const int* __restrict__ codes, int W,
                                 const int* __restrict__ lanes,
                                 const int* __restrict__ st, long long n,
                                 const int* __restrict__ sel, long long m,
                                 const int* __restrict__ steps,
                                 int* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= m) return;
  const long long i = sel == nullptr ? t : sel[t];
  if (i < 0 || i >= n) return;
  int sp = st[i], ep = st[n + i], ptr = st[5 * n + i];
  const int* row = codes + static_cast<long long>(lanes[i]) * W;
  const int k = steps[t];
  for (int it = 0; it < k; ++it) {
    const int ch = dsb::read_code(row, ptr, W);
    const int c = dsb::occ_column(ch);
    const uint2 ps = occ32[dsb::occ_block(sp, n_blk) * 5 + c];
    const uint2 pe = occ32[dsb::occ_block(ep, n_blk) * 5 + c];
    const bool valid_c = ch <= 5;
    const int rk = valid_c ? rank[ch < 0 ? 0 : ch] : 0;
    sp = valid_c ? rk + dsb::occ_count(ps, sp) : 0;
    ep = valid_c ? rk + dsb::occ_count(pe, ep) : 0;
    ptr -= 1;
  }
  out[t] = sp ^ ep;
}

__global__ void locate_walk_kernel(dsb::LocTables t,
                                   const int* __restrict__ rows,
                                   const unsigned char* __restrict__ valid,
                                   long long n, int max_lf,
                                   int* __restrict__ r_out,
                                   int* __restrict__ k_out,
                                   unsigned char* __restrict__ ok_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  int r = rows[i], k = 0;
  ok_out[i] = dsb::walk(t, valid[i] != 0, max_lf, r, k) ? 1 : 0;
  r_out[i] = r;
  k_out[i] = k;
}

__global__ void locate_tail_kernel(dsb::LocTables t,
                                   const int* __restrict__ r_in,
                                   const int* __restrict__ k_in,
                                   const unsigned char* __restrict__ ok_in,
                                   long long n, int P,
                                   int* __restrict__ ref_out,
                                   int* __restrict__ gpos_out,
                                   unsigned char* __restrict__ pv_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const bool in = i < n;
  const int r = in ? r_in[i] : 0, k = in ? k_in[i] : 0;
  const bool ok = in && ok_in[i] != 0;
  dsb::tail_guess(t, i, in, r, k, ok, P, ref_out, gpos_out, pv_out);
}

dsb::LocTables loc_tables(const void* lfc, long long n_lfc, long long n_pad,
                          const void* sa_uni, const void* sa_off,
                          long long n_sa, const void* uni_start,
                          long long n_us, long long n_ul, const void* reflist,
                          long long n_rl, const void* refpos_global,
                          const void* refpos_refid, long long n_rp) {
  return dsb::LocTables{static_cast<const unsigned*>(lfc), n_lfc, n_pad,
                        static_cast<const int*>(sa_uni),
                        static_cast<const int*>(sa_off), n_sa,
                        static_cast<const int*>(uni_start), n_us, n_ul,
                        static_cast<const int*>(reflist), n_rl,
                        static_cast<const int*>(refpos_global),
                        static_cast<const int*>(refpos_refid), n_rp};
}

constexpr int kLocThreads = 256;

unsigned loc_blocks(long long n) {
  return static_cast<unsigned>((n + kLocThreads - 1) / kLocThreads);
}

}  // namespace

// The tables' arguments of each locate entry point are dsb_locate's.
#define DSB_LOC_TABLE_ARGS                                                 \
  const void *lfc, long long n_lfc, long long n_pad, const void *sa_uni,  \
      const void *sa_off, long long n_sa, const void *uni_start,          \
      long long n_us, long long n_ul, const void *reflist, long long n_rl, \
      const void *refpos_global, const void *refpos_refid, long long n_rp
#define DSB_LOC_TABLES                                                     \
  loc_tables(lfc, n_lfc, n_pad, sa_uni, sa_off, n_sa, uni_start, n_us,    \
             n_ul, reflist, n_rl, refpos_global, refpos_refid, n_rp)

extern "C" int dsb_locate_walk(DSB_LOC_TABLE_ARGS, const void* rows,
                               const void* valid, long long n, int max_lf,
                               void* r_out, void* k_out, void* ok_out,
                               void* stream) {
  if (n > 0)
    locate_walk_kernel<<<loc_blocks(n), kLocThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        DSB_LOC_TABLES, static_cast<const int*>(rows),
        static_cast<const unsigned char*>(valid), n, max_lf,
        static_cast<int*>(r_out), static_cast<int*>(k_out),
        static_cast<unsigned char*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_locate_tail(DSB_LOC_TABLE_ARGS, const void* r,
                               const void* k, const void* ok, long long n,
                               int P, void* ref_out, void* gpos_out,
                               void* pvalid_out, void* stream) {
  if (n > 0)
    locate_tail_kernel<<<loc_blocks(n), kLocThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        DSB_LOC_TABLES, static_cast<const int*>(r),
        static_cast<const int*>(k), static_cast<const unsigned char*>(ok), n,
        P, static_cast<int*>(ref_out), static_cast<int*>(gpos_out),
        static_cast<unsigned char*>(pvalid_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_bloom_gather(const void* w01, const void* a1,
                                const void* a2, const void* sh, long long m,
                                void* warp_hits, void* stream) {
  if (m > 0) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    bloom_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(w01), static_cast<const unsigned*>(a1),
        static_cast<const unsigned*>(a2), static_cast<const unsigned*>(sh), m,
        static_cast<int*>(warp_hits));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_lf_chase(const void* lfc, long long n_rows,
                            const void* start, const void* loads, long long n,
                            void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    lf_chase_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(lfc), n_rows,
        static_cast<const int*>(start), static_cast<const int*>(loads), n,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_occ_chase(const void* occ32, long long n_blk,
                             const void* rank, const void* codes, int W,
                             const void* lanes, const void* st, long long n,
                             const void* sel, long long m, const void* steps,
                             void* out, void* stream) {
  if (m > 0) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    occ_chase_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(occ32), n_blk,
        static_cast<const int*>(rank), static_cast<const int*>(codes), W,
        static_cast<const int*>(lanes), static_cast<const int*>(st), n,
        static_cast<const int*>(sel), m, static_cast<const int*>(steps),
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsb_empty_launch(long long blocks, int threads,
                                void* stream) {
  if (blocks > 0)
    empty_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// in: n16 16-byte pieces (the call's inputs laid end to end); out: n_out
// words, written
extern "C" int dsb_one_round(const void* in, long long n16, void* out,
                             long long n_out, long long blocks, int threads,
                             void* stream) {
  if (blocks > 0)
    one_round_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), n16, static_cast<unsigned*>(out),
        n_out);
  return static_cast<int>(cudaGetLastError());
}
