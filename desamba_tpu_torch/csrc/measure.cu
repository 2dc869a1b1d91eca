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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kLfcRowMask = (1u << 29) - 1u;  // row_walks.cu kLfcShift

// JAX gather semantics: negative indices count from the end, then clamp.
__device__ __forceinline__ long long jax_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
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
    sp = static_cast<int>(__ldg(lfc + jax_index(sp, n_rows)) & kLfcRowMask);
  out[i] = sp;
}

}  // namespace

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
