// The taxon-weight reduction of the abundance report (K13), one launch a
// call after a memset.
//
// Replaces the shard-local body of desamba_tpu/parallel/collectives.py's
// taxon_weight_step (:26-32): tids clipped to [0, max_tid - 1], then the
// int32 weights scatter-added into a dense int32 [max_tid] vector. The
// psum over the 'data' axis that follows it there is the caller's
// torch.distributed all_reduce (parallel/collectives.py).
//
// Input: int32 tids[B], int32 weights[B]; output int32 out[max_tid].
// out is zeroed on the stream first (cudaMemsetAsync), then one thread an
// element (a grid-stride loop) clips its tid and atomicAdds its weight.
// Integer atomics give the same sum in any order, and a 32-bit add wraps
// at 2^31 as JAX's int32 scatter-add does, so the result is exact.
//
// What bounds it on this card: bytes (8 B an element in, 4 B a bin out;
// at NCBI's 2^22 taxids the 16 MiB output dominates). The abundance
// report sends one tid a read, so B is a batch of reads (thousands) and
// many reads share a tid: contended atomics on a few hot bins resolve in
// L2. A simple kernel first: no shared-memory histogram.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__global__ void taxon_weights_kernel(const int* __restrict__ tids,
                                     const int* __restrict__ weights,
                                     long long B, int max_tid,
                                     int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < B; i += stride) {
    int t = tids[i];
    t = t < 0 ? 0 : (t > max_tid - 1 ? max_tid - 1 : t);
    atomicAdd(out + t, weights[i]);
  }
}

}  // namespace

// tids, weights: int32[B]; out: int32[max_tid], max_tid >= 1
extern "C" int dsb_taxon_weights(const void* tids, const void* weights,
                                 long long B, int max_tid, void* out,
                                 void* stream) {
  if (B < 0 || max_tid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(max_tid) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    long long blocks = (B + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    taxon_weights_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(tids), static_cast<const int*>(weights), B,
        max_tid, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
