// The taxon-weight reduction of the abundance report (K13): one launch a
// call, each output bin written once with its final value.
//
// Replaces the shard-local body of desamba_tpu/parallel/collectives.py's
// taxon_weight_step (:26-32): tids clipped to [0, max_tid - 1], then the
// int32 weights scatter-added into a dense int32 [max_tid] vector. The
// psum over the 'data' axis that follows it there is the caller's
// torch.distributed all_reduce (parallel/collectives.py).
//
// Input: int32 tids[B], int32 weights[B]; output int32 out[max_tid].
//
// What bounds it on this card: bytes and latency. At NCBI's 2^22 taxids
// the 16 MiB output dominates (0.005 ms at 3.35 TB/s); a batch's tids
// (thousands, 8 B each) are nothing beside it, and at small max_tid the
// call is one launch's latency. The abundance report sends one tid a read
// and many reads share a tid, so adds pile onto a few hot bins.
//
// Design: bin-owning blocks (taxon_bins_kernel). Block i owns bins
// [i * bins, (i + 1) * bins) in shared memory (bins sized so that the
// blocks cover the card's SMs, at most 48 Ki bins = 192 KB): it zeroes
// them, streams all (tid, weight) pairs (from L2 after the first block),
// clips each tid and adds the weight into shared memory where the tid
// falls in its range, then writes its range out with 16-byte stores. No
// memset, no global atomics, contended adds resolve in shared memory,
// and the output is written once. Integer adds give the same sum in any
// order and a 32-bit add wraps at 2^31 as JAX's int32 scatter-add does,
// so the result is exact.
//
// Where it loses: every block reads all B pairs, so its time grows with
// B times the blocks (about 0.15 us a thousand pairs at 2^22 bins). On
// the abundance report's hot bins it stays ahead of zeros + index_add_
// (a memset and an atomic scatter) at the 2^17 and 2^19 pairs that
// chip_smoke.py's phase 8 times; on tids spread over the bins that
// scatter takes less from about 2^17 pairs on. A batch is a few thousand
// reads, so one route serves every caller (ROADMAP.md keeps a second
// route for spread tids at large B).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 8;  // pairs a thread loads at once
constexpr int kMinBins = 1024;
constexpr int kMaxBins = 48 * 1024;

__device__ __forceinline__ int clip(int t, int max_tid) {
  return t < 0 ? 0 : (t > max_tid - 1 ? max_tid - 1 : t);
}

// Loads kUnroll pairs of a thread (pair i0 + u * stride for u < kUnroll),
// each tid clipped and made relative to the block's first bin (-1 past B).
__device__ __forceinline__ void load_pairs(
    const int* __restrict__ tids, const int* __restrict__ weights,
    long long B, int max_tid, int base, long long i0, int stride,
    int (&d)[kUnroll], int (&w)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + static_cast<long long>(u) * stride;
    d[u] = i < B ? clip(tids[i], max_tid) - base : -1;
    w[u] = i < B ? weights[i] : 0;
  }
}

__global__ void taxon_bins_kernel(const int* __restrict__ tids,
                                  const int* __restrict__ weights,
                                  long long B, int max_tid, int bins,
                                  int* __restrict__ out) {
  extern __shared__ int4 sbin4[];  // [bins / 4]
  int* sbin = reinterpret_cast<int*>(sbin4);
  const int base = blockIdx.x * bins;  // < max_tid < 2^31
  const int n = max_tid - base < bins ? max_tid - base : bins;
  // kUnroll pairs a thread at a time, all loads issued before the first
  // add, so that a batch waits for one L2 latency; the first batch's
  // loads overlap the zeroing of the bins
  int d[kUnroll], w[kUnroll];
  long long i0 = threadIdx.x;
  load_pairs(tids, weights, B, max_tid, base, i0, blockDim.x, d, w);
  for (int i = threadIdx.x; i < bins / 4; i += blockDim.x)
    sbin4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (static_cast<unsigned>(d[u]) < static_cast<unsigned>(n))
        atomicAdd(sbin + d[u], w[u]);
    i0 += static_cast<long long>(blockDim.x) * kUnroll;
    if (i0 >= B) break;
    load_pairs(tids, weights, B, max_tid, base, i0, blockDim.x, d, w);
  }
  __syncthreads();
  int* o = out + base;  // 16-byte aligned: bins % 4 == 0
  const int n4 = n / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<int4*>(o)[i] = sbin4[i];
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) o[i] = sbin[i];
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];       // each device's SM count, read once
bool g_smem_set[kMaxDevices]; // kMaxBins * 4 bytes of shared memory allowed

}  // namespace

// tids, weights: int32[B]; out: int32[max_tid], 16-byte aligned;
// max_tid >= 1; launched on the current device
extern "C" int dsb_taxon_weights(const void* tids, const void* weights,
                                 long long B, int max_tid, void* out,
                                 void* stream) {
  if (B < 0 || max_tid < 1 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[dev] = sms < 1 ? 1 : sms;
  }
  // bins a block: the card's SMs share max_tid, in steps of kMinBins
  long long bins = (max_tid + g_sms[dev] - 1) / g_sms[dev];
  bins = (bins + kMinBins - 1) / kMinBins * kMinBins;
  if (bins > kMaxBins) bins = kMaxBins;
  const long long blocks = (max_tid + bins - 1) / bins;
  const int smem = static_cast<int>(bins) * 4;
  if (smem > 48 * 1024 && !g_smem_set[dev]) {
    // the attribute holds for the current device only
    err = cudaFuncSetAttribute(taxon_bins_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBins * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev] = true;
  }
  taxon_bins_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tids), static_cast<const int*>(weights), B,
      max_tid, static_cast<int>(bins), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
