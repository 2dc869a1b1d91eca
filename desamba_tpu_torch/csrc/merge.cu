// The genome-sharded classifier's cross-shard merge (K11), one launch a
// chunk.
//
// Replaces, fused into one kernel, three programs of
// desamba_tpu/engine/sharded_fast.py: b4's local -> global ref remap
// (:253-257), b5's merge of the shards' stage-4 results (:260-289) and
// the shard-max of the strand-folded n_exist (:368-372), with the [7, Bp]
// result pack (fast_engine.py:_pack7, :562-571). Input: the shards'
// results, int32 [n_index, 7, Bp]: rows score, ref (shard-local), direction,
// cov, pos, score_alt (stage 4's PACK_KEYS), then n_exist. Each shard's
// ref_map (global IDs) sits in `maps` at [map_off[s], map_off[s + 1]).
// Output: int32 [7, Bp] in the same row order, with global refs.
//
// One thread a read column, looping over the shards, in three passes:
// - the remap: rl >= 0 takes maps[map_off[s] + min(rl, len_s - 1)] (a
//   local ref past the shard's map clips to its last entry, as JAX's
//   edge padding of the stacked maps gives), else -1; sc = score where
//   the global ref is >= 0, else -1; s_max = max sc; n_exist = max of
//   the shards' n_exist; the largest score_alt;
// - the tie rule of the monolithic stage 4 (cly.c:53-63 under glibc's
//   mergesort): an odd s_max (-1 included) takes the highest global ref
//   at s_max, an even one the lowest (sentinel nref + 1);
// - sb, the first shard whose (sc, ref) is (s_max, r_best) (0 if none,
//   as argmax of an all-false row), and the largest sc of the other
//   refs (-1 if none).
// Then ref = s_max > 0 ? r_best : -1; direction and pos come from shard
// sb where ref >= 0 (else 0 and -1); cov comes from shard sb unmasked;
// score and score_alt are clamped at 0.
//
// What bounds it on this card: bytes, and at the smoke's shapes (2
// shards, Bp = 4096, ~0.26 MB) launch latency, since a launch costs a few
// microseconds and the bytes take ~0.1 us. The design reads each input
// word once from device memory (the second and third passes hit L1/L2),
// with the shards' rows strided by Bp so that neighbouring threads read
// neighbouring words, and writes each output word once.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 7;
enum { kScore, kRef, kDir, kCov, kPos, kAlt, kExist };

__device__ __forceinline__ int global_ref(const int* __restrict__ maps,
                                          const long long* __restrict__ off,
                                          int s, int rl) {
  if (rl < 0) return -1;
  const long long len = off[s + 1] - off[s];
  const long long k = rl < len - 1 ? rl : len - 1;
  return maps[off[s] + k];
}

__global__ void shard_merge_kernel(const int* __restrict__ res, int n_index,
                                   long long Bp,
                                   const int* __restrict__ maps,
                                   const long long* __restrict__ map_off,
                                   int nref, int* __restrict__ out) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j >= Bp) return;
  const long long shard = kRows * Bp;  // stride of one shard's block
  // pass 1: the top score, and the maxima of score_alt and n_exist
  int s_max = INT_MIN, alt_max = INT_MIN, ne_max = INT_MIN;
  for (int s = 0; s < n_index; ++s) {
    const int* r = res + s * shard + j;
    const int g = global_ref(maps, map_off, s, r[kRef * Bp]);
    const int sc = g >= 0 ? r[kScore * Bp] : -1;
    s_max = max(s_max, sc);
    alt_max = max(alt_max, r[kAlt * Bp]);
    ne_max = max(ne_max, r[kExist * Bp]);
  }
  // pass 2: the highest and the lowest global ref at the top score
  int r_hi = -1, r_lo = nref + 1;
  for (int s = 0; s < n_index; ++s) {
    const int* r = res + s * shard + j;
    const int g = global_ref(maps, map_off, s, r[kRef * Bp]);
    const int sc = g >= 0 ? r[kScore * Bp] : -1;
    if (sc == s_max) {
      r_hi = max(r_hi, g);
      r_lo = min(r_lo, g);
    }
  }
  const int r_best = (s_max & 1) ? r_hi : r_lo;
  const int ref_b = s_max > 0 ? r_best : -1;
  // pass 3: the first shard that holds the pick, and the other refs' top
  int sb = -1, other = -1;
  for (int s = 0; s < n_index; ++s) {
    const int* r = res + s * shard + j;
    const int g = global_ref(maps, map_off, s, r[kRef * Bp]);
    const int sc = g >= 0 ? r[kScore * Bp] : -1;
    if (sb < 0 && sc == s_max && g == r_best) sb = s;
    if (g >= 0 && g != ref_b) other = max(other, sc);
  }
  if (sb < 0) sb = 0;
  const int* rb = res + sb * shard + j;
  out[kScore * Bp + j] = max(s_max, 0);
  out[kRef * Bp + j] = ref_b;
  out[kDir * Bp + j] = ref_b >= 0 ? rb[kDir * Bp] : 0;
  out[kCov * Bp + j] = rb[kCov * Bp];
  out[kPos * Bp + j] = ref_b >= 0 ? rb[kPos * Bp] : -1;
  out[kAlt * Bp + j] = max(max(other, alt_max), 0);
  out[kExist * Bp + j] = ne_max;
}

}  // namespace

// res: int32[n_index, 7, Bp]; maps: int32[map_off[n_index]];
// map_off: int64[n_index + 1], each shard's map non-empty; out: int32[7, Bp]
extern "C" int dsb_shard_merge(const void* res, int n_index, long long Bp,
                               const void* maps, const void* map_off,
                               int nref, void* out, void* stream) {
  if (n_index < 1 || Bp < 0 || nref < 0 || nref == INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bp > 0) {
    const long long blocks = (Bp + kThreads - 1) / kThreads;
    shard_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(res), n_index, Bp,
        static_cast<const int*>(maps),
        static_cast<const long long*>(map_off), nref,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
