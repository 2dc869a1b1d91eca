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
// One thread a read column, over the shards, in three passes:
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
// What bounds it on this card: at the path's shapes (2 shards, Bp =
// 4096, ~0.26 MB) the bytes take ~0.1 us, so its time is its launch and
// its rounds of dependent loads. The earlier design (a thread a column,
// 256 a block, a loop over the shards with a runtime count) loaded each
// shard's map_off and local ref before the maps entry, and the chosen
// shard's direction, cov and pos after the passes. Here a block of
// kMergeThreads columns (one warp, 128 blocks at Bp = 4096) copies
// map_off and, up to kMapStageMax words, the maps into shared memory
// (cp.async) while each thread loads all 7 rows of every shard of its
// column into registers, coalesced and independent: one round of loads.
// The passes then run over registers and shared memory, and the pick of
// shard sb selects registers. Templated on n_index: 1, the path's 2, and
// 4; any other count runs the generic variant, which loops over the
// shards and reads the results from global memory in each pass (the
// later passes hit L1). Above kMapStageMax map words the maps, and above
// kShardStageMax shards map_off, are read from global memory: one more
// round.
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kMergeThreads = 32;   // read columns (threads) a block
constexpr int kMapStageMax = 4096;  // maps words staged at most (16 KB)
constexpr int kShardStageMax = 64;  // shards whose map_off is staged
constexpr int kRows = 7;
enum { kScore, kRef, kDir, kCov, kPos, kAlt, kExist };

__device__ __forceinline__ int global_ref(const int* maps,
                                          const long long* off, int s,
                                          int rl) {
  if (rl < 0) return -1;
  const long long len = off[s + 1] - off[s];
  const long long k = rl < len - 1 ? rl : len - 1;
  return maps[off[s] + k];
}

// NT > 0: n_index fixed at NT, the column's 7 * NT words in registers;
// NT == 0: any n_index. kStageMaps: maps in shared memory; map_off is
// staged up to kShardStageMax shards.
template <int NT, bool kStageMaps>
__global__ void __launch_bounds__(kMergeThreads) shard_merge_kernel(
    const int* __restrict__ res, int n_rt, long long Bp,
    const int* __restrict__ maps, int n_maps,
    const long long* __restrict__ map_off, int nref,
    int* __restrict__ out) {
  __shared__ long long sm_off[kShardStageMax + 1];
  extern __shared__ __align__(16) int sm_maps[];
  const int n_index = NT > 0 ? NT : n_rt;
  const long long j = blockIdx.x * static_cast<long long>(kMergeThreads) +
                      threadIdx.x;
  const bool stage_off = n_index <= kShardStageMax;
  if (stage_off) {
    for (int s = threadIdx.x; s <= n_index; s += kMergeThreads)
      __pipeline_memcpy_async(sm_off + s, map_off + s, 8);
  }
  if constexpr (kStageMaps) {
    for (int i = threadIdx.x; i < n_maps; i += kMergeThreads)
      __pipeline_memcpy_async(sm_maps + i, maps + i, 4);
  }
  __pipeline_commit();
  const long long shard = kRows * Bp;  // stride of one shard's block
  constexpr int kRegs = NT > 0 ? NT : 1;
  int v[kRegs][kRows];
  if constexpr (NT > 0) {
    if (j < Bp) {
#pragma unroll
      for (int s = 0; s < NT; ++s) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          v[s][r] = __ldg(res + s * shard + r * Bp + j);
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (j >= Bp) return;
  const int* mp = kStageMaps ? sm_maps : maps;
  const long long* off = stage_off ? sm_off : map_off;
  // row r of shard s of this column
  auto at = [&](int s, int r) -> int {
    if constexpr (NT > 0) {
      return v[s][r];
    } else {
      return __ldg(res + s * shard + r * Bp + j);
    }
  };
  // pass 1: the top score, and the maxima of score_alt and n_exist
  int g[kRegs], sc[kRegs];
  int s_max = INT_MIN, alt_max = INT_MIN, ne_max = INT_MIN;
#pragma unroll
  for (int s = 0; s < n_index; ++s) {
    const int gs = global_ref(mp, off, s, at(s, kRef));
    const int ss = gs >= 0 ? at(s, kScore) : -1;
    if constexpr (NT > 0) g[s] = gs, sc[s] = ss;
    s_max = max(s_max, ss);
    alt_max = max(alt_max, at(s, kAlt));
    ne_max = max(ne_max, at(s, kExist));
  }
  // the global ref and score of shard s: registers, or computed again
  auto g_at = [&](int s) -> int {
    if constexpr (NT > 0) return g[s];
    return global_ref(mp, off, s, at(s, kRef));
  };
  auto sc_at = [&](int s, int gs) -> int {
    if constexpr (NT > 0) return sc[s];
    return gs >= 0 ? at(s, kScore) : -1;
  };
  // pass 2: the highest and the lowest global ref at the top score
  int r_hi = -1, r_lo = nref + 1;
#pragma unroll
  for (int s = 0; s < n_index; ++s) {
    const int gs = g_at(s);
    if (sc_at(s, gs) == s_max) {
      r_hi = max(r_hi, gs);
      r_lo = min(r_lo, gs);
    }
  }
  const int r_best = (s_max & 1) ? r_hi : r_lo;
  const int ref_b = s_max > 0 ? r_best : -1;
  // pass 3: the first shard that holds the pick, and the other refs' top
  int sb = -1, other = -1;
#pragma unroll
  for (int s = 0; s < n_index; ++s) {
    const int gs = g_at(s);
    const int ss = sc_at(s, gs);
    if (sb < 0 && ss == s_max && gs == r_best) sb = s;
    if (gs >= 0 && gs != ref_b) other = max(other, ss);
  }
  if (sb < 0) sb = 0;
  int dir, cov, pos;
  if constexpr (NT > 0) {
    dir = v[0][kDir], cov = v[0][kCov], pos = v[0][kPos];
#pragma unroll
    for (int s = 1; s < NT; ++s) {
      if (sb == s) dir = v[s][kDir], cov = v[s][kCov], pos = v[s][kPos];
    }
  } else {
    dir = at(sb, kDir), cov = at(sb, kCov), pos = at(sb, kPos);
  }
  out[kScore * Bp + j] = max(s_max, 0);
  out[kRef * Bp + j] = ref_b;
  out[kDir * Bp + j] = ref_b >= 0 ? dir : 0;
  out[kCov * Bp + j] = cov;
  out[kPos * Bp + j] = ref_b >= 0 ? pos : -1;
  out[kAlt * Bp + j] = max(max(other, alt_max), 0);
  out[kExist * Bp + j] = ne_max;
}

template <int NT, bool kStageMaps>
void launch_merge(long long blocks, size_t smem, cudaStream_t stream,
                  const int* res, int n_index, long long Bp, const int* maps,
                  int n_maps, const long long* map_off, int nref, int* out) {
  shard_merge_kernel<NT, kStageMaps>
      <<<static_cast<unsigned>(blocks), kMergeThreads, smem, stream>>>(
          res, n_index, Bp, maps, n_maps, map_off, nref, out);
}

}  // namespace

// res: int32[n_index, 7, Bp]; maps: int32[n_maps], n_maps = map_off[n_index];
// map_off: int64[n_index + 1], each shard's map non-empty; out: int32[7, Bp]
extern "C" int dsb_shard_merge(const void* res, int n_index, long long Bp,
                               const void* maps, long long n_maps,
                               const void* map_off, int nref, void* out,
                               void* stream) {
  if (n_index < 1 || Bp < 0 || n_maps < 1 ||
      n_maps > INT_MAX || nref < 0 || nref == INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bp == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (Bp + kMergeThreads - 1) / kMergeThreads;
  const bool stage_maps = n_maps <= kMapStageMax;
  const size_t smem = stage_maps ? sizeof(int) * n_maps : 0;
  auto go = [&](auto launch) {
    launch(blocks, smem, static_cast<cudaStream_t>(stream),
           static_cast<const int*>(res), n_index, Bp,
           static_cast<const int*>(maps), static_cast<int>(n_maps),
           static_cast<const long long*>(map_off), nref,
           static_cast<int*>(out));
  };
  auto variant = [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (stage_maps) go(launch_merge<NT, true>);
    else go(launch_merge<NT, false>);
  };
  switch (n_index) {
    case 1: variant(std::integral_constant<int, 1>{}); break;
    case 2: variant(std::integral_constant<int, 2>{}); break;
    case 4: variant(std::integral_constant<int, 4>{}); break;
    default: variant(std::integral_constant<int, 0>{});
  }
  return static_cast<int>(cudaGetLastError());
}
