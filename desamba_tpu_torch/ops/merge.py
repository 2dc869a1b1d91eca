"""The genome-sharded classifier's cross-shard merge (K11).

Counterpart of desamba_tpu/engine/sharded_fast.py's b4 remap
(:253-257), b5 (:260-289) and the shard-max of n_exist (:368-372) with the
[7, Bp] pack: the shards' stage-4 results, stacked, become one result a
read with global ref IDs, under the monolithic stage 4's odd/even tie
rule. On one card the shards run one after another and their results are
stacked, where JAX all_gathers them over its 'index' mesh axis.

`shard_merge` has a hand-written CUDA kernel (csrc/merge.cu) and a plain
torch version, `shard_merge_plain`. The wrapper runs the plain version for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import kernels

I32 = torch.int32
N_ROWS = 7  # stage 4's PACK_KEYS, then the strand-folded n_exist
# the kernel's (csrc/merge.cu): read columns a block (kMergeThreads), the
# n_index it unrolls (the rest run its generic variant), maps words
# (kMapStageMax) and shards (kShardStageMax) whose tables it copies into
# shared memory at most; past those it reads them from device memory
MERGE_THREADS = 32
MERGE_UNROLLED = (1, 2, 4)
MERGE_MAPS_STAGED = 4096
MERGE_SHARDS_STAGED = 64


def ref_maps(ids_per_shard, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(maps int32[M], map_off int64[n_index + 1]) of per-shard sequences
    of global ref IDs: shard s's map is maps[map_off[s] : map_off[s + 1]]."""
    lens = [len(ids) for ids in ids_per_shard]
    if not lens or min(lens) < 1:
        raise ValueError(f"shard_merge: every shard needs a ref map, got "
                         f"lengths {lens}")
    maps = torch.tensor([g for ids in ids_per_shard for g in ids], dtype=I32)
    off = torch.zeros(len(lens) + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(torch.tensor(lens, dtype=torch.int64), 0)
    return maps.to(device), off.to(device)


def shard_merge_plain(res, maps, map_off, nref: int) -> torch.Tensor:
    """Plain torch version of the merge kernel. res: int32[n_index, 7, Bp]
    (rows score, ref with shard-local IDs, direction, cov, pos, score_alt,
    n_exist); maps, map_off: as ref_maps gives them; nref: the global ref
    count. Returns int32[7, Bp]."""
    score, rl, dirn, cov, pos, alt, ne = res.unbind(1)  # each [n, Bp]
    start = map_off[:-1, None]
    last = map_off[1:, None] - start - 1
    k = start + torch.minimum(rl.clamp(min=0).to(torch.int64), last)
    g = torch.where(rl >= 0, maps[k], -1)
    sc = torch.where(g >= 0, score, -1)
    s_max = sc.max(0).values
    odd = (s_max & 1) == 1
    at_max = sc == s_max[None]
    r_hi = torch.where(at_max, g, -1).max(0).values
    r_lo = torch.where(at_max, g, nref + 1).min(0).values
    r_best = torch.where(odd, r_hi, r_lo)
    chosen = at_max & (g == r_best[None])
    # the first True of each column, or 0 where it has none
    sb = chosen.to(torch.uint8).argmax(0)
    pick = lambda x: x.gather(0, sb[None])[0]  # noqa: E731
    ref_b = torch.where(s_max > 0, r_best, -1)
    other = (g != ref_b[None]) & (g >= 0)
    alt_b = torch.maximum(torch.where(other, sc, -1).max(0).values,
                          alt.max(0).values)
    return torch.stack([
        s_max.clamp(min=0), ref_b,
        torch.where(ref_b >= 0, pick(dirn), 0), pick(cov),
        torch.where(ref_b >= 0, pick(pos), -1), alt_b.clamp(min=0),
        ne.max(0).values]).to(I32)


def shard_merge(res, maps, map_off, nref: int) -> torch.Tensor:
    """The merge of the shards' stacked results into one [7, Bp] result
    with global refs (shard_merge_plain's function). res: int32[n_index,
    7, Bp] with n_index >= 1; maps: int32[M]; map_off: int64[n_index + 1],
    non-decreasing from 0 to M, each shard's map non-empty (ref_maps
    makes them; map_off[n_index] == M); 0 <= nref < 2^31 - 1."""
    if res.dim() != 3 or res.shape[1] != N_ROWS or res.shape[0] < 1:
        raise ValueError(f"shard_merge: res shape {tuple(res.shape)}, "
                         f"expected [n_index >= 1, {N_ROWS}, Bp]")
    n, _, Bp = res.shape
    dev = res.device
    kernels.check("res", res, I32, (n, N_ROWS, Bp), dev)
    kernels.check("maps", maps, I32, (maps.numel(),), dev)
    if not 1 <= maps.numel() < 2**31:
        raise ValueError(f"shard_merge: {maps.numel()} map entries")
    kernels.check("map_off", map_off, torch.int64, (n + 1,), dev)
    if not 0 <= nref < 2**31 - 1:
        raise ValueError(f"shard_merge: nref={nref} out of range")
    if not kernels.launch_device(res):
        return shard_merge_plain(res, maps, map_off, nref)
    out = torch.empty((N_ROWS, Bp), dtype=I32, device=dev)
    if Bp:
        with torch.cuda.device(dev):
            kernels.call("shard_merge", kernels.ptr(res), n, Bp,
                         kernels.ptr(maps), maps.numel(),
                         kernels.ptr(map_off), nref, kernels.ptr(out),
                         kernels.stream(dev))
        kernels.launches["shard_merge"] += 1
    return out
