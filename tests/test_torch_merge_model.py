"""The cross-shard merge (K11, shard_merge_kernel in csrc/merge.cu) in its
formulation: a numpy model of the kernel. A block takes MERGE_THREADS
read columns (one thread each); in one round it copies map_off (up to
MERGE_SHARDS_STAGED shards) and the maps (up to MERGE_MAPS_STAGED words)
into shared memory while each thread of the unrolled variants (n_index
in MERGE_UNROLLED) loads all 7 rows of every shard of its column into
registers. Then three passes over the shards (the remap through the
staged tables, clipped past a shard's map; the top score, the maxima of
score_alt and n_exist; the odd/even tie; the first shard holding the
pick, 0 if none, and the other refs' top) and the pick of shard sb's
direction, cov and pos from registers. The generic variant (any other
n_index) reads each shard's rows from device memory in every pass, and
past a cap the tables are read from device memory too. The model counts
the words each route loads from device memory and every output element
written (once each).

Held to shard_merge_plain and to the JAX package's own b4 remap (on its
edge-padded map stack) and b5 merge (ShardedFastClassifier's, built on a
1 x n_index mesh of the virtual CPU devices) with n_exist's shard-max,
element for element, at n_index = 1, 2, 3, 4 and 8, on
`merge_model_cases`: test_torch_merge.merge_cases' columns (ties of
either parity and across shards, top scores <= 0, rows with no ref,
score_alt above the other refs, local refs past a shard's map), with
maps of MERGE_MAPS_STAGED words and past it. `check_merge_coverage`
asserts each case reached.

The module imports no JAX at top level: the card's tests below reuse the
cases. On the card:

    python -m pytest tests/test_torch_merge_model.py -m cuda -q

Change the kernel and the model together.
"""
import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels
from desamba_tpu_torch.ops.merge import (MERGE_MAPS_STAGED,
                                         MERGE_SHARDS_STAGED, MERGE_THREADS,
                                         MERGE_UNROLLED, ref_maps,
                                         shard_merge, shard_merge_plain)
from test_torch_merge import (ALT, COV, DIR, NE, POS, REF, SCORE,
                              check_merge_coverage, cuda,  # noqa: F401
                              merge_cases)

N_ROWS = 7


def merge_model(res, maps, map_off, nref: int):
    """The kernel's output int32[7, Bp] and its route ({"variant",
    "maps_staged", "off_staged", "loads"}: loads counts the words read
    from device memory). res: int32[n, 7, Bp]; maps: int32[M]; map_off:
    int64[n + 1]."""
    n, _, Bp = res.shape
    M = len(maps)
    res = np.asarray(res, np.int64)
    unrolled = n in MERGE_UNROLLED
    maps_staged = M <= MERGE_MAPS_STAGED
    off_staged = n <= MERGE_SHARDS_STAGED
    out = np.zeros((N_ROWS, Bp), np.int64)
    writes = np.zeros((N_ROWS, Bp), np.int64)
    loads = 0
    for j0 in range(0, Bp, MERGE_THREADS):
        # the block's copies into shared memory (one round)
        sm_off = np.asarray(map_off, np.int64) if off_staged else None
        sm_maps = np.asarray(maps, np.int64) if maps_staged else None
        loads += (n + 1 if off_staged else 0) + (M if maps_staged else 0)
        for j in range(j0, min(j0 + MERGE_THREADS, Bp)):
            if unrolled:
                v = res[:, :, j].copy()  # 7n registers, one round
                loads += N_ROWS * n

            def at(s, r):
                nonlocal loads
                if unrolled:
                    return v[s, r]
                loads += 1
                return res[s, r, j]

            def off(s):
                nonlocal loads
                if off_staged:
                    return sm_off[s]
                loads += 1
                return map_off[s]

            def g_of(s):
                nonlocal loads
                rl = at(s, REF)
                if rl < 0:
                    return -1
                o0, o1 = off(s), off(s + 1)
                k = min(rl, o1 - o0 - 1)
                if maps_staged:
                    return sm_maps[o0 + k]
                loads += 1
                return maps[o0 + k]

            g, sc = {}, {}
            s_max = alt_max = ne_max = -2**31
            for s in range(n):  # pass 1
                g[s] = g_of(s)
                sc[s] = at(s, SCORE) if g[s] >= 0 else -1
                s_max = max(s_max, sc[s])
                alt_max = max(alt_max, at(s, ALT))
                ne_max = max(ne_max, at(s, NE))
            if not unrolled:  # the generic variant computes them again
                g = {s: g_of(s) for s in range(n)}
                sc = {s: at(s, SCORE) if g[s] >= 0 else -1 for s in range(n)}
            r_hi, r_lo = -1, nref + 1
            for s in range(n):  # pass 2
                if sc[s] == s_max:
                    r_hi, r_lo = max(r_hi, g[s]), min(r_lo, g[s])
            r_best = r_hi if s_max & 1 else r_lo
            ref_b = r_best if s_max > 0 else -1
            sb, other = -1, -1
            for s in range(n):  # pass 3
                if sb < 0 and sc[s] == s_max and g[s] == r_best:
                    sb = s
                if g[s] >= 0 and g[s] != ref_b:
                    other = max(other, sc[s])
            sb = max(sb, 0)
            out[:, j] = (max(s_max, 0), ref_b,
                         at(sb, DIR) if ref_b >= 0 else 0, at(sb, COV),
                         at(sb, POS) if ref_b >= 0 else -1,
                         max(other, alt_max, 0), ne_max)
            writes[:, j] += 1
    assert (writes == 1).all()
    return out.astype(np.int32), dict(
        variant="unrolled" if unrolled else "generic",
        maps_staged=maps_staged, off_staged=off_staged, loads=loads)


def merge_model_cases(n_index: int, big_maps: bool = False, seed: int = 0):
    """(res int32[n_index, 7, Bp], maps, nref): merge_cases' columns at
    n_index shards (at one shard, its shards 0 and 1 merged into one: the
    columns of shard 0, with shard 1's map appended to shard 0's); with
    big_maps, shard 0's map grown past MERGE_MAPS_STAGED words with
    global refs that its columns do not name."""
    res, maps, nref = merge_cases(max(n_index, 2), seed=seed)
    if n_index == 1:
        res, maps = res[:1].copy(), [maps[0] + maps[1]]
    if big_maps:
        extra = list(range(nref, nref + MERGE_MAPS_STAGED))
        maps = [maps[0] + extra] + maps[1:]
        nref += MERGE_MAPS_STAGED
    return res, maps, nref


def _args(res, maps, device="cpu"):
    m, off = ref_maps(maps, device)
    return torch.from_numpy(res).to(device), m, off


def _jax_merge(res, maps, nref):
    """The JAX package's b4 remap (sharded_fast.py:253-257, on the edge-
    padded stack of the maps) and b5 merge (the closure that
    ShardedFastClassifier._build_sharded_stages jits over a 1 x n_index
    mesh, built on a stand-in object with no shard tables: b5 reads only
    ref_names' length), then n_exist's shard-max."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from desamba_tpu.engine.sharded_fast import (ShardedFastClassifier,
                                                 _edge_pad_stack)
    from desamba_tpu.parallel.mesh import make_mesh

    n = res.shape[0]
    stand_in = SimpleNamespace(
        ek=SimpleNamespace(lek=16, single_base_max=12, mask_bits=20,
                           n_words0=20),
        mesh=make_mesh(n_data=1, n_index=n), ek_s=None, fm_s=None,
        loc_s=None, ra_s=None, ref_names=[None] * nref)
    ShardedFastClassifier._build_sharded_stages(stand_in)
    ref_map = jnp.asarray(_edge_pad_stack([np.asarray(m, np.int32)
                                           for m in maps]))
    rl = jnp.asarray(res[:, REF])
    g = jnp.where(rl >= 0, jnp.take_along_axis(
        ref_map, jnp.clip(rl, 0, ref_map.shape[1] - 1), axis=1), -1)
    keys = ("score", "ref", "direction", "cov", "pos", "score_alt")
    stacked = {k: jnp.asarray(res[:, i]) for i, k in enumerate(keys)}
    stacked["ref"] = g
    out = stand_in._sm5(stacked)
    return np.stack([np.asarray(out[k]) for k in keys]
                    + [res[:, NE].max(0)])


MODEL_CASES = [(1, False), (2, False), (3, False), (4, False), (8, False),
               (2, True), (3, True)]


@pytest.mark.parametrize("n_index,big_maps", MODEL_CASES)
def test_merge_model_equals_jax_and_plain(n_index, big_maps):
    res, maps, nref = merge_model_cases(n_index, big_maps, seed=n_index)
    if n_index >= 2:
        check_merge_coverage(res, maps)
    m, off = ref_maps(maps, "cpu")
    got, route = merge_model(res, m.numpy(), off.numpy(), nref)
    plain = shard_merge_plain(*_args(res, maps), nref).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _jax_merge(res, maps, nref))
    Bp, M = res.shape[2], m.numel()
    assert route["variant"] == ("unrolled" if n_index in MERGE_UNROLLED
                                else "generic")
    assert route["maps_staged"] == (not big_maps)
    # the unrolled variant with staged tables reads each input word of
    # device memory once: every column's rows, and the tables once a block
    if route["variant"] == "unrolled" and route["maps_staged"]:
        blocks = -(-Bp // MERGE_THREADS)
        assert route["loads"] == (N_ROWS * n_index * Bp
                                  + blocks * (n_index + 1 + M))


def test_merge_model_cases_reach_every_case():
    """Ties across shards and no shard holding the pick (s_max -1, ref
    -1 everywhere), local refs past a shard's map, at one shard too; and
    the routes: every unrolled count and the generic one, the maps
    staged and not."""
    routes = set()
    for n_index, big_maps in MODEL_CASES:
        res, maps, nref = merge_model_cases(n_index, big_maps)
        m, off = ref_maps(maps, "cpu")
        routes.add(merge_model(res, m.numpy(), off.numpy(), nref)[1][
            "variant"] + (" big" if big_maps else ""))
        rl = res[:, REF]
        lens = np.array([len(x) for x in maps])[:, None]
        assert (rl >= lens).any(), "a local ref past its shard's map"
        assert (rl < 0).all(0).any(), "a column with no ref"
    assert routes == {"unrolled", "generic", "unrolled big", "generic big"}


@pytest.mark.cuda
@pytest.mark.parametrize("n_index,big_maps", MODEL_CASES)
def test_merge_kernel_model_cases(cuda, n_index, big_maps):
    """The kernel against shard_merge_plain on the model's cases: every
    unrolled count and the generic variant, the maps staged and read
    from device memory."""
    res, maps, nref = merge_model_cases(n_index, big_maps, seed=n_index)
    before = kernels.launches["shard_merge"]
    got = shard_merge(*_args(res, maps, cuda), nref)
    torch.cuda.synchronize()
    assert kernels.launches["shard_merge"] == before + 1
    assert torch.equal(got.cpu(), shard_merge_plain(*_args(res, maps),
                                                    nref))


@pytest.mark.cuda
def test_merge_kernel_past_the_staged_shards(cuda):
    """More than MERGE_SHARDS_STAGED shards: map_off read from device
    memory, the generic variant."""
    n = MERGE_SHARDS_STAGED + 1
    rng = np.random.default_rng(3)
    res, maps, nref = merge_cases(2, seed=3)
    res = np.concatenate([res] + [res[1:]] * (n - 2))
    res[2:, SCORE] = rng.integers(-2, 100, res[2:, SCORE].shape)
    maps = maps + [maps[1]] * (n - 2)
    got = shard_merge(*_args(res, maps, cuda), nref)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), shard_merge_plain(*_args(res, maps),
                                                    nref))
