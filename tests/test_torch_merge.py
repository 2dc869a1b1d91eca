"""The cross-shard merge (K11, ops/merge.shard_merge) and the sharded
classifier's kernel path, against their plain torch versions.

`merge_cases` builds stacked shard results that reach each rule of the
merge (ties of either parity, one ref tied across shards, top scores <= 0,
rows with no ref, a score_alt above every other ref, local refs past a
shard's map); `check_merge_coverage` asserts that they do.
tests/test_torch_sharded.py holds the plain merge to JAX's on them. The
tests marked `cuda` run only where torch sees a GPU; on the card:

    python -m pytest tests/test_torch_merge.py -m cuda -q
"""
import os

import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels
from desamba_tpu_torch.ops.merge import ref_maps, shard_merge, shard_merge_plain

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SCORE, REF, DIR, COV, POS, ALT, NE = range(7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def case_maps(n_index: int, seed: int = 0) -> list[list[int]]:
    """Shard 0 maps to global ref 2 only and shard 1 to 0, 1, 2, so ref 2
    can come from both (the golden classifier numbers 3 refs); further
    shards map 1-4 refs each onto 0-5."""
    rng = np.random.default_rng(seed)
    maps = [[2], [0, 1, 2]]
    for _ in range(2, n_index):
        k = int(rng.integers(1, 5))
        maps.append(rng.choice(6, k, replace=False).tolist())
    return maps[:n_index]


def merge_cases(n_index: int, n_random: int = 64, seed: int = 0):
    """(res int32[n_index, 7, Bp], maps, nref): one column a case on shards
    0 and 1 (the other shards hold no ref there), then n_random random
    columns over all shards, scores drawn near ties."""
    assert n_index >= 2
    maps = case_maps(n_index, seed)
    nref = max(g for m in maps for g in m) + 1
    # (shard 0, shard 1) as (score, local ref, score_alt)
    cases = [
        ((101, 0, 0), (101, 0, 0)),   # odd tie, refs 2 and 0: 2, shard 0
        ((100, 0, 0), (100, 1, 0)),   # even tie, refs 2 and 1: 1, shard 1
        ((77, 0, 3), (77, 2, 5)),     # ref 2 tied across shards (odd)
        ((78, 0, 3), (78, 2, 5)),     # ... and even: shard 0's row
        ((0, 0, 0), (0, -1, 0)),      # s_max == 0 with a ref: no call
        ((30, -1, 7), (40, -1, 9)),   # no ref anywhere: s_max -1, shard 0
        ((90, 0, 300), (50, 0, 10)),  # score_alt above the other ref
        ((60, 5, 0), (61, 7, 0)),     # local refs past both maps
        ((-3, 0, 0), (-5, -1, 0)),    # a negative score with a ref
        ((12, 0, 0), (-1, 1, 0)),     # the other shard's ref at score -1
    ]
    rng = np.random.default_rng(seed + 1)
    Bp = len(cases) + n_random
    res = np.zeros((n_index, 7, Bp), np.int64)
    res[:, REF] = -1
    res[:, SCORE] = rng.integers(-2, 40, (n_index, Bp))
    res[:, DIR] = rng.integers(0, 2, (n_index, Bp))
    res[:, COV] = rng.integers(0, 3000, (n_index, Bp))
    res[:, POS] = rng.integers(-1, 10**6, (n_index, Bp))
    res[:, ALT] = rng.integers(0, 120, (n_index, Bp))
    res[:, NE] = rng.integers(0, 2**31 - 1, (n_index, Bp))
    for j, case in enumerate(cases):
        for s, (sc, rl, alt) in enumerate(case):
            res[s, SCORE, j], res[s, REF, j], res[s, ALT, j] = sc, rl, alt
    r = slice(len(cases), Bp)
    res[:, SCORE, r] = np.where(rng.random((n_index, n_random)) < 0.5,
                                rng.integers(95, 100, (n_index, n_random)),
                                rng.integers(-2, 4, (n_index, n_random)))
    for s, m in enumerate(maps):
        res[s, REF, r] = rng.integers(-1, len(m) + 2, n_random)
    return res.astype(np.int32), maps, nref


def merge_loop(res, maps, nref):
    """The merge, column by column in Python (an independent reference for
    the plain version at any shard count)."""
    n, _, Bp = res.shape
    out = np.zeros((7, Bp), np.int64)
    for j in range(Bp):
        g = [maps[s][min(res[s, REF, j], len(maps[s]) - 1)]
             if res[s, REF, j] >= 0 else -1 for s in range(n)]
        sc = [int(res[s, SCORE, j]) if g[s] >= 0 else -1 for s in range(n)]
        s_max = max(sc)
        top = [g[s] for s in range(n) if sc[s] == s_max]
        r_best = max(top) if s_max & 1 else min(top)
        sb = next(s for s in range(n) if sc[s] == s_max and g[s] == r_best)
        ref = r_best if s_max > 0 else -1
        alt = max([sc[s] for s in range(n) if g[s] >= 0 and g[s] != ref]
                  + [-1] + [int(v) for v in res[:, ALT, j]])
        out[:, j] = (max(s_max, 0), ref,
                     res[sb, DIR, j] if ref >= 0 else 0, res[sb, COV, j],
                     res[sb, POS, j] if ref >= 0 else -1, max(alt, 0),
                     res[:, NE, j].max())
    return out.astype(np.int32)


def check_merge_coverage(res, maps):
    """The columns reach every case merge_cases names."""
    n, _, Bp = res.shape
    hit = set()
    for j in range(Bp):
        rl = res[:, REF, j]
        g = [maps[s][min(rl[s], len(maps[s]) - 1)] if rl[s] >= 0 else -1
             for s in range(n)]
        sc = [int(res[s, SCORE, j]) if g[s] >= 0 else -1 for s in range(n)]
        s_max = max(sc)
        top = [s for s in range(n) if sc[s] == s_max]
        refs = {g[s] for s in top}
        if s_max > 0 and len(refs) > 1:
            hit.add("odd tie" if s_max & 1 else "even tie")
        if s_max > 0 and len(top) > len(refs):
            hit.add("one ref tied across shards")
        if s_max <= 0 and max(g) >= 0:
            hit.add("s_max <= 0 with a ref")
        if max(g) < 0:
            hit.add("no ref")
        if s_max > 0:
            best = max(refs) if s_max & 1 else min(refs)
            others = [sc[s] for s in range(n) if g[s] >= 0 and g[s] != best]
            if res[:, ALT, j].max() > max(others + [-1]):
                hit.add("score_alt above the other refs")
        if any(rl[s] >= len(maps[s]) for s in range(n)):
            hit.add("local ref past its map")
    want = {"odd tie", "even tie", "one ref tied across shards",
            "s_max <= 0 with a ref", "no ref",
            "score_alt above the other refs", "local ref past its map"}
    assert hit >= want, want - hit


def _merge_args(res, maps, device="cpu"):
    m, off = ref_maps(maps, device)
    return torch.from_numpy(res).to(device), m, off


@pytest.mark.parametrize("n_index", [2, 3, 8])
def test_merge_cases_reach_every_case(n_index):
    res, maps, _ = merge_cases(n_index)
    check_merge_coverage(res, maps)


@pytest.mark.parametrize("n_index", [1, 2, 3, 8])
def test_merge_plain_equals_column_loop(n_index):
    """The plain merge equals the column-by-column reference, and the
    wrapper on CPU tensors is the plain merge."""
    res, maps, nref = merge_cases(max(n_index, 2))
    res, maps = res[:n_index], maps[:n_index]
    got = shard_merge_plain(*_merge_args(res, maps), nref)
    assert got.dtype == torch.int32 and tuple(got.shape) == (7, res.shape[2])
    assert np.array_equal(got.numpy(), merge_loop(res, maps, nref))
    assert torch.equal(shard_merge(*_merge_args(res, maps), nref), got)


def test_merge_checks_its_inputs():
    res, maps, nref = merge_cases(2)
    t, m, off = _merge_args(res, maps)
    with pytest.raises(ValueError):
        shard_merge(t[:, :6], m, off, nref)
    with pytest.raises(ValueError):
        shard_merge(t.to(torch.int64), m, off, nref)
    with pytest.raises(ValueError):
        shard_merge(t, m, off[:2], nref)
    with pytest.raises(ValueError):
        shard_merge(t, m, off.to(torch.int32), nref)
    with pytest.raises(ValueError):
        shard_merge(t, m, off, 2**31 - 1)
    with pytest.raises(ValueError):
        ref_maps([[0], []], "cpu")
    assert tuple(shard_merge(t[:, :, :0].contiguous(), m, off,
                             nref).shape) == (7, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_index", [2, 3, 8])
def test_merge_kernel_cases(cuda, n_index):
    res, maps, nref = merge_cases(n_index)
    args = _merge_args(res, maps, cuda)
    n0 = kernels.launches["shard_merge"]
    got = shard_merge(*args, nref)
    torch.cuda.synchronize()
    assert kernels.launches["shard_merge"] == n0 + 1
    assert torch.equal(got, shard_merge_plain(*args, nref))


@pytest.mark.cuda
@pytest.mark.parametrize("n_index", [2, 3, 8])
def test_merge_kernel_random(cuda, n_index):
    """Random [n_index, 7, 4096] results (the smoke's chunk rows), scores
    near ties and local refs past the maps, and a chunk of no rows."""
    rng = np.random.default_rng(n_index)
    maps = case_maps(n_index, seed=n_index)
    nref = max(g for m in maps for g in m) + 1
    res = rng.integers(-5, 2**31 - 1, (n_index, 7, 4096)).astype(np.int64)
    res[:, SCORE] = rng.integers(-2, 12, (n_index, 4096))
    for s, m in enumerate(maps):
        res[s, REF] = rng.integers(-2, len(m) + 2, 4096)
    args = _merge_args(res.astype(np.int32), maps, cuda)
    got = shard_merge(*args, nref)
    torch.cuda.synchronize()
    assert torch.equal(got, shard_merge_plain(*args, nref))
    empty = args[0][:, :, :0].contiguous()
    assert tuple(shard_merge(empty, *args[1:], nref).shape) == (7, 0)


@pytest.fixture
def golden_shards(tmp_path):
    """The golden references in 2 genome shards, built in a temporary
    directory by the JAX package's index builder (numpy only) and removed
    after the test (tests/torch_shards.py); requested after `cuda`, so it
    is built only where the test runs."""
    from torch_shards import built_shards

    with built_shards(tmp_path) as root:
        yield root


@pytest.mark.cuda
def test_sharded_kernel_path_equals_plain(cuda, golden_shards):
    """The sharded classifier on the card: the kernel path launches the
    merge once a chunk and calls every golden read as the plain path does,
    with and without the exact replay."""
    from desamba_tpu_torch.engine.sharded_fast import load_sharded_fast
    from desamba_tpu_torch.io.fastx import read_fastx

    reads = [(r.name, r.seq, r.qual)
             for r in read_fastx(os.path.join(GOLD, "reads.fq"))]
    kern = load_sharded_fast(golden_shards, device=cuda)
    plain = load_sharded_fast(golden_shards, device=cuda, plain=True)
    tup = lambda rs: [(r.name, r.ref_ID, r.direction, r.score, r.read_len,
                       r.pos) for r in rs]
    for fallback in (False, True):
        kern.exact_fallback = plain.exact_fallback = fallback
        kernels.reset_launches()
        got = kern.classify_batch(reads)
        torch.cuda.synchronize()
        assert kernels.launches["shard_merge"] == kernels.launches["unpack"]
        assert kernels.launches["stage1"] == 2 * kernels.launches["unpack"]
        assert tup(got) == tup(plain.classify_batch(reads))
