"""Stage 2's compaction scan (K3: compact and row_grid) in the
formulation of csrc/compact.cu: a numpy model of the single-pass scan
(blocks take their index from a ticket, publish a count, look back over
the flags of the blocks before them, publish an inclusive prefix; fill
blocks wait for the last prefix and write the fill), run on a
ScanScratch as the wrapper keeps it, with the blocks' steps interleaved
at random. Held to JAX's cumsum-and-scatter expressions and to the plain
versions, element for element (integers: exact equality), on
compact_masks at every cap of compact_caps with and without a source
list, on row_grid_inputs, and on 50 back-to-back calls of mixed sizes
through one scratch whose call number wraps.

The module imports no JAX at top level: the card's tests below reuse
the cases. On the card:

    python -m pytest tests/test_torch_compact.py -m cuda -q

Change the kernel and the model together.
"""
import os

import numpy as np
import pytest
import torch

from desamba_tpu_torch.constants import ROWS_PER_SEARCH as R
from desamba_tpu_torch.ops.compact import (CALL_LIMIT, FILL_SPAN,
                                           LIST_BLOCK, SCAN_BLOCK,
                                           ScanScratch, compact_plain,
                                           row_grid_plain, scan_blocks)
from test_torch_kernels import compact_caps, compact_masks, row_grid_inputs

COUNT, PREFIX = 1, 2  # a flag's status (compact.cu kCount, kPrefix)
CALL_SHIFT = 34
LOW = (1 << 32) - 1


def wrap32(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def scan_model(live, m: int, cap: int, keep, fill, scratch: ScanScratch,
               rng, stats: dict | None = None,
               block: int = SCAN_BLOCK) -> None:
    """compact.cu's scan_block over m entries (live: bool[m]) in blocks of
    `block` entries (SCAN_BLOCK over a dense row, LIST_BLOCK over a source
    list) on the scratch's words, the blocks' steps interleaved at random:
    keep(slots, js) for a block's kept live entries, fill(slots) for a
    fill block's slots past the live total (int64 arrays). In three calls
    of ten (by rng) the steps are staged instead: every block takes its
    ticket, every block publishes its count, then the scan blocks run to
    their end from the last ticket down, so that each looks back over
    counts alone as far as block 0. stats counts the look-back's waits ("waits"), the flags it
    read from an earlier call ("stale"), the windows of 32 it summed
    without meeting a prefix ("windows") and the fill blocks
    ("fill_blocks")."""
    words, call = scratch.take(m, block)
    w = words.numpy().view(np.uint64)
    nb = scan_blocks(m, block)
    grid = nb + -(-cap // FILL_SPAN)
    tag = call << CALL_SHIFT
    st = stats if stats is not None else {}
    for k in ("waits", "stale", "windows", "fill_blocks"):
        st.setdefault(k, 0)

    def flag(i):
        return int(w[1 + i])

    def one_block():
        t = int(w[0])
        w[0] = np.uint64(0 if t == grid - 1 else t + 1)
        yield
        if t >= nb:  # a fill block
            st["fill_blocks"] += 1
            while (flag(nb - 1) >> 32) != (tag >> 32 | PREFIX):
                st["waits"] += 1
                yield
            used = min(flag(nb - 1) & LOW, cap)
            lo = (t - nb) * FILL_SPAN
            fill(np.arange(max(lo, used), min(lo + FILL_SPAN, cap)))
            return
        j = t * block + np.arange(block)
        lv = (j < m) & live[np.minimum(j, max(m - 1, 0))] if m else j < 0
        count = int(lv.sum())
        if t == 0:
            w[1] = np.uint64(tag | PREFIX << 32 | count)
            excl = 0
        else:
            w[1 + t] = np.uint64(tag | COUNT << 32 | count)
            yield
            excl, look = 0, t - 1
            while True:
                fs = [flag(i) if i >= 0 else tag | PREFIX << 32
                      for i in range(look, look - 32, -1)]
                ready = [f >> CALL_SHIFT == call and (f >> 32) & 3 != 0
                         for f in fs]
                if not all(ready):
                    st["waits"] += 1
                    st["stale"] += sum(f >> CALL_SHIFT != call
                                       and (f >> 32) & 3 != 0 for f in fs)
                    yield
                    continue
                pre = [(f >> 32) & PREFIX != 0 for f in fs]
                stop = pre.index(True) if any(pre) else 31
                excl += sum(f & LOW for f in fs[:stop + 1])
                if any(pre):
                    break
                st["windows"] += 1
                look -= 32
            w[1 + t] = np.uint64(tag | PREFIX << 32 | (excl + count))
        yield
        slots = excl + np.cumsum(lv) - 1
        kept = lv & (slots < cap)
        keep(slots[kept], j[kept])

    if rng.random() < 0.3:  # staged
        blocks = [one_block() for _ in range(grid)]
        for _ in range(2):
            for g in blocks:
                next(g, None)
        for g in blocks[nb - 1::-1] + blocks[nb:]:
            for _ in g:
                pass
    else:
        waiting, running = grid, []
        while waiting or running:
            if waiting and (not running or rng.random() < 0.3):
                running.append(one_block())
                waiting -= 1
            g = running[rng.integers(len(running))]
            try:
                next(g)
            except StopIteration:
                running.remove(g)
    assert int(w[0]) == 0  # the last ticket set it back


def compact_model(done, cap: int, src=None, scratch=None, rng=None,
                  stats=None) -> np.ndarray:
    """compact's kernel on the model: int32[cap]."""
    done = np.asarray(done)
    n = done.size
    if src is None:
        live, vals = done == 0, np.arange(n)
    else:
        vals = np.asarray(src, np.int64)
        ok = (vals >= 0) & (vals < n)
        live = ok & (done[np.clip(vals, 0, max(n - 1, 0))] == 0) if n else ok
    out = np.full(cap, -7, np.int64)
    wrote = np.zeros(cap, np.int64)

    def keep(s, j):
        out[s] = vals[j]
        wrote[s] += 1

    def fill(s):
        out[s] = n
        wrote[s] += 1

    scan_model(live, live.size, cap, keep, fill,
               scratch or ScanScratch("cpu"),
               rng or np.random.default_rng(0), stats,
               SCAN_BLOCK if src is None else LIST_BLOCK)
    assert (wrote == 1).all()  # every slot written once
    return out


def row_grid_model(st, seed_ok, lane, s_idx, cap: int, scratch=None,
                   rng=None, stats=None):
    """row_grid's kernel on the model: (sel [cap], walk [5, cap],
    wl [4, cap]), as compact.cu's RowGrid keeps and fills a slot."""
    st = np.asarray(st, np.int64)
    seed_ok, lane, s_idx = (np.asarray(a) for a in (seed_ok, lane, s_idx))
    S = st.shape[1]
    e = np.arange(S * R)
    s, k = e // R, e % R
    sp, ep = st[2][s], st[3][s]
    live = seed_ok[s] & (sp < ep) & (wrap32(sp + k) < ep)
    sel = np.zeros(cap, np.int64)
    walk = np.zeros((5, cap), np.int64)
    wl = np.zeros((4, cap), np.int64)

    def put(slot, ent, v, valid):
        si, ki = ent // R, ent % R
        ml = st[4, si]
        rem = wrap32(s_idx[si] - ml)
        sel[slot] = v
        walk[0, slot] = wrap32(st[2, si] + ki)
        walk[1, slot] = st[5, si]
        wl[:, slot] = (lane[si], np.where(valid & (rem > 0), rem, 0), ml,
                       s_idx[si])

    scan_model(live, S * R, cap, lambda slot, j: put(slot, j, j, True),
               lambda slot: put(slot, np.full(slot.size, S * R - 1),
                                S * R, False),
               scratch or ScanScratch("cpu"),
               rng or np.random.default_rng(0), stats)
    return sel, walk, wl


def _eq(ref, got, what):
    a, b = np.asarray(ref).astype(np.int64), np.asarray(got).astype(np.int64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a == b).all(), (what, int((a != b).sum()))


def mixed_calls(seed=50, n_calls=50):
    """n_calls back-to-back calls of mixed kinds and sizes: ("compact",
    done, cap, src) or ("row_grid", (st, seed_ok, lane, s_idx), cap).
    Sizes rise and fall (1 to 40,000 entries: 1 to 10 scan blocks), so a
    call meets flags of an earlier call with more blocks; caps bind, fit
    or exceed the entries."""
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(n_calls):
        n = int(rng.choice([1, 5, 1023, 4095, 4096, 4097, 9000, 40000]))
        if i % 5 == 4:
            S = max(1, n // R)
            args = row_grid_inputs(S, seed=i)
            calls.append(("row_grid", args, int(rng.choice(
                [1, S // 3 + 1, 2 * S, 2 * S + 9]))))
            continue
        done = torch.from_numpy((rng.random(n) < rng.random()).astype(
            np.int32))
        cap = int(rng.choice([1, n // 8 + 1, n, n + 13, 3 * FILL_SPAN + 5]))
        src = None
        if i % 3 == 1:
            src = torch.from_numpy(np.sort(rng.choice(
                np.arange(-3, n + 3), min(n, 700), replace=False)).astype(
                np.int32))
        calls.append(("compact", done, cap, src))
    return calls


def plain_call(c):
    if c[0] == "compact":
        return compact_plain(c[1], c[2], c[3])
    return row_grid_plain(*c[1], c[2])


# --------------------------------------------------------- CPU, vs JAX --
@pytest.mark.parametrize("n", [1, 1023, 4097, 40000, 140000])
def test_scan_model_compact_equals_jax(n):
    """The model's compact on every mask of compact_masks and cap of
    compact_caps, then its source-list form on that output (a second done
    row, every cap up to the first cut's), against JAX's sel2 and second
    cut and against compact_plain; 4,097 entries take a block and one
    entry more; at 140,000 entries (35 blocks) the look-back sums whole
    windows of 32 blocks."""
    import jax.numpy as jnp

    from test_torch_stage2 import jax_first

    rng = np.random.default_rng(n)
    scratch, stats = ScanScratch("cpu"), {}
    for name, done in compact_masks(n, seed=n).items():
        for cap in compact_caps(n):
            sel2 = np.asarray(jax_first(jnp.asarray(done.numpy() == 0), cap,
                                        n))
            got2 = compact_model(done.numpy(), cap, scratch=scratch, rng=rng,
                                 stats=stats)
            _eq(sel2, got2, (name, cap))
            _eq(compact_plain(done, cap), got2, (name, cap))
            done_b = (rng.random(n) < 0.5).astype(np.int32)
            s2i = np.minimum(sel2, n - 1)
            live3 = ~(done_b[s2i].astype(bool) | (sel2 >= n))
            for cap3 in compact_caps(cap):
                sel3 = np.asarray(jax_first(jnp.asarray(live3), cap3, cap))
                ref3 = np.where(sel3 < cap, s2i[np.minimum(sel3, cap - 1)], n)
                got3 = compact_model(done_b, cap3, src=got2, scratch=scratch,
                                     rng=rng, stats=stats)
                _eq(ref3, got3, (name, cap, cap3))
    assert stats["fill_blocks"] > 0
    if n > 32 * SCAN_BLOCK:
        assert stats["windows"] > 0


@pytest.mark.parametrize("S", [1, 2049, 3000])
def test_scan_model_row_grid_equals_jax(S):
    """The model's row grid on row_grid_inputs (int32 wraps included)
    against JAX's row grid and row_grid_plain, with a cap that binds, the
    exact valid count and past it; the entries (S * R) are not a multiple
    of the block."""
    import jax.numpy as jnp

    from test_torch_stage2 import jax_row_grid

    args = row_grid_inputs(S, seed=S)
    j = [jnp.asarray(t.numpy()) for t in args]
    n_valid = jax_row_grid(*j, 1)[-1]
    rng = np.random.default_rng(S)
    scratch = ScanScratch("cpu")
    for cap in sorted({1, max(1, n_valid // 2), n_valid or 1,
                       n_valid + 7}):
        ref = jax_row_grid(*j, cap)
        sel, walk, wl = row_grid_model(*(t.numpy() for t in args), cap,
                                       scratch=scratch, rng=rng)
        got = (sel, walk[0], walk[1], wl[0], wl[1], wl[2], wl[3])
        for i, (a, b) in enumerate(zip(ref, got)):
            _eq(a, b, (cap, i))
        assert not walk[2:].any()
        for a, b in zip(row_grid_plain(*args, cap), (sel, walk, wl)):
            _eq(a, b, cap)


def test_scan_model_back_to_back_through_a_wrapping_scratch():
    """50 calls of mixed kinds and sizes through one ScanScratch whose
    call number starts 20 below its wrap: each equals its plain version;
    the numbering wraps (the words zeroed once) and the look-back met
    flags that earlier calls left, which never read as ready."""
    scratch = ScanScratch("cpu", call=CALL_LIMIT - 20)
    rng, stats = np.random.default_rng(1), {}
    calls_seen = []
    for c in mixed_calls():
        if c[0] == "compact":
            got = compact_model(c[1].numpy(), c[2], None if c[3] is None
                                else c[3].numpy(), scratch, rng, stats)
            _eq(plain_call(c), got, c[2])
        else:
            got = row_grid_model(*(t.numpy() for t in c[1]), c[2], scratch,
                                 rng, stats)
            for a, b in zip(plain_call(c), got):
                _eq(a, b, c[2])
        calls_seen.append(scratch.call)
    assert CALL_LIMIT - 1 in calls_seen and calls_seen[-1] == 31
    assert stats["stale"] > 0 and stats["waits"] > 0


def test_scan_scratch_grows_and_wraps():
    """take() grows the words to 1 + the call's blocks (zeroed) and, at
    CALL_LIMIT, zeroes them and numbers from 1 again."""
    s = ScanScratch("cpu", call=CALL_LIMIT - 2)
    words, call = s.take(5 * SCAN_BLOCK + 1)
    assert words.numel() >= 7 and call == CALL_LIMIT - 1
    words[3] = 99
    words, call = s.take(1)
    assert call == 1 and not words.any() and words.numel() >= 7
    assert s.take(0)[1] == 2 and scan_blocks(0) == 1


# ------------------------------------------------------------ the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _card_call(c, dev):
    from desamba_tpu_torch.ops.compact import compact, row_grid

    if c[0] == "compact":
        return compact(c[1].to(dev), c[2],
                       None if c[3] is None else c[3].to(dev))
    return row_grid(*(t.to(dev) for t in c[1]), c[2])


@pytest.mark.cuda
def test_scan_kernels_back_to_back_on_one_stream(cuda):
    """mixed_calls' 50 calls launched back to back on one stream (no
    synchronize between them), the scratch's call number 20 below its
    wrap: each equals its plain version; one launch a call by the
    counts."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.ops.compact import scan_scratch

    calls = mixed_calls()
    _card_call(calls[0], cuda)
    scan_scratch(cuda).call = CALL_LIMIT - 20
    before = dict(kernels.launches)
    outs = [_card_call(c, cuda) for c in calls]
    torch.cuda.synchronize()
    assert scan_scratch(cuda).call == 31
    for c, got in zip(calls, outs):
        ref = plain_call(c)
        for a, b in zip(ref if c[0] == "row_grid" else [ref],
                        got if c[0] == "row_grid" else [got]):
            assert torch.equal(b.cpu(), a), c[0]
    n_rg = sum(c[0] == "row_grid" for c in calls)
    assert kernels.launches["row_grid"] - before["row_grid"] == n_rg
    assert (kernels.launches["compact"] - before["compact"]
            == len(calls) - n_rg)


def profile_one_call(name: str) -> list:
    """[[kernel, count], ...]: the CUDA rows of torch.profiler over one
    call of `name` (compact: 172,032 lanes, cap 21,504; row_grid: S =
    172,032, cap 86,016, the smoke chunk's shapes), after one untimed
    call, on this process's card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device("cuda")
    rng = np.random.default_rng(3)
    if name == "compact":
        c = ("compact", torch.from_numpy((rng.random(172032) < 0.7).astype(
            np.int32)).to(cuda), 21504, None)
    else:
        c = ("row_grid", tuple(t.to(cuda) for t in row_grid_inputs(
            172032, seed=3)), 86016)
    _card_call(c, cuda)
    torch.cuda.synchronize()
    for _ in range(3):  # torch.profiler at times reports no kernel row
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _card_call(c, cuda)
            torch.cuda.synchronize()
        rows = [[e.key, e.count] for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if rows:
            break
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["compact", "row_grid"])
def test_scan_kernels_one_launch_in_a_trace(cuda, name):
    """torch.profiler sees one kernel a call, and no memset, at the smoke
    chunk's shapes (profile_one_call). The profile is taken in a fresh
    process: late in a long process on the card the profiler has reported
    no row of a kernel launched through ctypes."""
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__, name], cwd=here, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    kern = [r for r in rows if f"{name}_kernel" in r[0]]
    assert len(kern) == 1 and kern[0][1] == 1, rows
    assert sum(r[1] for r in rows) == 1, rows


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(profile_one_call(sys.argv[1])))
