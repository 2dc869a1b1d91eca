"""A numpy model of the vote kernel's formulation (csrc/vote.cu), held to
JAX's stage 3 and to vote_plain on the CPU, and the kernel held to
vote_plain on the card.

vote_model runs what the kernel runs, step by step: the slot map (a
uint64 word a (row, window), tagged (call << 32) | lane by the map
kernel, a word of another call read as an empty window), then a warp a
read row: the row's windows 32 at a time, a lane a window, each lane's
listed anchors (pvalid, ref >= 0) appended to the row's list in slot
order through an inclusive prefix of the lanes' counts, the first
unlisted slot kept; a lane a listed entry summing the matching weights
in uint32; the three takes as each lane's best over its entries, then
the warp's (the largest value, then the smallest index holding it),
then against (-1, the first unlisted slot). Change the kernel and the
model together.

The synthetic cases (vote_synthetic) need no index: anchors made with
numpy from a seed, sel ascending, reversed and shuffled, rows with no
lane, rows with no anchor of a ref, lanes dropped (sel >= B2 * nwR), P
of 4 and of 3 (the kernel's vector and scalar loads), rows at
VOTE_MAX_SLOTS slots, and a slot map left by earlier calls. Everything
is integer: the tolerance is exact equality.

    python -m pytest tests/test_torch_vote_model.py -m cuda -q   # card

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import numpy as np
import pytest
import torch

from test_torch_kernels import cuda, tables  # noqa: F401
from test_torch_kernels import (I32_MAX, I32_MIN, _wrap32,
                                check_vote_coverage, vote_cases)
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

INT_MAX = I32_MAX
INT_MIN = I32_MIN


def _sub(a, b):
    return int(_wrap32(np.int64(a) - np.int64(b)))


def _abs(a):
    return a if a >= 0 or a == INT_MIN else -a


def _better(v, i, v2, i2):
    """take_better: (v2, i2) wins if larger, or equal at a smaller i."""
    return (v2, i2) if v2 > v or (v2 == v and i2 < i) else (v, i)


def _warp_best(vs, ks):
    """warp_best over 32 lanes' (value, index): the largest value
    (__reduce_max_sync), then the smallest index of the lanes that hold
    it (__reduce_min_sync, as uint32)."""
    m = max(vs)
    return m, min(k for v, k in zip(vs, ks) if v == m)


def map_model(sel, B2, nwR, words, call):
    """vote_map_kernel: lane c with 0 <= sel[c] < B2 * nwR writes
    (call << 32) | c into word sel[c] (words: uint64, in place)."""
    for c, s in enumerate(sel.tolist()):
        if 0 <= s < B2 * nwR:
            words[s] = np.uint64((call << 32) | c)


def vote_model(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2, B2, nwR,
               words=None, call=1, stats=None):
    """The kernel's formulation in numpy (arrays as vote takes them).
    words: the slot map as earlier calls left it (uint64, at least B2 *
    nwR; default zeros), updated in place; call: this call's number.
    Returns (ref_c, diag_c, vote_c), int32[B2, 3] each. stats, a dict,
    gathers the rows' list lengths and gap kinds."""
    ref, gpos, pvalid = (np.asarray(t) for t in (ref, gpos, pvalid))
    total_c, qleft_c, sel, lengths2 = (np.asarray(t) for t in (
        total_c, qleft_c, sel, lengths2))
    P = ref.shape[1]
    if words is None:
        words = np.zeros(B2 * nwR, np.uint64)
    map_model(sel, B2, nwR, words, call)
    out = np.zeros((3, B2, 3), np.int64)
    for b in range(B2):
        tol = int(np.clip(lengths2[b] >> 4, 30, 160))
        # 32 windows at a time, a lane a window: its listed anchors,
        # appended through the shuffle-up inclusive prefix of the lanes'
        # counts; the first unlisted slot
        lst, gap, gap_diag = [], INT_MAX, 0
        for w0 in range(0, nwR, 32):
            cnts, gaps, items = [], [], []
            for lane in range(32):
                w = w0 + lane
                c = -1
                if w < nwR:
                    e = int(words[b * nwR + w])
                    if e >> 32 == call:
                        c = e & 0xFFFFFFFF
                mine, my_gap = [], None
                if c >= 0:
                    ql, wt = int(qleft_c[c]), int(total_c[c])
                    for p in range(P):
                        r, d = int(ref[c, p]), _sub(gpos[c, p], ql)
                        if pvalid[c, p] and r >= 0:
                            mine.append((r, d, wt, w * P + p))
                        elif my_gap is None:
                            my_gap = (w * P + p, d)
                elif w < nwR:
                    my_gap = (w * P, 0)  # an empty window
                cnts.append(len(mine))
                gaps.append(my_gap)
                items.append(mine)
            incl = list(cnts)
            o = 1
            while o < 32:
                incl = [incl[ln] + (incl[ln - o] if ln >= o else 0)
                        for ln in range(32)]
                o <<= 1
            base = len(lst)
            lst += [None] * incl[31]
            for lane in range(32):
                k = base + incl[lane] - cnts[lane]
                for it in items[lane]:
                    lst[k] = it
                    k += 1
            if gap == INT_MAX:
                first = next((g for g in gaps if g is not None), None)
                if first is not None:
                    gap, gap_diag = first
        nv = len(lst)
        if stats is not None:
            stats.setdefault("nv", []).append(nv)
            stats.setdefault("A", set()).add(nwR * P)
        # scores: lane k % 32 sums entry k's matches in uint32 (a sum
        # mod 2^32, in any order; here in blocks of 1,024 entries)
        score = []
        if nv:
            L = np.array(lst, np.int64)
            for i0 in range(0, nv, 1024):
                e = L[i0:i0 + 1024]
                diff = _wrap32(e[:, 1, None] - L[None, :, 1])
                adiff = np.where(diff == INT_MIN, INT_MIN, np.abs(diff))
                m = (e[:, 0, None] == L[None, :, 0]) & (adiff <= tol)
                score += _wrap32((m * L[None, :, 2]).sum(1)).tolist()

        def take(value):
            vs, ks = [INT_MIN] * 32, [INT_MAX] * 32
            for k in range(nv):
                vs[k % 32], ks[k % 32] = _better(vs[k % 32], ks[k % 32],
                                                 value(k), k)
            v, k = _warp_best(vs, ks)
            if nv == 0 or (gap != INT_MAX and (
                    v < -1 or (v == -1 and gap < lst[k][3]))):
                if stats is not None:
                    stats.setdefault("gap_wins", 0)
                    stats["gap_wins"] += 1
                return -1, gap_diag, -1
            return (lst[k][0] if v > 0 else -1), lst[k][1], v

        r1, d1, v1 = take(lambda k: score[k])
        r2, d2, v2 = take(lambda k: score[k] if (
            lst[k][0] != r1 or _abs(_sub(lst[k][1], d1)) > 2 * tol) else -1)
        r3, d3, v3 = take(lambda k: score[k] if lst[k][0] != r1 else -1)
        out[0, b] = (r1, r2, r3)
        out[1, b] = (d1, d2, d3)
        out[2, b] = (max(v1, 0), max(v2, 0), max(v3, 0))
    return tuple(torch.from_numpy(o.astype(np.int32)) for o in out)


# ------------------------------------------------------ synthetic cases --
ORDERS = ("ascending", "reversed", "shuffled")


def vote_synthetic(seed, B2=48, nwR=42, P=4, order="shuffled"):
    """Anchors for the vote made with numpy from a seed, no index needed:
    (ref int32[n, P], gpos int32[n, P], pvalid bool[n, P], total_c,
    qleft_c, sel int32[n], lengths2 int32[B2]), with sel in `order`.
    Rows cycle through: random (half the windows filled, refs 0-2 and
    -3 with pvalid, diagonals around a centre, weights 1-60); full (every
    window filled, no unlisted slot unless an anchor lacks a ref); no
    lane; all invalid (pvalid false or refs < 0); ties and extremes
    (weights 0, negative and ~2^30, diagonals at INT_MIN and INT_MAX,
    qleft wrapping). Besides, lanes with sel = B2 * nwR and above are
    dropped."""
    rng = np.random.default_rng(seed)
    lanes = []  # (sel, ref[P], gpos[P], pvalid[P], total, qleft)
    lens = rng.integers(0, 9000, B2)

    def lane(s, refs, gp, pv, tot, ql):
        lanes.append((s, refs, gp, pv, tot, ql))

    for b in range(B2):
        kind = b % 5
        centre = int(rng.integers(-2 ** 31, 2 ** 31))
        if kind == 0:
            used = np.flatnonzero(rng.random(nwR) < 0.5)
        elif kind == 1:
            used = np.arange(nwR)
        elif kind == 2:
            continue  # no lane
        else:
            used = np.flatnonzero(rng.random(nwR) < 0.6)
        for w in used.tolist():
            refs = rng.integers(-3, 3, P)
            gp = _wrap32(centre + rng.normal(0, 120, P).astype(np.int64))
            pv = rng.random(P) < 0.8
            tot = int(rng.integers(1, 61))
            ql = int(rng.integers(-300, 300))
            if kind == 1:  # every slot listed
                refs = np.abs(refs) % 3
                pv = np.ones(P, bool)
            if kind == 3:  # none listed: not pvalid, or a ref below 0
                refs = np.where(pv, -1 - np.abs(refs), refs)
            if kind == 4:
                tot = int(rng.choice([0, -7, -1, 2 ** 30 + 3, 40, 40]))
                gp = np.where(rng.random(P) < 0.2, rng.choice(
                    [I32_MIN, I32_MAX], P), gp)
                ql = int(rng.choice([ql, I32_MIN + 3, I32_MAX - 2]))
            lane(b * nwR + w, refs, gp, pv, tot, ql)
    for k in range(4):  # dropped: the fill and beyond
        lane(B2 * nwR + k * 3, rng.integers(0, 3, P),
             rng.integers(-100, 100, P), np.ones(P, bool), 50, 0)
    lanes.sort(key=lambda x: x[0])
    if order == "reversed":
        lanes = lanes[::-1]
    elif order == "shuffled":
        lanes = [lanes[i] for i in rng.permutation(len(lanes))]
    sel, refs, gp, pv, tot, ql = zip(*lanes)
    t32 = lambda x: torch.from_numpy(_wrap32(np.asarray(x, np.int64)).astype(
        np.int32))
    return (t32(np.stack(refs)), t32(np.stack(gp)),
            torch.from_numpy(np.stack(pv).astype(bool)), t32(tot), t32(ql),
            t32(sel), t32(lens))


def _eq(a, b, what):
    for name, x, y in zip(("ref_c", "diag_c", "vote_c"), a, b, strict=True):
        assert x.dtype == y.dtype == torch.int32, (what, name)
        assert torch.equal(x, y), (what, name, int((x != y).sum()))


# (seed, B2, nwR, P): P = 4 takes the kernel's vector loads, P = 3 its
# scalar ones; nwR = 42 is W = 2048's, 33 a ragged second chunk of 32
# windows, 166 W = 8192's
SYNTH = [(1, 48, 42, 4), (2, 40, 33, 3), (3, 20, 166, 4), (4, 30, 7, 1)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("seed,B2,nwR,P", SYNTH)
def test_vote_model_equals_vote_plain_on_synthetic_anchors(seed, B2, nwR, P,
                                                           order):
    """vote_model equals vote_plain on numpy-made anchors, sel in any
    order; the rows reach every kind (no lane, no listed anchor, a full
    list, the first unlisted slot winning a take)."""
    from desamba_tpu_torch.ops.vote import vote_plain

    args = vote_synthetic(seed, B2, nwR, P, order)
    stats = {}
    got = vote_model(*args, B2, nwR, stats=stats)
    _eq(got, vote_plain(*args, B2, nwR), f"seed {seed} {order}")
    nv = np.array(stats["nv"])
    assert (nv == 0).sum() >= 2 and nv.max() >= nwR and stats["gap_wins"]


def test_vote_model_reads_a_map_of_earlier_calls_as_empty():
    """A slot map left by earlier calls (other shapes, other lanes, other
    call numbers) changes nothing: its words read as empty windows; the
    same call number on a stale word would not, so the wrapper never
    repeats one without zeroing the map."""
    from desamba_tpu_torch.ops.vote import vote_plain

    words = np.zeros(max(B2 * nwR for _, B2, nwR, _ in SYNTH), np.uint64)
    for call, (seed, B2, nwR, P) in enumerate(SYNTH, start=1):
        args = vote_synthetic(seed, B2, nwR, P)
        assert words.size >= B2 * nwR
        got = vote_model(*args, B2, nwR, words=words, call=call)
        _eq(got, vote_plain(*args, B2, nwR), f"call {call}")
    # the last call's words, read again under its own number by a call
    # that lists no lane (every sel dropped): its stale lanes would count
    seed, B2, nwR, P = SYNTH[-1]
    args = list(vote_synthetic(seed, B2, nwR, P))
    args[5] = torch.full_like(args[5], B2 * nwR)
    stale = vote_model(*args, B2, nwR, words=words, call=len(SYNTH))
    fresh = vote_plain(*args, B2, nwR)
    assert not all(torch.equal(a, b) for a, b in zip(stale, fresh))


def test_vote_model_at_the_slot_limit():
    """Rows of VOTE_MAX_SLOTS slots (a row's list in shared memory at its
    largest) agree with vote_plain; the wrapper refuses one slot more."""
    from desamba_tpu_torch.ops.vote import VOTE_MAX_SLOTS, vote, vote_plain

    nwR = VOTE_MAX_SLOTS // 4
    args = vote_synthetic(5, 2, nwR, 4)
    _eq(vote_model(*args, 2, nwR), vote_plain(*args, 2, nwR), "limit")
    _eq(vote(*args, 2, nwR), vote_plain(*args, 2, nwR), "limit wrapper")
    with pytest.raises(ValueError):
        vote(*vote_synthetic(5, 2, 9, 4), 2, VOTE_MAX_SLOTS // 4 + 1)


@pytest.mark.parametrize("W,B2", [(256, 40), (2048, 40), (4096, 40),
                                  (8192, 40)])
def test_vote_model_equals_jax_on_vote_cases(tables, golden_oracle_index,
                                             W, B2):
    """vote_model on locate's anchors for vote_cases equals JAX's stage 3
    (locate, then the vote) element for element, each case reached."""
    import jax
    import jax.numpy as jnp

    from desamba_tpu.engine.fast_engine import _build_stages
    from desamba_tpu.index.tensor_index import from_oracle_index
    from desamba_tpu.ops.fm import FmArrays
    from desamba_tpu.ops.locate import LocArrays
    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR
    from desamba_tpu_torch.ops.locate import locate_plain

    fm, ek, loc, _ = tables
    *s2, lengths2, nwR, groups = vote_cases(fm, loc, W, ek.lek, B2)
    anchors = locate_plain(fm, loc, s2[0], s2[1], REFPOS_PER_ANCHOR)
    check_vote_coverage(*anchors, *s2[2:], lengths2, B2, nwR, groups)
    got = vote_model(*anchors, *s2[2:], lengths2, B2, nwR)
    ti = from_oracle_index(golden_oracle_index)
    js3 = jax.jit(_build_stages(ek.lek, ek.single_base_max, ek.mask_bits,
                                20, ek.n_words0)[2],
                  static_argnames=("B2", "nwR"))
    ref = js3(FmArrays(ti), LocArrays(ti), jnp.asarray(lengths2.numpy()),
              *(jnp.asarray(t.numpy()) for t in s2), B2=B2, nwR=nwR)
    _eq(tuple(torch.from_numpy(np.array(r)) for r in ref), got,
        f"W={W}")


# -------------------------------------------------------------- the card --
@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("seed,B2,nwR,P", SYNTH)
def test_vote_kernel_on_synthetic_anchors(cuda, seed, B2, nwR, P, order):
    """The vote kernel equals vote_plain on the synthetic cases (P = 4's
    vector loads and P = 3's and 1's scalar ones), one launch a call."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.ops.vote import vote, vote_plain

    args = [t.to(cuda) for t in vote_synthetic(seed, B2, nwR, P, order)]
    n = kernels.launches["vote"]
    got = vote(*args, B2, nwR)
    assert kernels.launches["vote"] == n + 1
    ref = vote_plain(*args, B2, nwR)
    torch.cuda.synchronize()
    _eq(got, ref, f"seed {seed} {order}")


@pytest.mark.cuda
def test_vote_kernel_back_to_back_and_at_the_slot_limit(cuda):
    """Calls of every shape back to back on one stream (the slot map
    grows and each call's words shadow the last's), an unaligned anchor
    view (the scalar loads at P = 4), and rows of VOTE_MAX_SLOTS slots
    (the most shared memory a warp takes): each equal to vote_plain."""
    from desamba_tpu_torch.ops.vote import VOTE_MAX_SLOTS, vote, vote_plain

    calls = [(vote_synthetic(seed, B2, nwR, P), B2, nwR)
             for seed, B2, nwR, P in SYNTH * 2]
    nwR = VOTE_MAX_SLOTS // 4
    calls.append((vote_synthetic(5, 3, nwR, 4), 3, nwR))
    calls = [([t.to(cuda) for t in args], B2, nwR)
             for args, B2, nwR in calls]
    a = [t.to(cuda) for t in vote_synthetic(6, 20, 42, 4)]
    # ref and gpos as views one int32 into a buffer: not 16-byte aligned
    for i in (0, 1):
        buf = torch.empty(a[i].numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = a[i].reshape(-1)
        a[i] = buf[1:].view(a[i].shape)
        assert a[i].data_ptr() % 16
    calls.append((a, 20, 42))
    got = [vote(*args, B2, nwR) for args, B2, nwR in calls]
    torch.cuda.synchronize()
    for (args, B2, nwR), g in zip(calls, got):
        _eq(g, vote_plain(*args, B2, nwR), f"B2={B2} nwR={nwR}")
