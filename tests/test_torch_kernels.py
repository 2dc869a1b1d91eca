"""The hand CUDA kernels against their plain torch versions.

The tests marked `cuda` run only where torch sees a GPU (nvcc builds the
kernels at first use); elsewhere they skip with a reason. On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

The unmarked tests check, on any host, what surrounds the kernels: the
CPU route of each wrapper, the build naming and the sources.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import os

import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables(golden_index_dir):
    from desamba_tpu_torch.convert import build_tables
    from desamba_tpu_torch.index.loader import load_index

    return build_tables(load_index(golden_index_dir), "cpu")


def _to(tabs, dev):
    from desamba_tpu_torch.ops.fm import FmArrays

    fm = tabs[0]
    return FmArrays(fm.occ32.to(dev), fm.pad.to(dev), fm.rank.to(dev),
                    fm.hash13.to(dev), fm.sa_uni.to(dev), fm.sa_off.to(dev),
                    fm.lfc.to(dev), fm.L, fm.dollar_pos)


def _search_inputs(fm, n, W, seed):
    """n lanes over random reads of width W, seeded from hash13 of each
    read's 13-mer ending at a random position, plus odd lanes (ptr out of
    range, empty intervals)."""
    rng = np.random.default_rng(seed)
    B2 = max(1, n // 7)
    codes = rng.integers(0, 4, (B2, W)).astype(np.int32)
    lane = rng.integers(0, B2, n).astype(np.int32)
    s_idx = rng.integers(13, W + 3, n).astype(np.int32)
    pre = np.zeros(n, np.int64)
    for t in range(13):
        pre = (pre << 2) | codes[lane, np.clip(s_idx - 12 + t, 0, W - 1)]
    hash13 = fm.hash13.cpu().numpy()
    sp0 = hash13[pre].astype(np.int32)
    ep0 = hash13[pre + 1].astype(np.int32)
    k = min(3, n)
    sp0[:k] = [0, 5, int(fm.L) - 1][:k]
    ep0[:k] = [0, 40, int(fm.L) + 1][:k]
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return dict(codes=i32(codes), lane=i32(lane), s_idx=i32(s_idx),
                sp0=i32(sp0), ep0=i32(ep0),
                max_rst=i32(np.full(n, 2)),
                l_min=i32(rng.choice([14, 20], n)),
                l_max=i32(np.minimum(s_idx, rng.choice([16, 41], n))))


# ------------------------------------------------------------ stage 1 --
M64 = (1 << 64) - 1


def _hash64_np(k: np.ndarray):
    """hash64_1 and hash64_2 (lib/utils.c:1067-1091) in native numpy
    uint64 arithmetic, which wraps like C's."""
    u = np.uint64
    with np.errstate(over="ignore"):
        a = k.copy()
        a = ~a + (a << u(21))
        a ^= a >> u(24)
        a = (a + (a << u(3))) + (a << u(8))
        a ^= a >> u(14)
        a = (a + (a << u(2))) + (a << u(4))
        a ^= a >> u(28)
        a = a + (a << u(31))
        b = k.copy()
        b += ~(b << u(32))
        b ^= b >> u(22)
        b += ~(b << u(13))
        b ^= b >> u(8)
        b += b << u(3)
        b ^= b >> u(15)
        b += ~(b << u(27))
        b ^= b >> u(31)
    return a, b


def _grid_kmers(codes: np.ndarray, lek: int, stride: int = 3):
    """uint64[B, n_g] k-mers of the stride grid of code rows."""
    n_g = (codes.shape[1] - lek + 1 - stride) // stride + 1
    k = np.zeros((codes.shape[0], n_g), np.uint64)
    for j in range(lek):
        col = codes[:, stride - 1 + j : stride - 1 + j + stride * (n_g - 1)
                    + 1 : stride]
        k = (k << np.uint64(2)) | col.astype(np.uint64)
    return k


def _set_bits(words: np.ndarray, h: np.ndarray) -> None:
    """Set bloom bit h (byte h >> 3, bit 7 - (h & 7)) in uint32 words."""
    h = h.astype(np.int64)
    bit = ((h >> 3) & 3) * 8 + 7 - (h & 7)
    np.bitwise_or.at(words, h >> 5, (np.uint32(1) << bit.astype(np.uint32)))


def _golden_codes(W, min_len=0, Bp=None):
    """(codes2 uint8[2Bp, W], lengths2 int32[2Bp]) of the golden reads of
    min_len to W codes: forward rows, then reverse-complement rows, each
    half padded with empty rows to Bp (default: the read count), as the
    classifier encodes a chunk."""
    from desamba_tpu_torch.io.fastx import read_fastx

    code = np.full(256, 1, np.uint8)
    for j, b in enumerate(b"ACGT"):
        code[b] = j
    root = os.path.dirname(os.path.abspath(__file__))
    reads = [r.seq for r in read_fastx(os.path.join(root, "golden",
                                                    "reads.fq"))
             if min_len <= len(r.seq) <= W]
    B = Bp or len(reads)
    codes = np.zeros((2 * B, W), np.uint8)
    lens = np.zeros(2 * B, np.int32)
    for i, s in enumerate(reads):
        c = code[np.frombuffer(s, np.uint8)]
        codes[i, : len(c)] = c
        codes[B + i, : len(c)] = (3 - c)[::-1]
        lens[i] = lens[B + i] = len(c)
    return codes, lens


def _stage1_rows(B2, W, lek, seed):
    """Random code rows with edge lengths: 0, lek + 1, lek + 2, odd,
    full width, and random lengths."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B2, W)).astype(np.uint8)
    lens = rng.integers(0, W + 1, B2).astype(np.int32)
    edge = [0, lek + 1, lek + 2, lek + 3, 2 * lek + 1, W - 1, W]
    lens[: min(B2, len(edge))] = edge[: min(B2, len(edge))]
    lens[len(edge) : len(edge) + 4] |= 1
    if B2 > 12:
        codes[10, :] = 0          # the zero k-mer everywhere
        codes[11, : W // 2] = 2   # a single-base run (base-count filter)
    return codes, lens


@pytest.mark.cuda
@pytest.mark.parametrize("mask_bits,load", [(20, 1.0), (22, 0.93),
                                            (27, 0.5)])
@pytest.mark.parametrize("B2,W,lek", [(40, 256, 16), (33, 300, 17),
                                      (64, 2048, 16), (19, 3072, 20),
                                      (9, 8192, 18)])
def test_stage1_kernel_random_rows(cuda, B2, W, lek, mask_bits, load):
    """Random rows on synthetic bitmaps: every bit set (runs span whole
    rows), a dense random bitmap (runs of every length) and a sparse one
    where exactly half the rows' grid k-mers are set in both bitmaps (a
    hit needs both hashes right, bit for bit)."""
    from desamba_tpu_torch.ops.seeds import stage1, stage1_plain

    codes, lens = _stage1_rows(B2, W, lek, seed=W + lek + mask_bits)
    rng = np.random.default_rng(mask_bits)
    nw = 1 << (mask_bits - 5)
    if load == 0.5:
        words = np.zeros(2 * nw, np.uint32)
        k = _grid_kmers(codes, lek).reshape(-1)
        k = k[rng.random(k.size) < load]
        h1, h2 = _hash64_np(k)
        m = np.uint64((1 << mask_bits) - 1)
        _set_bits(words[:nw], h1 & m)
        _set_bits(words[nw:], h2 & m)
    else:
        bits = rng.random((2 * nw, 32)) < load
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                 ).sum(1).astype(np.uint32)
    w01 = torch.from_numpy(words.view(np.int32)).to(cuda)
    args = (w01, torch.from_numpy(codes).to(cuda),
            torch.from_numpy(lens).to(cuda), lek, int(0.8 * lek), mask_bits,
            nw)
    before = kernels.launches["stage1"]
    got = stage1(*args)
    ref = stage1_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launches["stage1"] == before + 1
    for name, g, r in zip(("lo26", "kidx", "runlen", "n_exist"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    assert int(ref[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1024, 2048, 3072])
def test_stage1_kernel_golden_rows(cuda, tables, W):
    """Golden reads (both strands) on the golden index's folded filter."""
    from desamba_tpu_torch.ops.seeds import stage1, stage1_plain

    codes, lens = _golden_codes(W)
    ek = tables[1]
    args = (ek.w01.to(cuda), torch.from_numpy(codes).to(cuda),
            torch.from_numpy(lens).to(cuda), ek.lek, ek.single_base_max,
            ek.mask_bits, ek.n_words0)
    got = stage1(*args)
    ref = stage1_plain(*args)
    torch.cuda.synchronize()
    for name, g, r in zip(("lo26", "kidx", "runlen", "n_exist"), got, ref):
        assert torch.equal(g, r), name
    assert int(ref[2].max()) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", ["all_set", "dense", "sparse"])
def test_stage1_kernel_stage1_cases(cuda, bitmap):
    """test_torch_stage1.stage1_cases at every (W, lek) of its WIDTH_LEK
    on the card: the kernel equals stage1_plain on every output, one
    launch a call, every case reached."""
    from desamba_tpu_torch.ops.seeds import stage1, stage1_plain
    from test_torch_stage1 import (WIDTH_LEK, check_stage1_coverage,
                                   stage1_args, stage1_cases)

    for W, lek in WIDTH_LEK:
        case = stage1_cases(W, lek, bitmap)
        args = stage1_args(case, cuda)
        before = kernels.launches["stage1"]
        got = stage1(*args)
        ref = stage1_plain(*args)
        torch.cuda.synchronize()
        assert kernels.launches["stage1"] == before + 1
        for name, g, r in zip(("lo26", "kidx", "runlen", "n_exist"), got,
                              ref):
            assert torch.equal(g, r), (W, lek, name)
        check_stage1_coverage(case, got)


# ------------------------------------------------------------ stage 3 --
def _lf_chains(lfc: np.ndarray, L: int, rounds: int):
    """(steps, end) of the LF chain from each row in [0, L), walked with
    numpy for `rounds` rounds: end 1 where it reached a sampled row
    (row % 8 == 0), 2 where it met a char >= 4 first ('#', '$', pad), 0
    where it is still walking."""
    r = np.arange(L, dtype=np.int64)
    steps = np.zeros(L, np.int64)
    end = np.zeros(L, np.int64)
    for _ in range(rounds):
        end[(end == 0) & (r % 8 == 0)] = 1
        walk = end == 0
        w = lfc[np.clip(r, 0, lfc.size - 1)]
        stop = walk & ((w >> 29) >= 4)
        end[stop] = 2
        go = walk & ~stop
        r = np.where(go, w & ((1 << 29) - 1), r)
        steps += go
    return steps, end


def locate_cases(fm, loc, seed=8):
    """(fm', rows int32[n], valid bool[n], lanes) covering locate's edge
    cases on the golden tables. fm' is fm with a few sa_uni and sa_off
    entries rewritten; the locate tables stay the golden ones, whose
    reflist already has unitigs with 0, 1 and more than 4 occurrences and
    an end past refpos_global's. lanes maps each case to its lane indices:
    - "invalid": invalid lanes at sampled rows and elsewhere;
    - "edge": rows 0, L - 1, past L, past the table, negative and the
      int32 ends (valid);
    - "sentinel": chains that meet '#' or '$' before a sample;
    - "steps23"/"steps24"/"steps25"/"steps26": chains that reach a
      sample in exactly that many steps (24 is the most that max_lf=24
      allows);
    - "sa_uni": sample entries -1 and -3 (counted from the end), below
      the start and past the end (clamped);
    - "tie": positions equal to a unitig start (the right-side tie), to
      the end of the last unitig, and wrapped past 2^31;
    - "refs0"/"refs1"/"refs5": samples in unitigs with 0, 1 and at least
      5 reference occurrences (P at most 5);
    - "random": random rows, 85% of them valid."""
    from desamba_tpu_torch.ops.fm import FmArrays

    rng = np.random.default_rng(seed)
    L, n_pad = fm.L, fm.pad.shape[0]
    lfc = fm.lfc.cpu().numpy().view(np.uint32).astype(np.int64)
    steps, end = _lf_chains(lfc, L, 40)
    sa_uni = fm.sa_uni.cpu().numpy().copy()
    sa_off = fm.sa_off.cpu().numpy().copy()
    us = loc.uni_start.cpu().numpy().astype(np.int64)
    ul = loc.uni_len.cpu().numpy().astype(np.int64)
    refs = np.diff(loc.reflist.cpu().numpy().astype(np.int64))
    n_us, n_ul = us.size, ul.size
    s_new = rng.choice(np.arange(1, sa_uni.size), 11, replace=False)
    groups, rows, valid = {}, [], []

    def add(name, r, v=True):
        r = np.asarray(r, np.int64)
        groups[name] = np.arange(len(rows), len(rows) + r.size)
        rows.extend(r.tolist())
        valid.extend(np.broadcast_to(np.asarray(v, bool), r.shape).tolist())

    sampled = 8 * rng.integers(0, L // 8, 6)
    add("invalid", np.concatenate([sampled, rng.integers(0, L, 6),
                                   [-8, L + 40]]), False)
    add("edge", [0, 1, L - 1, L, L + 1, L + 8, n_pad - 1, n_pad, n_pad + 9,
                 -1, -5, -8, -(2 ** 31), 2 ** 31 - 1])
    sent = np.flatnonzero(end == 2)
    add("sentinel", sent[rng.choice(sent.size, min(12, sent.size),
                                     replace=False)])
    for k in (23, 24, 25, 26):
        ks = np.flatnonzero((end == 1) & (steps == k))
        add(f"steps{k}", ks[:6])
    # the sa_uni gather rule: -1 and -3 count from the end, the others
    # clamp to the ends
    sa_uni[s_new[:4]] = [-1, -3, -n_us - 5, n_us + 5]
    add("sa_uni", 8 * s_new[:4])
    # p = uni_start[uni0] + sa_off + k + 1 on a sampled row (k = 0): its
    # own unitig's start, the next unitig's start, the end of the last
    # unitig, and past 2^31 (wraps negative)
    u0 = sa_uni[s_new[4:6]].astype(np.int64)
    sa_off[s_new[4]] = -1
    sa_off[s_new[5]] = ul[u0[1]]
    sa_uni[s_new[6]], sa_off[s_new[6]] = n_ul - 1, ul[-1]
    sa_uni[s_new[7]], sa_off[s_new[7]] = 0, 2 ** 31 - 1
    add("tie", 8 * s_new[4:8])
    for j, (name, u) in enumerate((
            ("refs0", np.flatnonzero(refs == 0)[0]),
            ("refs1", np.flatnonzero(refs == 1)[0]),
            ("refs5", np.flatnonzero(refs >= 5)[0]))):
        sa_uni[s_new[8 + j]], sa_off[s_new[8 + j]] = u, 0
        add(name, [8 * s_new[8 + j]])
    add("random", rng.integers(-16, n_pad + 16, 600), rng.random(600) < 0.85)
    fm2 = FmArrays(fm.occ32, fm.pad, fm.rank, fm.hash13,
                   torch.from_numpy(sa_uni).to(fm.sa_uni.device),
                   torch.from_numpy(sa_off).to(fm.sa_off.device), fm.lfc,
                   fm.L, fm.dollar_pos)
    return (fm2, torch.tensor(rows, dtype=torch.int32),
            torch.tensor(valid, dtype=torch.bool), groups)


def check_locate_coverage(res, expand, groups, P):
    """The cases of locate_cases reach what they are meant to: res is
    resolve_rows' dict, expand expand_refpos' (ref, gpos, valid)."""
    ok, st, u_off = res["ok"], res["steps"], res["u_off"]
    g = {k: torch.from_numpy(v) for k, v in groups.items()}
    assert not ok[g["invalid"]].any()
    assert (st[g["invalid"]] == 0).all()
    assert not ok[g["sentinel"]].any() and (st[g["sentinel"]] < 25).all()
    for k in (23, 24):
        assert len(g[f"steps{k}"]) and ok[g[f"steps{k}"]].all()
        assert (st[g[f"steps{k}"]] == k).all()
    for k in (25, 26):
        assert len(g[f"steps{k}"]) and not ok[g[f"steps{k}"]].any()
        assert (st[g[f"steps{k}"]] == 25).all()
    assert ok[g["sa_uni"]].all() and ok[g["tie"]].all()
    assert (u_off[g["tie"][:2]] == 0).all()
    n_occ = expand[2].sum(1)
    for name, want in (("refs0", 0), ("refs1", 1), ("refs5", P)):
        assert ok[g[name]].all() and (n_occ[g[name]] == want).all(), name
    assert 0 < int(ok[g["random"]].sum()) < len(g["random"])


def _wrap32(x):
    """int64 values as the int32 values that hold their low 32 bits."""
    return (np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def vote_nwR(W, lek):
    """Stage 3's nwR (n_win * ROWS_PER_SEARCH anchor lanes a read row) at
    width W and e-kmer length lek."""
    from desamba_tpu_torch.constants import ROWS_PER_SEARCH, STEP_EK
    from desamba_tpu_torch.ops.ekmer import _grid
    from desamba_tpu_torch.ops.seeds import WINDOW

    return -(-_grid(W - lek + 1, STEP_EK) // WINDOW) * ROWS_PER_SEARCH


def vote_cases(fm, loc, W, lek=16, B2=40, seed=15):
    """Stage 2's outputs as stage 3 takes them, at width W (nwR =
    vote_nwR(W, lek)) on the tables fm, loc (on the CPU): (fsp_c int32[NC],
    hit_c bool[NC], total_c int32[NC], qleft_c int32[NC], sel int32[NC],
    lengths2 int32[B2], nwR, groups {case: read rows}). The lanes are in
    random order; lane c holds slot sel[c] % nwR of row sel[c] // nwR, and
    its anchor's diagonal is gpos - qleft_c. Rows of length 1600 (tol 100)
    unless the case says; a and c below are BWT rows that locate to one
    occurrence on ref 0 and on ref 1. The cases:
    - "tie1", "tie2", "tie3": two anchors tie at the best positive score
      of take 1, of take 2 (two far diagonals) and of take 3 (two anchors
      on the other ref);
    - "tol_edge": same-ref anchors exactly tol apart (they vote for each
      other) and tol + 1 apart (they do not);
    - "far_diag": take 2 picks an anchor on the winner's ref more than
      2 tol away, over a higher-scoring one exactly 2 tol away (not far);
    - "far_ref": take 2 picks an anchor on another ref on the winner's
      diagonal;
    - "other_ref": take 2 picks a far diagonal of the winner's ref, take 3
      an anchor on another ref;
    - "empty_invalid0": no valid anchor, and slot 0 holds a lane with no
      hit whose gpos - qleft wraps int32 (the candidates' diagonal); a
      lane that locates to no occurrence; and a row with no lane at all;
    - "score_le0": valid anchors of weight 0 and -7 (scores 0 and -7);
    - "apart_2_31": same-ref anchors 2^31 apart (|INT_MIN| == INT_MIN, so
      they vote for each other) and at INT_MAX and INT_MIN (1 apart once
      wrapped);
    - "wrap_sum": three and four anchors of weight ~2^30 on one diagonal,
      whose sums wrap int32;
    - "tol_len": lengths 0, 500, 2559, 2560 and 9000 (tol 30, 31, 159,
      160, 160) with anchors 31 and 160 apart;
    - "multi": lanes that locate to 2-4 occurrences;
    - "random": random lanes, 85% with a hit, on random diagonals around
      a centre; the last row also fills slot nwR - 1.
    Besides, lanes of valid anchors carry the fill sel = B2 * nwR (dropped
    by stage 3)."""
    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR as P
    from desamba_tpu_torch.ops.locate import locate_plain

    rng = np.random.default_rng(seed)
    nwR = vote_nwR(W, lek)
    assert nwR >= 6 and B2 >= 24
    pool = rng.choice(fm.L, min(fm.L, 4000), replace=False).astype(np.int32)
    pr = torch.from_numpy(pool)
    ref_v, gpos_v, pv = (t.numpy() for t in locate_plain(
        fm, loc, pr, torch.ones(pool.size, dtype=torch.bool), P))
    gpos_i = locate_plain(fm, loc, pr, torch.zeros(pool.size,
                                                  dtype=torch.bool), P)[1]
    g_hit = dict(zip(pool.tolist(), gpos_v[:, 0].tolist()))
    g_miss = dict(zip(pool.tolist(), gpos_i[:, 0].tolist()))
    n_occ = pv.sum(1)
    a, c = (int(pool[(n_occ == 1) & pv[:, 0] & (ref_v[:, 0] == r)][0])
            for r in (0, 1))
    zero = pool[n_occ == 0]
    multi = pool[n_occ >= 2]
    lanes, lens, groups = [], [], {}

    def row(name, length=1600):
        groups.setdefault(name, []).append(len(lens))
        lens.append(length)
        return len(lens) - 1

    def put(b, k, fsp, D, w, hit=True):
        """lane at slot k of row b whose slot-0 anchor has diagonal D"""
        g = (g_hit if hit else g_miss)[int(fsp)]
        lanes.append((b * nwR + k, fsp, hit, w, int(_wrap32(g - D))))

    T = 100
    b = row("tie1")
    put(b, 1, c, 9000, 50), put(b, 3, a, 1000, 50), put(b, 4, a, 1300, 10)
    b = row("tie2")
    put(b, 0, a, 0, 100), put(b, 2, a, 5000, 40), put(b, 5, a, -5000, 40)
    b = row("tie3")
    put(b, 0, a, 0, 100), put(b, 1, c, 7, 30), put(b, 4, c, 20000, 30)
    b = row("tol_edge")
    put(b, 0, a, 0, 1000), put(b, 1, a, T, 5), put(b, 2, a, -T - 1, 6)
    b = row("far_diag")
    put(b, 0, a, 0, 1000), put(b, 1, a, 2 * T, 9)
    put(b, 3, a, -2 * T - 1, 8)
    b = row("far_ref")
    put(b, 0, a, 0, 100), put(b, 2, c, 0, 60)
    b = row("other_ref")
    put(b, 0, a, 0, 100), put(b, 1, a, 10000, 80), put(b, 3, c, 50, 30)
    b = row("empty_invalid0")
    f = next(int(r) for r in pool if g_miss[int(r)] >= 3)
    # qleft near INT_MIN: gpos - qleft passes INT_MAX and wraps
    lanes.append((b * nwR, f, False, 7, I32_MIN + 3))
    put(b, 2, zero[0], 40, 9)
    row("empty_invalid0")
    b = row("score_le0")
    put(b, 1, a, 123, 0), put(b, 2, c, 500, -7)
    b = row("score_le0")
    put(b, 3, c, 500, -7)
    b = row("apart_2_31")
    put(b, 0, a, 1000, 40), put(b, 1, a, 1000 - 2 ** 31, 30)
    put(b, 4, c, I32_MAX, 5), put(b, 5, c, I32_MIN, 6)
    b = row("wrap_sum")
    for k, D in enumerate((0, 5, -5)):
        put(b, k, a, D, 2 ** 30 + 3)
    put(b, 3, c, 0, 5)
    b = row("wrap_sum")
    for k, D in enumerate((0, 5, -5, 9)):
        put(b, k, a, D, 2 ** 30 + 1)
    put(b, 5, c, 0, 3)
    for length in (0, 500, 2559, 2560, 9000):
        b = row("tol_len", length)
        put(b, 0, a, 0, 10), put(b, 1, a, 31, 11), put(b, 2, a, -160, 12)
        put(b, 3, a, 200, 13)
    b = row("multi")
    for k in range(3):
        put(b, k, multi[k], int(rng.integers(-50, 50)), 20 + k)
    while len(lens) < B2:
        b = row("random", int(rng.integers(W // 2, W + 1)))
        centre = int(rng.integers(0, 2 ** 20))
        used = rng.random(nwR) < 0.5
        used[-1] &= b < B2 - 1  # the last row's last slot is set below
        for k in np.flatnonzero(used):
            put(b, int(k), rng.choice(pool),
                centre + int(rng.normal(0, 80)), int(rng.integers(20, 61)),
                bool(rng.random() < 0.85))
    put(B2 - 1, nwR - 1, a, 17, 33)
    for _ in range(5):  # unused lanes of valid anchors: dropped
        lanes.append((B2 * nwR, a, True, 40, 0))
    lanes = [lanes[i] for i in rng.permutation(len(lanes))]
    sel, fsp, hit, total, qleft = (np.array(x) for x in zip(*lanes))
    t32 = lambda x: torch.from_numpy(x.astype(np.int32))
    return (t32(fsp), torch.from_numpy(hit.astype(bool)), t32(total),
            t32(qleft), t32(sel), t32(np.array(lens)), nwR,
            {k: np.array(v) for k, v in groups.items()})


def check_vote_coverage(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2,
                        B2, nwR, groups):
    """The cases of vote_cases reach what they are meant to, on locate's
    (ref, gpos, pvalid) for its lanes: each row's dense layout, scores
    and three takes recomputed in numpy (int64, wrapped where int32
    wraps)."""
    ref, gpos, pv = ref.numpy(), gpos.numpy(), pvalid.numpy()
    tot, ql, sel = total_c.numpy(), qleft_c.numpy(), sel.numpy()
    lens = lengths2.numpy()
    P = ref.shape[1]
    A = nwR * P
    assert ((sel == B2 * nwR)[:, None] & pv).any()  # dropped valid anchors
    assert set(np.clip(lens >> 4, 30, 160).tolist()) >= {30, 31, 159, 160}
    rows = {}
    for b in range(B2):
        ln = np.flatnonzero(sel // nwR == b)
        slot = ((sel[ln] % nwR)[:, None] * P + np.arange(P)).ravel()
        r_a = np.full(A, -1, np.int64)
        d64 = np.zeros(A, np.int64)
        w_a = np.zeros(A, np.int64)
        r_a[slot] = np.where(pv[ln], ref[ln], -1).ravel()
        d64[slot] = (gpos[ln].astype(np.int64) - ql[ln, None]).ravel()
        w_a[slot] = np.where(pv[ln], tot[ln, None], 0).ravel()
        d_a = _wrap32(d64)
        tol = int(np.clip(lens[b] >> 4, 30, 160))
        diff = _wrap32(d_a[:, None] - d_a[None, :])
        adiff = np.where(diff == I32_MIN, I32_MIN, np.abs(diff))
        same = r_a[:, None] == r_a[None, :]
        s64 = ((same & (adiff <= tol)) * w_a[None, :]).sum(1)
        score = np.where(r_a >= 0, _wrap32(s64), -1)
        i1 = int(np.argmax(score))
        r1 = int(r_a[i1]) if score[i1] > 0 else -1
        dd = _wrap32(d_a - d_a[i1])
        ad1 = np.where(dd == I32_MIN, I32_MIN, np.abs(dd))
        far = (r_a != r1) | (ad1 > 2 * tol)
        m2 = np.where(far, score, -1)
        m3 = np.where(r_a != r1, score, -1)
        rows[b] = dict(r_a=r_a, d64=d64, d_a=d_a, s64=s64, score=score,
                       tol=tol, same=same & (r_a[:, None] >= 0), r1=r1,
                       adiff=adiff, ad1=ad1, m2=m2, m3=m3,
                       i2=int(np.argmax(m2)), i3=int(np.argmax(m3)),
                       lanes0=ln[sel[ln] % nwR == 0])

    def case(name):
        return [rows[b] for b in groups[name]]

    for name, key in (("tie1", "score"), ("tie2", "m2"), ("tie3", "m3")):
        for x in case(name):
            top = x[key].max()
            assert top > 0 and (x[key] == top).sum() >= 2, name
    for x in case("tol_edge"):
        t = x["tol"]
        assert (x["same"] & (x["adiff"] == t)).any()
        assert (x["same"] & (x["adiff"] == t + 1)).any()
    for x in case("far_diag"):
        i2, t = x["i2"], x["tol"]
        assert x["m2"][i2] > 0 and x["r_a"][i2] == x["r1"] >= 0
        assert x["ad1"][i2] > 2 * t
        edge = (x["r_a"] == x["r1"]) & (x["ad1"] == 2 * t)
        assert (x["score"][edge] > x["m2"][i2]).any()
    for x in case("far_ref"):
        i2 = x["i2"]
        assert x["m2"][i2] > 0 and x["r_a"][i2] != x["r1"] >= 0
        assert x["ad1"][i2] <= 2 * x["tol"]
    for x in case("other_ref"):
        i2, i3 = x["i2"], x["i3"]
        assert x["m2"][i2] > x["m3"][i3] > 0 and i2 != i3
        assert x["r_a"][i2] == x["r1"] and x["r_a"][i3] != x["r1"] >= 0
    inv = case("empty_invalid0")
    assert all((x["r_a"] < 0).all() for x in inv)
    assert any(len(x["lanes0"]) and not pv[x["lanes0"]].any()
               and (x["d64"][0] > I32_MAX or x["d64"][0] < I32_MIN)
               for x in inv)
    assert any((x["r_a"] >= 0).any() and x["score"][x["r_a"] >= 0].min() <= 0
               for x in case("score_le0"))
    for x in case("apart_2_31"):
        d = x["d_a"][:, None] - x["d_a"][None, :]
        m = x["same"] & (x["adiff"] <= x["tol"])
        assert (m & (np.abs(d) == 2 ** 31)).any()
        assert (m & (np.abs(d) > 2 ** 31)).any()
    for x in case("wrap_sum"):
        ok = x["r_a"] >= 0
        assert (x["s64"][ok] != x["score"][ok]).any()
    for x in case("multi"):
        assert ((x["r_a"] >= 0).reshape(nwR, P).sum(1) >= 2).any()
    assert (rows[B2 - 1]["r_a"][-P:] >= 0).any()


# ------------------------------------------------ stage 2 compactions --
STAGE2_BURSTS = ("IV_BURST", "IV_MID", "WALK_BURST", "WALK_MID")


def golden_stage2_inputs(ek, W=2048, Bp=64):
    """Stage 2's inputs (codes_i, lengths2, lo26, kidx, runlen) on the
    CPU for the golden reads of the width-W bucket (W/2 < length <= W),
    encoded at Bp rows, through the plain stages 0 and 1."""
    from desamba_tpu_torch.ops.seeds import stage1_plain

    codes, lens = _golden_codes(W, min_len=W // 2 + 1, Bp=Bp)
    c2, l2 = torch.from_numpy(codes), torch.from_numpy(lens)
    lo26, kidx, runlen, _ = stage1_plain(ek.w01, c2, l2, ek.lek,
                                         ek.single_base_max, ek.mask_bits,
                                         ek.n_words0)
    return c2.to(torch.int32), l2, lo26, kidx, runlen


def compact_masks(n, seed):
    """{case: int32[n] done row}: no lane live, every lane live, only the
    two end lanes live, and random rows with 3%, 50% and 97% live."""
    rng = np.random.default_rng(seed)
    ends = np.ones(n, np.int32)
    ends[[0, -1]] = 0
    rows = dict(none=np.ones(n), every=np.zeros(n), ends=ends,
                **{f"p{p}": rng.random(n) >= p / 100 for p in (3, 50, 97)})
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in rows.items()}


def compact_caps(n):
    """Caps for n lanes: 1, one that binds (n / 8), n and past n."""
    return sorted({1, max(1, n // 8), n, n + 5})


def row_grid_inputs(S, seed):
    """row_grid's inputs on S lanes: ([8, S] carry, seed_ok bool[S], lane
    int32[S], s_idx int32[S]). Intervals of -2..3 rows (R = 2 rows a lane
    at most are valid), most lanes seeded; the last lane at
    sp = ep = INT32_MAX (the padding slots' row sp + 1 wraps), one lane
    at sp = INT32_MAX - 1, ep = INT32_MAX, and match_len at the int32 ends
    (s_idx - match_len wraps)."""
    rng = np.random.default_rng(seed)
    st = rng.integers(-50, 5000, (8, S)).astype(np.int64)
    st[3] = st[2] + rng.integers(-2, 4, S)
    ok = rng.random(S) < 0.8
    ml = st[4]
    if S > 4:
        st[2, 1], st[3, 1] = I32_MAX - 1, I32_MAX
        ml[2], ml[3] = I32_MIN, I32_MAX
        ok[1:4] = True
    st[2, -1] = st[3, -1] = I32_MAX
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int32))
    return (i32(st), torch.from_numpy(ok), i32(np.arange(S) // 21),
            i32(rng.integers(-5, 3000, S)))


# ---------------------------------------------------- stages 0 and 4 --
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def pack_wire(fwd, rc):
    """Wire rows uint8[B, W/2] of code rows fwd and rc (uint8[B, W]): the
    forward codes, then the rc codes, 4 a byte, LSB first."""
    c = np.concatenate([fwd, rc], 1)
    return (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
            | (c[:, 3::4] << 6)).astype(np.uint8)


def wire_batch(Bp, W, seed):
    """(packed uint8[Bp, W/2], lens int32[Bp]) of random bytes at random
    lengths, with lengths 0 (padding rows, one of them all zero bytes as
    the encoder leaves it, one of random bytes), 1, W - 1 and W."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (Bp, W // 2), dtype=np.uint8)
    lens = rng.integers(0, W + 1, Bp).astype(np.int32)
    edge = [0, 0, 1, W - 1, W]
    k = min(Bp, len(edge))
    lens[:k] = edge[:k]
    if Bp > 1:
        packed[1] = 0
    return packed, lens


def ref_codes(ra):
    """uint8 codes of the concatenated reference of RefArrays ra."""
    w = ra.ref_words_lsb.cpu().numpy().view(np.uint32)
    sh = 2 * np.arange(16, dtype=np.uint32)
    return ((w[:, None] >> sh) & 3).astype(np.uint8).reshape(-1)


def band_scores(ra, packed, lens, ref_c, diag_c, K):
    """int32[2B, C] band scores of the candidates (the plain versions)."""
    from desamba_tpu_torch.ops.matchblock import band_score_packed_plain
    from desamba_tpu_torch.ops.rescore import band_windows_plain
    from desamba_tpu_torch.ops.unpack import unpack_plain

    _, _, rw, l2 = unpack_plain(torch.from_numpy(packed),
                                torch.from_numpy(lens))
    bs = band_score_packed_plain(*band_windows_plain(
        ra, rw, l2, torch.from_numpy(ref_c), torch.from_numpy(diag_c), K), K)
    return bs["score"].reshape(ref_c.shape).numpy()


def stage4_cases(ra, W, n_random=24, seed=4):
    """Stage-4 inputs at width W on the reference tables ra (on the CPU):
    (packed uint8[B, W/2], lens int32[B], ref_c int32[2B, 3], diag_c
    int32[2B, 3], groups {case: read indices}); candidate rows b (forward)
    and B + b (rc) belong to read b. The cases:
    - "tie_odd_fwd", "tie_odd_rc", "tie_even_fwd", "tie_even_rc": two
      refs tie at the best score, odd or even, and the tie order picks a
      candidate on the forward or the rc strand; the read is two halves
      copied from the two refs, drawn until their scores tie;
    - "all_invalid": every candidate of both strands is -1;
    - "int32_ends": diagonals at the int32 ends and within the band of
      them (the aligned band start and rel_lo wrap);
    - "ref_edges": refs 0, n_ref - 1 and past n_ref on diagonals that
      match the read, and -1;
    - "random": reads copied from a random ref with 8% errors, candidates
      near the true diagonal on random refs."""
    from desamba_tpu_torch.constants import _band

    rng = np.random.default_rng(seed)
    C, band = 3, _band(W)
    K = 2 * band + 16
    codes = ref_codes(ra)
    off = ra.ref_offset.numpy().astype(np.int64)
    ln = ra.ref_len.numpy().astype(np.int64)
    n_ref = off.size
    reads, groups = [], {}

    def add(name, fwd, rc, length, refs, diags):
        """refs, diags: [fwd candidates, rc candidates]"""
        groups.setdefault(name, []).append(len(reads))
        reads.append((fwd, rc, length, refs, diags))

    def rand_codes():
        return rng.integers(0, 4, W).astype(np.uint8)

    def inside(r, span):  # a global position of ref r with span codes after
        return int(off[r] + rng.integers(band, ln[r] - span - band))

    def any_diag():
        return rng.integers(I32_MIN, I32_MAX, C, endpoint=True).tolist()

    none = [-1] * C
    for parity in (1, 0):
        m = 40 + parity
        for _ in range(500):
            a, b = sorted(rng.choice(n_ref, 2, replace=False).tolist())
            ga, gb = inside(a, 2 * m), inside(b, 2 * m)
            f = rand_codes()
            f[:m] = codes[ga : ga + m]
            f[m : 2 * m] = codes[gb : gb + m]
            da, db = ga, gb - m
            s = band_scores(ra, pack_wire(f[None], f[None]),
                            np.array([2 * m], np.int32),
                            np.array([[a, b, -1], none], np.int32),
                            np.array([[da, db, 0], [0] * C], np.int32), K)
            if s[0, 0] == s[0, 1] > 0 and s[0, 0] % 2 == parity:
                break
        else:
            raise AssertionError("no tie found")
        name = "odd" if parity else "even"
        # odd: the highest tied ref (b) wins, even: the lowest (a)
        win, lose = ((b, db), (a, da)) if parity else ((a, da), (b, db))
        add(f"tie_{name}_fwd", f, f, 2 * m,
            [[lose[0], win[0], -1], [-1, -1, win[0]]],
            [[lose[1], win[1], 0], [0, 0, win[1]]])
        add(f"tie_{name}_rc", f, f, 2 * m,
            [[lose[0], -1, -1], [-1, win[0], -1]],
            [[lose[1], 0, 0], [0, win[1], 0]])
    add("all_invalid", rand_codes(), rand_codes(), W, [none, none],
        [any_diag(), any_diag()])
    add("all_invalid", rand_codes(), rand_codes(), W // 2, [none, none],
        [[I32_MIN, I32_MAX, 0], [I32_MIN + band - 1, I32_MAX - band, -1]])
    add("int32_ends", rand_codes(), rand_codes(), W,
        [[0, n_ref - 1, 1], [n_ref - 1, 0, n_ref + 2]],
        [[I32_MIN, I32_MIN + band - 1, I32_MIN + band + 40],
         [I32_MAX, I32_MAX - band + 1, I32_MAX - 7]])
    add("int32_ends", rand_codes(), rand_codes(), W - 3,
        [[n_ref - 1, 0, n_ref - 1], [-1, 1, 0]],
        [[I32_MIN + 3, I32_MIN + band, I32_MIN + band + 15],
         [I32_MIN, I32_MAX - 15, I32_MAX - band - 16]])
    for k in range(2):
        gl = inside(n_ref - 1, W)
        g0 = inside(0, W)
        f = codes[gl : gl + W].copy()
        r = rand_codes()
        r[: W // 2] = codes[g0 : g0 + W // 2]
        add("ref_edges", f, r, W - 5 * k,
            [[n_ref - 1, n_ref + 4, 0], [n_ref, -1, 0]],
            [[gl, gl, g0], [gl, gl, g0]])
    for _ in range(n_random):
        r0 = int(rng.integers(n_ref))
        g = inside(r0, W)
        f = codes[g : g + W].copy()
        err = rng.random(W) < 0.08
        f[err] = rng.integers(0, 4, int(err.sum()))
        refs = rng.choice([-1, r0, r0, int(rng.integers(n_ref + 1))],
                          (2, C)).tolist()
        diags = (g + rng.integers(-band, band + 1, (2, C))).tolist()
        add("random", f, rand_codes(), int(rng.integers(W // 2, W + 1)),
            refs, diags)
    fwd = np.stack([x[0] for x in reads])
    rc = np.stack([x[1] for x in reads])
    lens = np.array([x[2] for x in reads], np.int32)
    ref_c = np.array([x[3][0] for x in reads] + [x[3][1] for x in reads],
                     np.int32)
    diag_c = np.array([x[4][0] for x in reads] + [x[4][1] for x in reads],
                      np.int64).astype(np.int32)
    return (pack_wire(fwd, rc), lens, ref_c, diag_c,
            {k: np.array(v) for k, v in groups.items()})


def check_stage4_coverage(ra, packed, lens, ref_c, diag_c, groups, K):
    """The cases of stage4_cases reach what they are meant to."""
    from desamba_tpu_torch.ops.rescore import combine_plain

    B = lens.size
    band = (K - 16) // 2
    n_ref = ra.ref_offset.shape[0]
    s = band_scores(ra, packed, lens, ref_c, diag_c, K)
    d = diag_c.astype(np.int64)
    ok = ref_c >= 0
    # the aligned band start wraps; rel_lo = lo - g0a wraps
    assert (ok & (d - band < I32_MIN)).any()
    g0a = (((d - band) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    g0a &= ~15
    lo = ra.ref_offset.numpy().astype(np.int64)[np.clip(ref_c, 0, n_ref - 1)]
    assert (ok & ((lo - g0a > I32_MAX) | (lo - g0a < I32_MIN))).any()
    assert (d == I32_MIN).any() and (d == I32_MAX).any()
    assert {-1, 0, n_ref - 1} <= set(ref_c.ravel().tolist())
    assert (s[ref_c >= n_ref] > 0).any()
    inv = (ref_c[:B] < 0).all(1) & (ref_c[B:] < 0).all(1)
    assert inv[groups["all_invalid"]].all()
    # the ties: two refs or more at the best score, and where the pick is
    ref2 = np.concatenate([ref_c[:B], ref_c[B:]], 1)
    s4 = np.where(ref2 >= 0, np.concatenate([s[:B], s[B:]], 1), -1)
    s_max = s4.max(1)
    n_at = np.array([len(set(ref2[i][s4[i] == s_max[i]].tolist()))
                     for i in range(B)])
    out = combine_plain(ra, torch.from_numpy(s.reshape(-1).copy()),
                        torch.zeros(s.size, dtype=torch.int32),
                        torch.zeros(s.size, dtype=torch.int32),
                        torch.from_numpy(ref_c), torch.from_numpy(diag_c))
    fwd = out[2].numpy() == 1
    for name, odd, on_fwd in (("tie_odd_fwd", 1, True),
                              ("tie_odd_rc", 1, False),
                              ("tie_even_fwd", 0, True),
                              ("tie_even_rc", 0, False)):
        i = groups[name]
        assert (n_at[i] >= 2).all() and (s_max[i] > 0).all(), name
        assert (s_max[i] % 2 == odd).all() and (fwd[i] == on_fwd).all(), name


# ------------------------------------------------ validation engine --
def probe_cases(lek, W, seed=6):
    """probe_reads inputs at width W: (codes uint8[B, W], lengths
    int32[B], groups {case: row indices}). The cases:
    - "golden": golden reads of both strands cut to W (they hit the
      filter);
    - "padding": rows of length 0 over random codes;
    - "short": reads shorter than lek + 1 (lengths 1, lek - 1 and lek);
    - "run": a read whose first half is one base (the base-count filter);
    - "zero": a read of code 0 (the zero k-mer);
    - "random": random codes and lengths; "full": random codes at
      length W."""
    from desamba_tpu_torch.io.fastx import read_fastx
    from desamba_tpu_torch.utils.codec import seq_to_codes

    rng = np.random.default_rng(seed)
    root = os.path.dirname(os.path.abspath(__file__))
    rows, groups = [], {}

    def add(name, c, length):
        groups.setdefault(name, []).append(len(rows))
        row = rng.integers(0, 4, W).astype(np.uint8)
        row[length:] = 0  # the engine's padding past a read
        row[: min(len(c), W)] = c[:W]
        rows.append((row, length))

    for r in list(read_fastx(os.path.join(root, "golden", "reads.fq")))[:6]:
        f = seq_to_codes(r.seq)
        add("golden", f, min(f.size, W))
        add("golden", (3 - f[::-1]).astype(np.uint8), min(f.size, W))
    add("padding", rng.integers(0, 4, W).astype(np.uint8), 0)
    for n in (1, lek - 1, lek):
        add("short", rng.integers(0, 4, n).astype(np.uint8), n)
    run = rng.integers(0, 4, W).astype(np.uint8)
    run[: W // 2] = 2
    add("run", run, W)
    add("zero", np.zeros(W, np.uint8), W)
    for _ in range(4):
        add("random", rng.integers(0, 4, W).astype(np.uint8),
            int(rng.integers(0, W + 1)))
    add("full", rng.integers(0, 4, W).astype(np.uint8), W)
    return (np.stack([r for r, _ in rows]),
            np.array([n for _, n in rows], np.int32),
            {k: np.array(v) for k, v in groups.items()})


def check_probe_coverage(ek, codes, lengths, ex, groups):
    """The cases of probe_cases reach what they are meant to: golden hits,
    nothing past a read's end, and the base-count filter and the zero
    k-mer rejecting points that lie in a read."""
    from desamba_tpu_torch.ops.ekmer import _probe_addrs

    lek = ek.lek
    n_k = codes.shape[1] - lek + 1
    assert ex[groups["golden"]].any()
    past = np.arange(n_k)[None, :] + lek > lengths[:, None]
    assert past.any() and not ex[past].any()
    assert not ex[groups["padding"]].any()
    want = _probe_addrs(torch.from_numpy(codes), torch.from_numpy(lengths),
                        lek, ek.single_base_max, ek.mask_bits)[0].numpy()
    run = groups["run"][0]
    n_run = codes.shape[1] // 2 - lek + 1
    assert n_run > 0 and not want[run, :n_run].any()
    assert not want[groups["zero"]].any()


def walk_trace_cases(fm, seed=13, cap=96):
    """Traced row-walk inputs on the index of fm: (codes int32[B, W],
    lanes, start_rows, ptrs, max_lens int32[n], groups {case: lanes}).
    Read row 0 spells, right to left, the chars of a 140-step LF chain
    of ACGT from row r0 (so a walk from r0 matches it all the way);
    row 1 is the same with its char 96 steps in changed; past each read
    the codes are 255, as the engine pads them. The cases:
    - "overflow": from r0 with max_len 200, still walking after cap steps;
    - "max_at_cap": max_len cap, which it reaches at the last step;
    - "stop_at_cap": max_len cap - 1, so it stops at step cap;
    - "mismatch_at_cap": on row 1, a mismatch at step cap;
    - "max_len": max_len 5;
    - "bad_char": start rows at pad nibbles (rows past L, and -1, which
      JAX's gather clamps to the last row);
    - "ptr_out": ptr -1 (the engine's padding walks) and ptr W + 3;
    - "random": random rows, ptrs and max_lens on both read rows."""
    rng = np.random.default_rng(seed)
    lfc = fm.lfc.numpy().astype(np.int64) & 0xFFFFFFFF
    n_chain = cap + 44
    cand = rng.permutation(fm.L)[:4000]
    r, chars, ok = cand.copy(), [], np.ones(cand.size, bool)
    for _ in range(n_chain):
        w = lfc[r]
        chars.append(w >> 29)
        ok &= (w >> 29) < 4
        r = w & ((1 << 29) - 1)
    assert ok.any(), "no ACGT chain of the length the cases need"
    k = int(np.argmax(ok))
    r0 = int(cand[k])
    chain = np.array([c[k] for c in chars], np.int32)
    W = n_chain + 16
    codes = np.full((2, W), 255, np.int32)
    codes[0, :n_chain] = chain[::-1]
    codes[1] = codes[0]
    codes[1, n_chain - 1 - (cap - 1)] ^= 1  # the char of step cap
    lanes, rows, ptrs, mlen, groups = [], [], [], [], {}

    def add(name, lane, row, ptr, max_len):
        groups.setdefault(name, []).append(len(lanes))
        lanes.append(lane)
        rows.append(row)
        ptrs.append(ptr)
        mlen.append(max_len)

    top = n_chain - 1
    add("overflow", 0, r0, top, 200)
    add("max_at_cap", 0, r0, top, cap)
    add("stop_at_cap", 0, r0, top, cap - 1)
    add("mismatch_at_cap", 1, r0, top, 200)
    add("max_len", 0, r0, top, 5)
    assert lfc.size > fm.L, "the index has no pad rows"
    for row in (fm.L, lfc.size - 1, -1):
        add("bad_char", 0, row, top, 10)
    add("ptr_out", 0, r0, -1, 200)
    add("ptr_out", 1, r0, W + 3, 200)
    for _ in range(40):
        add("random", int(rng.integers(2)), int(rng.integers(fm.L)),
            int(rng.integers(-2, W)), int(rng.integers(0, 130)))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return (i32(codes), i32(lanes), i32(rows), i32(ptrs), i32(mlen),
            {k: np.array(v) for k, v in groups.items()})


def check_walk_trace_coverage(out, groups, cap=96):
    """The cases of walk_trace_cases reach what they are meant to."""
    o = {k: v.numpy() for k, v in out.items()}

    def at(case, **want):
        i = groups[case]
        for k, v in want.items():
            assert (o[k][i] == v).all(), (case, k, o[k][i])

    at("overflow", steps=cap, overflow=1, stop_max=0)
    at("max_at_cap", steps=cap, overflow=1, stop_max=1)
    at("stop_at_cap", steps=cap - 1, overflow=0, stop_max=1)
    at("mismatch_at_cap", steps=cap - 1, overflow=0, stop_max=0)
    at("max_len", steps=5, overflow=0, stop_max=1)
    at("bad_char", steps=0, bad_char=1, overflow=0)
    at("ptr_out", steps=0, overflow=0, bad_char=0)
    tr = o["trace"]
    assert (tr[groups["overflow"]] >= 0).all()
    assert (tr[groups["stop_at_cap"], : cap - 1] >= 0).all()
    assert (tr[groups["stop_at_cap"], cap - 1] == -1).all()
    assert (tr[groups["ptr_out"]] == -1).all()
    assert o["steps"][groups["random"]].max() > 0


# --------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("n,W,steps", [(1, 256, 4096), (1000, 300, 2),
                                       (4099, 1024, 8), (777, 2048, 28)])
def test_interval_search_kernel(cuda, tables, n, W, steps):
    from desamba_tpu_torch.ops.fm import (interval_search_plain,
                                          interval_search_state, iv_init)

    fm = _to(tables, cuda)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, n, W, n).items()}
    st = iv_init(d["sp0"], d["ep0"], d["s_idx"])
    args = (fm, d["codes"], d["lane"], d["max_rst"], d["l_min"], d["l_max"])
    before = kernels.launches["interval_search"]
    for k in range(2):  # fresh, then resumed from the kernel's carry
        got = interval_search_state(*args, st, steps)
        ref = interval_search_plain(*args, st, steps)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        st = got
    assert kernels.launches["interval_search"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,W,cap", [(1, 256, 12), (999, 300, 16),
                                     (5003, 2048, 60)])
def test_row_walks_kernel(cuda, tables, n, W, cap):
    from desamba_tpu_torch.ops.fm import (interval_search_state, iv_init,
                                          row_walks_plain, row_walks_state,
                                          rw_init)

    fm = _to(tables, cuda)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, n, W, n + 1).items()}
    st = interval_search_state(fm, d["codes"], d["lane"], d["max_rst"],
                               d["l_min"], d["l_max"],
                               iv_init(d["sp0"], d["ep0"], d["s_idx"]), 28)
    rows = st[2].clone()
    k = min(2, n)
    rows[:k] = torch.tensor([-3, fm.lfc.shape[0] + 5][:k], dtype=torch.int32)
    mlen = torch.clamp(d["s_idx"] - st[4], min=0).to(torch.int32)
    state = rw_init(rows, st[5])
    for k in range(2):
        got = row_walks_state(fm, d["codes"], d["lane"], mlen, state, cap)
        ref = row_walks_plain(fm, d["codes"], d["lane"], mlen, state, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        state = got


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,K", [(1, 256, 16), (7, 512, 80),
                                   (33, 2048, 144), (130, 3072, 208),
                                   (65, 4096, 272), (17, 8192, 272)])
def test_band_score_kernel(cuda, B, W, K):
    from desamba_tpu_torch.ops.matchblock import (band_score_packed,
                                                  band_score_packed_plain)

    rng = np.random.default_rng(B)
    NW = W // 16 + K // 16 + 1
    read = rng.integers(0, 4, (B, W))
    win = rng.integers(0, 4, (B, 16 * NW))
    for b in range(B):
        for _ in range(6):
            k, q, ln = (int(rng.integers(0, K)), int(rng.integers(0, W - 40)),
                        int(rng.integers(4, 40)))
            win[b, q + k : q + k + ln] = read[b, q : q + ln]
    pack = lambda c: torch.from_numpy((c.reshape(c.shape[0], -1, 16).astype(
        np.uint64) << (2 * np.arange(16, dtype=np.uint64))).sum(2).astype(
        np.uint32).view(np.int32))
    rlen = rng.integers(1, W + 1, B).astype(np.int32)
    lo = rng.integers(-100, 60, B).astype(np.int32)
    hi = rng.integers(16 * NW - 60, 16 * NW + 100, B).astype(np.int32)
    if B > 1:
        lo[1], hi[1] = 200, 200
    args = [pack(read), torch.from_numpy(rlen), pack(win),
            torch.from_numpy(lo), torch.from_numpy(hi)]
    args = [a.to(cuda) for a in args]
    got = band_score_packed(*args, K)
    ref = band_score_packed_plain(*args, K)
    torch.cuda.synchronize()
    for f in ("score", "q_st", "q_ed"):
        assert torch.equal(got[f], ref[f]), f
    assert int(got["score"].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("K,W", [(16, 512), (144, 2048), (208, 3072),
                                 (272, 4096), (272, 8192)])
def test_band_score_kernel_band_cases(cuda, K, W):
    """The kernel on tests/test_torch_band_score.band_cases (runs of 8, 9
    and 10 codes across word, plane-word and run boundaries, rlen and
    rel_lo / rel_hi cuts at every shift, fully invalid rows), one launch:
    equal to the plain version, and every case reached."""
    from test_torch_band_score import band_args, band_cases, check_band_coverage

    from desamba_tpu_torch.ops.matchblock import (band_score_packed,
                                                  band_score_packed_plain)

    case = band_cases(K, W)
    args = band_args(case, cuda)
    before = kernels.launches["band_score_packed"]
    got = band_score_packed(*args)
    ref = band_score_packed_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launches["band_score_packed"] == before + 1
    for f in ("score", "q_st", "q_ed"):
        assert torch.equal(got[f], ref[f]), f
    check_band_coverage(case, {f: v.cpu() for f, v in got.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_locate_kernel_edge_cases(cuda, tables, P):
    """The locate cases (locate_cases) on the card: kernel == plain on
    all three outputs, and the cases reach what they are meant to."""
    from desamba_tpu_torch.ops.locate import (LocArrays, expand_refpos,
                                              locate, locate_plain,
                                              resolve_rows)

    fm, rows, valid, groups = locate_cases(_to(tables, cuda), tables[2])
    loc = LocArrays(**{k: getattr(tables[2], k).to(cuda)
                       for k in LocArrays.FIELDS})
    rows, valid = rows.to(cuda), valid.to(cuda)
    before = kernels.launches["locate"]
    got = locate(fm, loc, rows, valid, P)
    ref = locate_plain(fm, loc, rows, valid, P)
    torch.cuda.synchronize()
    assert kernels.launches["locate"] == before + 1
    for name, g, r in zip(("ref", "gpos", "pvalid"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    res = {k: v.cpu() for k, v in resolve_rows(fm, loc, rows, valid).items()}
    check_locate_coverage(res, [t.cpu() for t in ref], groups, P)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 86016])
def test_locate_kernel_random_batch(cuda, tables, n):
    """Random BWT rows over the whole table (90% valid) on the golden
    tables, up to the smoke chunk's NC = 86,016 lanes."""
    from desamba_tpu_torch.ops.locate import LocArrays, locate, locate_plain

    fm = _to(tables, cuda)
    loc = LocArrays(**{k: getattr(tables[2], k).to(cuda)
                       for k in LocArrays.FIELDS})
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.integers(0, fm.L, n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    got = locate(fm, loc, rows.to(cuda), valid.to(cuda), 4)
    ref = locate_plain(fm, loc, rows.to(cuda), valid.to(cuda), 4)
    torch.cuda.synchronize()
    for name, g, r in zip(("ref", "gpos", "pvalid"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,W", [(1, 16), (7, 256), (33, 3072),
                                  (4096, 2048), (1, 48), (3, 48), (5, 8192),
                                  (4096, 3072)])
def test_unpack_kernel(cuda, Bp, W):
    """Random wire rows with padding rows, up to the smoke's chunks; one
    word a row, ragged rows (W/16 = 3), Bp = 1 and odd."""
    from desamba_tpu_torch.ops.unpack import unpack, unpack_plain

    packed, lens = wire_batch(Bp, W, seed=Bp + W)
    args = (torch.from_numpy(packed).to(cuda), torch.from_numpy(lens).to(cuda))
    before = kernels.launches["unpack"]
    got = unpack(*args)
    ref = unpack_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launches["unpack"] == before + 1
    for name, g, r in zip(("codes2", "codes_i", "read_w2", "lengths2"), got,
                          ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r), name


def _ra_to(ra, dev):
    from desamba_tpu_torch.ops.refwin import RefArrays

    return RefArrays(ra.ref_words_lsb.to(dev), ra.ref_offset.to(dev),
                     ra.ref_len.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [256, 2048, 3072])
def test_stage4_kernels_edge_cases(cuda, tables, W):
    """The stage-4 cases (stage4_cases) on the card: band_windows and
    combine each equal their plain version, and stage 4 on the kernels
    equals stage 4 on the plain versions."""
    from desamba_tpu_torch.constants import _band
    from desamba_tpu_torch.engine import fast_engine as tfe
    from desamba_tpu_torch.ops.rescore import (band_windows,
                                               band_windows_plain, combine,
                                               combine_plain)
    from desamba_tpu_torch.ops.unpack import unpack_plain

    packed, lens, ref_c, diag_c, groups = stage4_cases(tables[3], W)
    K = 2 * _band(W) + 16
    check_stage4_coverage(tables[3], packed, lens, ref_c, diag_c, groups, K)
    ra = _ra_to(tables[3], cuda)
    _, _, rw, l2 = unpack_plain(torch.from_numpy(packed).to(cuda),
                                torch.from_numpy(lens).to(cuda))
    rc_t, dc_t = (torch.from_numpy(ref_c).to(cuda),
                  torch.from_numpy(diag_c).to(cuda))
    before = dict(kernels.launches)
    got = band_windows(ra, rw, l2, rc_t, dc_t, K)
    ref = band_windows_plain(ra, rw, l2, rc_t, dc_t, K)
    for name, g, r in zip(("read_w", "rlen", "win_w", "rel_lo", "rel_hi"),
                          got, ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    bs = tfe.band_score_packed_plain(*ref, K)
    cargs = (ra, bs["score"], bs["q_st"], bs["q_ed"], rc_t, dc_t)
    assert torch.equal(combine(*cargs), combine_plain(*cargs))
    B2 = ref_c.shape[0]
    s4 = [tfe.build_stages(16, 12, 20, 20, ops=ops)[3]
          for ops in (tfe.KERNEL_OPS, tfe.PLAIN_OPS)]
    outs = [f(ra, rw, l2, rc_t, dc_t, None, B2=B2, K=K) for f in s4]
    torch.cuda.synchronize()
    assert list(outs[0]) == list(outs[1])
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    for k in ("band_windows", "combine"):
        assert kernels.launches[k] == before[k] + 2, k
    assert kernels.launches["band_score_packed"] == (
        before["band_score_packed"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B2,W", [(2, 256), (130, 3072), (8192, 2048),
                                  (1, 16), (7, 48), (33, 8192),
                                  (8192, 3072)])
def test_band_windows_kernel_random(cuda, tables, B2, W):
    """Random candidates, up to the smoke chunks' 8,192 rows: refs in
    [-1, n_ref], diagonals over the reference, past both ends and at
    random int32 values; one word a row, ragged rows (W/16 = 3), odd
    rows."""
    from desamba_tpu_torch.constants import _band
    from desamba_tpu_torch.ops.rescore import band_windows, band_windows_plain

    rng = np.random.default_rng(B2)
    ra = _ra_to(tables[3], cuda)
    n_ref, total = ra.ref_offset.shape[0], 16 * ra.ref_words_lsb.shape[0]
    ref_c = rng.integers(-1, n_ref + 1, (B2, 3)).astype(np.int32)
    diag_c = rng.integers(-500, total + 500, (B2, 3)).astype(np.int32)
    wild = rng.random((B2, 3)) < 0.1
    diag_c[wild] = rng.integers(I32_MIN, I32_MAX, int(wild.sum()),
                                endpoint=True)
    rw = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, (B2, W // 16),
                                       endpoint=True).astype(np.int32))
    l2 = torch.from_numpy(rng.integers(0, W + 1, B2).astype(np.int32))
    args = [t.to(cuda) for t in (rw, l2, torch.from_numpy(ref_c),
                                 torch.from_numpy(diag_c))]
    K = 2 * _band(W) + 16
    got = band_windows(ra, *args, K)
    ref = band_windows_plain(ra, *args, K)
    torch.cuda.synchronize()
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r)


def _combine_inputs(B, C, n_ref, seed, dev):
    """Random combine inputs on synthetic reference offsets: scores in a
    small range (many ties), refs in [-1, n_ref + 1], q_st, q_ed, diag and
    offsets over the whole int32 range in a tenth of the candidates (the
    pos and cov arithmetic wraps)."""
    from desamba_tpu_torch.ops.refwin import RefArrays

    rng = np.random.default_rng(seed)
    n = 2 * B * C

    def i32(lo, hi, shape):
        return rng.integers(lo, hi, shape, endpoint=True).astype(np.int32)

    score = i32(0, 6, n)
    q_st, q_ed = i32(0, 2048, n), i32(-1, 2048, n)
    diag = i32(0, 1 << 20, n)
    for a in (q_st, q_ed, diag):
        m = rng.random(n) < 0.1
        a[m] = i32(I32_MIN, I32_MAX, int(m.sum()))
    ref_c = i32(-1, n_ref + 1, (2 * B, C))
    off = i32(0, I32_MAX, n_ref)
    ra = RefArrays(torch.zeros(4, dtype=torch.int32, device=dev),
                   torch.from_numpy(off).to(dev),
                   torch.ones(n_ref, dtype=torch.int32, device=dev))
    t = lambda a: torch.from_numpy(a).to(dev)
    return (ra, t(score), t(q_st), t(q_ed), t(ref_c),
            t(diag.reshape(2 * B, C)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,n_ref", [(1, 1, 1), (1, 3, 2), (77, 3, 3),
                                       (4096, 3, 89), (300, 5, 4)])
def test_combine_kernel_random(cuda, B, C, n_ref):
    from desamba_tpu_torch.ops.rescore import combine, combine_plain

    args = _combine_inputs(B, C, n_ref, B + C, cuda)
    got = combine(*args)
    ref = combine_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.cuda
def test_stage_0_and_4_wrappers_reject_other_devices(cuda, tables):
    """A table or an input on another device than the first input raises
    before anything launches."""
    from desamba_tpu_torch.ops.rescore import band_windows, combine
    from desamba_tpu_torch.ops.unpack import unpack

    packed, lens = wire_batch(4, 256, seed=1)
    with pytest.raises(ValueError):
        unpack(torch.from_numpy(packed).to(cuda), torch.from_numpy(lens))
    ra_cpu = tables[3]
    rw = torch.zeros((4, 16), dtype=torch.int32, device=cuda)
    z = torch.zeros(4, dtype=torch.int32, device=cuda)
    c = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        band_windows(ra_cpu, rw, z, c, c, 80)
    with pytest.raises(ValueError):
        band_windows(_ra_to(ra_cpu, cuda), rw, z.cpu(), c, c, 80)
    s = torch.zeros(12, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        combine(ra_cpu, s, s, s, c, c)
    with pytest.raises(ValueError):
        combine(_ra_to(ra_cpu, cuda), s, s.cpu(), s, c, c)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    from desamba_tpu_torch.ops.matchblock import band_score_packed

    rw = torch.zeros((4, 16), dtype=torch.int64, device=cuda)
    z = torch.zeros(4, dtype=torch.int32, device=cuda)
    ww = torch.zeros((4, 16 + 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        band_score_packed(rw, z, ww, z, z, 16)
    strided = torch.zeros((4, 36), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        band_score_packed(rw.to(torch.int32), z, strided, z, z, 16)
    with pytest.raises(ValueError):
        band_score_packed(rw.to(torch.int32), z.cpu(), ww, z, z, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, 172032])
def test_compact_kernel(cuda, n):
    """compact on every edge mask and cap against compact_plain, then the
    source-list form on that output (a second done row, every cap up to
    the first cut's, and a list with entries outside [0, n))."""
    from desamba_tpu_torch.ops.compact import compact, compact_plain

    rng = np.random.default_rng(n)
    before = kernels.launches["compact"]
    calls = 0
    odd = torch.tensor([n, -1, 0, n - 1, n + 7], dtype=torch.int32)
    for name, done in compact_masks(n, seed=n).items():
        dc = done.to(cuda)
        for cap in compact_caps(n):
            got, ref = compact(dc, cap), compact_plain(done, cap)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), ref), (name, cap)
            done_b = torch.from_numpy((rng.random(n) < 0.5).astype(np.int32))
            for cap3 in compact_caps(cap):
                g3 = compact(done_b.to(cuda), cap3, got)
                torch.cuda.synchronize()
                assert torch.equal(g3.cpu(), compact_plain(done_b, cap3,
                                                           ref)), (name, cap3)
            g4 = compact(dc, 3, odd.to(cuda))
            assert torch.equal(g4.cpu(), compact_plain(done, 3, odd))
            calls += 2 + len(compact_caps(cap))
    assert kernels.launches["compact"] == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 1023, 1025, 172032])
def test_row_grid_kernel(cuda, S):
    """row_grid against row_grid_plain with caps that bind, the exact
    valid count and past it, on row_grid_inputs (int32 wraps included)."""
    from desamba_tpu_torch.ops.compact import row_grid, row_grid_plain

    args = row_grid_inputs(S, seed=S)
    on_card = [t.to(cuda) for t in args]
    sel = row_grid_plain(*args, 2 * S)[0]
    n_valid = int((sel < 2 * S).sum())
    before = kernels.launches["row_grid"]
    caps = sorted({1, max(1, n_valid // 2), n_valid or 1, n_valid + 7})
    for cap in caps:
        got = row_grid(*on_card, cap)
        ref = row_grid_plain(*args, cap)
        torch.cuda.synchronize()
        for g, r in zip(got, ref, strict=True):
            assert torch.equal(g.cpu(), r), cap
    assert kernels.launches["row_grid"] == before + len(caps)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1025, 172032])
def test_resume_kernels_through_an_index_list(cuda, tables, n):
    """interval_search_state and row_walks_state with sel (caps 1, n/8
    and past n of the live lanes) against their plain versions, which
    gather, loop and scatter; each resume updates its carry in place and
    returns it, unlisted lanes and slots unchanged."""
    from desamba_tpu_torch.ops.compact import compact
    from desamba_tpu_torch.ops.fm import (interval_search_plain,
                                          interval_search_state, iv_init,
                                          row_walks_plain, row_walks_state,
                                          rw_init)

    fm = _to(tables, cuda)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, n, 300, n + 2).items()}
    args = (fm, d["codes"], d["lane"], d["max_rst"], d["l_min"], d["l_max"])
    st = interval_search_state(*args, iv_init(d["sp0"], d["ep0"],
                                              d["s_idx"]), 0)
    mlen = torch.clamp(d["s_idx"] - 13, min=0).to(torch.int32)
    wst = rw_init(st[2], st[5])
    for cap in sorted({1, max(1, n // 8), n + 5}):
        sel = compact(st[6], cap)
        # each kernel's resume updates its carry in place: it gets a copy
        copy = st.clone()
        got = interval_search_state(*args, copy, 8, sel=sel)
        ref = interval_search_plain(*args, st, 8, sel=sel)
        wsel = compact(wst[3], cap)
        # the kernel's resume updates the carry in place: it gets a copy
        wcopy = wst.clone()
        wgot = row_walks_state(fm, d["codes"], d["lane"], mlen, wcopy, 16,
                               sel=wsel)
        wref = row_walks_plain(fm, d["codes"], d["lane"], mlen, wst, 16,
                               sel=wsel)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(wgot, wref), cap
        assert got is copy and wgot is wcopy
        for new, old, lst in ((got, st, sel), (wgot, wst, wsel)):
            listed = torch.zeros(n, dtype=torch.bool, device=cuda)
            listed[lst[(lst >= 0) & (lst < n)].long()] = True
            assert torch.equal(new[:, ~listed], old[:, ~listed]), cap


@pytest.mark.cuda
@pytest.mark.parametrize("bursts", [(0, 0, 0, 0), None],
                         ids=["bursts0", "defaults"])
def test_stage2_kernels_golden_chunk(cuda, tables, monkeypatch, bursts):
    """Stage 2 on the card under KERNEL_OPS equals stage 2 under
    PLAIN_OPS on the CPU, on the golden W = 2048 chunk at Bp = 64, with
    the bursts before the cuts at 0 (four caps bind) and at the defaults;
    each kernel launches as often as stage 2 calls it."""
    from desamba_tpu_torch.engine import fast_engine as tfe

    if bursts is not None:
        for name, v in zip(STAGE2_BURSTS, bursts):
            monkeypatch.setattr(tfe, name, v)
    ek = tables[1]
    inputs = golden_stage2_inputs(ek)
    build = lambda ops: tfe.build_stages(ek.lek, ek.single_base_max,
                                         ek.mask_bits, 20, ek.n_words0,
                                         ops=ops)[1]
    before = dict(kernels.launches)
    got = build(tfe.KERNEL_OPS)(_to(tables, cuda),
                                *(t.to(cuda) for t in inputs))
    ref = build(tfe.PLAIN_OPS)(tables[0], *inputs)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref, strict=True)):
        assert torch.equal(g.cpu(), r), i
    for name, k in (("interval_search", 3), ("compact", 4), ("row_grid", 1),
                    ("row_walks", 3)):
        assert kernels.launches[name] == before[name] + k, name


@pytest.mark.cuda
def test_stage2_wrappers_reject_bad_inputs(cuda, tables):
    """compact, row_grid and the loops' sel refuse other dtypes, shapes
    and devices before anything launches."""
    from desamba_tpu_torch.ops.compact import compact, row_grid
    from desamba_tpu_torch.ops.fm import interval_search_state, iv_init

    done = torch.zeros(100, dtype=torch.int32, device=cuda)
    src = torch.arange(10, dtype=torch.int32, device=cuda)
    st, ok, lane, s_idx = (t.to(cuda) for t in row_grid_inputs(50, 1))
    before = dict(kernels.launches)
    bad = [lambda: compact(done.long(), 8), lambda: compact(done, 8,
                                                            src.cpu()),
           lambda: compact(done.cpu(), 8, src), lambda: compact(done, 0),
           lambda: compact(done[::2], 8),
           lambda: row_grid(st, ok.cpu(), lane, s_idx, 16),
           lambda: row_grid(st, ok, lane.long(), s_idx, 16),
           lambda: row_grid(st[:, :0], ok[:0], lane[:0], s_idx[:0], 16)]
    fm = _to(tables, cuda)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, 50, 64, 3).items()}
    state = iv_init(d["sp0"], d["ep0"], d["s_idx"])
    args = (fm, d["codes"], d["lane"], d["max_rst"], d["l_min"], d["l_max"],
            state, 4)
    bad += [lambda: interval_search_state(*args, sel=src.cpu()),
            lambda: interval_search_state(*args, sel=src.long())]
    for f in bad:
        with pytest.raises(ValueError):
            f()
    assert kernels.launches == before


@pytest.mark.cuda
def test_compact_entry_points_refuse_short_scratch(cuda):
    """compact.cu's entry points refuse a scan scratch shorter than one
    uint64 word for the ticket and one for each of their blocks of 4,096
    entries, and a call number of 0 or of 2^30 and past; with one that
    long they equal the plain versions (8,193 lanes and 4,097 x 2 grid
    entries need three blocks, four words)."""
    from desamba_tpu_torch.constants import ROWS_PER_SEARCH as R
    from desamba_tpu_torch.ops.compact import (CALL_LIMIT, compact_plain,
                                               row_grid_plain)

    assert R == 2
    n, S, cap, P = 8193, 4097, 64, kernels.ptr
    done = torch.from_numpy(
        (np.random.default_rng(5).random(n) < 0.5).astype(np.int32))
    grid = row_grid_inputs(S, 2)
    dc, gc = done.to(cuda), [t.to(cuda) for t in grid]
    before = dict(kernels.launches)
    for k in (3, 4):
        words = torch.zeros(k, dtype=torch.int64, device=cuda)
        out = torch.empty(cap, dtype=torch.int32, device=cuda)
        sel = torch.empty(cap, dtype=torch.int32, device=cuda)
        walk = torch.empty((5, cap), dtype=torch.int32, device=cuda)
        wl = torch.empty((4, cap), dtype=torch.int32, device=cuda)

        def calls(call):
            return [
                lambda: kernels.call("compact", P(dc), n, P(None), n, cap,
                                     P(words), k, call, P(out),
                                     kernels.stream(cuda)),
                lambda: kernels.call("row_grid", *map(P, gc), S, R, cap,
                                     P(words), k, call + 1, P(sel), P(walk),
                                     P(wl), kernels.stream(cuda))]
        for f in calls(0)[:1] + calls(CALL_LIMIT - 1)[1:] + calls(
                CALL_LIMIT)[:1]:
            with pytest.raises(RuntimeError, match="cudaError"):
                f()
        for f in calls(1):
            if k == 3:
                with pytest.raises(RuntimeError, match="cudaError"):
                    f()
            else:
                f()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), compact_plain(done, cap))
    for g, r in zip((sel, walk, wl), row_grid_plain(*grid, cap),
                    strict=True):
        assert torch.equal(g.cpu(), r)
    assert kernels.launches == before


@pytest.fixture(scope="module")
def ek_unfolded(golden_index_dir):
    """The golden index's exist filter unfolded, as the validation engine
    probes it."""
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.ops.ekmer import EkArrays

    return EkArrays.from_tensor_index(load_index(golden_index_dir), "cpu")


def _ek_to(ek, dev):
    from desamba_tpu_torch.ops.ekmer import EkArrays

    return EkArrays(ek.w01.to(dev), ek.n_words0, ek.mask_bits, ek.lek,
                    ek.single_base_max, ek.fold_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 256, 4096])
def test_probe_reads_kernel(cuda, ek_unfolded, W):
    """probe_cases on the golden index's unfolded filter, then on a random
    filter at three-quarter load (many hits)."""
    from desamba_tpu_torch.ops.ekmer import (EkArrays, probe_reads,
                                             probe_reads_plain)

    codes, lens, groups = probe_cases(ek_unfolded.lek, W)
    args = (torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda))
    rng = np.random.default_rng(W)
    words = rng.integers(0, 2 ** 32, 2 << 15, dtype=np.uint64).astype(
        np.uint32) | rng.integers(0, 2 ** 32, 2 << 15, dtype=np.uint64
                                  ).astype(np.uint32)
    dense = EkArrays(torch.from_numpy(words.view(np.int32)).to(cuda), 1 << 15,
                     20, ek_unfolded.lek, ek_unfolded.single_base_max)
    before = kernels.launches["probe_reads"]
    outs = []
    for ek in (_ek_to(ek_unfolded, cuda), dense):
        got = probe_reads(ek, *args)
        ref = probe_reads_plain(ek, *args)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and torch.equal(got, ref)
        outs.append(got.cpu().numpy())
    check_probe_coverage(ek_unfolded, codes, lens, outs[0], groups)
    assert int(outs[1].sum()) > codes.shape[0]
    assert kernels.launches["probe_reads"] == before + 2


@pytest.mark.cuda
def test_row_walks_trace_kernel(cuda, tables):
    """walk_trace_cases, each case asserted reached, then a random batch
    resumed from the interval search on random reads."""
    from desamba_tpu_torch.ops.fm import (TRACE_KEYS, interval_search_state,
                                          iv_init, row_walks_trace,
                                          row_walks_trace_plain)

    fm = _to(tables, cuda)
    codes, lanes, rows, ptrs, mlen, groups = walk_trace_cases(tables[0])
    args = [t.to(cuda) for t in (codes, lanes, rows, ptrs, mlen)]
    before = kernels.launches["row_walks_trace"]
    got = row_walks_trace(fm, *args)
    ref = row_walks_trace_plain(fm, *args)
    torch.cuda.synchronize()
    assert set(got) == set(ref) == {"trace", *TRACE_KEYS}
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    check_walk_trace_coverage({k: v.cpu() for k, v in got.items()}, groups)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, 3000, 2048, 5).items()}
    st = interval_search_state(fm, d["codes"], d["lane"], d["max_rst"],
                               d["l_min"], d["l_max"],
                               iv_init(d["sp0"], d["ep0"], d["s_idx"]), 28)
    walk = (d["codes"], d["lane"], st[2], st[5],
            torch.clamp(d["s_idx"] - st[4], min=0).to(torch.int32))
    for cap in (96, 7):
        got = row_walks_trace(fm, *walk, cap)
        ref = row_walks_trace_plain(fm, *walk, cap)
        torch.cuda.synchronize()
        for k in ref:
            assert torch.equal(got[k], ref[k]), (cap, k)
    assert kernels.launches["row_walks_trace"] == before + 3


@pytest.mark.cuda
def test_validation_wrappers_reject_bad_inputs(cuda, tables, ek_unfolded):
    """probe_reads and row_walks_trace refuse inputs of another dtype,
    shape or device on the card, as on the CPU."""
    from desamba_tpu_torch.ops.ekmer import probe_reads
    from desamba_tpu_torch.ops.fm import row_walks_trace

    ek = _ek_to(ek_unfolded, cuda)
    codes = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    lens = torch.full((4,), 64, dtype=torch.int32, device=cuda)
    for c, n in ((codes.int(), lens), (codes, lens.long()),
                 (codes.cpu(), lens), (codes[:, ::2], lens),
                 (codes[:, :10], lens), (codes, lens[:3])):
        with pytest.raises(ValueError):
            probe_reads(ek, c, n)
    fm = _to(tables, cuda)
    c2 = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    z = torch.zeros(5, dtype=torch.int32, device=cuda)
    for a in ((c2.long(), z, z, z, z), (c2, z[:4], z, z, z),
              (c2, z, z.cpu(), z, z), (c2, z, z, z.long(), z),
              (c2[0], z, z, z, z)):
        with pytest.raises(ValueError):
            row_walks_trace(fm, *a)


# ------------------------------------------------------------ any host --
def test_stage1_cpu_route_and_input_checks(tables):
    """On the CPU the wrapper runs stage1_plain and counts nothing; bad
    inputs raise on any device."""
    from desamba_tpu_torch.ops.seeds import stage1, stage1_plain

    ek = tables[1]
    codes, lens = _stage1_rows(20, 256, ek.lek, seed=3)
    args = [ek.w01, torch.from_numpy(codes), torch.from_numpy(lens), ek.lek,
            ek.single_base_max, ek.mask_bits, ek.n_words0]
    before = dict(kernels.launches)
    for g, r in zip(stage1(*args), stage1_plain(*args)):
        assert torch.equal(g, r)
    assert kernels.launches == before
    bad = [(1, args[1].to(torch.int32)), (2, args[2].to(torch.int64)),
           (1, args[1][:, ::2]), (0, args[0][: ek.n_words0]),
           (5, 40)]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            stage1(*a)


def test_locate_cpu_route_and_input_checks(tables):
    """On the CPU the locate wrapper runs locate_plain and counts nothing;
    bad inputs raise on any device."""
    import copy

    from desamba_tpu_torch.ops.locate import locate, locate_plain

    fm, rows, valid, _ = locate_cases(tables[0], tables[2])
    loc = tables[2]
    before = dict(kernels.launches)
    for g, r in zip(locate(fm, loc, rows, valid, 4),
                    locate_plain(fm, loc, rows, valid, 4)):
        assert torch.equal(g, r)
    assert kernels.launches == before
    for bad_rows, bad_valid in ((rows.long(), valid), (rows, valid.int()),
                                (rows[::2], valid[::2]),
                                (rows, valid[:-1])):
        with pytest.raises(ValueError):
            locate(fm, loc, bad_rows, bad_valid, 4)
    for field, t in (("refpos_refid", loc.refpos_refid[:-1]),
                     ("uni_start", loc.uni_start[:-1]),
                     ("reflist", loc.reflist[:0]),
                     ("refpos_global", loc.refpos_global.long())):
        loc2 = copy.copy(loc)
        setattr(loc2, field, t)
        with pytest.raises(ValueError):
            locate(fm, loc2, rows, valid, 4)
    with pytest.raises(ValueError):
        locate(fm, loc, rows, valid, 0)


def test_unpack_cpu_route_and_input_checks():
    """On the CPU the unpack wrapper runs unpack_plain and counts nothing;
    bad inputs raise on any device."""
    from desamba_tpu_torch.ops.unpack import unpack, unpack_plain

    packed, lens = wire_batch(9, 512, seed=2)
    args = [torch.from_numpy(packed), torch.from_numpy(lens)]
    before = dict(kernels.launches)
    for g, r in zip(unpack(*args), unpack_plain(*args), strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert kernels.launches == before
    bad = [(0, args[0].to(torch.int32)), (1, args[1].long()),
           (0, args[0][:, :-4]), (0, args[0][:, ::2]), (1, args[1][:-1]),
           (0, args[0][0])]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            unpack(*a)


def test_band_windows_cpu_route_and_input_checks(tables):
    """On the CPU the band_windows wrapper runs band_windows_plain and
    counts nothing; bad inputs and tables raise on any device."""
    import copy

    from desamba_tpu_torch.ops.rescore import band_windows, band_windows_plain
    from desamba_tpu_torch.ops.unpack import unpack_plain

    ra = tables[3]
    packed, lens, ref_c, diag_c, _ = stage4_cases(ra, 256, n_random=4)
    _, _, rw, l2 = unpack_plain(torch.from_numpy(packed),
                                torch.from_numpy(lens))
    args = [ra, rw, l2, torch.from_numpy(ref_c), torch.from_numpy(diag_c),
            80]
    before = dict(kernels.launches)
    for g, r in zip(band_windows(*args), band_windows_plain(*args),
                    strict=True):
        assert torch.equal(g, r)
    assert kernels.launches == before
    bad = [(1, rw.long()), (1, rw[:-2]), (2, l2[:-1]), (2, l2.long()),
           (3, args[3].long()), (3, args[3][:, :2]), (4, args[4][:-2]),
           (4, args[4].t()), (5, 72), (5, 0)]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            band_windows(*a)
    for field, t in (("ref_offset", ra.ref_offset[:-1]),
                     ("ref_len", ra.ref_len.long()),
                     ("ref_words_lsb", ra.ref_words_lsb[:0])):
        ra2 = copy.copy(ra)
        setattr(ra2, field, t)
        with pytest.raises(ValueError):
            band_windows(ra2, *args[1:])


def test_combine_cpu_route_and_input_checks():
    """On the CPU the combine wrapper runs combine_plain and counts
    nothing; bad inputs raise on any device."""
    from desamba_tpu_torch.ops.rescore import combine, combine_plain

    args = list(_combine_inputs(50, 3, 4, 7, "cpu"))
    before = dict(kernels.launches)
    got = combine(*args)
    assert got.dtype == torch.int32 and got.shape == (6, 50)
    assert torch.equal(got, combine_plain(*args))
    assert kernels.launches == before
    s, rc = args[1], args[4]
    bad = [(1, s.long()), (2, s[:-1]), (3, s[::2]), (4, rc[:-1]),
           (4, rc[:, :2]), (5, args[5].long()), (4, rc[:0, :0])]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            combine(*a)


def test_compact_cpu_route_and_input_checks():
    """On the CPU the compact wrapper runs compact_plain and counts
    nothing; a source list's entries outside [0, n) are skipped; bad
    inputs raise on any device."""
    from desamba_tpu_torch.ops.compact import compact, compact_plain

    done = compact_masks(300, seed=1)["p50"]
    src = torch.tensor([300, -1, 0, 299, 307, 5, 7], dtype=torch.int32)
    before = dict(kernels.launches)
    for args in ((done, 40), (done, 400), (done, 2, src), (done, 9, src)):
        assert torch.equal(compact(*args), compact_plain(*args))
    live = [s for s in (0, 299, 5, 7) if done[s] == 0]
    assert compact(done, 9, src).tolist() == live + [300] * (9 - len(live))
    assert kernels.launches == before
    bad = [(done.long(), 8, None), (done[::2], 8, None),
           (done.reshape(20, 15), 8, None), (done, 0, None),
           (done, 8, src.long()), (done, 8, src.reshape(7, 1))]
    for args in bad:
        with pytest.raises(ValueError):
            compact(*args)


def test_row_grid_cpu_route_and_input_checks():
    """On the CPU the row_grid wrapper runs row_grid_plain and counts
    nothing; bad inputs raise on any device."""
    from desamba_tpu_torch.ops.compact import row_grid, row_grid_plain

    args = list(row_grid_inputs(50, seed=3))
    before = dict(kernels.launches)
    for cap in (16, 200):
        for g, r in zip(row_grid(*args, cap), row_grid_plain(*args, cap),
                        strict=True):
            assert g.dtype == torch.int32 and torch.equal(g, r)
    assert kernels.launches == before
    st, ok, lane, s_idx = args
    bad = [(0, st.long()), (0, st[:7]), (1, ok.int()), (2, lane[:-1]),
           (3, s_idx.long()), (3, s_idx[::2])]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            row_grid(*a, 16)
    with pytest.raises(ValueError):
        row_grid(*args, 0)
    with pytest.raises(ValueError):
        row_grid(st[:, :0], ok[:0], lane[:0], s_idx[:0], 16)


def test_resume_cpu_route_and_input_checks(tables):
    """On the CPU, interval_search_state and row_walks_state with sel run
    their plain versions and count nothing; only the listed lanes change;
    a sel of another dtype or shape raises."""
    from desamba_tpu_torch.ops.fm import (interval_search_plain,
                                          interval_search_state, iv_init,
                                          row_walks_plain, row_walks_state,
                                          rw_init)

    fm = tables[0]
    d = _search_inputs(fm, 200, 128, seed=9)
    args = (fm, d["codes"], d["lane"], d["max_rst"], d["l_min"], d["l_max"])
    st = iv_init(d["sp0"], d["ep0"], d["s_idx"])
    sel = torch.tensor([3, 200, 0, 150, -1], dtype=torch.int32)
    wst = rw_init(d["sp0"], d["s_idx"])
    mlen = torch.full((200,), 20, dtype=torch.int32)
    before = dict(kernels.launches)
    got = interval_search_state(*args, st, 5, sel=sel)
    assert torch.equal(got, interval_search_plain(*args, st, 5, sel=sel))
    wgot = row_walks_state(fm, d["codes"], d["lane"], mlen, wst, 5, sel=sel)
    assert torch.equal(wgot, row_walks_plain(fm, d["codes"], d["lane"], mlen,
                                             wst, 5, sel=sel))
    assert kernels.launches == before
    other = torch.ones(200, dtype=torch.bool)
    other[[3, 0, 150]] = False
    assert torch.equal(got[:, other], st[:, other])
    assert torch.equal(wgot[:, other], wst[:, other])
    assert not torch.equal(got, st)
    for bad in (sel.long(), sel.reshape(5, 1)):
        with pytest.raises(ValueError):
            interval_search_state(*args, st, 5, sel=bad)
        with pytest.raises(ValueError):
            row_walks_state(fm, d["codes"], d["lane"], mlen, wst, 5, sel=bad)


def test_probe_reads_cpu_route_and_input_checks(ek_unfolded):
    """On the CPU the probe_reads wrapper runs probe_reads_plain and counts
    nothing; the cases reach what they are meant to; bad inputs raise on
    any device."""
    from desamba_tpu_torch.ops.ekmer import probe_reads, probe_reads_plain

    codes, lens, groups = probe_cases(ek_unfolded.lek, 128)
    c, n = torch.from_numpy(codes), torch.from_numpy(lens)
    before = dict(kernels.launches)
    got = probe_reads(ek_unfolded, c, n)
    assert got.dtype == torch.uint8 and got.shape == (
        codes.shape[0], 128 - ek_unfolded.lek + 1)
    assert torch.equal(got, probe_reads_plain(ek_unfolded, c, n))
    assert kernels.launches == before
    check_probe_coverage(ek_unfolded, codes, lens, got.numpy(), groups)
    for bad_c, bad_n in ((c.int(), n), (c, n.long()), (c[:, ::2], n),
                         (c[:, : ek_unfolded.lek - 1], n), (c[0], n),
                         (c, n[:-1])):
        with pytest.raises(ValueError):
            probe_reads(ek_unfolded, bad_c, bad_n)


def test_row_walks_trace_cpu_route_and_input_checks(tables):
    """On the CPU the row_walks_trace wrapper runs row_walks_trace_plain
    and counts nothing; the cases reach what they are meant to; bad inputs
    raise on any device."""
    from desamba_tpu_torch.ops.fm import (TRACE_KEYS, row_walks_trace,
                                          row_walks_trace_plain)

    fm = tables[0]
    codes, lanes, rows, ptrs, mlen, groups = walk_trace_cases(fm)
    args = [codes, lanes, rows, ptrs, mlen]
    before = dict(kernels.launches)
    got = row_walks_trace(fm, *args)
    ref = row_walks_trace_plain(fm, *args)
    assert kernels.launches == before
    assert set(got) == {"trace", *TRACE_KEYS}
    for k in got:
        assert got[k].dtype == torch.int32 and torch.equal(got[k], ref[k]), k
    assert got["trace"].shape == (rows.numel(), 96)
    check_walk_trace_coverage(got, groups)
    bad = [(0, codes.long()), (0, codes[0]), (1, lanes[:-1]),
           (2, rows.long()), (3, ptrs[::2]), (4, mlen[:-1])]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            row_walks_trace(fm, *a)
    with pytest.raises(ValueError):
        row_walks_trace(fm, *args, -1)


def test_numpy_hashes_equal_the_u64_emulation():
    """The tests' native uint64 hashes equal the port's (hi, lo) pair
    emulation on random 40-bit keys."""
    from desamba_tpu_torch.ops import u64emu

    rng = np.random.default_rng(40)
    k = rng.integers(0, 1 << 40, 5000, dtype=np.uint64)
    h1, h2 = _hash64_np(k)
    pair = (torch.from_numpy((k >> np.uint64(32)).astype(np.int64)),
            torch.from_numpy((k & np.uint64(0xFFFFFFFF)).astype(np.int64)))
    for h, e in ((h1, u64emu.hash64_1(pair)), (h2, u64emu.hash64_2(pair))):
        assert ((h >> np.uint64(32)).astype(np.int64) == e[0].numpy()).all()
        assert ((h & np.uint64(0xFFFFFFFF)).astype(np.int64)
                == e[1].numpy()).all()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    from desamba_tpu_torch.ops.matchblock import band_score_packed

    before = dict(kernels.launches)
    rw = torch.zeros((2, 16), dtype=torch.int32)
    ww = torch.zeros((2, 16 + 2), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    out = band_score_packed(rw, z + 256, ww, z, z + 300, 16)
    assert out["score"].tolist() == [248, 248]
    assert kernels.launches == before


def test_devices_other_than_cpu_and_cuda_are_refused():
    assert kernels.launch_device(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        kernels.launch_device(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_kernel_sources_and_build_names(name):
    src = kernels.source_path(name)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, src)).read()
    entry = kernels.KERNELS[name][1]
    assert f'extern "C" int {entry}(' in text
    assert "cudaGetLastError()" in text
    path = kernels._lib_path(kernels.KERNELS[name][0])
    assert path == kernels._lib_path(kernels.KERNELS[name][0])
    assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
