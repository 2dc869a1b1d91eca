"""The hand CUDA kernels against their plain torch versions.

The tests marked `cuda` run only where torch sees a GPU (nvcc builds the
kernels at first use); elsewhere they skip with a reason. On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

The unmarked tests check, on any host, what surrounds the kernels: the
CPU route of each wrapper, the build naming and the sources.
"""
import os

import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels


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


def _golden_codes(W):
    """(codes2 uint8[2B, W], lengths2 int32[2B]) of the golden reads that
    fit width W: forward rows, then reverse-complement rows."""
    from desamba_tpu_torch.io.fastx import read_fastx

    code = np.full(256, 1, np.uint8)
    for j, b in enumerate(b"ACGT"):
        code[b] = j
    root = os.path.dirname(os.path.abspath(__file__))
    reads = [r.seq for r in read_fastx(os.path.join(root, "golden",
                                                    "reads.fq"))
             if len(r.seq) <= W]
    B = len(reads)
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
                                   (33, 2048, 144), (130, 3072, 208)])
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
