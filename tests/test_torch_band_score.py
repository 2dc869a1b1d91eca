"""Stage 4's band scorer (K8, ops/matchblock.band_score_packed): a numpy
model of the kernel's formulation (csrc/band_score.cu) held to JAX's
band_score_packed and to the port's plain version, on edge rows that
`band_cases` builds and `check_band_coverage` asserts reached.

The model is the kernel's arithmetic step for step: the packed words
split into a low-bit and a high-bit plane of 32 codes a word; runs of
RUN plane words with one halo word, walked from high to low at each band
offset, and no work for runs wholly past rlen or rows with nothing
valid; e = ~(rh ^ ah) & ~((rl ^ al) | ~valid); the 9-run test by
tripling (r3 = e & e>>1 & e>>2, run starts = r3 & r3>>3 & r3>>6, the
halo's r3 from its own word only); the window-range mask applied only
to the 32-offset window blocks in which a run's positions below rlen do
not all meet valid window codes. (The kernel also splits each run's
offsets over threads, which ORs the same bits and is not modelled.) The
hypothesis test holds the tripling to the 8-step AND on random words.

This module imports no JAX at its top level, so test_torch_kernels.py
and chip_smoke.py reuse band_cases on the card.
"""
import numpy as np
import pytest
import torch

RUN = 8                       # csrc/band_score.cu kRun
M32 = np.uint64(0xFFFFFFFF)
RUN_LEN = 9                   # S_A_KMER_L
# (K, W) of every band the classifier makes (constants._band: K = 2 *
# band + 16) and of the small band of the JAX package's own test
BANDS = [(16, 512), (144, 2048), (208, 3072), (272, 4096)]


# ------------------------------------------------------------- cases --
def _pack(codes: np.ndarray) -> np.ndarray:
    """uint32 [B, n/16] words, code t of word w at bits 2t (LSB first)."""
    B, n = codes.shape
    sh = 2 * np.arange(16, dtype=np.uint64)
    return (codes.reshape(B, n // 16, 16).astype(np.uint64) << sh).sum(
        2).astype(np.uint32)


def band_cases(K: int, W: int) -> dict:
    """Rows for the band scorer at band K and read width W (W a multiple
    of 256 and >= 512): dict(read_w uint32 [B, W/16], rlen, win_w uint32
    [B, NW], rel_lo, rel_hi int32 [B], K, names [B], want {row: (score,
    q_st, q_ed)}).

    Planted rows: read codes 0 and window codes 1 everywhere (no match at
    any offset), then read positions [q0, q0 + L) and window positions
    [q0 + k0, q0 + k0 + L) set to one pattern of codes 2 and 3, so that
    the only run is the planted one at offset k0 and its ends are known:
    runs of exactly 8, 9 and 10 codes; runs across a 16-code word, a
    32-code plane word and a RUN-word boundary, and at the read's end;
    rlen cutting a run (rlen % 16 != 0) and rlen <= 9; rel_lo and rel_hi
    cutting a 10-code run's first or last code at every shift of a
    32-code plane word, and rel_hi cutting one inside a 32-offset window
    block; a fully invalid row (rel_lo == rel_hi) and a negative
    rel_lo. Random rows as tests/test_torch_ops.py builds them:
    planted MEMs, a fully valid row, a fully invalid row, a negative
    rel_lo, rel_lo / rel_hi at +-2^20, random rlen."""
    assert W % 256 == 0 and W >= 512 and K % 16 == 0
    NW = W // 16 + K // 16 + 1
    NC = 16 * NW
    pat = np.random.default_rng(K + W).integers(2, 4, 64)
    rows, names, want = [], [], {}

    def plant(name, q0, k0, L, rlen=W, lo=0, hi=NC, expect=None):
        read = np.zeros(W, np.int64)
        win = np.ones(NC, np.int64)
        read[q0 : q0 + L] = pat[:L]
        win[q0 + k0 : q0 + k0 + L] = pat[:L]
        if expect is None:  # every code of the run valid
            n = L - RUN_LEN + 1
            expect = (n, q0 + 8, q0 + L - 1) if n > 0 else (0, W, -1)
        want[len(rows)] = expect
        rows.append((read, win, rlen, lo, hi))
        names.append(name)

    k_mid = K // 2
    plant("run_8", 100, k_mid, 8)
    plant("run_9", 100, k_mid, 9)
    plant("run_10", 100, k_mid, 10)
    plant("cross_word16", 44, 5, 9)            # codes 44-52 cross 48
    plant("cross_plane32", 60, K - 1, 10)      # 60-69 cross 64
    plant("cross_run", 32 * RUN - 4, 31 % K, 9)  # across a run boundary
    plant("cross_run_k0", 32 * RUN - 5, 0, 12)
    plant("read_end", W - 9, K - 1, 9)
    r = 16 * (W // 32) + 7                     # rlen % 16 == 7
    plant("rlen_cuts_run", r - 9, k_mid, 10, rlen=r,
          expect=(1, r - 1, r - 1))
    plant("rlen_9", 0, 3, 9, rlen=9)
    plant("rlen_8", 0, 3, 9, rlen=8, expect=(0, W, -1))
    plant("rlen_0", 0, 3, 9, rlen=0, expect=(0, W, -1))
    plant("rlen_negative", 0, 3, 9, rlen=-5, expect=(0, W, -1))
    plant("fully_invalid", 100, k_mid, 12, lo=200, hi=200,
          expect=(0, W, -1))
    plant("negative_rel_lo", 0, 0, 10, lo=-40)
    for m in range(32):
        # the run's first window code at rel_lo - 1 or its last at rel_hi
        # (rel_lo % 32 and rel_hi % 32 take every value; the cut read
        # position takes every value around the first RUN-word boundary,
        # 256): the valid part is 9 codes, one run end
        q0, k0 = 240 + m, min(64, K - 1)
        p0 = q0 + k0
        plant(f"rel_lo_shift_{m}", q0, k0, 10, lo=p0 + 1,
              expect=(1, q0 + 9, q0 + 9))
        plant(f"rel_hi_shift_{m}", q0, k0, 10, hi=p0 + 9,
              expect=(1, q0 + 8, q0 + 8))
    for k0 in (30, 62, 94):
        # rel_hi cuts the run's last code, in the first run's halo, at an
        # offset past the first of its 32-offset window block at which the
        # run's positions all meet valid window codes
        if k0 < K:
            plant(f"rel_hi_mid_block_{k0}", 250, k0, 10, hi=259 + k0,
                  expect=(1, 258, 258))
    # tests/test_torch_ops.py's rows, at this width
    rng = np.random.default_rng(K)
    nr = 9
    read = rng.integers(0, 4, (nr, W))
    rlen = rng.integers(30, W + 1, nr)
    rlen[2] = W
    winc = rng.integers(0, 4, (nr, NC))
    for b in range(nr):
        for _ in range(6):
            k = int(rng.integers(0, K))
            q = int(rng.integers(0, W - 40))
            ln = int(rng.integers(4, 40))
            winc[b, q + k : q + k + ln] = read[b, q : q + ln]
    winc[2, 5 : 5 + W] = read[2]  # a full-length match on diagonal 5
    vlo = rng.integers(0, 60, nr)
    vhi = rng.integers(NC - 60, NC, nr)
    vlo[0], vhi[0] = 0, NC                 # fully valid
    vlo[1], vhi[1] = 200, 200              # fully invalid
    vlo[2], vhi[2] = -40, NC + 50          # negative virtual start
    vlo[3], vhi[3] = -(1 << 20), 1 << 20
    tags = ["random_fully_valid", "random_fully_invalid",
            "random_negative_rel_lo", "random_wide"] + [
        f"random_{b}" for b in range(4, nr)]
    for b in range(nr):
        rows.append((read[b], winc[b], rlen[b], vlo[b], vhi[b]))
        names.append(tags[b])
    i32 = lambda v: np.array(v, np.int64).astype(np.int32)
    return dict(read_w=_pack(np.stack([x[0] for x in rows])),
                rlen=i32([x[2] for x in rows]),
                win_w=_pack(np.stack([x[1] for x in rows])),
                rel_lo=i32([x[3] for x in rows]),
                rel_hi=i32([x[4] for x in rows]), K=K, names=names,
                want=want)


def band_args(case: dict, device="cpu") -> tuple:
    """band_score_packed's arguments for a case, int32 tensors."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32)).to(device)
    return (t(case["read_w"]), t(case["rlen"]), t(case["win_w"]),
            t(case["rel_lo"]), t(case["rel_hi"]), case["K"])


def check_band_coverage(case: dict, out: dict) -> None:
    """Every planted row scored as built (so each edge was reached), the
    random rows scored some runs, and the fully invalid ones none."""
    score, q_st, q_ed = (np.asarray(out[f]) for f in ("score", "q_st",
                                                       "q_ed"))
    for b, exp in case["want"].items():
        got = (int(score[b]), int(q_st[b]), int(q_ed[b]))
        assert got == exp, (case["names"][b], got, exp)
    names = case["names"]
    rand = [b for b, n in enumerate(names) if n.startswith("random_")]
    assert int(score[rand].max()) > 0
    assert int(score[names.index("random_fully_invalid")]) == 0
    W = 16 * case["read_w"].shape[1]
    assert int(score[names.index("random_negative_rel_lo")]) >= W - 8


# ------------------------------------------------------------- model --
def _unzip(x: np.ndarray) -> np.ndarray:
    """csrc/band_score.cu unzip: even bits to 0-15, odd bits to 16-31."""
    x = x.astype(np.uint32)
    for mask, s in ((0x22222222, 1), (0x0C0C0C0C, 2), (0x00F000F0, 4),
                    (0x0000FF00, 8)):
        t = (x ^ (x >> np.uint32(s))) & np.uint32(mask)
        x = x ^ t ^ (t << np.uint32(s))
    return x


def _planes(words: np.ndarray, n32: int):
    """(low plane, high plane) uint32 [B, n32] of packed 16-code words."""
    B, n = words.shape
    w = np.zeros((B, 2 * n32), np.uint32)
    w[:, : min(n, 2 * n32)] = words[:, : 2 * n32]
    a, c = _unzip(w[:, 0::2]), _unzip(w[:, 1::2])
    return ((a & np.uint32(0xFFFF)) | (c << np.uint32(16)),
            (a >> np.uint32(16)) | (c & np.uint32(0xFFFF0000)))


def _fsh(lo, hi, s: int):
    """__funnelshift_r(lo, hi, s): the low word of (hi:lo) >> s."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(s)) & M32).astype(np.uint32)


def _mask32(n: np.ndarray) -> np.ndarray:
    n = np.clip(n, 0, 32).astype(np.uint64)
    return ((np.uint64(1) << n) - np.uint64(1)).astype(np.uint32)


def band_score_model(read_w, rlen, win_w, rel_lo, rel_hi, K: int):
    """The kernel's formulation in numpy (uint32 words). Returns
    (dict(score, q_st, q_ed) int32 [B], dict(masked=, unmasked=) the
    (row, run, offset) steps of live rows that took each path)."""
    read_w = np.asarray(read_w).view(np.uint32)
    win_w = np.asarray(win_w).view(np.uint32)
    B, Wq = read_w.shape
    W = 16 * Wq
    wq32 = (Wq + 1) // 2
    runs = -(-wq32 // RUN)
    wq32p = runs * RUN
    nws = wq32p + ((K - 1) >> 5) + 2
    rl, rh = _planes(read_w, wq32p + 1)
    wl, wh = _planes(win_w, nws)
    lo = np.asarray(rel_lo, np.int64)[:, None]
    hi = np.asarray(rel_hi, np.int64)[:, None]
    p = 32 * np.arange(nws, dtype=np.int64)[None, :]
    wv = _mask32(hi - p) & ~_mask32(lo - p)
    rl_c = np.clip(np.asarray(rlen, np.int64), 0, W)[:, None]
    rv = _mask32(rl_c - 32 * np.arange(wq32p + 1, dtype=np.int64)[None, :])
    live = (lo[:, 0] < hi[:, 0]) & (rl_c[:, 0] > 0)
    w0 = RUN * np.arange(runs)                                  # [runs]
    # runs wholly past rlen have no work; a run's window block jj (offsets
    # 32 jj .. 32 jj + n_m - 1) runs unmasked when every read position of
    # the run below rlen (halo included) meets a valid window code there
    work = live[:, None] & (32 * w0[None, :] < rl_c)            # [B, runs]
    q_end = np.minimum(32 * (w0[None, :] + RUN + 1), rl_c)
    ka = np.clip(lo - 32 * w0[None, :], 0, K)
    kb = np.clip(hi - q_end, -1, K)
    acc = np.zeros((B, wq32p), np.uint32)
    stats = dict(masked=0, unmasked=0)
    for k in range(K):
        m, base = k & 31, w0 + (k >> 5)
        jj = k >> 5
        n_m = min(32, K - 32 * jj)
        full = (ka <= 32 * jj) & (32 * jj + n_m - 1 <= kb)
        stats["unmasked"] += int((full & work).sum())
        stats["masked"] += int((~full & work).sum())
        e_n = r3_n = None
        for i in range(RUN, -1, -1):
            wi = base + i
            v = rv[:, w0 + i]
            v = np.where(full, v, v & _fsh(wv[:, wi], wv[:, wi + 1], m))
            ah = _fsh(wh[:, wi], wh[:, wi + 1], m)
            al = _fsh(wl[:, wi], wl[:, wi + 1], m)
            x = (rl[:, w0 + i] ^ al) | ~v
            e = ~(rh[:, w0 + i] ^ ah) & ~x
            if i == RUN:  # the halo: its r3 from its own word
                r3 = e & (e >> np.uint32(1)) & (e >> np.uint32(2))
            else:
                r3 = e & _fsh(e, e_n, 1) & _fsh(e, e_n, 2)
                acc[:, w0 + i] |= r3 & _fsh(r3, r3_n, 3) & _fsh(r3, r3_n, 6)
            e_n, r3_n = e, r3
    acc &= np.repeat(np.where(work, 0xFFFFFFFF, 0).astype(np.uint32), RUN,
                     axis=1)
    acc = acc[:, :wq32]
    # run-start bit at q -> run-end bit at q + 8
    prev = np.concatenate([np.zeros((B, 1), np.uint32), acc[:, :-1]], 1)
    e = ((acc.astype(np.uint64) << np.uint64(8)) & M32).astype(
        np.uint32) | (prev >> np.uint32(24))
    bits = np.unpackbits(e.view(np.uint8), axis=1, bitorder="little")
    score = bits.sum(1)
    pos = np.nonzero(bits)
    q_st = np.full(B, W)
    q_ed = np.full(B, -1)
    np.minimum.at(q_st, pos[0], pos[1])
    np.maximum.at(q_ed, pos[0], pos[1])
    i32 = lambda a: np.asarray(a).astype(np.int32)
    return dict(score=i32(score), q_st=i32(q_st), q_ed=i32(q_ed)), stats


# ------------------------------------------------------------- tests --
def _eq(ref, got, what):
    a, b = np.asarray(ref), np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.nonzero(a != b)[0]
    assert bad.size == 0, (what, bad[:5], a[bad[:5]], b[bad[:5]])


@pytest.mark.parametrize("K,W", BANDS)
def test_band_cases_reach_every_case(K, W):
    from desamba_tpu_torch.ops.matchblock import band_score_packed_plain

    case = band_cases(K, W)
    check_band_coverage(case, band_score_packed_plain(*band_args(case)))


@pytest.mark.parametrize("K,W", BANDS)
def test_model_equals_jax_and_plain(K, W):
    """The kernel's formulation equals JAX's band_score_packed and the
    port's plain version (and so the CPU route of the wrapper) on every
    row; both of its paths (masked and unmasked steps) are taken."""
    from desamba_tpu.ops.matchblock import band_score_packed as jbs
    from desamba_tpu_torch.ops.matchblock import (band_score_packed,
                                                  band_score_packed_plain)

    case = band_cases(K, W)
    args = band_args(case)
    ref = jbs(case["read_w"], case["rlen"], case["win_w"], case["rel_lo"],
              case["rel_hi"], K=K)
    got, stats = band_score_model(*args[:5], K)
    plain = band_score_packed_plain(*args)
    wrapped = band_score_packed(*args)
    for f in ("score", "q_st", "q_ed"):
        _eq(ref[f], got[f], f"model {f}")
        _eq(ref[f], plain[f], f"plain {f}")
        _eq(ref[f], wrapped[f], f"wrapper {f}")
    assert stats["masked"] > 0 and stats["unmasked"] > 0, stats


def _and8(e: int, en: int) -> int:
    v = (en << 32) | e
    r = 0xFFFFFFFF
    for i in range(RUN_LEN):
        r &= v >> i
    return r & 0xFFFFFFFF


def _tripling(e: int, en: int) -> int:
    f = lambda lo, hi, s: (((hi << 32) | lo) >> s) & 0xFFFFFFFF
    r3 = e & f(e, en, 1) & f(e, en, 2)
    r3n = en & (en >> 1) & (en >> 2)          # the halo's, own word only
    return r3 & f(r3, r3n, 3) & f(r3, r3n, 6)


def test_run_test_equals_the_8_step_and():
    """A word's 9-run starts (its bits and the next word's) by the
    kernel's tripling equal the 8-step AND on random words; `dense` ORs
    in copies of the words shifted by one, which makes long runs common.
    (hypothesis is imported here, so that the card's smoke, which reuses
    band_cases, does not need it.)"""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=400, deadline=None, database=None)
    @given(e=st.integers(0, 2**32 - 1), en=st.integers(0, 2**32 - 1),
           dense=st.integers(0, 3))
    def check(e, en, dense):
        for _ in range(dense):
            e, en = e | ((e << 1) & 0xFFFFFFFF) | (e >> 1), en | (en >> 1)
        assert _tripling(e, en) == _and8(e, en)

    check()


def test_model_equals_plain_on_odd_shapes():
    """Widths that are not a multiple of 32 codes (an odd word count, a
    partial last run) and every K of a few: the model against the plain
    version on random rows."""
    from desamba_tpu_torch.ops.matchblock import band_score_packed_plain

    rng = np.random.default_rng(5)
    for Wq, K in ((1, 16), (3, 32), (17, 48), (40, 144)):
        B, NW = 6, Wq + K // 16 + 1
        read = rng.integers(0, 4, (B, 16 * Wq))
        win = rng.integers(0, 4, (B, 16 * NW))
        for b in range(B):
            k = int(rng.integers(0, K))
            win[b, k : k + 16 * Wq] = read[b]
        case = dict(read_w=_pack(read),
                    rlen=rng.integers(-3, 16 * Wq + 4, B).astype(np.int32),
                    win_w=_pack(win),
                    rel_lo=rng.integers(-20, 40, B).astype(np.int32),
                    rel_hi=rng.integers(16 * NW - 40, 16 * NW + 20,
                                        B).astype(np.int32), K=K)
        args = band_args(case)
        got, _ = band_score_model(*args[:5], K)
        ref = band_score_packed_plain(*args)
        for f in ("score", "q_st", "q_ed"):
            _eq(ref[f], got[f], f"Wq={Wq} K={K} {f}")
        assert int(ref["score"].max()) > 0
