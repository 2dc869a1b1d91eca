"""Stage 1 of the fast path (K4 + K5, ops/seeds.stage1): a numpy model of
the kernel's formulation (csrc/stage1.cu) held to JAX's stage 1
(_probe_reads, kmer_lo26 and top_seeds on the STEP_EK grid) and to the
port's plain version, on rows that `stage1_cases` builds and
`check_stage1_coverage` asserts reached.

The model is the kernel's arithmetic step for step: a warp a row, lane l
on the contiguous run of grid points [l * per, (l + 1) * per) with per
= lane_run(n_g) (ceil(n_g / 32), or a little more where that would put
the lanes' code reads more than two to a shared-memory bank); the lane's first k-mer and per-base counts (one byte a
base) built in full, then rolled by STEP_EK codes a point (three codes
shifted in, the k-mer masked to 2 * lek bits; three counts added, three
taken off); the filter as a byte test (count + 128 - sbm reaching bit
7); the probe gated on k != 0 and p + lek <= len, bitmap 2 read only
where bitmap 1's bit is set; then a lane a window, in groups of 32
windows: the window's hits as a bit mask, the last miss before it by a
max-scan over the group with the groups' carry, and the longest run end,
earliest on ties, by the encoding runlen * 2w + (w - 1 - j).

This module imports no JAX at its top level, so test_torch_kernels.py
and chip_smoke.py reuse stage1_cases on the card. All values are
integers: the tolerance is exact equality.
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_kernels import _grid_kmers, _hash64_np, _set_bits

STEP = 3      # constants.STEP_EK
WINDOW = 33   # ops/seeds.WINDOW: SEED_RANGE // STEP_EK
LANES = 32
MASK_BITS = 22
# every width bucket constants._bucket makes, each with a lek of 13, 16,
# 20 or 31 (the wrapper takes 13-31; the index ladder uses 16-20); W =
# 2048 and 8192 with all four
WIDTH_LEK = [(256, 13), (512, 31), (1024, 20), (2048, 13), (2048, 16),
             (2048, 20), (2048, 31), (3072, 16), (4096, 20), (5120, 31),
             (6144, 13), (7168, 16), (8192, 13), (8192, 20), (8192, 31)]
BITMAPS = ("all_set", "dense", "sparse")


def n_grid(W: int, lek: int) -> int:
    return (W - lek + 1 - STEP) // STEP + 1


def lane_run(n_g: int) -> int:
    """csrc/stage1.cu run_of / lane_run: the points a lane takes, the
    smallest run >= ceil(n_g / 32) at which lanes 3 * run bytes apart read
    at most two distinct words of one 32-bank shared memory, at each byte
    offset (a lane's word is never below the lane before's, so a word is
    new where it differs from that)."""
    first = -(-n_g // LANES) if n_g > 0 else 0
    for run in range(first, first + 8):
        worst = 0
        for off in range(4):
            per_bank = [0] * 32
            for ln in range(LANES):
                w = (off + STEP * run * ln) // 4
                if ln == 0 or w != (off + STEP * run * (ln - 1)) // 4:
                    per_bank[w % 32] += 1
                    worst = max(worst, per_bank[w % 32])
        if worst <= 2:
            return run
    return first


# ------------------------------------------------------------- cases --
def stage1_cases(W: int, lek: int, bitmap: str) -> dict:
    """Rows for stage 1 at width W and k-mer length lek, on one of three
    synthetic bitmap pairs of MASK_BITS bits (`bitmap`): "all_set" (every
    bit set: runs as long as the filter lets them), "dense" (93% of the
    bits set: runs of every length) or "sparse" (only planted grid
    k-mers set in both bitmaps: hits exactly where planted).

    dict(codes uint8[B, W], lens int32[B], w01 int32 words (bitmap 1,
    then bitmap 2 from word nw0), nw0, lek, sbm, mask_bits, names [B],
    planted {row: [(g0, g1), ...]}). Rows (names):
    - "len_0", "len_short" (lek - 1), "len_lek" (lek: no point has p +
      lek <= len), "len_first" (lek + 2: the first point only), "full"
      (W);
    - "straddle": the read ends mid-window (its last in-read point is the
      17th of window 1);
    - "zero": all codes 0 (the zero k-mer; its filter fails too);
    - "single_base": a run of one base longer than sbm (the filter
      fails on the windows inside it);
    - "cross_window": planted runs across window boundaries, one of
      them longer than a window and one wholly inside a window;
    - "cross_lane": planted runs across the boundaries of the lanes'
      point runs;
    - "ties": two planted runs of equal length in one window (the
      earlier end wins);
    - "random": random codes and lengths.
    The sparse bitmap sets the planted points of "cross_window",
    "cross_lane" and "ties", and every third point of "full"."""
    rng = np.random.default_rng(W * 100 + lek + BITMAPS.index(bitmap))
    n_g = n_grid(W, lek)
    per = lane_run(n_g)
    names = ["len_0", "len_short", "len_lek", "len_first", "full",
             "straddle", "zero", "single_base", "cross_window", "cross_lane",
             "ties"] + ["random"] * 6
    B = len(names)
    codes = rng.integers(0, 4, (B, W)).astype(np.uint8)
    last = min(n_g - 1, WINDOW + 16)  # the 17th point of window 1
    lens = np.array([0, lek - 1, lek, lek + 2, W,
                     STEP - 1 + STEP * last + lek, W, W, W, W, W]
                    + list(rng.integers(0, W + 1, 6)), np.int32)
    # rows whose every window passes the filter: each block of 4 codes a
    # permutation of 0-3 (a base at most ceil(lek / 4) + 1 < sbm times)
    for name in ("full", "straddle", "cross_window", "cross_lane", "ties"):
        codes[names.index(name)] = np.concatenate(
            [rng.permutation(4) for _ in range(W // 4)])
    codes[names.index("zero")] = 0
    sb = names.index("single_base")
    codes[sb, W // 4 : W // 4 + 3 * lek] = 2
    planted = {}

    def plant(name, spans):
        planted[names.index(name)] = [(a, min(b, n_g)) for a, b in spans
                                      if a < n_g]

    b = [WINDOW * i for i in range(1, n_g // WINDOW + 1)]
    plant("cross_window",
          [(x - 4, x + 3) for x in b[::2]]
          + ([(b[0] + 10, b[0] + 10 + WINDOW + 9)] if len(b) > 1 else [])
          + [(2, 7)])
    plant("cross_lane", [(per * ln - 3, per * ln + 2)
                         for ln in range(1, LANES) if per * ln < n_g])
    plant("ties", [(3, 8), (12, 17)])
    if bitmap == "sparse":
        planted[names.index("full")] = [(g, g + 1) for g in range(0, n_g, 3)]
    sbm = int(0.8 * lek)
    nw = 1 << (MASK_BITS - 5)
    if bitmap == "sparse":
        words = np.zeros(2 * nw, np.uint32)
        k = _grid_kmers(codes, lek, STEP)
        pick = np.zeros(k.shape, bool)
        for r, spans in planted.items():
            for a, e in spans:
                pick[r, a:e] = True
        h1, h2 = _hash64_np(k[pick])
        m = np.uint64((1 << MASK_BITS) - 1)
        _set_bits(words[:nw], h1 & m)
        _set_bits(words[nw:], h2 & m)
    else:
        load = 1.0 if bitmap == "all_set" else 0.93
        bits = np.random.default_rng(lek).random((2 * nw, 32)) < load
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                 ).sum(1).astype(np.uint32)
    return dict(codes=codes, lens=lens, w01=words.view(np.int32), nw0=nw,
                lek=lek, sbm=sbm, mask_bits=MASK_BITS, names=names,
                planted=planted, bitmap=bitmap)


def stage1_args(case: dict, device="cpu") -> tuple:
    """stage1's positional arguments for a case, on device."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(case["w01"]), t(case["codes"]), t(case["lens"]), case["lek"],
            case["sbm"], case["mask_bits"], case["nw0"])


def check_stage1_coverage(case: dict, out) -> None:
    """The rows of stage1_cases reach what they are meant to, on stage 1's
    (lo26, kidx, runlen, n_exist) (numpy or torch)."""
    lo26, kidx, runlen, n_exist = (np.asarray(x.cpu() if hasattr(x, "cpu")
                                              else x) for x in out)
    row = {n: i for i, n in enumerate(case["names"]) if n != "random"}
    n_g = lo26.shape[1]
    for n in ("len_0", "len_short", "len_lek", "zero"):
        assert n_exist[row[n]] == 0 and not runlen[row[n]].any(), n
    assert n_exist[row["len_first"]] <= 1
    # a run that started before its window: it crosses a boundary
    start = kidx - runlen + 1
    base = WINDOW * np.arange(kidx.shape[1])[None, :]
    crossing = (runlen > 0) & (start < base)
    if case["bitmap"] == "sparse":
        for name in ("cross_window", "cross_lane", "ties"):
            r = row[name]
            got = np.zeros(n_g, bool)
            for a, e in case["planted"][r]:
                got[a:e] = True
            assert n_exist[r] >= got.sum() > 0, name
        assert crossing[row["cross_window"]].any()
        assert runlen[row["cross_window"]].max() > WINDOW
        # two runs of 5 in window 0: the earlier end (point 7) wins
        assert (kidx[row["ties"], 0], runlen[row["ties"], 0]) == (7, 5)
        assert n_exist[row["full"]] > 0
    else:
        assert crossing[row["full"]].any()
        if case["bitmap"] == "all_set":
            assert runlen[row["full"]].max() > WINDOW
        s = row["straddle"]
        hit = np.nonzero(runlen[s])[0]
        assert n_exist[s] > 0 and hit.max() <= 1
        assert kidx[s, 1] <= WINDOW + 16
        # the single-base run cuts the row's runs: fewer hits than points
        assert 0 < n_exist[row["single_base"]] < n_g
    assert (lo26 >= 0).all() and (lo26 < (1 << 26)).all()


# ------------------------------------------------------------- model --
def stage1_model(w01, codes, lens, lek: int, sbm: int, mask_bits: int,
                 nw0: int):
    """csrc/stage1.cu's formulation in numpy (see the module docstring).
    Returns (lo26, kidx, runlen, n_exist) int32 and the number of
    bitmap-2 reads it made (only where bitmap 1's bit is set)."""
    u = np.uint64
    words = np.asarray(w01).view(np.uint32).astype(np.int64)
    codes = np.asarray(codes)
    B, W = codes.shape
    n_g = n_grid(W, lek)
    n_win = -(-n_g // WINDOW)
    per = lane_run(n_g)
    lane = np.arange(LANES)
    g0 = np.minimum(n_g, lane * per)
    g1 = np.minimum(n_g, g0 + per)
    sbm_c = min(max(sbm, 0), 32)
    bias = (128 - sbm_c) * 0x01010101
    kmask = u((1 << (2 * lek)) - 1)
    hmask = u((1 << mask_bits) - 1)
    lo26 = np.zeros((B, n_g), np.int64)
    hit = np.zeros((B, n_g), bool)
    k = np.zeros((B, LANES), u)
    counts = np.zeros((B, LANES), np.int64)
    c = codes.astype(np.int64)
    p = STEP - 1 + STEP * g0
    live = g0 < g1
    pc = np.minimum(p, W - lek)  # lanes without points read nothing
    for j in range(lek):
        cj = c[:, pc + j]
        k = (k << u(2)) | cj.astype(u)
        counts += np.int64(1) << (8 * cj)
    reads2 = 0
    for t in range(per):
        g = g0 + t
        on = live & (g < g1)
        if t > 0:
            p = p + STEP
            pr = np.where(on, p, lek)  # a lane past its run rolls nothing
            for s in range(STEP):
                cin = c[:, pr + lek - STEP + s]
                cout = c[:, pr - STEP + s]
                k = (k << u(2)) | cin.astype(u)
                counts += (np.int64(1) << (8 * cin)) - (
                    np.int64(1) << (8 * cout))
            k &= kmask
        passes = (sbm_c > 0) & (((counts + bias) & 0x80808080) == 0)
        want = passes & (k != 0) & ((p + lek)[None, :] <= lens[:, None])
        want &= on[None, :]
        h1, h2 = _hash64_np(k)
        a1, a2 = h1 & hmask, h2 & hmask

        def bit(words_off, h):
            wi = (h >> u(5)).astype(np.int64) + words_off
            sh = (((h >> u(3)) & u(3)) * u(8) + u(7) - (h & u(7))).astype(
                np.int64)
            return (words[np.where(want, wi, 0)] >> sh) & 1

        b1 = want & (bit(0, a1) == 1)
        reads2 += int(b1.sum())
        h = b1 & (bit(nw0, a2) == 1)
        gi = np.where(on, g, 0)
        rows, lanes_on = np.nonzero(np.broadcast_to(on, (B, LANES)))
        lo26[rows, gi[lanes_on]] = (k & u(0x3FFFFFF)).astype(np.int64)[
            rows, lanes_on]
        hit[rows, gi[lanes_on]] = h[rows, lanes_on]
    # the windows: a lane each, in groups of 32 with a carry
    kidx = np.zeros((B, n_win), np.int64)
    runlen = np.zeros((B, n_win), np.int64)
    carry = np.full(B, -1, np.int64)
    for wg in range(0, n_win, LANES):
        wi = wg + lane
        base = wi * WINDOW
        end = np.where(wi < n_win, np.minimum(WINDOW, n_g - base), 0)
        m = np.zeros((B, LANES, WINDOW), bool)
        for j in range(WINDOW):
            ok = j < end
            m[:, ok, j] = hit[:, base[ok] + j]
        jj = np.arange(WINDOW)
        miss = ~m & (jj[None, None, :] < end[None, :, None])
        last = np.where(miss.any(2),
                        base[None, :] + WINDOW - 1 - np.argmax(
                            miss[:, :, ::-1], axis=2), -1)
        incl = np.maximum.accumulate(last, axis=1)
        before = np.concatenate([np.full((B, 1), -1), incl[:, :-1]], 1)
        before = np.maximum(before, carry[:, None])
        carry = np.maximum(carry, incl[:, -1])
        best = np.full((B, LANES), -1, np.int64)
        for j in range(WINDOW):
            ok = j < end
            h = m[:, :, j] & ok[None, :]
            enc = (base[None, :] + j - before) * 2 * WINDOW + (WINDOW - 1 - j)
            best = np.where(h, np.maximum(best, enc), best)
            before = np.where(~m[:, :, j] & ok[None, :], base[None, :] + j,
                              before)
        on = wi < n_win
        has = best >= 0
        kidx[:, wi[on]] = np.where(
            has, base[None, :] + WINDOW - 1 - best % (2 * WINDOW), 0)[:, on]
        runlen[:, wi[on]] = np.where(has, best // (2 * WINDOW), 0)[:, on]
    out = tuple(x.astype(np.int32) for x in (lo26, kidx, runlen,
                                             hit.sum(1)))
    return out, reads2


# ------------------------------------------------------------- tests --
@functools.lru_cache
def _jax_stage1_fn(lek: int, sbm: int, mask_bits: int, nw0: int):
    import jax

    from desamba_tpu.engine.fast_engine import _build_stages

    return jax.jit(_build_stages(lek, sbm, mask_bits, 20, nw0)[0])


def _jax_stage1(case):
    import jax.numpy as jnp

    s1 = _jax_stage1_fn(case["lek"], case["sbm"], case["mask_bits"],
                        case["nw0"])
    out = s1(jnp.asarray(case["w01"].view(np.uint32)),
             jnp.asarray(case["codes"]), jnp.asarray(case["lens"]))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("W,lek", WIDTH_LEK)
def test_stage1_model_equals_jax_and_plain(W, lek):
    """The kernel's formulation equals JAX's stage 1 and the port's
    stage1_plain on every case of every bitmap, each case reached."""
    from desamba_tpu_torch.ops.seeds import stage1_plain

    for bitmap in BITMAPS:
        case = stage1_cases(W, lek, bitmap)
        got, reads2 = stage1_model(case["w01"], case["codes"], case["lens"],
                                   lek, case["sbm"], case["mask_bits"],
                                   case["nw0"])
        ref = _jax_stage1(case)
        plain = [x.numpy() for x in stage1_plain(*stage1_args(case))]
        for name, a, b, c in zip(("lo26", "kidx", "runlen", "n_exist"), ref,
                                 got, plain):
            assert a.shape == b.shape == c.shape, (bitmap, name)
            assert (a == b).all(), (bitmap, name, int((a != b).sum()))
            assert (a == c).all(), (bitmap, name)
        check_stage1_coverage(case, got)
        if bitmap == "all_set":
            assert reads2 == got[3].sum()


def test_rolled_kmer_equals_the_full_build():
    """Rolling by STEP codes (mask to 2 * lek bits) gives the full build's
    k-mer at every grid point of random 2-bit rows, at every lek the
    wrapper takes, and each lane's rolled counts the window's counts."""
    rng = np.random.default_rng(5)
    u = np.uint64
    for lek in range(13, 32):
        codes = rng.integers(0, 4, (3, 400)).astype(np.uint8)
        full = _grid_kmers(codes, lek, STEP)
        k = full[:, 0].copy()
        c = codes.astype(np.int64)
        counts = sum(np.int64(1) << (8 * c[:, STEP - 1 + j])
                     for j in range(lek))
        for g in range(1, full.shape[1]):
            p = STEP - 1 + STEP * g
            for s in range(STEP):
                k = (k << u(2)) | c[:, p + lek - STEP + s].astype(u)
                counts += (np.int64(1) << (8 * c[:, p + lek - STEP + s])) - (
                    np.int64(1) << (8 * c[:, p - STEP + s]))
            k &= u((1 << (2 * lek)) - 1)
            assert (k == full[:, g]).all(), (lek, g)
            for base in range(4):
                n = (c[:, p : p + lek] == base).sum(1)
                assert ((counts >> (8 * base)) & 0xFF == n).all()


def test_lane_run_equals_its_definition():
    """lane_run's short loop equals its definition, counted from the set
    of distinct words the 32 lanes read, for every run of points that
    csrc/stage1.cu's table holds (first < 128) and past it."""
    def worst(run: int) -> int:
        n = 0
        for off in range(4):
            words = {(off + STEP * run * ln) // 4 for ln in range(LANES)}
            n = max(n, int(np.bincount([w % 32 for w in words],
                                       minlength=32).max()))
        return n

    for first in range(1, 160):
        want = next((r for r in range(first, first + 8) if worst(r) <= 2),
                    first)
        for n_g in (LANES * first - LANES + 1, LANES * first):
            assert lane_run(n_g) == want, (first, n_g)
    assert lane_run(0) == 0


@pytest.mark.parametrize("sbm", [-1, 0, 1, 7, 13, 31, 32, 40, 200])
def test_filter_byte_test_equals_the_count_compare(sbm):
    """The kernel's filter, (counts + (128 - sbm') * 0x01010101) &
    0x80808080 == 0 with sbm' = sbm clamped to [0, 32] and sbm' = 0
    failing, equals "every base count < sbm" for every count vector of a
    k-mer of up to 31 codes."""
    rng = np.random.default_rng(sbm + 2)
    cnt = rng.integers(0, 32, (20000, 4))
    cnt[:4] = np.eye(4, dtype=np.int64) * 31
    cnt[4] = 0
    packed = (cnt << (8 * np.arange(4))).sum(1)
    sbm_c = min(max(sbm, 0), 32)
    got = (sbm_c > 0) & (((packed + (128 - sbm_c) * 0x01010101)
                          & 0x80808080) == 0)
    assert (got == (cnt < sbm).all(1)).all()
