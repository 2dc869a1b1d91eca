"""Stage 4's window gather (K9a, band_windows in csrc/rescore.cu) in its
formulation: a numpy model of the kernel's index map. A warp takes a
read row b and its C candidates f = b*C + c (ROWS rows a block); lanes
c < C load candidate c's ref, diagonal and the row's length, then every
lane loads its pieces of the read row (VR words each, lane i pieces
i + 32k, ROW_REGS at a time), and lanes c < C load the bounds' offset and
length of the clamped ref; the row is stored C times; the C windows are
one span of C*nw words at win_w[f0*nw:], cut in pieces of VW words,
lane i pieces i + 32k, WIN_BATCH pieces' loads (clamped to
ref_words_lsb) before their stores, the window start of candidate c
taken from lane c; last, lanes c < C store rlen, rel_lo and rel_hi. Two
variants: VR = 4, VW = 2 where W/16 is a multiple of 4, nw is even and
the pointers align (every width of the path), else VR = VW = 1. The
model counts the writes to every output element.

Held to band_windows_plain (odd rows too) and to the window gather of
JAX's stage 4 (its arguments to band_score_packed, captured), element
for element, with every element written exactly once and every store
aligned to its width and inside its candidate's row: at one read row
(Bp = 1) and odd row counts, W = 16, 32, 48, 64, 256, 2048, 3072, 8192
(both variants), C = 1 to 4, windows clamped at both ends
of ref_words_lsb, diagonals whose band start wraps past the int32 ends,
ref_c = -1 and past n_ref, and bounds whose end wraps.

The module imports no JAX at top level: the card's tests below reuse
the cases. On the card:

    python -m pytest tests/test_torch_rescore_model.py -m cuda -q

Change the kernel and the model together.
"""
import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels
from desamba_tpu_torch.ops.refwin import RefArrays
from desamba_tpu_torch.ops.rescore import (BAND_WINDOWS_MAX_C, band_windows,
                                           band_windows_plain)

ROWS = 8  # read rows (warps) a block (rescore.cu kRows)
ROW_REGS = 4  # row pieces a lane holds at once (kRowRegs)
WIN_BATCH = 8  # window pieces a lane loads before storing (kWinBatch)
I32_MIN, I32_MAX = -2**31, 2**31 - 1

# (B2, W, C, K): one read row's two strands, odd row counts, one word a
# row (W = 16), W/16 = 2 and ragged W/16 = 3 (VR = VW = 1), W = 64 and
# 256 (nw = 12, 22: VR = 4, VW = 2; odd nw = 23: VR = VW = 1), the path's
# widths and bands (nw = 138, 206, 530: VR = 4, VW = 2) and C = 1 to 4
CASES = [(2, 16, 3, 80), (7, 32, 2, 80), (13, 48, 4, 80), (9, 64, 1, 112),
         (6, 256, 3, 96), (31, 256, 2, 80), (4, 2048, 3, 144),
         (11, 3072, 3, 208), (3, 8192, 4, 272), (2, 8192, 1, 272),
         (40, 2048, 3, 144)]


def wrap32(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31)


def variant(Wq: int, nw: int, aligned) -> tuple[int, int]:
    """(VR, VW) of dsb_band_windows: (4, 2) where 4 divides Wq, 2
    divides nw and the pointers align, else (1, 1); aligned: whether
    read_w2, rw_f and win_w are 16-byte aligned."""
    return (4, 2) if Wq % 4 == 0 and nw % 2 == 0 and all(aligned) else (1, 1)


def synthetic_refs(total_w: int, n_ref: int, seed: int) -> RefArrays:
    """ref_words_lsb of total_w random words; n_ref refs, the last one
    with an offset near int32's end, so that offset + length wraps."""
    rng = np.random.default_rng(seed)
    words = rng.integers(I32_MIN, I32_MAX, total_w, endpoint=True)
    off = np.sort(rng.integers(0, 16 * total_w, n_ref))
    ln = rng.integers(1, 16 * total_w, n_ref)
    off[-1], ln[-1] = I32_MAX - 40, 1000
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return RefArrays(t(words), t(off), t(ln))


def window_cases(B2: int, W: int, C: int, K: int, seed: int):
    """(ra, read_w2, lengths2, ref_c, diag_c) on synthetic_refs: diagonals
    inside the reference, before its start and past its end (windows
    clamped at both ends), at the int32 ends and within the band of them
    (the band start wraps), any int32; refs -1, 0, n_ref - 1, past n_ref."""
    rng = np.random.default_rng(seed)
    total_w, n_ref = 60 + W // 16, 5
    ra = synthetic_refs(total_w, n_ref, seed)
    band = (K - 16) // 2
    n = 16 * total_w
    pick = [rng.integers(0, n, B2 * C), rng.integers(-3 * W, 0, B2 * C),
            rng.integers(n - W, n + 3 * W, B2 * C),
            rng.choice([I32_MIN, I32_MIN + band - 1, I32_MAX,
                        I32_MAX - band + 1, I32_MIN + 7], B2 * C),
            rng.integers(I32_MIN, I32_MAX, B2 * C, endpoint=True)]
    diag = np.choose(rng.integers(0, len(pick), B2 * C), pick)
    # each kind once: before the start, past the end, a band start that
    # wraps below int32, int32's top, inside
    first = [-W, n + W, I32_MIN + band - 1, I32_MAX, n // 2]
    diag[: min(len(diag), len(first))] = first[: len(diag)]
    ref = rng.integers(-1, n_ref + 2, B2 * C)
    ref[: min(len(ref), 3)] = [-1, n_ref - 1, n_ref + 1][: len(ref)]
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return (ra, t(rng.integers(I32_MIN, I32_MAX, (B2, W // 16),
                               endpoint=True)),
            t(rng.integers(0, W + 1, B2)), t(ref.reshape(B2, C)),
            t(diag.reshape(B2, C)))


def band_windows_model(ra: RefArrays, read_w2, lengths2, ref_c, diag_c,
                       K: int, aligned=(True, True, True),
                       stats: dict | None = None):
    """csrc/rescore.cu's band_windows_kernel on numpy copies of the
    wrapper's inputs: band_windows_plain's (read_w int32[B2*C, W/16], rlen,
    win_w int32[B2*C, nw], rel_lo, rel_hi), by the kernel's index map.
    aligned: whether read_w2, rw_f and win_w are 16-byte aligned. Asserts
    that every output element is written exactly once, every vector store
    aligned to its width and inside its candidate's row. stats: the
    widths taken ("VR", "VW"), the row chunks past the first ("chunks"),
    the window batches past the first ("batches"), the window words
    clamped to the first and to the last word ("clamped_low",
    "clamped_high") and the wrapped band starts ("wrapped")."""
    words = ra.ref_words_lsb.numpy().astype(np.int64)
    off = ra.ref_offset.numpy().astype(np.int64)
    lens = ra.ref_len.numpy().astype(np.int64)
    rw2 = read_w2.numpy()
    l2 = lengths2.numpy()
    rc_all = ref_c.numpy().reshape(-1).astype(np.int64)
    dg_all = diag_c.numpy().reshape(-1).astype(np.int64)
    B2, C = ref_c.shape
    assert 1 <= C <= BAND_WINDOWS_MAX_C
    Wq = rw2.shape[1]
    nw = Wq + K // 16 + 1
    band = (K - 16) // 2
    total_w, n_ref = words.size, off.size
    n = B2 * C
    rw_f = np.zeros(n * Wq, np.int64)
    win_w = np.zeros(n * nw, np.int64)
    rl_f, rel_lo, rel_hi = (np.zeros(n, np.int64) for _ in range(3))
    hits = {k: np.zeros(v.size, np.int64)
            for k, v in (("read_w", rw_f), ("win_w", win_w), ("rlen", rl_f),
                         ("rel_lo", rel_lo), ("rel_hi", rel_hi))}
    VR, VW = variant(Wq, nw, aligned)
    st = stats if stats is not None else {}
    st.update(VR=VR, VW=VW)
    for k in ("chunks", "batches", "clamped_low", "clamped_high",
              "wrapped"):
        st.setdefault(k, 0)
    lanes = np.arange(32)
    n_pieces = Wq // VR
    span = C * nw // VW
    for blk in range(-(-B2 // ROWS)):
        for warp in range(ROWS):
            b = blk * ROWS + warp
            if b >= B2:
                break
            f0 = b * C
            cand = lanes < C
            r = np.where(cand, rc_all[f0 + np.minimum(lanes, C - 1)], -1)
            d = np.where(cand, dg_all[f0 + np.minimum(lanes, C - 1)], 0)
            # (diag - band) & ~15 in uint32, as int32; then >> 4
            g0a = wrap32((d - band) & 0xFFFFFFF0)
            st["wrapped"] += int((cand & (d - band < I32_MIN)).sum())
            w0 = g0a >> 4
            rcl = np.clip(r, 0, n_ref - 1)
            lo, ln = off[rcl], lens[rcl]
            # the row, C times, ROW_REGS pieces a lane at a time
            row = rw2[b]
            for p0 in range(0, n_pieces, 32 * ROW_REGS):
                st["chunks"] += p0 > 0
                p = (p0 + lanes[:, None] + 32 * np.arange(ROW_REGS)).reshape(
                    -1)
                p = p[p < n_pieces]
                src = (p[:, None] * VR + np.arange(VR)).reshape(-1)
                for c in range(C):
                    dst = (f0 + c) * Wq + p * VR
                    assert (dst % VR == 0).all()
                    idx = (dst[:, None] + np.arange(VR)).reshape(-1)
                    rw_f[idx] = row[src]
                    np.add.at(hits["read_w"], idx, 1)
            # the C windows as one span of pieces of VW words
            for p0 in range(0, span, 32 * WIN_BATCH):
                st["batches"] += p0 > 0
                loads = []
                for k in range(WIN_BATCH):
                    p = p0 + lanes + 32 * k
                    q = p * VW
                    c = np.where(p < span, q // nw, 0)
                    start = w0[c] + (q - c * nw)  # lane c's start, shuffled
                    wi = start[:, None] + np.arange(VW)
                    st["clamped_low"] += int((wi < 0)[p < span].sum())
                    st["clamped_high"] += int((wi >= total_w)[p < span].sum())
                    loads.append((p, q, c, words[np.clip(wi, 0,
                                                         total_w - 1)]))
                for p, q, c, y in loads:
                    on = p < span
                    dst = f0 * nw + q[on]
                    assert (dst % VW == 0).all()
                    assert ((q[on] - c[on] * nw) + VW <= nw).all()
                    idx = (dst[:, None] + np.arange(VW)).reshape(-1)
                    win_w[idx] = y[on].reshape(-1)
                    np.add.at(hits["win_w"], idx, 1)
            f = f0 + lanes[cand]
            rl_f[f] = l2[b]
            ok = r[cand] >= 0
            rel_lo[f] = np.where(ok, wrap32(lo[cand] - g0a[cand]), 0)
            rel_hi[f] = np.where(ok, wrap32(wrap32(lo[cand] + ln[cand])
                                            - g0a[cand]), 0)
            for name in ("rlen", "rel_lo", "rel_hi"):
                np.add.at(hits[name], f, 1)
    for name, h in hits.items():
        assert (h == 1).all(), (name, int((h == 0).sum()),
                                int((h > 1).sum()))
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return (i32(rw_f.reshape(n, Wq)), i32(rl_f), i32(win_w.reshape(n, nw)),
            i32(rel_lo), i32(rel_hi))


def _jax_windows(ra, read_w2, lengths2, ref_c, diag_c, K, monkeypatch):
    """The arguments that JAX's stage 4 hands band_score_packed (its
    window gather), captured with the scorer replaced by zeros."""
    import jax.numpy as jnp

    import desamba_tpu.ops.matchblock as jmb
    from desamba_tpu.engine.fast_engine import _build_stages
    from desamba_tpu.ops.refwin import RefArrays as JaxRefArrays

    seen = []

    def capture(read_w, rlen, win_w, rel_lo, rel_hi, K):
        seen.append((read_w, rlen, win_w, rel_lo, rel_hi))
        z = jnp.zeros(rlen.shape, jnp.int32)
        return dict(score=z, q_st=z, q_ed=z)

    monkeypatch.setattr(jmb, "band_score_packed", capture)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jra = JaxRefArrays(_from=((None, None, j(ra.ref_words_lsb),
                               j(ra.ref_offset), j(ra.ref_len)), ()))
    B2 = ref_c.shape[0]
    _build_stages(16, 12, 20, 20)[3](
        jra, jnp.asarray(read_w2.numpy().view(np.uint32)), j(lengths2),
        j(ref_c), j(diag_c), None, B2=B2, K=K)
    (out,) = seen
    return [np.asarray(a).view(np.int32) if np.asarray(a).dtype == np.uint32
            else np.asarray(a) for a in out]


@pytest.mark.parametrize("B2,W,C,K", CASES)
def test_band_windows_model_equals_plain_and_jax(B2, W, C, K, monkeypatch):
    """The model == band_windows_plain, and == JAX's window gather where
    B2 is even (JAX's stage 4 folds the rows into reads); every element
    written once."""
    args = window_cases(B2, W, C, K, seed=B2 * W + C)
    stats: dict = {}
    got = band_windows_model(*args, K, stats=stats)
    plain = band_windows_plain(*args, K)
    for i, (g, p) in enumerate(zip(got, plain, strict=True)):
        assert g.shape == tuple(p.shape) and (g == p.numpy()).all(), i
    if B2 % 2 == 0:
        ref = _jax_windows(*args, K, monkeypatch)
        for i, (g, r) in enumerate(zip(got, ref, strict=True)):
            assert g.shape == r.shape and (g == r).all(), i
    ra, _, _, ref_c, _ = args
    assert (ref_c == -1).any()


def test_band_windows_model_widths_and_strides():
    """CASES reach both variants, windows of more than one batch,
    windows clamped at both ends, band starts that wrap and refs past
    n_ref; misaligned pointers take VR = VW = 1 and give the same
    outputs; a row of more than one chunk of pieces."""
    seen = set()
    total: dict = {}
    for B2, W, C, K in CASES:
        st: dict = {}
        args = window_cases(B2, W, C, K, seed=B2 * W + C)
        band_windows_model(*args, K, stats=st)
        seen.add((st["VR"], st["VW"]))
        for k in ("batches", "clamped_low", "clamped_high", "wrapped"):
            total[k] = total.get(k, 0) + st[k]
        total["past"] = total.get("past", 0) + int(
            (args[3] >= args[0].ref_offset.numel()).sum())
    assert seen == {(4, 2), (1, 1)}
    assert all(v > 0 for v in total.values()), total
    args = window_cases(5, 64, 3, 112, seed=3)
    st = {}
    got = band_windows_model(*args, 112, aligned=(False, True, False),
                             stats=st)
    assert (st["VR"], st["VW"]) == (1, 1)
    for g, p in zip(got, band_windows_plain(*args, 112), strict=True):
        assert (g == p.numpy()).all()
    # a row of more than 32 * ROW_REGS pieces: W = 8192 at VR = 1
    st = {}
    args = window_cases(2, 8192, 2, 272, seed=4)
    band_windows_model(*args, 272, aligned=(False, False, True), stats=st)
    assert st["VR"] == 1 and st["chunks"] > 0


def test_band_windows_refuses_more_candidates_than_lanes():
    """Past BAND_WINDOWS_MAX_C candidates a row the wrapper raises, on
    the CPU route as on the card's."""
    ra, rw, l2, ref_c, diag_c = window_cases(2, 256, 3, 80, seed=5)
    C = BAND_WINDOWS_MAX_C + 1
    wide = lambda t: t[:, :1].repeat(1, C).contiguous()  # noqa: E731
    band_windows(ra, rw, l2, wide(ref_c)[:, :-1].contiguous(),
                 wide(diag_c)[:, :-1].contiguous(), 80)
    with pytest.raises(ValueError):
        band_windows(ra, rw, l2, wide(ref_c), wide(diag_c), 80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _offset(t, words: int):
    """t's copy that starts `words` int32 into a buffer of its device."""
    buf = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)
    return buf[words:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("B2,W,C,K", CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_band_windows_kernel_model_cases(cuda, B2, W, C, K, aligned):
    """The kernel == band_windows_plain on CASES, one launch a call; not
    aligned: read_w2 starts one word into its buffer (VR = 1)."""
    ra, *rest = window_cases(B2, W, C, K, seed=B2 * W + C)
    ra = RefArrays(*(t.to(cuda) for t in (ra.ref_words_lsb, ra.ref_offset,
                                          ra.ref_len)))
    rw, l2, ref_c, diag_c = (t.to(cuda) for t in rest)
    if not aligned:
        rw = _offset(rw, 1)
        assert rw.data_ptr() % 8 == 4
    before = kernels.launches["band_windows"]
    got = band_windows(ra, rw, l2, ref_c, diag_c, K)
    ref = band_windows_plain(ra, rw, l2, ref_c, diag_c, K)
    torch.cuda.synchronize()
    assert kernels.launches["band_windows"] == before + 1
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r)
