"""The torch port's ops against the JAX package's, on the CPU: the same
inputs (made with numpy from a seed, or the golden index and reads) go
through both; the port runs its plain versions. Everything is integer,
so every comparison is exact equality.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _eq(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a.astype(np.int64) == b.astype(np.int64)).all(), (
        what, int((a != b).sum()))


@pytest.fixture(scope="module")
def ti(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index

    return from_oracle_index(golden_oracle_index)


@pytest.fixture(scope="module")
def jtab(ti):
    from desamba_tpu.ops.ekmer import EkArrays
    from desamba_tpu.ops.fm import FmArrays
    from desamba_tpu.ops.locate import LocArrays
    from desamba_tpu.ops.refwin import RefArrays

    return FmArrays(ti), EkArrays(ti, fold_bits="auto"), LocArrays(ti), \
        RefArrays(ti)


@pytest.fixture(scope="module")
def ttab(ti):
    from desamba_tpu_torch.convert import build_tables

    return build_tables(ti, "cpu")


def _golden_codes(W, n=None):
    """(codes2 uint8[2B, W], lengths2 int32[2B]) for golden reads that
    fit width W (forward rows, then reverse-complement rows)."""
    from desamba_tpu.io.fastx import read_fastx

    code = np.full(256, 1, np.uint8)
    for j, b in enumerate(b"ACGT"):
        code[b] = j
    reads = [r.seq for r in read_fastx(os.path.join(GOLD, "reads.fq"))
             if len(r.seq) <= W][:n]
    B = len(reads)
    codes = np.zeros((2 * B, W), np.uint8)
    lens = np.zeros(2 * B, np.int32)
    for i, s in enumerate(reads):
        c = code[np.frombuffer(s, np.uint8)]
        codes[i, : len(c)] = c
        codes[B + i, : len(c)] = (3 - c)[::-1]
        lens[i] = lens[B + i] = len(c)
    return codes, lens


# ------------------------------------------------------------- hashes --
@pytest.mark.parametrize("name", ["hash64_1", "hash64_2"])
@pytest.mark.parametrize("bits", [20, 40, 64])
def test_hash64(name, bits):
    from desamba_tpu.ops import u64emu as ju
    from desamba_tpu_torch.ops import u64emu as tu

    rng = np.random.default_rng(bits)
    key = rng.integers(0, 1 << min(bits, 63), 4096, dtype=np.uint64)
    if bits == 64:
        key |= np.uint64(1) << np.uint64(63)
    key[:4] = [0, 1, (1 << 32) - 1, 1 << 32]
    hi = (key >> np.uint64(32)).astype(np.uint32)
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    jh = getattr(ju, name)((jnp.asarray(hi), jnp.asarray(lo)))
    th = getattr(tu, name)((torch.from_numpy(hi.astype(np.int64)),
                            torch.from_numpy(lo.astype(np.int64))))
    _eq(jh[0], th[0], "hi")
    _eq(jh[1], th[1], "lo")
    for mb in (27, 33):
        jm = ju.and_mask_bits(jh, mb)
        tm = tu.and_mask_bits(th, mb)
        _eq(jm[0], tm[0])
        _eq(jm[1], tm[1])


# ------------------------------------------------------------ stage 1 --
@pytest.mark.parametrize("W", [256, 2048])
def test_probe_reads_and_kmer_lo26(W, jtab, ttab):
    from desamba_tpu.ops.ekmer import _probe_reads as jprobe
    from desamba_tpu.ops.ekmer import kmer_lo26 as jlo26
    from desamba_tpu_torch.ops.ekmer import _probe_reads, kmer_lo26

    codes, lens = _golden_codes(W)
    jek, tek = jtab[1], ttab[1]
    for stride in (1, 3):
        ref = jprobe(jek.w01, jnp.asarray(codes), jnp.asarray(lens),
                     jek.lek, jek.single_base_max, jek.mask_bits,
                     stride=stride, n_words0=jek.n_words0)
        got = _probe_reads(tek.w01, torch.from_numpy(codes),
                           torch.from_numpy(lens), tek.lek,
                           tek.single_base_max, tek.mask_bits,
                           stride=stride, n_words0=tek.n_words0)
        _eq(ref, got, f"probe stride {stride}")
        assert int(got.sum()) > 0
        _eq(jlo26(jnp.asarray(codes), jek.lek, stride=stride),
            kmer_lo26(torch.from_numpy(codes), tek.lek, stride=stride),
            f"lo26 stride {stride}")


@pytest.mark.parametrize("case", ["runs", "ties", "random"])
def test_run_lengths_and_top_seeds(case):
    from desamba_tpu.ops import seeds as js
    from desamba_tpu_torch.ops import seeds as ts

    if case == "runs":
        ex, window = np.array([[0, 1, 1, 1, 0, 1, 0, 0, 1, 1]], np.uint8), 5
    elif case == "ties":
        ex, window = np.array([[1, 0, 1, 0, 1, 0]], np.uint8), 6
    else:
        rng = np.random.default_rng(1)
        ex = (rng.random((9, 341)) < 0.6).astype(np.uint8)
        window = 11
    _eq(js.run_lengths(ex), ts.run_lengths(torch.from_numpy(ex)))
    jk, jr = js.top_seeds(ex, window=window)
    tk, tr = ts.top_seeds(torch.from_numpy(ex), window=window)
    _eq(jk, tk, "kidx")
    _eq(jr, tr, "runlen")
    if case == "ties":
        assert tk.tolist() == [[0]] and tr.tolist() == [[1]]


@pytest.fixture(scope="module")
def host_ek(golden_index_dir):
    from desamba_tpu_torch.convert import build_tables
    from desamba_tpu_torch.index.loader import load_index

    return build_tables(load_index(golden_index_dir), "cpu")[1]


def _edge_rows(codes, lens, lek):
    """The golden rows plus rows of length 0, lek + 1, lek + 2 and odd
    lengths, cut from the first golden rows (codes past a length stay, as
    padding does)."""
    extra = [0, lek + 1, lek + 2, lek + 3, 2 * lek + 1, 101, 999]
    n = len(extra)
    W = codes.shape[1]
    c2 = np.concatenate([codes, codes[:n]])
    l2 = np.concatenate([lens, np.minimum(extra, W).astype(np.int32)])
    l2[: len(lens)] |= 1  # every golden row odd too (<= its true length)
    l2[: len(lens)] = np.minimum(l2[: len(lens)], lens)
    return c2, l2


@pytest.mark.parametrize("W", [256, 512, 1024, 2048, 3072])
def test_stage1_plain_equals_jax_stage1(W, jtab, host_ek):
    """stage1_plain (the kernel's oracle and CPU route) equals the JAX
    fast path's stage 1 at each width bucket, edge rows included."""
    import jax

    from desamba_tpu.engine.fast_engine import _build_stages
    from desamba_tpu_torch.ops.seeds import stage1, stage1_plain

    jek = jtab[1]
    codes, lens = _edge_rows(*_golden_codes(W), jek.lek)
    js1 = jax.jit(_build_stages(jek.lek, jek.single_base_max, jek.mask_bits,
                                20, jek.n_words0)[0])
    ref = js1(jek.w01, jnp.asarray(codes), jnp.asarray(lens))
    args = (host_ek.w01, torch.from_numpy(codes), torch.from_numpy(lens),
            host_ek.lek, host_ek.single_base_max, host_ek.mask_bits,
            host_ek.n_words0)
    got = stage1_plain(*args)
    for name, a, b in zip(("lo26", "kidx", "runlen", "n_exist"), ref, got):
        assert b.dtype == torch.int32
        _eq(a, b, name)
    assert int(got[2].max()) > 1 and int(got[3][-7]) == 0
    for a, b in zip(got, stage1(*args)):  # the CPU route of the wrapper
        assert torch.equal(a, b)


# ------------------------------------------------------------ stage 2 --
@pytest.fixture(scope="module")
def seeds(jtab, ttab):
    """Real search lanes: every probe-grid position of golden reads at
    W=1024 with its hash13 head start, as stage 2 sets them up."""
    from desamba_tpu_torch.ops.ekmer import kmer_lo26

    codes, lens = _golden_codes(1024, n=24)
    lek = ttab[1].lek
    lo26 = kmer_lo26(torch.from_numpy(codes), lek, stride=3).numpy()
    B2, n_g = lo26.shape
    lane = np.repeat(np.arange(B2, dtype=np.int32), n_g)
    g = np.tile(np.arange(n_g, dtype=np.int32), B2)
    s_idx = (2 + 3 * g + lek - 1).astype(np.int32)
    ok = s_idx < lens[lane]
    hash13 = ttab[0].hash13.numpy()
    pre = lo26.reshape(-1)
    sp0 = np.where(ok, hash13[pre], 0).astype(np.int32)
    ep0 = np.where(ok, hash13[pre + 1], 0).astype(np.int32)
    n = lane.size
    # every third lane gets a short depth cap, so some lanes stop on it
    # (status 1) rather than on a narrowed interval
    short = np.arange(n) % 3 == 0
    return dict(codes=codes.astype(np.int32), lane=lane, s_idx=s_idx,
                sp0=sp0, ep0=ep0, max_rst=np.full(n, 2, np.int32),
                l_min=np.where(short, 14, 20).astype(np.int32),
                l_max=np.minimum(s_idx, np.where(short, 16, 41)).astype(
                    np.int32))


def _iv_args(sd, jax_side):
    f = jnp.asarray if jax_side else torch.from_numpy
    return [f(sd[k]) for k in ("codes", "s_idx", "sp0", "ep0", "max_rst",
                               "l_min", "l_max")]


IV_KEYS = ("sp", "ep", "nsp", "nep", "match_len", "ptr", "done", "status")
RW_KEYS = ("sp", "ptr", "n", "done", "bad")


def _tis(fm, codes, s_idx, sp0, ep0, max_rst, l_min, l_max, lanes, st,
         steps):
    """The port's interval search from a fresh [8, n] carry (st None) or a
    resumed one; returns the new carry."""
    from desamba_tpu_torch.ops.fm import interval_search_state, iv_init

    if st is None:
        st = iv_init(sp0, ep0, s_idx)
    return interval_search_state(fm, codes, lanes, max_rst, l_min, l_max,
                                 st, steps)


def _trw(fm, codes, rows, ptrs, mlen, lanes, st, cap):
    """The port's row walks from a fresh [5, n] carry (st None) or a
    resumed one; returns the new carry."""
    from desamba_tpu_torch.ops.fm import row_walks_state, rw_init

    if st is None:
        st = rw_init(rows, ptrs)
    return row_walks_state(fm, codes, lanes, mlen, st, cap)


@pytest.mark.parametrize("schedule", [(4096,), (2, 8, 4096), (1, 1, 3, 60)])
def test_interval_search(seeds, jtab, ttab, schedule):
    """One-shot, and resumed through a burst schedule: every carry field
    equal after every call."""
    from desamba_tpu.ops.fm import interval_search as jis

    jc, js_, jsp, jep, jmr, jlmin, jlmax = _iv_args(seeds, True)
    targs = _iv_args(seeds, False)
    jl, tl = jnp.asarray(seeds["lane"]), torch.from_numpy(seeds["lane"])
    jst = tst = None
    for steps in schedule:
        jst = jis(jtab[0], jc, 0, js_, jsp, jep, jmr, jlmin, jlmax,
                  max_steps=steps, lanes=jl, state=jst, return_state=True)
        tst = _tis(ttab[0], *targs, tl, tst, steps)
        for i, k in enumerate(IV_KEYS):
            _eq(jst[k], tst[i], f"{k} after {steps}")
    # the JAX function's result view (sp, ep = nsp, nep) of a one-shot run
    jres = jis(jtab[0], jc, 0, js_, jsp, jep, jmr, jlmin, jlmax, lanes=jl)
    tres = _tis(ttab[0], *targs, tl, None, 4096)
    for k, i in (("sp", 2), ("ep", 3), ("match_len", 4), ("ptr", 5),
                 ("status", 7)):
        _eq(jres[k], tres[i], k)
    assert (tres[2] < tres[3]).sum() > 0
    assert int(tres[7].sum()) > 0


@pytest.mark.parametrize("schedule", [(60,), (12, 16, 32), (1, 2, 5)])
def test_row_walks(seeds, jtab, ttab, schedule):
    """Walks from the rows of real intervals; one-shot and resumed."""
    from desamba_tpu.ops.fm import row_walks as jrw

    tl = torch.from_numpy(seeds["lane"])
    res = _tis(ttab[0], *_iv_args(seeds, False), tl, None, 4096).numpy()
    ok = res[2] < res[3]
    rows = np.concatenate([res[2], res[2] + 1])
    lanes = np.tile(seeds["lane"], 2)
    ptrs = np.tile(res[5], 2)
    mlen = np.tile(np.maximum(seeds["s_idx"] - res[4], 0), 2)
    mlen = np.where(np.tile(ok, 2), mlen, 0).astype(np.int32)
    # add lanes whose start row or ptr is out of range
    rows[:5] = [-3, 0, int(ttab[0].lfc.shape[0]) + 7, 1, 2]
    ptrs[5:8] = [-1, 5000, 1023]
    mlen[:8] = 9
    args = [rows.astype(np.int32), ptrs.astype(np.int32), mlen]
    jcodes = jnp.asarray(seeds["codes"])
    tcodes = torch.from_numpy(seeds["codes"])
    targs = [torch.from_numpy(a) for a in args]
    tlanes = torch.from_numpy(lanes)
    jst = tst = None
    for cap in schedule:
        jst = jrw(jtab[0], jcodes, *[jnp.asarray(a) for a in args],
                  trace_cap=cap, lanes=jnp.asarray(lanes), with_trace=False,
                  state=jst, return_state=True)
        tst = _trw(ttab[0], tcodes, *targs, tlanes, tst, cap)
        for i, k in enumerate(RW_KEYS):
            _eq(jst[i], tst[i], f"{k} after {cap}")
    assert int(tst[2].max()) >= 5
    # the JAX function's result view of a one-shot walk
    jd = jrw(jtab[0], jcodes, *[jnp.asarray(a) for a in args], trace_cap=32,
             lanes=jnp.asarray(lanes), with_trace=False)
    sp, ptr, cnt, done, bad = _trw(ttab[0], tcodes, *targs, tlanes, None,
                                   32).unbind(0)
    td = dict(steps=cnt, final_sp=sp, final_ptr=ptr, bad_char=bad,
              overflow=done == 0, stop_max=cnt >= targs[2])
    for k, v in td.items():
        _eq(jd[k], v, k)


# ------------------------------------------------------------ stage 3 --
def test_resolve_rows(golden_oracle_index, jtab, ttab):
    from desamba_tpu.ops.locate import resolve_rows as jrr
    from desamba_tpu_torch.ops.locate import resolve_rows

    oi = golden_oracle_index
    rng = np.random.default_rng(3)
    rows = rng.integers(0, oi.L + 40, 512).astype(np.int32)
    valid = rng.random(512) < 0.9
    ref = jrr(jtab[0], jtab[2], rows, valid)
    got = resolve_rows(ttab[0], ttab[2], torch.from_numpy(rows),
                       torch.from_numpy(valid))
    for k in ("pos", "uni", "u_off", "ok"):
        _eq(ref[k], got[k], k)
    assert int(got["ok"].sum()) > 200


def test_expand_refpos(golden_oracle_index, jtab, ttab):
    from desamba_tpu.ops.locate import expand_refpos as jex
    from desamba_tpu_torch.ops.locate import expand_refpos

    n_uni = int(ttab[2].uni_len.shape[0])
    rng = np.random.default_rng(4)
    uni = rng.integers(0, n_uni, 300).astype(np.int32)
    u_off = rng.integers(0, 50, 300).astype(np.int32)
    ok = rng.random(300) < 0.8
    for P in (1, 4):
        ref = jex(jtab[2], uni, u_off, ok, P=P)
        got = expand_refpos(ttab[2], torch.from_numpy(uni),
                            torch.from_numpy(u_off), torch.from_numpy(ok),
                            P=P)
        for i in range(3):
            _eq(ref[i], got[i], f"P={P} [{i}]")


@pytest.mark.parametrize("P", [1, 4])
def test_locate_plain_equals_jax(jtab, ttab, P):
    """locate_plain == JAX resolve_rows then expand_refpos, element for
    element, on the locate cases (test_torch_kernels.locate_cases):
    invalid lanes at sampled rows, rows at 0, L - 1, past L and negative,
    chains that meet '#'/'$', chains of exactly 24 and 25 steps, sa_uni
    entries that take the JAX gather rule, positions on a unitig start,
    and unitigs with 0, 1 and more than P occurrences."""
    import copy

    from desamba_tpu.ops.locate import expand_refpos as jex
    from desamba_tpu.ops.locate import resolve_rows as jrr
    from desamba_tpu_torch.ops.locate import (expand_refpos, locate_plain,
                                              resolve_rows)
    from test_torch_kernels import check_locate_coverage, locate_cases

    fm, rows, valid, groups = locate_cases(ttab[0], ttab[2])
    jfm = copy.copy(jtab[0])
    jfm.sa_uni = jnp.asarray(fm.sa_uni.numpy())
    jfm.sa_off = jnp.asarray(fm.sa_off.numpy())
    jr = jrr(jfm, jtab[2], rows.numpy(), valid.numpy())
    ref = jex(jtab[2], jr["uni"], jr["u_off"], jr["ok"], P=P)
    got = locate_plain(fm, ttab[2], rows, valid, P)
    for name, a, b in zip(("ref", "gpos", "pvalid"), ref, got):
        _eq(a, b, name)
    res = resolve_rows(fm, ttab[2], rows, valid)
    for k in ("pos", "uni", "u_off", "ok"):
        _eq(jr[k], res[k], k)
    check_locate_coverage(
        res, expand_refpos(ttab[2], res["uni"], res["u_off"], res["ok"], P),
        groups, P)


# ------------------------------------------------------------ stage 4 --
def _pack(codes, n_words):
    sh = 2 * (np.arange(16 * n_words) % 16).astype(np.uint32)
    out = np.zeros((codes.shape[0], n_words), np.uint32)
    np.add.at(out.T, np.arange(16 * n_words) // 16,
              (codes.astype(np.uint32) << sh).T)
    return out


@pytest.mark.parametrize("K", [16, 80, 144])
def test_band_score_packed(K):
    """Planted MEMs, a fully valid row, a fully invalid row, a negative
    rel_lo and partial reads, as the JAX package's own test builds them."""
    from desamba_tpu.ops.matchblock import band_score_packed as jbs
    from desamba_tpu_torch.ops.matchblock import band_score_packed

    rng = np.random.default_rng(K)
    B, W = 9, 512
    NW = W // 16 + K // 16 + 1
    read = rng.integers(0, 4, (B, W)).astype(np.int32)
    rlen = rng.integers(30, W + 1, B).astype(np.int32)
    rlen[2] = W
    winc = rng.integers(0, 4, (B, 16 * NW)).astype(np.int32)
    for b in range(B):
        for _ in range(6):
            k = int(rng.integers(0, K))
            q = int(rng.integers(0, W - 40))
            ln = int(rng.integers(4, 40))
            winc[b, q + k : q + k + ln] = read[b, q : q + ln]
    winc[2, 5 : 5 + W] = read[2]  # a full-length match on diagonal 5
    vlo = rng.integers(0, 60, B).astype(np.int32)
    vhi = rng.integers(16 * NW - 60, 16 * NW, B).astype(np.int32)
    vlo[0], vhi[0] = 0, 16 * NW          # fully valid
    vlo[1], vhi[1] = 200, 200            # fully invalid
    vlo[2], vhi[2] = -40, 16 * NW + 50   # negative virtual start
    vlo[3], vhi[3] = -(1 << 20), 1 << 20
    read_w = _pack(read, W // 16)
    win_w = _pack(winc, NW)
    ref = jbs(read_w, rlen, win_w, vlo, vhi, K=K)
    got = band_score_packed(torch.from_numpy(read_w.view(np.int32)),
                            torch.from_numpy(rlen),
                            torch.from_numpy(win_w.view(np.int32)),
                            torch.from_numpy(vlo), torch.from_numpy(vhi), K)
    for f in ("score", "q_st", "q_ed"):
        _eq(ref[f], got[f], f)
    assert int(got["score"][1]) == 0 and int(got["q_st"][1]) == W
    assert int(got["score"][2]) >= W - 8
