"""Stage 3's locate (K6) in the formulation of csrc/locate.cu: a numpy
model of the kernel (the walk, then the search from a verified guess
with its galloping and bisecting fallbacks, then the expansion), held to
JAX's resolve_rows + expand_refpos and to locate_plain, element for
element (integers: exact equality), on the edge cases of
test_torch_kernels.locate_cases plus the routes of the search
(locate_route_cases) and on 86,016 random rows of the golden index.

The module imports no JAX at top level: the card's tests below and
chip_smoke.py reuse locate_model and locate_route_cases. On the card:

    python -m pytest tests/test_torch_locate.py -m cuda -q

Change the kernel and the model together.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import numpy as np
import pytest
import torch

from test_torch_kernels import _to, locate_cases
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

LF_SHIFT = 29
# routes of a lane's search (locate.cuh tail_guess): the guess holds; p
# lies past the next start (gallop from uni0 + 2); p lies below the
# guess's start (bisect [0, uni0)); uni0 is the last start (no search)
GUESS, GALLOP, BISECT, LAST = range(4)
ROUTES = ("guess", "gallop", "bisect", "last")
WARP = 32


def wrap32(x):
    """int32 arithmetic that wraps, on int64 values."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def jax_index(i, n):
    i = np.where(i < 0, i + n, i)
    return np.clip(i, 0, n - 1)


def model_tables(fm, loc, lfc: bool = True) -> dict:
    """The tables the kernel reads, as int64 numpy arrays (lfc's uint32
    bits unsigned; without lfc, those tail_model reads)."""
    a = lambda t: t.cpu().numpy().astype(np.int64)  # noqa: E731
    return dict(lfc=fm.lfc.cpu().numpy().view(np.uint32).astype(np.int64)
                if lfc else None,
                n_pad=int(fm.pad.shape[0]), sa_uni=a(fm.sa_uni),
                sa_off=a(fm.sa_off), us=a(loc.uni_start),
                n_ul=int(loc.uni_len.shape[0]), reflist=a(loc.reflist),
                rpg=a(loc.refpos_global), rpr=a(loc.refpos_refid))


def walk_model(t: dict, rows, valid, max_lf: int = 24):
    """locate.cuh walk on every lane: (row it stopped at, steps, ok)."""
    r = np.asarray(rows, np.int64).copy()
    k = np.zeros(r.size, np.int64)
    ok = np.zeros(r.size, bool)
    act = np.asarray(valid, bool).copy()
    lfc = t["lfc"]
    for _ in range(max_lf + 1):
        at = act & ((r & 7) == 0)
        ok |= at
        act &= ~at
        w = lfc[jax_index(np.clip(r, 0, t["n_pad"] - 1), lfc.size)]
        act &= (w >> LF_SHIFT) < 4
        r = np.where(act, w & ((1 << LF_SHIFT) - 1), r)
        k += act
    return r, k, ok


def tail_model(t: dict, r, k, ok, P: int = 4) -> dict:
    """locate.cuh tail_guess on every lane: the outputs (ref, gpos,
    pvalid), the unitig u, the guess's uni0 and p, each lane's route and
    probes after the guess's loads, the indices of uni_start it probed
    (probed) and the search loop's rounds in each warp of 32 lanes (the
    most probes of a lane of the warp)."""
    us, n_ul, rl = t["us"], t["n_ul"], t["reflist"]
    n_us, n_rl, n_rp = us.size, rl.size, t["rpg"].size
    s = np.clip(np.asarray(r, np.int64) >> 3, 0, t["sa_uni"].size - 1)
    uni0 = jax_index(t["sa_uni"][s], n_us)
    ug = np.minimum(uni0, n_ul - 1)
    a0 = us[uni0]
    a1 = us[np.minimum(uni0 + 1, n_us - 1)]
    rp_s = rl[jax_index(ug, n_rl)]
    rp_e = rl[np.clip(ug + 1, 0, n_rl - 1)]
    p = wrap32(a0 + t["sa_off"][s] + np.asarray(k, np.int64) + 1)
    fwd = a0 <= p
    nxt = uni0 + 1 < n_us
    hit = fwd & nxt & (p < a1)
    past = fwd & nxt & (p >= a1)
    lo = np.where(past, uni0 + 2, np.where(fwd, uni0 + 1, 0))
    hi = np.where(hit, uni0 + 1, np.where(fwd, n_us, uni0))
    step = past.astype(np.int64)
    route = np.select([hit, past, ~fwd], [GUESS, GALLOP, BISECT], LAST)
    probes = np.zeros(lo.size, np.int64)
    probed = []
    while (lo < hi).any():
        act = lo < hi
        mid = np.where(step > 0, np.minimum(lo + step - 1, hi - 1),
                       (lo + hi) >> 1)
        le = us[np.clip(mid, 0, n_us - 1)] <= p
        probed.append(mid[act])
        probes += act
        up, down = act & le, act & ~le
        lo = np.where(up, mid + 1, lo)
        hi = np.where(down, mid, hi)
        step = np.where(up, 2 * step, np.where(down, 0, step))
    u = np.clip(lo - 1, 0, n_ul - 1)
    again = u != uni0
    u_start = np.where(again, us[u], a0)
    rp_s = np.where(again, rl[jax_index(u, n_rl)], rp_s)
    rp_e = np.where(again, rl[np.clip(u + 1, 0, n_rl - 1)], rp_e)
    u_off = wrap32(p - u_start)
    rp = wrap32(rp_s[:, None] + np.arange(P))
    rc = np.clip(rp, 0, n_rp - 1)
    pad = -lo.size % WARP
    return dict(ref=t["rpr"][rc], gpos=wrap32(t["rpg"][rc] + u_off[:, None]),
                pvalid=np.asarray(ok, bool)[:, None] & (rp < rp_e[:, None]),
                u=u, uni0=uni0, p=p, u_off=u_off, route=route,
                probes=probes, again=again,
                probed=np.concatenate(probed) if probed else
                np.zeros(0, np.int64),
                warp_rounds=np.concatenate([probes, np.zeros(pad, np.int64)])
                .reshape(-1, WARP).max(1))


def locate_model(fm, loc, rows, valid, P: int = 4, max_lf: int = 24):
    """The kernel's formulation on every lane (walk_model, then
    tail_model); also the walk's r, k and ok."""
    t = model_tables(fm, loc)
    r, k, ok = walk_model(t, rows.cpu().numpy(), valid.cpu().numpy(), max_lf)
    return dict(tail_model(t, r, k, ok, P), r=r, k=k, ok=ok)


def locate_route_cases(fm, loc, seed=8):
    """(fm', rows int32[n], valid bool[n], groups): locate_cases plus the
    routes of the search, with a few more sa_uni / sa_off entries
    rewritten (sampled rows take no step, so p = start of the sample's
    unitig + sa_off + 1):
    - "gallop": p at the start of the unitig 1, 2, 3, 5 and 9 past the
      sample's (a walk past its unitig's end);
    - "bisect": p at the start of a unitig below the sample's, and p far
      below it;
    - "wrap": p past 2^31 from the last unitig (wraps negative; bisects
      to unitig 0);
    - "last": the sample names the last start (uni0 = n_us - 1);
    - "capfail": 300 valid rows whose walk runs out of its 25 steps;
    - "warp1": 32 lanes that fill one warp, 31 whose guess holds and one
      that gallops."""
    fm2, rows, valid, groups = locate_cases(fm, loc, seed)
    t = model_tables(fm2, loc)
    rng = np.random.default_rng(seed + 100)
    us, n_ul = t["us"], t["n_ul"]
    n_us = us.size
    sa_uni, sa_off = t["sa_uni"].copy(), t["sa_off"].copy()
    used = set((rows.numpy()[np.concatenate([groups[g] for g in (
        "sa_uni", "tie", "refs0", "refs1", "refs5")])] >> 3).tolist())
    free = [s for s in rng.permutation(np.arange(1, sa_uni.size))
            if s not in used]
    rows, valid = rows.numpy().tolist(), valid.numpy().tolist()

    def add(name, r, v=True):
        r = np.asarray(r, np.int64)
        groups[name] = np.arange(len(rows), len(rows) + r.size)
        rows.extend(r.tolist())
        valid.extend(np.broadcast_to(np.asarray(v, bool), r.shape).tolist())

    def sample(u, off):
        s = free.pop()
        sa_uni[s], sa_off[s] = u, off
        return 8 * s

    u = n_ul // 3
    add("gallop", [sample(u, us[u + d] - us[u] - 1) for d in (1, 2, 3, 5, 9)])
    add("bisect", [sample(2 * u, us[u // 2] - us[2 * u] - 1),
                   sample(2 * u, -us[2 * u] - 1000)])
    add("wrap", [sample(n_ul - 1, 2**31 - 1 - us[n_ul - 1] + 10)])
    add("last", [sample(n_us - 1, 0)])
    steps, end = _chains(t, 40)
    cap = np.flatnonzero((end == 0) | (steps >= 25))
    add("capfail", rng.choice(cap, min(300, cap.size), replace=False))
    # a whole warp: 31 sampled rows whose guess holds and one that gallops
    hits = [8 * s for s in free[:400]
            if tail_model(t, [8 * s], [0], [True])["route"][0] == GUESS]
    add("align", np.zeros(-len(rows) % WARP, np.int64), False)
    warp = hits[:31]
    warp.insert(17, sample(u + 1, us[u + 3] - us[u + 1] + 2))
    add("warp1", warp)
    fm3 = type(fm2)(fm2.occ32, fm2.pad, fm2.rank, fm2.hash13,
                    torch.from_numpy(sa_uni.astype(np.int32)).to(
                        fm2.sa_uni.device),
                    torch.from_numpy(sa_off.astype(np.int32)).to(
                        fm2.sa_off.device), fm2.lfc, fm2.L, fm2.dollar_pos)
    return (fm3, torch.tensor(rows, dtype=torch.int32),
            torch.tensor(valid, dtype=torch.bool), groups)


def _chains(t, rounds):
    """(steps, end) of the LF chain from each row in [0, n_pad): end 1
    where it reached a sampled row, 2 where it met a char >= 4 first, 0
    where it still walks after `rounds` rounds."""
    r = np.arange(t["n_pad"], dtype=np.int64)
    steps, end = np.zeros_like(r), np.zeros_like(r)
    for _ in range(rounds):
        end[(end == 0) & (r % 8 == 0)] = 1
        w = t["lfc"][np.clip(r, 0, t["lfc"].size - 1)]
        stop = (end == 0) & ((w >> LF_SHIFT) >= 4)
        end[stop] = 2
        go = end == 0
        r = np.where(go, w & ((1 << LF_SHIFT) - 1), r)
        steps += go
    return steps, end


def check_route_coverage(m: dict, groups: dict, valid) -> None:
    """The cases reach every route of the search: the guess, galloping
    (over several probes), bisecting (over several probes), the last
    start; failed walks whose guess holds and whose guess fails; p that
    wraps; and a warp whose one lane misses."""
    route, probes, ok = m["route"], m["probes"], m["ok"]
    valid = np.asarray(valid, bool)
    g = groups
    assert (route[g["gallop"]] == GALLOP).all()
    assert probes[g["gallop"]].max() >= 3
    assert (route[g["bisect"]] == BISECT).all()
    assert probes[g["bisect"]].min() >= 3
    assert (route[g["wrap"]] == BISECT).all() and (m["p"][g["wrap"]] < 0).all()
    assert (m["u"][g["wrap"]] == 0).all()
    assert (route[g["last"]] == LAST).all() and m["again"][g["last"]].all()
    failed = valid & ~ok
    assert (failed & (route == GUESS)).any()
    assert (failed & (route != GUESS)).any()
    cf = g["capfail"]
    assert not ok[cf].any() and (m["k"][cf] == 25).all()
    w = g["warp1"]
    assert w[0] % WARP == 0 and w.size == WARP
    assert (route[w] != GUESS).sum() == 1
    assert m["warp_rounds"][w[0] // WARP] >= 1
    for name in ROUTES:
        assert (route == ROUTES.index(name)).any(), name


# --------------------------------------------------------- CPU, vs JAX --
@pytest.fixture(scope="module")
def ti(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index

    return from_oracle_index(golden_oracle_index)


@pytest.fixture(scope="module")
def jtab(ti):
    from desamba_tpu.ops.fm import FmArrays
    from desamba_tpu.ops.locate import LocArrays

    return FmArrays(ti), LocArrays(ti)


@pytest.fixture(scope="module")
def ttab(ti):
    from desamba_tpu_torch.convert import build_tables

    return build_tables(ti, "cpu")


def _jax_locate(jtab, fm, rows, valid, P):
    """JAX's resolve_rows then expand_refpos, with fm's sa_uni / sa_off."""
    import copy

    import jax.numpy as jnp

    from desamba_tpu.ops.locate import expand_refpos, resolve_rows

    jfm = copy.copy(jtab[0])
    jfm.sa_uni = jnp.asarray(fm.sa_uni.numpy())
    jfm.sa_off = jnp.asarray(fm.sa_off.numpy())
    jr = resolve_rows(jfm, jtab[1], rows.numpy(), valid.numpy())
    return jr, expand_refpos(jtab[1], jr["uni"], jr["u_off"], jr["ok"], P=P)


def _held(jtab, ttab, fm, rows, valid, P):
    """The model against JAX and locate_plain on these lanes; returns the
    model's dict."""
    from desamba_tpu_torch.ops.locate import locate_plain, resolve_rows

    m = locate_model(fm, ttab[2], rows, valid, P)
    jr, jout = _jax_locate(jtab, fm, rows, valid, P)
    plain = locate_plain(fm, ttab[2], rows, valid, P)
    for name, a, b, c in zip(("ref", "gpos", "pvalid"), jout, plain,
                             (m["ref"], m["gpos"], m["pvalid"])):
        a = np.asarray(a).astype(np.int64)
        assert (a == b.numpy().astype(np.int64)).all(), name
        assert (a == c.astype(np.int64)).all(), name
    for key, mk in (("pos", "p"), ("uni", "u"), ("u_off", "u_off"),
                    ("ok", "ok")):
        assert (np.asarray(jr[key]).astype(np.int64)
                == m[mk].astype(np.int64)).all(), key
    rr = resolve_rows(fm, ttab[2], rows, valid)
    assert (rr["row"].numpy() == m["r"]).all()
    assert (rr["steps"].numpy() == m["k"]).all()
    return m


@pytest.mark.parametrize("P", [1, 4, 5])
def test_locate_model_equals_jax_on_route_cases(jtab, ttab, P):
    """The model == JAX's resolve_rows + expand_refpos == locate_plain on
    locate_route_cases; every route of the search is reached."""
    fm, rows, valid, groups = locate_route_cases(ttab[0], ttab[2])
    m = _held(jtab, ttab, fm, rows, valid, P)
    check_route_coverage(m, groups, valid.numpy())


def test_locate_model_equals_jax_on_random_rows(jtab, ttab):
    """86,016 random BWT rows of the golden index (90% valid), the smoke
    chunk's NC: the model == JAX == locate_plain; the guess holds for
    more than 99% of the lanes that are ok, and holds and fails on
    lanes whose walk failed."""
    rng = np.random.default_rng(86016)
    fm = ttab[0]
    rows = torch.from_numpy(rng.integers(0, fm.L, 86016).astype(np.int32))
    valid = torch.from_numpy(rng.random(86016) < 0.9)
    m = _held(jtab, ttab, fm, rows, valid, 4)
    hit = m["route"] == GUESS
    v = valid.numpy()
    assert hit[v & m["ok"]].mean() > 0.99
    assert (~hit[v & ~m["ok"]]).any() and hit[v & ~m["ok"]].any()


def test_walk_model_equals_resolve_rows_on_edge_rows(ttab):
    """walk_model's row, steps and ok == resolve_rows' on locate_cases
    (rows outside the table, sentinels, chains of 23-26 steps)."""
    from desamba_tpu_torch.ops.locate import resolve_rows

    fm, rows, valid, _ = locate_cases(ttab[0], ttab[2])
    t = model_tables(fm, ttab[2])
    r, k, ok = walk_model(t, rows.numpy(), valid.numpy())
    rr = resolve_rows(fm, ttab[2], rows, valid)
    assert (rr["row"].numpy() == r).all() and (rr["steps"].numpy() == k).all()
    assert (rr["ok"].numpy() == ok).all()


# ------------------------------------------------------------ the card --
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


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_locate_kernel_route_cases(cuda, tables, P):
    """The kernel == locate_plain == the model on locate_route_cases, one
    launch, every route reached."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.ops.locate import LocArrays, locate, locate_plain

    fm, rows, valid, groups = locate_route_cases(tables[0], tables[2])
    loc = LocArrays(**{k: getattr(tables[2], k).to(cuda)
                       for k in LocArrays.FIELDS})
    fmc = _to((fm,), cuda)
    before = kernels.launches["locate"]
    got = locate(fmc, loc, rows.to(cuda), valid.to(cuda), P)
    ref = locate_plain(fmc, loc, rows.to(cuda), valid.to(cuda), P)
    torch.cuda.synchronize()
    assert kernels.launches["locate"] == before + 1
    m = locate_model(fm, tables[2], rows, valid, P)
    for name, g, r in zip(("ref", "gpos", "pvalid"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
        assert (g.cpu().numpy().astype(np.int64)
                == m[name].astype(np.int64)).all(), name
    check_route_coverage(m, groups, valid.numpy())
