"""Stage 2 of the torch port against the JAX package's, where the
compaction caps bind.

With the bursts before the cuts set to 0 in both packages (monkeypatched
module constants; no JAX file changes), almost every seed lane is still
live at the interval search's first cut and every row slot at the walks'
first cut, so four of the five caps bind on the golden reads. Stage 2's
five outputs must then equal JAX's element for element, under the
wrappers (the plain routes on the CPU) and under the plain versions.
The row grid's cap (NC) does not bind on the golden index, so the plain
row grid, like the plain compaction and the loops' resume through an
index list, is also held to JAX's own expressions on inputs built to
fill it. All values are integers: the tolerance is exact equality.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import (STAGE2_BURSTS, _search_inputs,
                                compact_caps, compact_masks,
                                golden_stage2_inputs, row_grid_inputs)
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401


@pytest.fixture(scope="module")
def jax_cl(golden_oracle_index):
    from desamba_tpu.engine.fast_engine import FastClassifier

    return FastClassifier(golden_oracle_index)


@pytest.fixture(scope="module")
def tables(golden_index_dir):
    from desamba_tpu_torch.convert import build_tables
    from desamba_tpu_torch.index.loader import load_index

    return build_tables(load_index(golden_index_dir), "cpu")


def _eq(ref, got, what):
    a, b = np.asarray(ref), got.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a == b).all(), (what, int((a != b).sum()))


def _live(done, src=None):
    """Live entries a compaction sees (compact_plain's rule)."""
    if src is None:
        return int((done == 0).sum())
    n = done.shape[0]
    return int((done[src[(src >= 0) & (src < n)].long()] == 0).sum())


@pytest.mark.parametrize("bursts", [(0, 0, 0, 0), (1, 1, 1, 1), None],
                         ids=["bursts0", "bursts1", "defaults"])
def test_stage2_equals_jax_where_the_caps_bind(monkeypatch, jax_cl, tables,
                                               bursts):
    """The golden W = 2048 reads at Bp = 64 (S = 2,688 seed lanes): JAX's
    stage 2 under a fresh jit against the port's, under KERNEL_OPS and
    PLAIN_OPS; with the bursts at 0, the NC2, NC3, NCW and NCW2 cuts each
    see more live lanes than their cap."""
    from desamba_tpu.engine import fast_engine as jfe
    from desamba_tpu_torch.engine import fast_engine as tfe

    if bursts is not None:
        for mod in (jfe, tfe):
            for name, v in zip(STAGE2_BURSTS, bursts):
                monkeypatch.setattr(mod, name, v)
    ek = tables[1]
    inputs = golden_stage2_inputs(ek)
    js = jfe._build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                           ek.n_words0)
    ref = jax.jit(js[1])(jax_cl.fm, *(jnp.asarray(t.numpy())
                                      for t in inputs))
    S = inputs[3].numel()
    assert S == 2688
    for ops in (tfe.KERNEL_OPS, tfe.PLAIN_OPS):
        cuts = []

        def recording(done, cap, src=None, _cp=ops["compact"]):
            cuts.append((_live(done, src), cap))
            return _cp(done, cap, src=src)

        s2 = tfe.build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                              ek.n_words0, ops=dict(ops, compact=recording))[1]
        got = s2(tables[0], *inputs)
        assert len(got) == len(ref) == 5
        for i, (a, b) in enumerate(zip(ref, got)):
            _eq(a, b, f"stage2[{i}]")
        assert [c for _, c in cuts] == [336, 128, 336, 128]
        if bursts == (0, 0, 0, 0):
            assert [n for n, _ in cuts] == [2688, 336, 1344, 336]
    assert int(got[1].sum()) > 0


# ------------------------------------------------- JAX's expressions --
def jax_first(live, cap: int, fill: int):
    """JAX's compaction (desamba_tpu/engine/fast_engine.py:242-244, and
    the same at :257-259, :298-303, :316-318 and :332-334)."""
    n = live.shape[0]
    pos = jnp.cumsum(live.astype(jnp.int32)) - 1
    tgt = jnp.where(live & (pos < cap), pos, cap)
    return jnp.full(cap, fill, jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")


@pytest.mark.parametrize("n", [1, 1023, 1025, 2688])
def test_compact_plain_equals_jax(n):
    """compact_plain on every mask and cap of compact_masks /
    compact_caps against JAX's sel2; the source-list form on the first
    cut's output against JAX's second cut: live where the gathered carry
    (padding marked done) is live, the lanes s2i[s3i] it resumes, and n in
    the unused slots."""
    from desamba_tpu_torch.ops.compact import compact_plain

    rng = np.random.default_rng(n)
    masks = compact_masks(n, seed=n)
    bound = 0
    for name, done in masks.items():
        for cap in compact_caps(n):
            sel2 = jax_first(jnp.asarray(done.numpy() == 0), cap, n)
            got2 = compact_plain(done, cap)
            _eq(sel2, got2, (name, cap))
            bound += _live(done) > cap
            done_b = torch.from_numpy(
                (rng.random(n) < rng.random()).astype(np.int32))
            s2i = jnp.minimum(sel2, n - 1)
            live3 = ~(jnp.asarray(done_b.numpy())[s2i].astype(bool)
                      | (sel2 >= n))
            for cap3 in compact_caps(cap):
                sel3 = jax_first(live3, cap3, cap)
                ref3 = jnp.where(sel3 < cap,
                                 s2i[jnp.minimum(sel3, cap - 1)], n)
                got3 = compact_plain(done_b, cap3, got2)
                _eq(ref3, got3, (name, cap, cap3))
                bound += _live(done_b, got2) > cap3
    assert bound > 0 or n == 1


def jax_row_grid(st, seed_ok, lane, s_idx, cap: int):
    """JAX's row grid (desamba_tpu/engine/fast_engine.py:287-313) and the
    epilogue's gathers through seli (:348-350), on the interval carry's
    final nsp, nep, match_len and ptr."""
    from desamba_tpu.engine.fast_engine import ROWS_PER_SEARCH as R

    sp, ep, ml0, ptr = st[2], st[3], st[4], st[5]
    srch_ok = seed_ok & (sp < ep)
    rowk = jnp.arange(R, dtype=jnp.int32)
    rows = (sp[:, None] + rowk[None, :]).reshape(-1)
    rvalid = (srch_ok[:, None] & (
        sp[:, None] + rowk[None, :] < ep[:, None])).reshape(-1)
    lane_r = jnp.repeat(lane, R)
    ptr_r = jnp.repeat(ptr, R)
    rem_r = jnp.repeat(jnp.maximum(s_idx - ml0, 0), R)
    SR = sp.shape[0] * R
    sel = jax_first(rvalid, cap, SR)
    sval = sel < SR
    seli = jnp.minimum(sel, SR - 1)
    wlens = jnp.where(sval, rem_r[seli], 0)
    return (sel, rows[seli], ptr_r[seli], lane_r[seli], wlens,
            jnp.repeat(ml0, R)[seli], jnp.repeat(s_idx, R)[seli],
            int(rvalid.sum()))


@pytest.mark.parametrize("S", [1, 1025, 3000])
def test_row_grid_plain_equals_jax(S):
    """row_grid_plain against JAX's row grid, with a cap that binds (half
    the valid rows), one that does not, and the exact valid count; the
    int32 wraps of row_grid_inputs included."""
    from desamba_tpu_torch.ops.compact import row_grid_plain

    st, ok, lane, s_idx = row_grid_inputs(S, seed=S)
    j = [jnp.asarray(t.numpy()) for t in (st, ok, lane, s_idx)]
    n_valid = jax_row_grid(*j, 1)[-1]
    assert n_valid > 2 or S == 1
    for cap in sorted({1, max(1, n_valid // 2), n_valid or 1,
                       n_valid + 7}):
        ref = jax_row_grid(*j, cap)
        sel, walk, wl = row_grid_plain(st, ok, lane, s_idx, cap)
        got = (sel, walk[0], walk[1], wl[0], wl[1], wl[2], wl[3])
        for i, (a, b) in enumerate(zip(ref, got)):
            _eq(a, b, (cap, i))
        assert walk.shape == (5, cap) and not walk[2:].any()


def test_resume_through_an_index_list_equals_jax(jax_cl, tables):
    """interval_search_plain and row_walks_plain with sel (a binding cut
    of the live lanes, fill n) against JAX's interval_search and
    row_walks resumed with state= on the carry gathered at the listed
    lanes, then scattered back; the wrappers' CPU route gives the same."""
    from desamba_tpu.ops.fm import interval_search, row_walks
    from desamba_tpu_torch.ops.compact import compact_plain
    from desamba_tpu_torch.ops.fm import (interval_search_plain,
                                          interval_search_state, iv_init,
                                          row_walks_plain, row_walks_state,
                                          rw_init)

    fm, jfm = tables[0], jax_cl.fm
    n = 3000
    d = _search_inputs(fm, n, 300, seed=11)
    per_lane = (d["lane"], d["max_rst"], d["l_min"], d["l_max"])
    st = interval_search_plain(fm, d["codes"], *per_lane,
                               iv_init(d["sp0"], d["ep0"], d["s_idx"]), 0)
    sel = compact_plain(st[6], 64)
    assert _live(st[6]) > 64
    got = interval_search_plain(fm, d["codes"], *per_lane, st, 8, sel=sel)
    assert torch.equal(got, interval_search_state(fm, d["codes"], *per_lane,
                                                  st, 8, sel=sel))
    idx = sel[sel < n].long()
    keys = ("sp", "ep", "nsp", "nep", "match_len", "ptr", "done", "status")
    jst = {k: jnp.asarray(st[i][idx].numpy()) for i, k in enumerate(keys)}
    jst["done"] = jst["done"].astype(bool)
    g = lambda t: jnp.asarray(t[idx].numpy())
    res = interval_search(jfm, jnp.asarray(d["codes"].numpy()), 0,
                          g(d["s_idx"]), g(d["sp0"]), g(d["ep0"]),
                          *(g(t) for t in per_lane[1:]), max_steps=8,
                          lanes=g(d["lane"]), state=jst, return_state=True)
    ref = st.clone()
    ref[:, idx] = torch.from_numpy(np.stack(
        [np.asarray(res[k]).astype(np.int32) for k in keys]))
    assert torch.equal(got, ref) and not torch.equal(got, st)

    mlen = torch.clamp(d["s_idx"] - got[4], min=0).to(torch.int32)
    wst = row_walks_plain(fm, d["codes"], d["lane"], mlen,
                          rw_init(got[2], got[5]), 0)
    wsel = compact_plain(wst[3], 64)
    assert _live(wst[3]) > 64
    wgot = row_walks_plain(fm, d["codes"], d["lane"], mlen, wst, 16,
                           sel=wsel)
    assert torch.equal(wgot, row_walks_state(fm, d["codes"], d["lane"], mlen,
                                             wst, 16, sel=wsel))
    idx = wsel[wsel < n].long()
    jw = tuple(jnp.asarray(wst[i][idx].numpy()).astype(
        bool if i >= 3 else jnp.int32) for i in range(5))
    wres = row_walks(jfm, jnp.asarray(d["codes"].numpy()), jw[0], jw[1],
                     g(mlen), lanes=g(d["lane"]), with_trace=False,
                     state=jw, trace_cap=16, return_state=True)
    wref = wst.clone()
    wref[:, idx] = torch.from_numpy(np.stack(
        [np.asarray(x).astype(np.int32) for x in wres]))
    assert torch.equal(wgot, wref) and not torch.equal(wgot, wst)


# ------------------------------------- K1's and K2's in-place resumes --
def interval_search_in_place(fm, codes, lanes, max_rst, l_min, l_max, state,
                             max_steps, sel=None):
    """interval_search_state's CUDA contract on the CPU: a resume through
    sel writes the listed lanes' new carry into `state` itself and
    returns it; the call without sel returns a new carry."""
    from desamba_tpu_torch.ops.fm import interval_search_plain

    out = interval_search_plain(fm, codes, lanes, max_rst, l_min, l_max,
                                state, max_steps, sel)
    if sel is None:
        return out
    state.copy_(out)
    return state


def test_interval_search_in_place_resume_equals_jax(jax_cl, tables):
    """K1's resume in place returns the carry it was given: the listed
    lanes equal JAX's gather of the carry at those lanes, its
    interval_search resumed with state=, and the scatter back
    (fast_engine.py:245-275); every unlisted lane is bit-identical to the
    carry before the call, and entries of sel outside [0, n) (negative,
    n and beyond) are skipped."""
    from desamba_tpu.ops.fm import interval_search
    from desamba_tpu_torch.ops.compact import compact_plain
    from desamba_tpu_torch.ops.fm import interval_search_plain, iv_init

    fm, jfm = tables[0], jax_cl.fm
    n = 3000
    d = _search_inputs(fm, n, 300, seed=13)
    per_lane = (d["lane"], d["max_rst"], d["l_min"], d["l_max"])
    st = interval_search_plain(fm, d["codes"], *per_lane,
                               iv_init(d["sp0"], d["ep0"], d["s_idx"]),0)
    sel = compact_plain(st[6], 96)
    assert _live(st[6]) > 96
    sel = torch.cat([sel[:40], torch.tensor([-1, n, n + 9], dtype=torch.int32),
                     sel[40:].flip(0)])
    before = st.clone()
    got = interval_search_in_place(fm, d["codes"], *per_lane, st, 8,
                                   sel=sel)
    assert got is st
    idx = sel[(sel >= 0) & (sel < n)].long()
    keys = ("sp", "ep", "nsp", "nep", "match_len", "ptr", "done", "status")
    jst = {k: jnp.asarray(before[i][idx].numpy())
           for i, k in enumerate(keys)}
    jst["done"] = jst["done"].astype(bool)
    g = lambda t: jnp.asarray(t[idx].numpy())
    res = interval_search(jfm, jnp.asarray(d["codes"].numpy()), 0,
                          g(d["s_idx"]), g(d["sp0"]), g(d["ep0"]),
                          *(g(t) for t in per_lane[1:]), max_steps=8,
                          lanes=g(d["lane"]), state=jst, return_state=True)
    ref = before.clone()
    ref[:, idx] = torch.from_numpy(np.stack(
        [np.asarray(res[k]).astype(np.int32) for k in keys]))
    assert torch.equal(got, ref)
    listed = torch.zeros(n, dtype=torch.bool)
    listed[idx] = True
    assert torch.equal(got[:, ~listed], before[:, ~listed])
    assert not torch.equal(got[:, listed], before[:, listed])


def row_walks_in_place(fm, codes, lanes, max_lens, state, trace_cap,
                       sel=None):
    """row_walks_state's CUDA contract on the CPU: a resume through sel
    writes the listed slots' new carry into `state` itself and returns
    it; the call without sel returns a new carry."""
    from desamba_tpu_torch.ops.fm import row_walks_plain

    out = row_walks_plain(fm, codes, lanes, max_lens, state, trace_cap, sel)
    if sel is None:
        return out
    state.copy_(out)
    return state


def test_in_place_resume_leaves_unlisted_slots(tables):
    """A resume in place returns the carry it was given, with the listed
    slots walked as row_walks_plain walks them and every other slot (and
    an entry of sel outside [0, n)) as it was."""
    from desamba_tpu_torch.ops.compact import compact_plain
    from desamba_tpu_torch.ops.fm import row_walks_plain, rw_init

    fm = tables[0]
    n = 3000
    d = _search_inputs(fm, n, 300, seed=12)
    mlen = torch.clamp(d["s_idx"] - 13, min=0).to(torch.int32)
    wst = row_walks_plain(fm, d["codes"], d["lane"], mlen,
                          rw_init(d["sp0"], d["s_idx"] - 13), 1)
    sel = compact_plain(wst[3], 64)
    sel[-1] = n + 7  # skipped
    before = wst.clone()
    ref = row_walks_plain(fm, d["codes"], d["lane"], mlen, wst, 16, sel=sel)
    got = row_walks_in_place(fm, d["codes"], d["lane"], mlen, wst, 16,
                             sel=sel)
    assert got is wst and torch.equal(got, ref)
    listed = torch.zeros(n, dtype=torch.bool)
    listed[sel[(sel >= 0) & (sel < n)].long()] = True
    assert torch.equal(got[:, ~listed], before[:, ~listed])
    assert not torch.equal(got[:, listed], before[:, listed])


@pytest.mark.parametrize("bursts", [(0, 0, 0, 0), None],
                         ids=["bursts0", "defaults"])
def test_chunk_with_in_place_resumes_equals_jax(monkeypatch, jax_cl,
                                                tables, bursts):
    """A golden W = 2048 chunk through build_full, the interval search's
    and the row walks' two resumes each updating the carry in place
    (interval_search_in_place, row_walks_in_place), equals JAX's fused
    program: stage 2 never reads a carry after handing it to a resume.
    With the bursts at 0 the cuts bind."""
    from desamba_tpu.engine import fast_engine as jfe
    from desamba_tpu_torch.engine import fast_engine as tfe
    from desamba_tpu_torch.index.loader import load_index
    from test_torch_fast_engine import _golden_reads

    if bursts is not None:
        for mod in (jfe, tfe):
            for name, v in zip(STAGE2_BURSTS, bursts):
                monkeypatch.setattr(mod, name, v)
    fm, ek, loc, ra = tables
    calls = []

    def recording(in_place):
        def call(*a, sel=None):
            calls.append((in_place.__name__, sel is not None))
            return in_place(*a, sel=sel)
        return call

    full = tfe.build_full(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                          ek.n_words0,
                          dict(tfe.PLAIN_OPS,
                               interval_search=recording(
                                   interval_search_in_place),
                               row_walks=recording(row_walks_in_place)))
    reads = _golden_reads(min_len=1025, max_len=2048)
    packed, lens, _ = jax_cl._encode(reads, W=2048, Bp=64)
    got = full(fm, loc, ra, ek.w01, torch.from_numpy(packed),
               torch.from_numpy(lens))
    jek = jax_cl.ek
    jfull = jax.jit(jfe._build_full(jek.lek, jek.single_base_max,
                                    jek.mask_bits, 20, jek.n_words0))
    ref = jfull(jax_cl.fm, jax_cl.loc, jax_cl.ra, jek.w01,
                jnp.asarray(packed), jnp.asarray(lens))
    assert calls == [(f"{k}_in_place", r) for k in ("interval_search",
                                                    "row_walks")
                     for r in (False, True, True)]
    _eq(ref, got, "build_full [7, Bp]")
    assert int((got[1] >= 0).sum()) > 0
