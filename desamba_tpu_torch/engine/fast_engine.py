"""Device-resident batched classifier ("fast mode") on PyTorch.

Counterpart of desamba_tpu/engine/fast_engine.py. The stages are the JAX
package's, step for step, with the same static schedule and caps:

  stage0  2-bit unpack of the per-read fwd|rc packed rows
  stage1  exist-filter probe + per-window top seed (ops/ekmer, ops/seeds)
  stage2  FM backward interval search from the hash13 head start and the
          per-row LF walks, each as burst / compact / resume (ops/fm; the
          two loops are hand CUDA kernels)
  stage3  SA-sample resolution (ops/locate) and the windowed diagonal vote
  stage4  SWAR banded rescore (ops/matchblock; a hand CUDA kernel) and
          the reference's odd/even tie order

Every stage is integer-only, so a stage's output equals the JAX stage's
element for element. Where JAX clamps an out-of-range gather index or
drops an out-of-range scatter, the code here clamps or pads explicitly.

`FastClassifier` subclasses the JAX package's class and overrides only
__init__, _run, _shard_stages and _run_mesh: the gate, width bucketing,
long-read block partitioning, result formatting and the exact native
replay of ambiguous reads are inherited unchanged.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from desamba_tpu.constants import (DEFAULT_FILTER_MIN_LENGTH,
                                   DEFAULT_MIN_SCORE, SEED_RANGE, STEP_EK)
from desamba_tpu.engine import fast_engine as _ref
from desamba_tpu.engine.fast_engine import (
    AMB_LARGE_L, AMB_MARGIN, AMB_MARGIN_LARGE, FM_EXT_CAP, IV_BURST, IV_MID,
    PACK_KEYS, REFPOS_PER_ANCHOR, ROWS_PER_SEARCH, VOTE_TILE, WALK_BURST,
    WALK_MID, WALK_TAIL, _band)

from ..ops.ekmer import _probe_reads, kmer_lo26
from ..ops.fm import (interval_search_plain, interval_search_state, iv_init,
                      row_walks_plain, row_walks_state, rw_init)
from ..ops.locate import expand_refpos, resolve_rows
from ..ops.matchblock import band_score_packed, band_score_packed_plain
from ..ops.seeds import top_seeds

I32 = torch.int32
# the (interval search, row walks, band score) functions the stages call:
# the wrappers, which launch the hand kernels on CUDA tensors, or their
# plain torch versions on any device (to check the kernel path)
KERNEL_OPS = (interval_search_state, row_walks_state, band_score_packed)
PLAIN_OPS = (interval_search_plain, row_walks_plain, band_score_packed_plain)


def stage0_unpack(packed: torch.Tensor, lens: torch.Tensor):
    """packed uint8[Bp, W//2] (per read row: W//4 bytes of forward codes,
    then W//4 of reverse-complement codes, 4 codes per byte LSB-first) ->
    (codes2 uint8[2Bp, W], lengths2 int32[2Bp]), fwd rows then rc rows."""
    Bp, Wq2 = packed.shape
    Wq = Wq2 // 2
    both = torch.cat([packed[:, :Wq], packed[:, Wq:]], 0)
    codes2 = torch.stack([(both >> s) & 3 for s in (0, 2, 4, 6)], 2)
    lens = lens.to(I32)
    return codes2.reshape(2 * Bp, 4 * Wq), torch.cat([lens, lens])


def _read_words(packed: torch.Tensor) -> torch.Tensor:
    """int32[2Bp, W/16] packed code words (uint32 bits, code t of each
    word at bits 2t), fwd rows then rc: the wire bytes viewed as
    little-endian 32-bit words."""
    Wq = packed.shape[1] // 2
    both = torch.cat([packed[:, :Wq], packed[:, Wq:]], 0).contiguous()
    return both.view(I32)


def _compact(live: torch.Tensor, cap: int) -> torch.Tensor:
    """Stable prefix-position compaction: int32[cap] holding the indices of
    the first `cap` live lanes in order, then n (= len(live)) in the
    unused slots. Live lanes past the cap are dropped."""
    n = live.shape[0]
    pos = torch.cumsum(live.to(I32), 0, dtype=I32) - 1
    tgt = torch.where(live & (pos < cap), pos, cap)
    sel = torch.full((cap + 1,), n, dtype=I32, device=live.device)
    sel.scatter_(0, tgt.long(), torch.arange(n, dtype=I32,
                                             device=live.device))
    return sel[:cap]


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst[:, idx] = src, dropping idx == dst.shape[1] (JAX mode='drop')."""
    n = dst.shape[1]
    out = torch.cat([dst, dst[:, :1]], 1)
    out[:, idx.long()] = src
    return out[:, :n]


def build_stages(lek: int, sbm: int, mask_bits: int, min_match: int,
                 nw0: int = 0, ops=KERNEL_OPS):
    """Returns (stage1, stage2, stage3, stage4) closed over the static
    exist-filter parameters; `ops` is KERNEL_OPS or PLAIN_OPS."""
    iv, rw, bsp = ops

    def stage1(w01, codes2, lengths2):
        ex = _probe_reads(w01, codes2, lengths2, lek, sbm, mask_bits,
                          stride=STEP_EK, n_words0=nw0)
        lo26 = kmer_lo26(codes2, lek, stride=STEP_EK)
        kidx, runlen = top_seeds(ex, SEED_RANGE // STEP_EK)
        n_exist = ex.sum(1, dtype=I32)
        return lo26, kidx, runlen, n_exist

    def stage2(fm, codes_i, lengths2, lo26, kidx, runlen):
        B2, W = codes_i.shape
        dev = codes_i.device
        n_win = kidx.shape[1]
        S = B2 * n_win
        lane = torch.arange(B2, dtype=I32, device=dev).repeat_interleave(
            n_win)
        sk = kidx.reshape(S)
        rl = runlen.reshape(S)
        s_idx = (STEP_EK - 1) + STEP_EK * sk + (lek - 1)
        seed_ok = (rl > 0) & (s_idx < lengths2[lane.long()])
        pre = lo26[lane.long(), sk.long()].long()
        sp0 = torch.where(seed_ok, fm.hash13[pre], 0)
        ep0 = torch.where(seed_ok, fm.hash13[pre + 1], 0)
        max_rst_a = torch.full((S,), ROWS_PER_SEARCH, dtype=I32, device=dev)
        l_min_a = torch.full((S,), min_match, dtype=I32, device=dev)
        l_max_a = torch.clamp(s_idx, max=13 + FM_EXT_CAP).to(I32)
        # burst on all S lanes, compact the stragglers to S/8, resume,
        # compact to S/32, finish; lanes past a cap keep their carry
        st = iv(fm, codes_i, lane, max_rst_a, l_min_a, l_max_a,
                iv_init(sp0, ep0, s_idx), IV_BURST)
        NC2 = max(128, S // 8)
        sel2 = _compact(st[6] == 0, NC2)
        s2i = sel2.clamp(max=S - 1).long()
        st_c = st[:, s2i]
        st_c[6] |= (sel2 >= S).to(I32)
        mid_c = iv(fm, codes_i, lane[s2i], max_rst_a[s2i], l_min_a[s2i],
                   l_max_a[s2i], st_c, IV_MID)
        NC3 = max(128, S // 32)
        sel3 = _compact(mid_c[6] == 0, NC3)
        s3i = sel3.clamp(max=NC2 - 1).long()
        st_c3 = mid_c[:, s3i]
        st_c3[6] |= (sel3 >= NC2).to(I32)
        s2i3 = s2i[s3i]
        fin_c = iv(fm, codes_i, lane[s2i3], max_rst_a[s2i3], l_min_a[s2i3],
                   l_max_a[s2i3], st_c3, 4096)
        keep = [2, 3, 4, 5, 7]  # nsp, nep, match_len, ptr, status
        mid_f = _scatter_rows(mid_c[keep], sel3, fin_c[keep])
        res_sp, res_ep, ml0, res_ptr, _ = _scatter_rows(
            st[keep], sel2, mid_f).unbind(0)
        # status 1 (depth cap / read start reached) is a hit here too
        srch_ok = seed_ok & (res_sp < res_ep)
        # per-row single-interval extension (bwt_single_search analog)
        # on the compacted live rows, in three burst/compact phases
        R = ROWS_PER_SEARCH
        rowk = torch.arange(R, dtype=I32, device=dev)
        rows = (res_sp[:, None] + rowk[None, :]).reshape(-1)
        rvalid = (srch_ok[:, None] & (
            res_sp[:, None] + rowk[None, :] < res_ep[:, None])).reshape(-1)
        lane_r = lane.repeat_interleave(R)
        ptr_r = res_ptr.repeat_interleave(R)
        rem_r = torch.clamp(s_idx - ml0, min=0).repeat_interleave(R)
        SR = S * R
        NC = max(256, SR // 4)
        sel = _compact(rvalid, NC)
        sval = sel < SR
        seli = sel.clamp(max=SR - 1).long()
        wlens = torch.where(sval, rem_r[seli], 0).to(I32)
        wlanes = lane_r[seli]
        stw = rw(fm, codes_i, wlanes, wlens, rw_init(rows[seli], ptr_r[seli]),
                 WALK_BURST)
        NCW = max(128, NC // 4)
        selw = _compact(stw[3] == 0, NCW)
        swi = selw.clamp(max=NC - 1).long()
        stw_c = stw[:, swi]
        stw_c[3] |= (selw >= NC).to(I32)
        wlanes2, wlens2 = wlanes[swi], wlens[swi]
        st2 = rw(fm, codes_i, wlanes2, wlens2, stw_c, WALK_MID)
        NCW2 = max(128, NCW // 4)
        selw2 = _compact(st2[3] == 0, NCW2)
        swi2 = selw2.clamp(max=NCW - 1).long()
        st2_c = st2[:, swi2]
        st2_c[3] |= (selw2 >= NCW).to(I32)
        wrc = rw(fm, codes_i, wlanes2[swi2], wlens2[swi2], st2_c, WALK_TAIL)
        keep = [0, 2, 4]  # sp, n, bad
        mid = _scatter_rows(st2[keep], selw2, wrc[keep])
        final_sp, steps, badw = _scatter_rows(stw[keep], selw, mid).unbind(0)
        total_c = ml0.repeat_interleave(R)[seli] + 1 + steps
        hit_c = sval & (total_c >= min_match) & (badw == 0)
        qleft_c = s_idx.repeat_interleave(R)[seli] - total_c + 1
        # all [NC]-compacted; sel maps back to the (seed-window, row) grid
        return final_sp, hit_c, total_c, qleft_c.to(I32), sel

    def stage3(fm, loc, lengths2, fsp_c, hit_c, total_c, qleft_c, sel,
               B2: int, nwR: int):
        """Anchor resolution and the exact windowed diagonal vote on the
        compacted lanes; sel // nwR is the read row (B2 for unused slots,
        dropped) and sel % nwR the anchor slot in the dense [B2, A]
        layout."""
        dev = fsp_c.device
        loc_r = resolve_rows(fm, loc, fsp_c, hit_c)
        ref, gpos, pvalid = expand_refpos(
            loc, loc_r["uni"], loc_r["u_off"], loc_r["ok"],
            P=REFPOS_PER_ANCHOR)
        P = ref.shape[1]
        A = nwR * P
        b_i = (sel // nwR).long()
        slot = ((sel % nwR)[:, None] * P
                + torch.arange(P, dtype=I32, device=dev)).long()

        def dense(fill, val):  # [B2 + 1, A] scatter, row B2 dropped
            d = torch.full((B2 + 1, A), fill, dtype=I32, device=dev)
            d[b_i[:, None], slot] = val.to(I32)
            return d[:B2]

        ref_a = dense(-1, torch.where(pvalid, ref, -1))
        diag_a = dense(0, gpos - qleft_c[:, None])
        w_a = dense(0, torch.where(pvalid, total_c[:, None], 0))
        tol = torch.clamp(lengths2 >> 4, 30, 160)[:, None, None]
        # score[b, i] = sum_j w[b, j] * [same ref & |diag diff| <= tol],
        # over j-tiles of VOTE_TILE to bound memory
        Ap = -(-A // VOTE_TILE) * VOTE_TILE
        pad = torch.nn.functional.pad
        refp = pad(ref_a, (0, Ap - A), value=-2)
        diagp = pad(diag_a, (0, Ap - A))
        wp = pad(w_a, (0, Ap - A))
        score = torch.zeros((B2, A), dtype=I32, device=dev)
        for j0 in range(0, Ap, VOTE_TILE):
            rj = refp[:, None, j0 : j0 + VOTE_TILE]
            dj = diagp[:, None, j0 : j0 + VOTE_TILE]
            wj = wp[:, None, j0 : j0 + VOTE_TILE]
            same = (ref_a[:, :, None] == rj) & (
                (diag_a[:, :, None] - dj).abs() <= tol)
            score += (same * wj).sum(2, dtype=I32)
        score = torch.where(ref_a >= 0, score, -1)

        def take(sc):
            i1 = torch.argmax(sc, 1, keepdim=True)  # first index on ties
            v1 = sc.gather(1, i1)[:, 0]
            r1 = torch.where(v1 > 0, ref_a.gather(1, i1)[:, 0], -1)
            return r1, diag_a.gather(1, i1)[:, 0], torch.clamp(v1, min=0)

        # three candidates per strand: the winner, the best on a far
        # diagonal, the best on another ref (cly.c:200-223)
        r1, d1, v1 = take(score)
        far = (ref_a != r1[:, None]) | (
            (diag_a - d1[:, None]).abs() > 2 * tol[:, :, 0])
        r2, d2, v2 = take(torch.where(far, score, -1))
        r3, d3, v3 = take(torch.where(ref_a != r1[:, None], score, -1))
        return (torch.stack([r1, r2, r3], 1), torch.stack([d1, d2, d3], 1),
                torch.stack([v1, v2, v3], 1))

    def stage4(ra, read_w2, lengths2, ref_c, diag_c, vote_c, B2: int,
               K: int):
        """Banded rescore of every candidate and the strand + candidate
        combine with the reference's tie order. K is the full band-score
        width 2*band + 16 (band start aligned down to a 16-code word)."""
        dev = ref_c.device
        W = 16 * read_w2.shape[1]
        C = ref_c.shape[1]
        band = (K - 16) // 2
        ref_f = ref_c.reshape(-1)
        diag_f = diag_c.reshape(-1)
        lane_f = torch.arange(B2, device=dev).repeat_interleave(C)
        g0a = (diag_f - band) & ~15
        nw = W // 16 + K // 16 + 1
        total_w = ra.ref_words_lsb.shape[0]
        widx = (g0a >> 4)[:, None] + torch.arange(nw, dtype=I32, device=dev)
        win_w = ra.ref_words_lsb[widx.clamp(0, total_w - 1).long()]
        n_ref = ra.ref_offset.shape[0]
        rc0 = ref_f.clamp(0, n_ref - 1).long()
        lo = ra.ref_offset[rc0]
        hi = lo + ra.ref_len[rc0]
        ok = ref_f >= 0
        rel_lo = torch.where(ok, lo - g0a, 0).to(I32)
        rel_hi = torch.where(ok, hi - g0a, 0).to(I32)
        bs = bsp(read_w2[lane_f].contiguous(), lengths2[lane_f].contiguous(),
                 win_w.contiguous(), rel_lo, rel_hi, K)
        B = B2 // 2

        def fold(x):  # [B2, C] -> [B, 2C]: fwd candidates then rc
            return torch.cat([x[:B], x[B:]], 1)

        score4 = fold(bs["score"].reshape(B2, C))
        q_st = fold(bs["q_st"].reshape(B2, C))
        q_ed = fold(bs["q_ed"].reshape(B2, C))
        ref2 = fold(ref_c)
        diag2 = fold(diag_c)
        score4 = torch.where(ref2 >= 0, score4, -1)
        # the reference's tie order (cly.c:62): an odd best score takes
        # the highest tied ref_ID, an even one the lowest
        s_max = score4.amax(1)
        odd = (s_max & 1) == 1
        at_max = score4 == s_max[:, None]
        r_hi = torch.where(at_max, ref2, -1).amax(1)
        r_lo = torch.where(at_max, ref2, n_ref + 1).amin(1)
        r_best = torch.where(odd, r_hi, r_lo)
        chosen = at_max & (ref2 == r_best[:, None])
        cb = torch.argmax(chosen.to(I32), 1, keepdim=True)
        ref_b = torch.where(s_max > 0, ref2.gather(1, cb)[:, 0], -1)
        rc = ref_b.clamp(0, n_ref - 1).long()
        pos = (diag2.gather(1, cb)[:, 0] + q_st.gather(1, cb)[:, 0]
               - ra.ref_offset[rc])
        other = (ref2 != ref_b[:, None]) & (ref2 >= 0)
        score_alt = torch.where(other, score4, -1).amax(1)
        cb = cb[:, 0]
        return dict(
            score=torch.clamp(s_max, min=0),
            ref=ref_b,
            direction=torch.where(cb >= C, 0, 1),  # 1 = forward (cly.h)
            cov=torch.clamp(q_ed.gather(1, cb[:, None])[:, 0]
                            - q_st.gather(1, cb[:, None])[:, 0], min=0),
            pos=torch.where(ref_b >= 0, pos, -1),
            score_alt=torch.clamp(score_alt, min=0),
        )

    return stage1, stage2, stage3, stage4


def build_full(lek: int, sbm: int, mask_bits: int, min_match: int,
               nw0: int = 0, ops=KERNEL_OPS):
    """The whole pipeline (stage 0, stages 1-4, result pack) as one call:
    full(fm, loc, ra, w01, packed, lens) -> int32[7, Bp]."""
    s1, s2, s3, s4 = build_stages(lek, sbm, mask_bits, min_match, nw0, ops)

    def full(fm, loc, ra, w01, packed, lens):
        codes2, lengths2 = stage0_unpack(packed, lens)
        lo26, kidx, runlen, n_exist = s1(w01, codes2, lengths2)
        codes_i = codes2.to(I32)
        fsp, hit, tot, qleft, sel = s2(fm, codes_i, lengths2, lo26, kidx,
                                       runlen)
        B2, W = codes2.shape
        nwR = kidx.shape[1] * ROWS_PER_SEARCH
        ref_c, diag_c, vote_c = s3(fm, loc, lengths2, fsp, hit, tot, qleft,
                                   sel, B2=B2, nwR=nwR)
        out = s4(ra, _read_words(packed), lengths2, ref_c, diag_c, vote_c,
                 B2=B2, K=2 * _band(W) + 16)
        B = B2 // 2
        ne = n_exist[:B] + n_exist[B:]
        return torch.stack([out[k].to(I32) for k in PACK_KEYS] + [ne])

    return full


class DeviceResult:
    """A chunk's [7, Bp] int32 result on the device; np.asarray copies it
    to the host (the inherited drain calls np.asarray on it)."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        a = self.t.cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


class FastClassifier(_ref.FastClassifier):
    """The JAX package's FastClassifier with its device program run by
    torch on `device` (required: "cuda", "cuda:N" or "cpu"; never chosen
    for the caller). On a CUDA device the three hand kernels run; on the
    CPU, their plain versions. plain=True runs the plain versions on any
    device."""

    def __init__(self, oi, min_score: int = DEFAULT_MIN_SCORE,
                 filter_min_length: int = DEFAULT_FILTER_MIN_LENGTH,
                 mesh=None, exact_fallback: bool = True,
                 fallback_threads: int | None = None,
                 max_width: int = 8192, amb_margin: int | None = None, *,
                 device, plain: bool = False, tables=None):
        from desamba_tpu.index.tensor_index import from_oracle_index

        from ..convert import build_tables

        if amb_margin is None:
            amb_margin = (AMB_MARGIN if oi.L < AMB_LARGE_L
                          else AMB_MARGIN_LARGE)
        self.device = torch.device(device)
        self.oi = oi
        if tables is None:
            tables = build_tables(from_oracle_index(oi), self.device)
        self.fm, self.ek, self.loc, self.ra = tables
        self.min_score = min_score
        self.filter_min_length = filter_min_length
        self._full = build_full(
            self.ek.lek, self.ek.single_base_max, self.ek.mask_bits,
            min_match=20, nw0=self.ek.n_words0,
            ops=PLAIN_OPS if plain else KERNEL_OPS)
        self._code = np.full(256, 1, np.uint8)
        for j, b in enumerate(b"ACGT"):
            self._code[b] = j
        for j, b in enumerate(b"acgt"):
            self._code[b] = j
        self.mesh = mesh
        if mesh is not None:
            self._shard_stages(mesh)
        self.exact_fallback = exact_fallback
        self.amb_margin = amb_margin
        self.max_width = max_width
        self._fallback_threads = fallback_threads or min(
            8, os.cpu_count() or 1)
        self._native = None  # built lazily on first ambiguous read
        self._replay_lock = threading.Lock()
        self.stats = dict(n_reads=0, n_fallback=0)

    def _run(self, packed, lens):
        p = torch.from_numpy(packed).to(self.device)
        ln = torch.from_numpy(lens).to(self.device)
        return DeviceResult(self._full(self.fm, self.loc, self.ra,
                                       self.ek.w01, p, ln))

    def _shard_stages(self, mesh):
        raise NotImplementedError(
            "multi-GPU data parallel is not ported yet (ROADMAP queue 1 "
            "item 9)")

    def _run_mesh(self, packed, lens):
        raise NotImplementedError(
            "multi-GPU data parallel is not ported yet (ROADMAP queue 1 "
            "item 9)")
