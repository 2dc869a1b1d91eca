"""Device-resident batched classifier ("fast mode") on PyTorch.

Counterpart of desamba_tpu/engine/fast_engine.py. The stages are the JAX
package's, step for step, with the same static schedule and caps:

  stage0  2-bit unpack of the per-read fwd|rc packed rows (ops/unpack, a
          hand CUDA kernel)
  stage1  exist-filter probe + per-window top seed (ops/seeds.stage1, a
          hand CUDA kernel)
  stage2  FM backward interval search from the hash13 head start and the
          per-row LF walks, each as burst / compact / resume (ops/fm's
          two loops resume through ops/compact's index lists; all four
          are hand CUDA kernels)
  stage3  SA-sample resolution and reference positions (ops/locate.locate)
          and the windowed diagonal vote (ops/vote.vote), each a hand CUDA
          kernel
  stage4  candidate windows (ops/rescore.band_windows), SWAR banded
          rescore (ops/matchblock) and the strand + candidate combine in
          the reference's odd/even tie order (ops/rescore.combine), each a
          hand CUDA kernel

Every stage is integer-only, so a stage's output equals the JAX stage's
element for element. Where JAX clamps an out-of-range gather index or
drops an out-of-range scatter, the code here clamps or pads explicitly.

`FastClassifier` is the host side of the JAX package's classifier, method
for method: the gate, width bucketing, long-read block partitioning,
result formatting and the exact native replay of ambiguous reads.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (AMB_LARGE_L, AMB_MARGIN, AMB_MARGIN_LARGE,
                         AMB_MIN_EXIST, DEFAULT_FILTER_MIN_LENGTH,
                         DEFAULT_MIN_SCORE, FILTER_MIN_SCORE_2G,
                         FILTER_MIN_SCORE_SHORT_3G, FM_EXT_CAP, IV_BURST,
                         IV_MID, LONG_OVERLAP, NGS_MAX_READ_L, PACK_KEYS,
                         REFPOS_PER_ANCHOR, ROWS_PER_SEARCH, SHORT_3G_READ_L,
                         STEP_EK, WALK_BURST, WALK_MID, WALK_TAIL, _band,
                         _bucket, _pow2)
from ..ops.compact import compact, compact_plain, row_grid, row_grid_plain
from ..ops.fm import (interval_search_plain, interval_search_state, iv_init,
                      row_walks_plain, row_walks_state)
from ..ops.locate import locate as locate_op
from ..ops.locate import locate_plain
from ..ops.matchblock import band_score_packed, band_score_packed_plain
from ..ops.rescore import (band_windows, band_windows_plain, combine,
                           combine_plain)
from ..ops.seeds import stage1 as stage1_op
from ..ops.seeds import stage1_plain
# stage 0's two steps, also under the JAX module's names
from ..ops.unpack import read_words as _read_words  # noqa: F401
from ..ops.unpack import stage0_unpack, unpack, unpack_plain  # noqa: F401
from ..ops.vote import vote, vote_plain

I32 = torch.int32
# the functions the stages call, by kernel name (kernels.KERNELS): the
# wrappers, which launch the hand kernels on CUDA tensors, or their plain
# torch versions on any device (to check the kernel path)
KERNEL_OPS = dict(unpack=unpack, stage1=stage1_op,
                  interval_search=interval_search_state, compact=compact,
                  row_grid=row_grid, row_walks=row_walks_state,
                  locate=locate_op, vote=vote,
                  band_windows=band_windows,
                  band_score_packed=band_score_packed, combine=combine)
PLAIN_OPS = dict(unpack=unpack_plain, stage1=stage1_plain,
                 interval_search=interval_search_plain,
                 compact=compact_plain, row_grid=row_grid_plain,
                 row_walks=row_walks_plain, locate=locate_plain,
                 vote=vote_plain, band_windows=band_windows_plain,
                 band_score_packed=band_score_packed_plain,
                 combine=combine_plain)


def compaction_caps(S: int) -> tuple[int, int, int, int, int]:
    """Stage 2's compaction caps for S seed lanes: (NC2, NC3) of the
    interval search's two resumes, then (NC, NCW, NCW2) of the row walks'
    start over the S * ROWS_PER_SEARCH row grid and their two resumes."""
    NC2, NC3 = max(128, S // 8), max(128, S // 32)
    NC = max(256, S * ROWS_PER_SEARCH // 4)
    NCW = max(128, NC // 4)
    return NC2, NC3, NC, NCW, max(128, NCW // 4)


def build_stages(lek: int, sbm: int, mask_bits: int, min_match: int,
                 nw0: int = 0, ops=KERNEL_OPS):
    """Returns (stage1, stage2, stage3, stage4) closed over the static
    exist-filter parameters; `ops` is KERNEL_OPS or PLAIN_OPS."""
    s1, iv, cp, rg, rw, lc, vt, bw, bsp, cmb = (ops[k] for k in (
        "stage1", "interval_search", "compact", "row_grid", "row_walks",
        "locate", "vote", "band_windows", "band_score_packed", "combine"))

    def stage1(w01, codes2, lengths2):
        """(lo26, kidx, runlen, n_exist) of the STEP_EK probe grid."""
        return s1(w01, codes2, lengths2, lek, sbm, mask_bits, nw0)

    def stage2(fm, codes_i, lengths2, lo26, kidx, runlen):
        B2, W = codes_i.shape
        dev = codes_i.device
        n_win = kidx.shape[1]
        S = B2 * n_win
        lane = torch.arange(S, dtype=I32, device=dev) // n_win
        lane_l = lane.long()
        sk = kidx.reshape(S)
        rl = runlen.reshape(S)
        s_idx = STEP_EK * sk + (STEP_EK - 1 + lek - 1)
        seed_ok = (rl > 0) & (s_idx < lengths2[lane_l])
        pre = lo26[lane_l, sk.long()].long()
        sp0 = torch.where(seed_ok, fm.hash13[pre], 0)
        ep0 = torch.where(seed_ok, fm.hash13[pre + 1], 0)
        max_rst_a = torch.full((S,), ROWS_PER_SEARCH, dtype=I32, device=dev)
        l_min_a = torch.full((S,), min_match, dtype=I32, device=dev)
        l_max_a = torch.clamp(s_idx, max=13 + FM_EXT_CAP).to(I32)
        NC2, NC3, NC, NCW, NCW2 = compaction_caps(S)
        # burst on all S lanes, then resume the first NC2 still live, then
        # the first NC3 of those, in place in the full carry: a live lane
        # past a cap keeps its carry (JAX's truncation at the cut)
        args = (fm, codes_i, lane, max_rst_a, l_min_a, l_max_a)
        st = iv(*args, iv_init(sp0, ep0, s_idx), IV_BURST)
        sel2 = cp(st[6], NC2)
        st = iv(*args, st, IV_MID, sel=sel2)
        st = iv(*args, st, 4096, sel=cp(st[6], NC3, src=sel2))
        # the first NC valid rows of the final intervals (status 1, depth
        # cap or read start, is a hit too) and the per-row single-interval
        # extension (bwt_single_search analog) on them, in the same three
        # burst / cut phases over the [5, NC] walk carry
        sel, stw, (wlanes, wlens, ml_c, s_c) = rg(st, seed_ok, lane, s_idx,
                                                  NC)
        stw = rw(fm, codes_i, wlanes, wlens, stw, WALK_BURST)
        selw = cp(stw[3], NCW)
        stw = rw(fm, codes_i, wlanes, wlens, stw, WALK_MID, sel=selw)
        stw = rw(fm, codes_i, wlanes, wlens, stw, WALK_TAIL,
                 sel=cp(stw[3], NCW2, src=selw))
        final_sp, steps, badw = stw[0], stw[2], stw[4]
        total_c = ml_c + 1 + steps
        hit_c = ((sel < S * ROWS_PER_SEARCH) & (total_c >= min_match)
                 & (badw == 0))
        qleft_c = s_c - total_c + 1
        # all [NC]-compacted; sel maps back to the (seed-window, row) grid
        return final_sp, hit_c, total_c, qleft_c, sel

    def stage3(fm, loc, lengths2, fsp_c, hit_c, total_c, qleft_c, sel,
               B2: int, nwR: int):
        """Anchor resolution (locate) and the exact windowed diagonal vote
        (vote) on the compacted lanes; sel // nwR is the read row (B2 for
        unused slots, dropped) and sel % nwR the anchor slot in the dense
        [B2, A] layout. Returns (ref_c, diag_c, vote_c), int32[B2, 3]."""
        ref, gpos, pvalid = lc(fm, loc, fsp_c, hit_c, REFPOS_PER_ANCHOR)
        return vt(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2, B2,
                  nwR)

    def stage4(ra, read_w2, lengths2, ref_c, diag_c, vote_c, B2: int,
               K: int):
        """Banded rescore of every candidate and the strand + candidate
        combine with the reference's tie order. K is the full band-score
        width 2*band + 16 (band start aligned down to a 16-code word).
        Returns {PACK_KEYS[i]: row i} of the combine's int32[6, B]."""
        bs = bsp(*bw(ra, read_w2, lengths2, ref_c, diag_c, K), K)
        out = cmb(ra, bs["score"], bs["q_st"], bs["q_ed"], ref_c, diag_c)
        return dict(zip(PACK_KEYS, out))

    return stage1, stage2, stage3, stage4


def build_full(lek: int, sbm: int, mask_bits: int, min_match: int,
               nw0: int = 0, ops=KERNEL_OPS):
    """The whole pipeline (stage 0, stages 1-4, result pack) as one call:
    full(fm, loc, ra, w01, packed, lens) -> int32[7, Bp]."""
    s1, s2, s3, s4 = build_stages(lek, sbm, mask_bits, min_match, nw0, ops)
    s0 = ops["unpack"]

    def full(fm, loc, ra, w01, packed, lens):
        codes2, codes_i, read_w2, lengths2 = s0(packed, lens)
        lo26, kidx, runlen, n_exist = s1(w01, codes2, lengths2)
        fsp, hit, tot, qleft, sel = s2(fm, codes_i, lengths2, lo26, kidx,
                                       runlen)
        B2, W = codes2.shape
        nwR = kidx.shape[1] * ROWS_PER_SEARCH
        ref_c, diag_c, vote_c = s3(fm, loc, lengths2, fsp, hit, tot, qleft,
                                   sel, B2=B2, nwR=nwR)
        out = s4(ra, read_w2, lengths2, ref_c, diag_c, vote_c, B2=B2,
                 K=2 * _band(W) + 16)
        B = B2 // 2
        return torch.stack([*out.values(), n_exist[:B] + n_exist[B:]])

    return full


class DeviceResult:
    """A chunk's [7, Bp] int32 result on the device; np.asarray copies it
    to the host."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        a = self.t.cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


@dataclass
class FastResult:
    name: str
    ref_ID: int      # -1 = unclassified
    direction: int
    score: int       # band-MEM score (reference sum_score scale)
    read_len: int
    pos: int = -1    # 0-based position in the reference (approximate)


def _score_threshold(read_len: int, filter_min_score: int,
                     filter_min_length: int) -> tuple[int, int]:
    """(thr, long_thr) of the reference's final filter ladder
    (delete_small_score_rst, cly.c:2955-2981): a read is kept if score' >=
    thr, or, for long reads, if score' >= filter_min_score and coverage >=
    filter_min_length (score' = sum_score + (cov >> 5))."""
    if read_len < SHORT_3G_READ_L:
        return FILTER_MIN_SCORE_SHORT_3G, 0
    if read_len < NGS_MAX_READ_L:
        return FILTER_MIN_SCORE_2G, 0
    return filter_min_score + 10, filter_min_score


def _unpack_rows(arr: np.ndarray, B: int) -> dict:
    """Inverse of the device-side [7, Bp] pack."""
    res = {k: arr[i, :B] for i, k in enumerate(PACK_KEYS)}
    res["n_exist"] = arr[6, :B]
    return res


class FastClassifier:
    """Resident-index batched classifier on one torch `device` ("cuda",
    "cuda:N" or "cpu"; required, never chosen for the caller). On a CUDA
    device the hand kernels run; on the CPU, their plain versions.
    plain=True runs the plain versions on any device.

    With `mesh` (parallel.make_mesh: the ranks of a process group), each
    chunk's rows are split over the mesh's ranks: every rank encodes the
    same chunk, runs its own block of rows on mesh.device (the default
    device; any other raises) and gathers the others' results, so every
    rank returns the whole batch's results. Every rank calls
    classify_batch on the same reads.

    `idx` is a HostIndex (index.loader.load_index). Reads are called by
    the reference's final-filter thresholds on the stage-4 band score.
    With exact_fallback=True, reads the device pipeline cannot call
    unambiguously (near-tied cross-genome scores, threshold-border
    scores, exist-filter seeds without anchors) are replayed through the
    bit-exact native engine, as the reference splits fast_classify and
    slow_classify (cly.c:3098-3122); .stats counts the replays."""

    mesh = None  # the data mesh, where __init__ is given one

    def __init__(self, idx, min_score: int = DEFAULT_MIN_SCORE,
                 filter_min_length: int = DEFAULT_FILTER_MIN_LENGTH,
                 mesh=None, exact_fallback: bool = True,
                 fallback_threads: int | None = None,
                 max_width: int = 8192, amb_margin: int | None = None, *,
                 device=None, plain: bool = False, tables=None):
        from ..convert import build_tables
        from ..parallel.mesh import as_device

        if mesh is not None:
            if device is None:
                device = mesh.device
            elif as_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
        elif device is None:
            raise TypeError("FastClassifier needs a device (or a mesh)")
        self.mesh = mesh
        if amb_margin is None:
            amb_margin = (AMB_MARGIN if idx.L < AMB_LARGE_L
                          else AMB_MARGIN_LARGE)
        self.device = torch.device(device)
        self.idx = idx
        if tables is None:
            tables = build_tables(idx, self.device)
        self.fm, self.ek, self.loc, self.ra = tables
        self._full = build_full(
            self.ek.lek, self.ek.single_base_max, self.ek.mask_bits,
            min_match=20, nw0=self.ek.n_words0,
            ops=PLAIN_OPS if plain else KERNEL_OPS)
        self._init_host(min_score, filter_min_length, exact_fallback,
                        fallback_threads, max_width, amb_margin)

    def _init_host(self, min_score, filter_min_length, exact_fallback,
                   fallback_threads, max_width, amb_margin):
        """The host side's settings and state: the filter thresholds, the
        2-bit code table, the replay's settings and lock, the stats."""
        self.min_score = min_score
        self.filter_min_length = filter_min_length
        self._code = np.full(256, 1, np.uint8)
        for j, b in enumerate(b"ACGT"):
            self._code[b] = j
        for j, b in enumerate(b"acgt"):
            self._code[b] = j
        self.exact_fallback = exact_fallback
        self.amb_margin = amb_margin
        self.max_width = max_width
        self._fallback_threads = fallback_threads or min(
            8, os.cpu_count() or 1)
        self._native = None  # built on the first ambiguous read
        self._replay_lock = threading.Lock()
        self.stats = dict(n_reads=0, n_fallback=0)

    def _run(self, packed, lens):
        p = torch.from_numpy(packed).to(self.device)
        ln = torch.from_numpy(lens).to(self.device)
        return DeviceResult(self._full(self.fm, self.loc, self.ra,
                                       self.ek.w01, p, ln))

    def _run_mesh(self, packed, lens):
        """The chunk's rows split over the mesh's ranks: this rank runs
        rows [rank * Bp / n, (rank + 1) * Bp / n) and gathers every rank's
        [7, Bl] block in rank order, which is read order. Each rank
        derives both strands of its own rows, so the blocks join as they
        are (JAX's shard_map over 'data', where the stage-2 caps also
        scale with a shard's rows). The gather runs on the stream the
        pipeline ran on."""
        import torch.distributed as dist

        n, r = self.mesh.n_data, self.mesh.rank
        Bp = packed.shape[0]
        lo, hi = r * Bp // n, (r + 1) * Bp // n
        mine = self._run(packed[lo:hi], lens[lo:hi]).t
        blocks = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(blocks, mine, group=self.mesh.group)
        return DeviceResult(torch.cat(blocks, 1))

    # ------------------------------------------------------------ encode --
    def _encode(self, reads, W: int | None = None, Bp: int | None = None):
        """Encode into the 2-bit wire format (stage0_unpack) at width W and
        row count Bp (default: the reads' width bucket and the next power
        of two). Returns (packed uint8[Bp, W//2], lens_p int32[Bp], lens
        int32[B]): per read row, forward codes then reverse-complement
        codes, 4 codes a byte, LSB first."""
        lens = np.array([len(r[1]) for r in reads], np.int32)
        if W is None:
            W = _bucket(max(int(lens.max()), self.ek.lek + 2))
        B = len(reads)
        if Bp is None:
            Bp = _pow2(B, 8)
        flat = self._code[np.frombuffer(
            b"".join(r[1] for r in reads), np.uint8)]
        inv = 3 - flat
        off = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
        codes = np.zeros((Bp, 2 * W), np.uint8)
        # a contiguous copy per read row beats one 2D fancy scatter
        for i in range(B):
            o0, o1 = off[i], off[i + 1]
            codes[i, : o1 - o0] = flat[o0:o1]
            codes[i, W : W + o1 - o0] = inv[o0:o1][::-1]
        packed = (codes[:, 0::4] | (codes[:, 1::4] << 2)
                  | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
        lens_p = np.zeros(Bp, np.int32)
        lens_p[:B] = lens
        return packed, lens_p, lens

    # ---------------------------------------------------------- classify --
    def classify_batch(self, reads, block: int = 512) -> list[FastResult]:
        """Pipelined batch classify (the kt_pipeline analog,
        lib/kthread.c:157-197): chunk i+1 is encoded and launched before
        chunk i is drained and formatted, and ambiguous reads are replayed
        on a worker thread while later chunks compute. Reads are grouped
        by width bucket; full chunks have `block` rows, a partial tail its
        own power of two."""
        out: list = [None] * len(reads)
        by_bucket: dict[int, list[int]] = {}
        long_ids: list[int] = []
        for i, r in enumerate(reads):
            if len(r[1]) > self.max_width:
                long_ids.append(i)  # block-partitioned below
                continue
            Wb = _bucket(max(len(r[1]), self.ek.lek + 2))
            by_bucket.setdefault(Wb, []).append(i)
        pending: list = []
        # the native engine releases the GIL, so a chunk's replays run
        # while the next chunks compute on the device
        replay_ex = ThreadPoolExecutor(max_workers=1) \
            if self.exact_fallback else None
        replay_futs: list = []

        def drain():
            sub, chunk, lens, handles = pending.pop(0)
            res = _unpack_rows(np.asarray(handles), len(chunk))
            frs, replay = self._format(chunk, lens, res)
            for j, fr in zip(sub, frs):
                out[j] = fr
            if replay:
                idxs = [sub[k] for k, _ in replay]
                rds = [r for _, r in replay]
                replay_futs.append(
                    (idxs, replay_ex.submit(self._replay, rds)))

        try:
            for Wb in sorted(by_bucket):
                ids = by_bucket[Wb]
                for s0 in range(0, len(ids), block):
                    sub = ids[s0 : s0 + block]
                    chunk = [reads[i] for i in sub]
                    Bp = block if len(sub) == block else _pow2(len(sub), 8)
                    if self.mesh is not None:
                        Bp += (-Bp) % self.mesh.n_data  # rows split evenly
                    handles, lens = self._dispatch_chunk(chunk, Wb, Bp)
                    pending.append((sub, chunk, lens, handles))
                    while len(pending) > 1:
                        drain()
            while pending:
                drain()
            if long_ids:
                self._classify_long(reads, long_ids, out, block)
            for idxs, fut in replay_futs:
                for i, fr in zip(idxs, fut.result()):
                    out[i] = fr
        finally:
            if replay_ex is not None:
                replay_ex.shutdown(wait=True)
        return out

    # ------------------------------------------------- very long reads --
    # A read longer than max_width is cut into max_width segments that
    # overlap by LONG_OVERLAP; each segment runs through the same device
    # pipeline and the segment scores are summed per genome (the band
    # score counts read positions, so it adds up over segments; the error
    # a cut or an overlap brings is inside the AMB_MARGIN replay guard).
    def _classify_long(self, reads, ids, out, block):
        SEG = self.max_width
        OV = LONG_OVERLAP
        seg_of: dict[int, list[int]] = {}
        segs: list = []  # (read index, segment start, (name, seq, None))
        for i in ids:
            name, seq, _q = reads[i]
            L = len(seq)
            starts = list(range(0, L - SEG, SEG - OV)) + [L - SEG]
            seg_of[i] = starts
            for s0 in starts:
                segs.append((i, s0, (name, seq[s0 : s0 + SEG], None)))
        rows: dict = {}
        pending: list = []

        def drain():
            sub, handles = pending.pop(0)
            res = _unpack_rows(np.asarray(handles), len(sub))
            for j, (ri, ss, _) in enumerate(sub):
                rows[(ri, ss)] = {k: int(v[j]) for k, v in res.items()}

        Wb = _bucket(SEG)
        for c0 in range(0, len(segs), block):
            sub = segs[c0 : c0 + block]
            chunk = [s[2] for s in sub]
            Bp = block if len(sub) == block else _pow2(len(sub), 8)
            if self.mesh is not None:
                Bp += (-Bp) % self.mesh.n_data
            handles, _lens = self._dispatch_chunk(chunk, Wb, Bp)
            pending.append((sub, handles))
            while len(pending) > 1:
                drain()
        while pending:
            drain()

        replay = []
        self.stats["n_reads"] += len(ids)
        for i in ids:
            name, seq, qual = reads[i]
            L = len(seq)
            acc: dict[int, int] = {}
            cov: dict[int, int] = {}
            dirv: dict[tuple, int] = {}
            best_pos: dict[int, tuple] = {}  # rid -> (seg score, read pos)
            n_exist = 0
            # the sum of the per-segment other-genome scores bounds the
            # total of a genome that narrowly loses every segment
            alt_floor = 0
            for ss in seg_of[i]:
                row = rows[(i, ss)]
                n_exist += row["n_exist"]
                alt_floor += row["score_alt"]
                rid = row["ref"]
                if rid >= 0 and row["score"] > 0:
                    acc[rid] = acc.get(rid, 0) + row["score"]
                    cov[rid] = cov.get(rid, 0) + row["cov"]
                    dirv[(rid, row["direction"])] = dirv.get(
                        (rid, row["direction"]), 0) + row["score"]
                    # the segment at read offset ss sits at offset
                    # L - SEG - ss of the reverse-complement strand
                    s_off = ss if row["direction"] == 1 else L - SEG - ss
                    cand = (row["score"], max(row["pos"] - s_off, 0))
                    if rid not in best_pos or cand > best_pos[rid]:
                        best_pos[rid] = cand
            if acc:
                rid = max(acc, key=lambda r: (acc[r], -r))
                sc = acc[rid]
                second = max([v for r, v in acc.items() if r != rid],
                             default=0)
                second = max(second, alt_floor)
                cv = cov[rid]
                eff = sc + (cv >> 5)
                thr, long_thr = _score_threshold(
                    L, self.min_score, self.filter_min_length)
                ok = eff >= thr or (long_thr and eff >= long_thr
                                    and cv >= self.filter_min_length)
                d = max((k for k in dirv if k[0] == rid),
                        key=lambda k: dirv[k])[1]
                ambiguous = (ok and sc - second <= self.amb_margin) or (
                    not ok and eff >= thr - self.amb_margin)
            else:
                rid, sc, d, ok = -1, 0, 0, False
                ambiguous = n_exist >= AMB_MIN_EXIST
            if self.exact_fallback and ambiguous:
                replay.append(i)
                continue
            out[i] = FastResult(
                name=name, ref_ID=rid if ok else -1,
                direction=d if ok else 0, score=sc, read_len=L,
                pos=best_pos[rid][1] if (ok and rid in best_pos) else -1)
        if replay:
            self.stats["n_fallback"] += len(replay)
            for i, fr in zip(replay, self._replay([reads[i] for i in replay])):
                out[i] = fr

    def _dispatch_chunk(self, reads, W=None, Bp=None):
        """Encode and launch the device pipeline; returns (DeviceResult,
        lens) without waiting for the device."""
        packed, lens_p, lens = self._encode(reads, W=W, Bp=Bp)
        if self.mesh is not None:
            assert packed.shape[0] % self.mesh.n_data == 0, \
                "the chunk's rows must split evenly over the mesh"
            return self._run_mesh(packed, lens_p), lens
        return self._run(packed, lens_p), lens

    def _format(self, reads, lens, res):
        """Format one chunk's device rows. Returns (results, replay), replay
        being the (local index, read) pairs this chunk could not call
        unambiguously; the caller replays them."""
        out = []
        replay = []
        self.stats["n_reads"] += len(reads)
        for i, (name, seq, qual) in enumerate(reads):
            sc = int(res["score"][i])
            rid = int(res["ref"][i])
            rl = int(lens[i])
            cov = int(res["cov"][i])
            eff = sc + (cov >> 5)
            thr, long_thr = _score_threshold(
                rl, self.min_score, self.filter_min_length)
            ok = rid >= 0 and (eff >= thr or (
                long_thr and eff >= long_thr
                and cov >= self.filter_min_length))
            if self.exact_fallback:
                ambiguous = (
                    # another genome scored within tie-order distance
                    (ok and sc - int(res["score_alt"][i]) <= self.amb_margin)
                    # hovering at the filter threshold
                    or (rid >= 0 and not ok and eff >= thr - self.amb_margin)
                    # seeds existed but the device path found no anchors
                    or (rid < 0 and int(res["n_exist"][i]) >= AMB_MIN_EXIST)
                )
                if ambiguous:
                    replay.append((i, (name, seq, qual)))
            out.append(FastResult(
                name=name, ref_ID=rid if ok else -1,
                direction=int(res["direction"][i]) if ok else 0,
                score=sc, read_len=rl,
                pos=int(res["pos"][i]) if ok else -1))
        if replay:
            self.stats["n_fallback"] += len(replay)
        return out, replay

    def _replay(self, reads) -> list[FastResult]:
        """Exact calls of ambiguous reads by the native engine. Serialized:
        classify_batch replays on a worker thread while _classify_long may
        replay from the caller's."""
        with self._replay_lock:
            return self._replay_inner(reads)

    def _replay_engine(self):
        """The exact engine of the replay: the native engine on the
        index."""
        from .native import NativeClassifier

        return NativeClassifier(self.idx, n_threads=self._fallback_threads)

    def _replay_inner(self, reads) -> list[FastResult]:
        if self._native is None:
            self._native = self._replay_engine()
        out = []
        for rr in self._native.classify_batch(reads):
            prim = next((h for h in rr.hits if h.primary == 1), None)
            if prim is None:
                out.append(FastResult(name=rr.name, ref_ID=-1, direction=0,
                                      score=0, read_len=len(rr.seq)))
            else:
                out.append(FastResult(
                    name=rr.name, ref_ID=prim.ref_ID,
                    direction=prim.direction, score=prim.sum_score,
                    read_len=len(rr.seq), pos=prim.t_st))
        return out

    # ------------------------------------------------------------ report --
    def tid_of(self, ref_ID: int) -> int:
        """tid from the 'tid|NNN|...' reference naming convention
        (cly_mt.c:777-786); 0 when unclassified or unnamed."""
        if ref_ID < 0:
            return 0
        parts = self.idx.ref_names[ref_ID].split("|")
        return int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
