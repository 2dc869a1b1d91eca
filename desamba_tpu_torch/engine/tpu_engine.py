"""The bit-exact validation engine: device compute and an exact host
replay (`classify --engine tpu`).

Counterpart of desamba_tpu/engine/tpu_engine.py. For each sub-batch of
reads the device runs three kinds of lockstep work, each a hand CUDA
kernel on the card and its plain torch version elsewhere:
  1. the exist-filter probe of every e-kmer of both strands
     (ops/ekmer.probe_reads, csrc/probe.cu);
  2. FM interval searches for every candidate seed position, speculative
     over the adaptive j-stepping of fast/slow classify
     (ops/fm.interval_search_state, csrc/fm_search.cu);
  3. single-row backward extensions with row traces
     (ops/fm.row_walks_trace, csrc/row_walks.cu).

Each call's outputs come to the host in one copy. The host then replays
the reference's exact control flow from them (island stepping, the
sp_set dedup applied to the walk traces, anchor mapping, chaining, M2
rescoring, filtering, primary detection), falling back on the oracle's
scalar FM search where a walk outran its trace, so the SAM equals the C
reference's byte for byte. This engine proves that the device FM kernels
reproduce the reference; its per-read Python replay makes it far slower
than the fast engine.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (DEFAULT_FILTER_MIN_LENGTH, DEFAULT_MAX_SEC_N,
                         DEFAULT_MIN_SCORE, MEM_SEARCH_FAST,
                         MEM_SEARCH_SLOW, MIN_MEM_LEN_FAST, MIN_MEM_LEN_SLOW,
                         MIN_READ_LEN, PRE_IDX_MASK, SEED_RANGE)
from ..ops.ekmer import EkArrays, probe_reads, probe_reads_plain
from ..ops.fm import (FmArrays, interval_search_plain, interval_search_state,
                      iv_init, row_walks_trace, row_walks_trace_plain)
from ..oracle import classify as ocl
from ..oracle.classify import (FORWARD, MemRst, OracleIndex, ReadResult,
                               SearchDir, SpSet, map_seed, resolve_tree,
                               search_exist_kmer_m2)
from ..oracle.cqsort import qsort_list
from ..oracle.driver import format_sam
from ..oracle.rescore import CBuf, delete_small_score_rst, detect_primary
from ..utils import codec

# the engine's three device calls, by kernel name (kernels.KERNELS): the
# wrappers, which launch the hand kernels on CUDA tensors, or their plain
# torch versions on any device
KERNEL_OPS = dict(probe_reads=probe_reads,
                  interval_search=interval_search_state,
                  row_walks_trace=row_walks_trace)
PLAIN_OPS = dict(probe_reads=probe_reads_plain,
                 interval_search=interval_search_plain,
                 row_walks_trace=row_walks_trace_plain)
MAX_SEARCH_STEPS = 4096  # the interval search's step bound (ops/fm.py:166)
SUB_BATCH = 256  # reads a round of device calls (the JAX engine's sub_batch)


@dataclass
class _Cand:
    """One speculative bwt_MEM_search call (positions lane-local)."""

    lane: int
    s_local: int  # rightmost pattern char within the direction's read
    s_off: int  # direction base offset within the lane's bin2 row
    pre_v: int
    l_min: int
    max_rst: int


def _build_sd(exists, bin_read, kmers, direction) -> SearchDir:
    """get_seed_vector_M2 top-marking from device probe output
    (cly.c:1157-1229)."""
    seeds = search_exist_kmer_m2(exists, direction)
    total_score = 0
    max_index, max_length, index_end = 0, 0, SEED_RANGE
    n_kmer = exists.size
    if seeds:
        for m, s in enumerate(seeds):
            s[2] = 0
            posk = s[0] if direction == FORWARD else (n_kmer - s[0] - s[1])
            if posk < index_end:
                if max_length < s[1]:
                    max_length = s[1]
                    max_index = m
                seeds[max_index][2] = 0
            else:
                seeds[max_index][2] = 1
                index_end += SEED_RANGE
                total_score += max_length
                max_index = m
                max_length = s[1]
        seeds[max_index][2] = 1
        total_score += max_length
    return SearchDir(seeds, bin_read, kmers, direction,
                     total_score & 0xFFFFFFFF)


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device)


class TpuClassifier:
    """Validation classifier on one torch `device` ("cuda", "cuda:N" or
    "cpu"; required, never chosen for the caller): the hand kernels on a
    CUDA device, their plain versions on the CPU or with plain=True.

    `idx` is a HostIndex (index.loader.load_index); the host replay reads
    it through an OracleIndex, which shares its arrays. `fm`, if given, is
    the FmArrays of the same index already on `device` (a
    FastClassifier's), so the FM index sits on the card once. The exist
    filter is this engine's own and never folded: its probes must be the
    reference's bit for bit. .stats counts fm_searches, fm_walks,
    walk_fallback and cand_fallback as the JAX engine does."""

    def __init__(self, idx,
                 filter_min_length: int = DEFAULT_FILTER_MIN_LENGTH,
                 filter_min_score: int = DEFAULT_MIN_SCORE, *, device,
                 plain: bool = False, fm=None):
        self.device = torch.device(device)
        self.oi = OracleIndex(idx, filter_min_length, filter_min_score)
        self.fm = (fm if fm is not None
                   else FmArrays.from_tensor_index(idx, self.device))
        self.ek = EkArrays.from_tensor_index(idx, self.device)
        self.ops = PLAIN_OPS if plain else KERNEL_OPS
        self.stats = defaultdict(int)

    # ---------------------------------------------------------- probes ----
    def _probe_batch(self, reads):
        lek = self.oi.lek
        lens = np.array([len(s) for _, s, _ in reads], dtype=np.int32)
        W = max(int(lens.max()), lek + 1)
        B = len(reads)
        codes = np.zeros((2 * B, W), np.uint8)
        bin2s = []
        for i, (_, seq, _) in enumerate(reads):
            f = codec_seq(seq)
            r = (3 - f[::-1]).astype(np.uint8)
            codes[i, : f.size] = f
            codes[B + i, : r.size] = r
            bin2s.append(np.concatenate([f, r]))
        ex = self.ops["probe_reads"](
            self.ek, torch.from_numpy(codes).to(self.device),
            _i32(np.concatenate([lens, lens]), self.device)).cpu().numpy()
        return bin2s, ex[:B], ex[B:], lens

    # ------------------------------------------------------- fm batches ----
    def _run_fm(self, cands: list[_Cand], bin2_mat: torch.Tensor):
        """One interval search over every candidate, then one traced walk
        of every row of the intervals that hit, each lane reading its
        read's row of bin2_mat (int32, 255 past each read's 2L codes)."""
        if not cands:
            return []
        oi, dev = self.oi, self.device
        nC = len(cands)
        field = lambda k: np.array([getattr(c, k) for c in cands], np.int64)
        s_local, lanes = field("s_local"), field("lane")
        pre = field("pre_v")
        st = iv_init(_i32(oi.hash13[pre], dev), _i32(oi.hash13[pre + 1], dev),
                     _i32(field("s_off") + s_local, dev))
        st = self.ops["interval_search"](
            self.fm, bin2_mat, _i32(lanes, dev), _i32(field("max_rst"), dev),
            _i32(field("l_min"), dev), _i32(s_local, dev), st,
            MAX_SEARCH_STEPS).cpu().numpy().astype(np.int64)
        nsp, nep, ml, ptr, stt = st[2], st[3], st[4], st[5], st[7]
        self.stats["fm_searches"] += nC
        # every row of each hit interval, in candidate then row order
        n_rows = np.where((stt != 1) & (nsp < nep), nep - nsp, 0)
        owner = np.repeat(np.arange(nC), n_rows)
        walk_rows = nsp[owner] + np.arange(owner.size) - np.repeat(
            np.cumsum(n_rows) - n_rows, n_rows)
        walks_by_cand = defaultdict(dict)
        if owner.size:
            self.stats["fm_walks"] += owner.size
            wr = self.ops["row_walks_trace"](
                self.fm, bin2_mat, _i32(lanes[owner], dev),
                _i32(walk_rows, dev), _i32(ptr[owner], dev),
                _i32(np.maximum(0, s_local[owner] - ml[owner]), dev))
            trace = wr["trace"].cpu().numpy()
            steps, over, stop_max = torch.stack(
                [wr["steps"], wr["overflow"], wr["stop_max"]]).cpu().numpy()
            for k, i in enumerate(owner.tolist()):
                walks_by_cand[i][int(walk_rows[k])] = dict(
                    steps=int(steps[k]), trace=trace[k],
                    overflow=bool(over[k]), stop_max=bool(stop_max[k]),
                )
        return [dict(status=int(stt[i]), nsp=int(nsp[i]), nep=int(nep[i]),
                     match_len=int(ml[i]), ptr=int(ptr[i]),
                     walks=walks_by_cand.get(i, {}))
                for i in range(nC)]

    # ---------------------------------------------------------- replay ----
    def _replay_mem_search(self, dev, cand: _Cand, bin2, sp_set: SpSet, out):
        """bwt_MEM_search tail (cly.c:1418-1441) from device outputs."""
        if dev["status"] == 1:
            return 0
        nsp, nep = dev["nsp"], dev["nep"]
        if nsp >= nep:
            return 0
        n0 = len(out)
        ml = dev["match_len"]
        single = nsp + 1 == nep
        for row in range(nsp, nep):
            if not sp_set.insert(row):
                if single:
                    return 0
                continue
            w = dev["walks"].get(row)
            if w is None or w["overflow"]:
                self.stats["walk_fallback"] += 1
                m = MemRst()
                ocl.bwt_single_search(self.oi, row, dev["ptr"], bin2,
                                      max(0, cand.s_local - ml), sp_set, m)
            else:
                m = self._walk_from_trace(row, w, sp_set)
            m.match_len += ml + 1
            if m.match_len >= cand.l_min:
                out.append(m)
        return len(out) - n0

    @staticmethod
    def _walk_from_trace(start_row, w, sp_set: SpSet) -> MemRst:
        m = MemRst()
        steps = w["steps"]
        trace = w["trace"]
        for k in range(steps):  # dedup replay (cly.c:1366-1371)
            if not sp_set.insert(int(trace[k])):
                m.match_len = -1000
                return m
        visited = [start_row] + [int(trace[k]) for k in range(steps)]
        sa_rows = visited if not w["stop_max"] else visited[:-1]
        sa_sp, sa_sp_l = -1, 0
        for v in sa_rows:  # sa tracking (cly.c:1353-1359)
            if v % 8 == 0:
                sa_sp, sa_sp_l = v, 0
            else:
                sa_sp_l -= 1
        m.sp = visited[-1]
        m.match_len = steps
        m.sa_sp = sa_sp
        m.sa_sp_l = sa_sp_l
        return m

    # --------------------------------------------------------- classify ----
    def _collect(self, mode, which_dirs, sds, lens, lek):
        cands, keys = [], []
        min_index = MIN_MEM_LEN_FAST - lek
        for i in range(len(lens)):
            if lens[i] < MIN_READ_LEN or not which_dirs[i]:
                continue
            for dpos in which_dirs[i]:
                sd = sds[i][dpos]
                off = 0 if sd.direction == FORWARD else int(lens[i])
                for si, s in enumerate(sd.seeds):
                    if mode == "fast":
                        if not s[2]:
                            continue
                        lo = min_index
                        l_min, max_rst = MIN_MEM_LEN_FAST - 1, MEM_SEARCH_FAST
                    else:
                        if s[1] < 3 and not (sd.seeds[0][2] if sd.seeds else 0):
                            continue
                        lo = 1
                        l_min = min(MIN_MEM_LEN_SLOW - 1, lek + 1)
                        max_rst = MEM_SEARCH_SLOW
                    for j in range(lo, s[1]):
                        kidx = s[0] + j
                        pv = int(sd.kmers[kidx] & np.uint64(PRE_IDX_MASK))
                        sidx = kidx + lek - 1
                        cands.append(_Cand(i, sidx, off, pv, l_min, max_rst))
                        keys.append((i, dpos, si, j, mode))
        return cands, keys

    def _classify_sub(self, reads):
        oi = self.oi
        lek = oi.lek
        bin2s, exF, exR, lens = self._probe_batch(reads)
        B = len(reads)
        sds = []
        for i in range(B):
            L = int(lens[i])
            if L < lek + 1:
                sds.append(None)
                continue
            n_kmer = L - lek + 1
            f = bin2s[i][:L]
            r = bin2s[i][L:]
            kf = ocl.store_kmers(f, n_kmer, lek, oi.single_base_max)
            kr = ocl.store_kmers(r, n_kmer, lek, oi.single_base_max)
            sd0 = _build_sd(exF[i][:n_kmer], f, kf, FORWARD)
            sd1 = _build_sd(exR[i][:n_kmer], r, kr, 1 - FORWARD)
            if sd0.total_score < sd1.total_score:
                sd0, sd1 = sd1, sd0
            sds.append((sd0, sd1))
        W2 = max(b.size for b in bin2s)
        bin2_mat = np.full((B, W2), 255, np.int32)
        for i, b in enumerate(bin2s):
            bin2_mat[i, : b.size] = b
        bin2_mat = torch.from_numpy(bin2_mat).to(self.device)

        both = [False] * B
        fast_dirs = [[] for _ in range(B)]
        for i in range(B):
            if sds[i] is None or lens[i] < MIN_READ_LEN:
                continue
            sd0, sd1 = sds[i]
            both[i] = ((sd0.total_score - sd1.total_score) & 0xFFFFFFFF) <= (
                sd0.total_score >> 3
            )
            fast_dirs[i] = [0, 1] if both[i] else [0]
        cands, keys = self._collect("fast", fast_dirs, sds, lens, lek)
        fast_tab = dict(zip(keys, self._run_fm(cands, bin2_mat)))

        results = []
        anchors_by_read = {}
        sr_by_read = {}
        slow_needed = []
        for i, (name, seq, qual) in enumerate(reads):
            res = ReadResult(name=name, seq=seq, qual=qual or b"")
            results.append(res)
            if lens[i] < MIN_READ_LEN or sds[i] is None:
                continue
            anchors = []
            sr = self._fast_replay(i, 0, sds, bin2s[i], int(lens[i]), fast_tab, anchors)
            if both[i]:
                sr += self._fast_replay(i, 1, sds, bin2s[i], int(lens[i]), fast_tab, anchors)
            resolve_tree(res, anchors)
            run_slow = False
            if len(res.hits) <= 0:
                run_slow = True
            elif res.hits[0].anchor_number < 5 and sr < 3:
                run_slow = True
                if lens[i] <= 300 and res.hits[0].sum_score > 200:
                    run_slow = False
            anchors_by_read[i] = anchors
            sr_by_read[i] = sr
            if run_slow:
                slow_needed.append(i)

        if slow_needed:
            slow_dirs = [[] for _ in range(B)]
            for i in slow_needed:
                slow_dirs[i] = [0, 1]  # speculate both directions
            cands, keys = self._collect("slow", slow_dirs, sds, lens, lek)
            slow_tab = dict(zip(keys, self._run_fm(cands, bin2_mat)))
            for i in slow_needed:
                res = results[i]
                anchors = []
                self._slow_replay(i, 0, sds, bin2s[i], int(lens[i]), slow_tab, anchors)
                resolve_tree(res, anchors)
                res.fast_classify = False
                if (
                    both[i]
                    or len(res.hits) <= 0
                    or (res.hits[0].anchor_number < 5 and sr_by_read[i] < 3)
                ):
                    self._slow_replay(i, 1, sds, bin2s[i], int(lens[i]), slow_tab, anchors)
                    resolve_tree(res, anchors)
                anchors_by_read[i] = anchors
        for i, res in enumerate(results):
            res.n_anchor = len(anchors_by_read.get(i, []))
        return results, sds, bin2s, lens

    def _fast_replay(self, i, dpos, sds, bin2, read_len, tab, anchors):
        """fast_classify (cly.c:1471-1541) consuming device FM results."""
        oi = self.oi
        lek = oi.lek
        min_index = MIN_MEM_LEN_FAST - lek
        sd = sds[i][dpos]
        off = 0 if sd.direction == FORWARD else read_len
        sp_set = SpSet()
        sv = sd.seeds
        ci = 0
        read_view = bin2[off : off + read_len]
        while ci < len(sv):
            c_sv = sv[ci]
            if not c_sv[2]:
                ci += 1
                continue
            sp_set.reset()
            a_b_idx = len(anchors)
            j = c_sv[1] - 1
            while j >= min_index:
                kidx = c_sv[0] + j
                sidx = kidx + lek - 1
                dev = tab.get((i, dpos, ci, j, "fast"))
                mr: list[MemRst] = []
                if dev is None:
                    self.stats["cand_fallback"] += 1
                    pv = int(sd.kmers[kidx] & np.uint64(PRE_IDX_MASK))
                    ocl.bwt_mem_search(oi, bin2, off + sidx, pv, MEM_SEARCH_FAST,
                                       MIN_MEM_LEN_FAST - 1, sidx, sp_set, mr)
                    n = len(mr)
                else:
                    cand = _Cand(i, sidx, off, 0, MIN_MEM_LEN_FAST - 1, MEM_SEARCH_FAST)
                    n = self._replay_mem_search(dev, cand, bin2, sp_set, mr)
                if n == 0:
                    j -= 2
                    continue
                j -= 3
                max_score = 0
                for m in mr:
                    m.read_offset = sidx - m.match_len
                    s = map_seed(oi, m, read_view, read_len, ci, sd.direction, anchors)
                    max_score = max(s, max_score)
                if max_score > 35:
                    j -= 7
                if max_score > 256:
                    if max_score > 512:
                        ci += 1
                    break
            top = 35
            for a in anchors[a_b_idx:]:
                top = max(top, a.score)
            for a in anchors[a_b_idx:]:
                a.anchor_useless = 1 if a.score < top else 0
            ci += 1
        return 0  # super_repeat counters are dead code in the reference

    def _slow_replay(self, i, dpos, sds, bin2, read_len, tab, anchors):
        """slow_classify (cly.c:1543-1606) consuming device FM results."""
        oi = self.oi
        lek = oi.lek
        sd = sds[i][dpos]
        off = 0 if sd.direction == FORWARD else read_len
        sp_set = SpSet()
        sv = sd.seeds
        read_view = bin2[off : off + read_len]
        for si, c_sv in enumerate(sv):
            if c_sv[1] < 3 and not (sv[0][2] if sv else 0):
                continue
            min_match_len = min(MIN_MEM_LEN_SLOW - 1, lek + 1)
            sp_set.reset()
            mr: list[MemRst] = []
            j = c_sv[1] - 1
            while j >= 1:
                kidx = c_sv[0] + j
                sidx = kidx + lek - 1
                dev = tab.get((i, dpos, si, j, "slow"))
                n0 = len(mr)
                if dev is None:
                    self.stats["cand_fallback"] += 1
                    pv = int(sd.kmers[kidx] & np.uint64(PRE_IDX_MASK))
                    ocl.bwt_mem_search(oi, bin2, off + sidx, pv, MEM_SEARCH_SLOW,
                                       min_match_len, sidx, sp_set, mr)
                else:
                    cand = _Cand(i, sidx, off, 0, min_match_len, MEM_SEARCH_SLOW)
                    self._replay_mem_search(dev, cand, bin2, sp_set, mr)
                for m in mr[n0:]:
                    m.read_offset = sidx - m.match_len
                j -= 2
            if not mr:
                continue
            if len(mr) > 1:
                mr = qsort_list(mr, ocl.SZ_MEMRST, lambda a, b: b.match_len - a.match_len)
            a_b_idx = len(anchors)
            for m in mr[: min(len(mr), MEM_SEARCH_SLOW)]:
                map_seed(oi, m, read_view, read_len, si, sd.direction, anchors)
            top = 35
            for a in anchors[a_b_idx:]:
                top = max(top, a.score)
            for a in anchors[a_b_idx:]:
                a.anchor_useless = 1 if a.score < top else 0

    # ------------------------------------------------------------- API ----
    def classify_results(self, reads) -> list:
        """Full classify flow (speculate -> replay -> rescore -> primary)
        returning result objects. The RM_buffer state (max_read_l filter
        mode, bin-buffer growth, cly_mt.c:963-1006) runs across the reads
        of one call, as in a single-thread run of the reference."""
        oi = self.oi
        out = []
        buff = {"max_read_l": 0}
        m_bin = [0]

        def prepad(read_len):
            if 2 * read_len > m_bin[0]:
                m_bin[0] = 2 * read_len + 20
            csz = max(32, (m_bin[0] + 8 + 15) & ~15) | 1
            return csz.to_bytes(8, "little")

        for s0 in range(0, len(reads), SUB_BATCH):
            chunk = reads[s0 : s0 + SUB_BATCH]
            results, sds, bin2s, lens = self._classify_sub(chunk)
            for k, res in enumerate(results):
                if lens[k] >= MIN_READ_LEN and sds[k] is not None:
                    sd0, sd1 = sds[k]
                    off = {FORWARD: 0, 1 - FORWARD: int(lens[k])}
                    bin2c = CBuf(bin2s[k], prepad(int(lens[k])))
                    delete_small_score_rst(oi, res, sd0, sd1, buff, bin2c, off)
                    detect_primary(res.hits, int(lens[k]))
                out.append(res)
        return out

    def classify_to_sam(self, reads, output_seq=False,
                        max_sec_n=DEFAULT_MAX_SEC_N) -> str:
        return "".join(
            format_sam(self.oi, res, output_seq, max_sec_n)
            for res in self.classify_results(reads))


def codec_seq(seq):
    """CLY_Bit codes of a read (cly.c:16-34)."""
    return codec.seq_to_codes(seq, codec.CLY_BIT)
