"""Bit-exact NumPy/Python model of the reference's per-read classify
steps, as the validation engine (engine/tpu_engine.py) replays them.

A copy of the parts of desamba_tpu/oracle/classify.py that the validation
engine calls: the read's seed islands (store_kmers,
search_exist_kmer_m2), the scalar FM search it falls back on
(bwt_mem_search, bwt_single_search), seed-to-anchor mapping (map_seed
with lv_extd and get_new_ed) and chaining (resolve_tree), with every
integer-width quirk, dead-code oddity and comparator tie of the C
reference kept. Citations are file:line into the reference's C sources.
`OracleIndex` here is a view of the port's HostIndex
(index/loader.load_index), whose arrays it shares.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    CHAIN_M3_THRESHOLD,
    DEFAULT_FILTER_MIN_LENGTH,
    DEFAULT_MIN_SCORE,
    L_PRE_IDX,
    LV_ERROR,
    LV_L,
    MAX_ANCHOR_OVERLAP,
    MAX_DIS_MINUS,
    MAX_WAITING_LEN,
    MIN_S_1,
    MIN_S_2,
    MIN_UNI_L,
    SP_SET_CAP,
    STEP_EK,
)
from .cqsort import qsort_list

FORWARD, REVERSE = 1, 0  # lib/utils.h:66-67
# byte sizes of the C structs, which set glibc qsort's comparison order
SZ_CHAIN, SZ_ANCHOR, SZ_MEMRST = 56, 56, 40


def u32(x) -> int:
    return int(x) & 0xFFFFFFFF


def i32(x) -> int:
    v = int(x) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


# ---------------------------------------------------------------- LV ----
def lv_extd(ref, ref_length: int, query, query_length: int) -> int:
    """Banded Landau-Vishkin edit-distance extend (cly.c:505-604).

    Sentinels are virtual: ref[ref_length]='#', query[query_length]='$'.
    Out-of-range reads (the reference reads adjacent stack bytes there) are
    modeled as never-matching.
    """
    if ref_length < query_length:
        ref, query = query, ref
        ref_length, query_length = query_length, ref_length
    mn = {}
    ed = {}
    for i in range(-LV_ERROR - 1, LV_ERROR + 3):
        mn[i] = -1
        ed[i] = abs(i)
    best = query_length

    def rc(k):
        if k == ref_length:
            return 35  # '#'
        if 0 <= k < ref_length:
            # data beyond the filled buffer is uninitialized in C
            return int(ref[k]) if k < len(ref) else -1
        return -1

    def qc(k):
        if k == query_length:
            return 36  # '$'
        if 0 <= k < query_length:
            return int(query[k]) if k < len(query) else -2
        return -2

    for i in range(LV_ERROR + 1):
        prev_mn, cur_mn, next_mn = -1, i - 1, mn[-i + 1]
        prev_ed, cur_ed, next_ed = i + 1, i, ed[-i + 1]
        for j in range(-i, LV_ERROR + 1):
            if cur_mn + j < ref_length - 1:
                mx = cur_mn + 1 - cur_ed
                mn[j] = cur_mn + 1
                ed[j] = cur_ed + 1
                if mx < next_mn + 1 - next_ed:
                    mn[j] = next_mn + 1
                    ed[j] = next_ed + 1
                    mx = next_mn - next_ed
                if mx < prev_mn - prev_ed:
                    mn[j] = prev_mn + 1
                    ed[j] = prev_ed + 1
            else:
                mx = cur_mn - cur_ed
                mn[j] = cur_mn
                ed[j] = cur_ed + 1
                if mx < prev_mn - prev_ed:
                    mn[j] = prev_mn
                    ed[j] = prev_ed + 1
                    mx = prev_mn - prev_ed
                if mx < next_mn + 1 - next_ed:
                    mn[j] = next_mn + 1
                    ed[j] = next_ed + 1
            mn_j = min(mn[j], query_length, ref_length - j)
            while rc(mn_j + j) == qc(mn_j):
                mn_j += 1
            mn[j] = mn_j
            if qc(mn_j) == 36 or rc(mn_j + j) == 35:
                best = min(ed[j] - 1, best)
                if j <= i + 1:
                    return best
            prev_mn, cur_mn, next_mn = cur_mn, next_mn, mn[j + 2]
            prev_ed, cur_ed, next_ed = cur_ed, next_ed, ed[j + 2]
    return best


# ------------------------------------------------------------- index ----
class OracleIndex:
    """FM-index view with O(1) occ through full prefix-count tables.

    Built from a HostIndex, whose arrays it shares: the loader already
    holds what desamba_tpu/oracle/classify.py:OracleIndex.__init__
    prepares (the padded code stream, `cum`, the extended unitig tables,
    the MAPQ tables), so nothing of the index is copied (`cum` alone is
    6 x 8 B a BWT row)."""

    def __init__(self, host, filter_min_length=DEFAULT_FILTER_MIN_LENGTH,
                 filter_min_score=DEFAULT_MIN_SCORE):
        self.rank = host.rank
        self.N = host.n_unitig
        self.L = host.L
        self.dollar_pos = host.dollar_pos
        # unitig table as loaded: N real + dummy + load-time extra
        # (idx.c:1124-1127)
        self.uni_len_ext = host.uni_len
        self.reflist_ext = host.uni_reflist
        self.sa_uni = host.sa_uni
        self.sa_off = host.sa_off
        self.hash13 = host.hash13
        self.refpos_global = host.refpos_global
        self.refpos_refid = host.refpos_refid
        self.ref_names = host.ref_names
        self.ref_len = host.ref_len
        self.ref_offset = host.ref_offset
        self.ref_bin = host.ref_bin
        self.lek = host.ek_len
        self.single_base_max = host.ek_single_base_max
        # the full padded code stream: transient rows at/after L read the
        # block pad nibbles in C (occ reads them as chars; 0xF would hit
        # the xassert in occ, bwt.c:53)
        self.codes = host.bwt_pad
        # occ prefix tables: cum[c][r] = count of c in [0, r)
        self.cum = host.cum
        self.q_mem, self.q_lv = host.q_mem, host.q_lv
        self.filter_min_length = filter_min_length
        self.filter_min_score = filter_min_score
        self.filter_min_score_lv3 = filter_min_score + 10

    # occ (bwt.c:43-65): count of c before row r
    def occ(self, r: int, c: int) -> int:
        return int(self.cum[c, r])

    def occ_cur(self, r: int):
        """occ with c==0xff: returns (char_at_r, occ or DOLLOR_POS)."""
        c = int(self.codes[r])
        if c == 5:
            return c, self.dollar_pos
        if c > 5:
            from .rescore import OracleAbort

            raise OracleAbort("occ read pad nibble > 5 (bwt.c:53 xassert)")
        return c, int(self.cum[c, r])

    def get_ref(self, offset: int, length: int, forward: bool) -> np.ndarray:
        """2-bit reference fetch (get_ref, cly.c:434-461). Out-of-range
        positions return 255 (modeling unmatchable heap garbage)."""
        if length <= 0:
            return np.empty(0, dtype=np.uint8)
        total = self.ref_bin.size * 4
        if forward:
            idxs = offset + np.arange(length, dtype=np.int64)
        else:
            idxs = offset - np.arange(length, dtype=np.int64)
        out = np.full(length, 255, dtype=np.uint8)
        ok = (idxs >= 0) & (idxs < total)
        if ok.any():
            ii = idxs[ok]
            byte = self.ref_bin[ii >> 2]
            shift = (6 - ((ii & 3) << 1)).astype(np.uint8)
            out[ok] = (byte >> shift) & 3
        return out

    def get_uni(self, bwt_pos: int, search_l: int):
        """SA resolve (get_uni, cly.c:466-491) -> (uni_id, global_off, uni_off)."""
        s = bwt_pos >> 3
        uni_id = int(self.sa_uni[s])
        uni_offset = u32(int(self.sa_off[s]) + search_l + 1)
        if search_l > 0:
            while uni_offset >= int(self.uni_len_ext[uni_id]):
                uni_offset -= int(self.uni_len_ext[uni_id]) + 1
                uni_id += 1
                if uni_id > self.N:
                    raise RuntimeError("get_uni walked past dummy unitig")
        # (the search_l <= 0 branch compares unsigned < 0: dead, cly.c:482)
        g = int(self.refpos_global[int(self.reflist_ext[uni_id])]) + uni_offset
        return uni_id, g, uni_offset

    def uni_length(self, uni_id: int) -> int:
        return int(self.uni_len_ext[uni_id])

    def uni_refpos_range(self, uni_id: int):
        return int(self.reflist_ext[uni_id]), int(self.reflist_ext[uni_id + 1])


# ------------------------------------------------------- data records ----
@dataclass
class Anchor:  # cly.h:44-61
    mtch_len: int = 0
    score: int = 0
    left_len: int = 0
    left_ED: int = 0
    rigt_len: int = 0
    rigt_ED: int = 0
    direction: int = 0
    global_offset: int = 0
    ref_ID: int = 0
    ref_offset: int = 0  # uint32 semantics
    index_in_read: int = 0
    chain_anchor_pre: "Anchor | None" = None
    seed_ID: int = 0
    chain_id: int = 0
    anchor_useless: int = 0
    duplicate: int = 0


@dataclass
class Chain:  # chain_item, cly.h:69-89
    ref_ID: int = 0
    q_t_dis: int = 0
    sum_score: int = 0
    anchor_number: int = 0
    direction: int = 0
    with_top_anchor: int = 0
    primary: int = 0
    pri_index: int = 0
    t_st: int = 0
    t_ed: int = 0
    q_st: int = 0
    q_ed: int = 0
    indel: int = 0
    chain_id: int = 0
    chain_anchor_cur: Anchor | None = None


@dataclass
class SearchDir:  # SEARCH_DIR, cly.c:941-949
    seeds: list
    bin_read: np.ndarray
    kmers: np.ndarray
    direction: int
    total_score: int


@dataclass
class ReadResult:  # cly_r
    name: str
    seq: bytes
    qual: bytes
    hits: list = field(default_factory=list)
    fast_classify: bool = True
    n_anchor: int = 0


class SpSet:  # SP_SET dedup ring (cly.c:1276-1293)
    def __init__(self, cap=SP_SET_CAP):
        self.cap = cap
        self.v: list[int] = []

    def reset(self):
        self.v.clear()

    def insert(self, node: int) -> bool:
        if len(self.v) == self.cap:
            self.v.clear()
        if node in self.v:
            return False
        self.v.append(node)
        return True


# ------------------------------------------------------------ islands ----
def store_kmers(bin_read, n_kmer, lek, single_base_max):
    """Rolling e-kmers with low-complexity zeroing (store_kmers, cly.c:359-397)."""
    out = np.zeros(n_kmer, dtype=np.uint64)
    counts = np.zeros(4, dtype=np.int64)
    for i in range(lek):
        counts[bin_read[i]] += 1
    mask = np.uint64((1 << (2 * lek)) - 1)
    kmer = np.uint64(0)
    for i in range(lek - 1):
        kmer = (kmer << np.uint64(2)) | np.uint64(bin_read[i])
    # i == 0
    for i in range(n_kmer):
        if i > 0:
            counts[bin_read[i - 1]] -= 1
            counts[bin_read[i + lek - 1]] += 1
        failed = (counts >= single_base_max).any()
        kmer = ((kmer << np.uint64(2)) | np.uint64(bin_read[i + lek - 1])) & mask
        out[i] = 0 if failed else kmer
    return out


def search_exist_kmer_m2(exists: np.ndarray, direction: int):
    """Island detection (search_exist_kmer_M2, cly.c:1066-1155)."""
    n = exists.size
    seeds = []  # (offset, len)
    if direction == FORWARD:
        i = STEP_EK - 1
        while i < n:
            if exists[i]:
                offset, ln = i, 1
                for j in range(1, STEP_EK):
                    if exists[i - j]:
                        offset -= 1
                        ln += 1
                    else:
                        break
                j = 1
                while i + j < n:
                    if exists[i + j]:
                        ln += 1
                        if ln > 60:
                            break
                    else:
                        break
                    j += 1
                seeds.append([offset, ln, 0])
                i = offset + ln
            i += STEP_EK
    else:
        i = n - STEP_EK
        while i >= 0:
            if exists[i]:
                offset, ln = i, 1
                for j in range(1, STEP_EK):
                    if i + j < n and exists[i + j]:
                        offset += 1
                        ln += 1
                    else:
                        break
                j = 1
                while j <= i:
                    if exists[i - j]:
                        ln += 1
                        if ln > 60:
                            break
                    else:
                        break
                    j += 1
                seeds.append([offset - ln + 1, ln, 0])
                i = offset - ln
            i -= STEP_EK
    return seeds


# ------------------------------------------------------- FM MEM search ----
class MemRst:
    __slots__ = ("match_len", "sp", "sa_sp", "sa_sp_l", "kmer_index", "read_offset")

    def __init__(self):
        self.match_len = 0
        self.sp = 0
        self.sa_sp = -1  # MAX_uint64_t
        self.sa_sp_l = 0
        self.kmer_index = 0
        self.read_offset = 0


def bwt_single_search(idx, sp, spos, bin2, max_match_len, sp_set, m: MemRst):
    """Single-row backward extension (bwt_single_search, cly.c:1339-1378).

    spos: current index into bin2 (the char to match next, moving left)."""
    sa_sp, sa_sp_l = -1, 0
    match_len = 0
    while True:
        if match_len >= max_match_len:
            break
        if (sp & 7) == 0:
            sa_sp, sa_sp_l = sp, 0
        else:
            sa_sp_l -= 1
        c, v = idx.occ_cur(sp)
        new_sp = v + int(idx.rank[c])
        want = int(bin2[spos]) if 0 <= spos < bin2.size else -1
        if c != want:
            break
        match_len += 1
        spos -= 1
        if not sp_set.insert(new_sp):
            m.match_len = -1000
            return
        sp = new_sp
    m.sp = sp
    m.match_len = match_len
    m.sa_sp = sa_sp
    m.sa_sp_l = sa_sp_l


def bwt_mem_search(idx, bin2, s_idx, pre_v, max_rst, l_min, l_max, sp_set, out):
    """Backward MEM search from the 13-mer hash (bwt_MEM_search, cly.c:1383-1442).

    bin2: combined read buffer; s_idx: index of the rightmost pattern char.
    Appends MemRst to out; returns number appended."""
    sp = int(idx.hash13[pre_v])
    ep = int(idx.hash13[pre_v + 1])
    ptr = s_idx - L_PRE_IDX
    match_len = L_PRE_IDX
    new_sp = new_ep = 0
    while True:
        c = int(bin2[ptr]) if 0 <= ptr < bin2.size else 255
        ptr -= 1
        if c > 5:
            # out-of-buffer read: model as a char matching nothing
            new_sp, new_ep = 0, 0
        else:
            new_sp = int(idx.rank[c]) + idx.occ(sp, c)
            new_ep = int(idx.rank[c]) + idx.occ(ep, c)
        if match_len >= l_min - 1:
            if new_sp + max_rst >= new_ep:
                break
            if match_len >= l_max:
                return 0
        if new_sp + 1 >= new_ep:
            break
        match_len += 1
        sp, ep = new_sp, new_ep
    if new_sp >= new_ep:
        return 0
    n0 = len(out)
    if new_sp + 1 == new_ep:
        if not sp_set.insert(new_sp):
            return 0
        m = MemRst()
        bwt_single_search(idx, new_sp, ptr, bin2, max(0, l_max - match_len), sp_set, m)
        m.match_len += match_len + 1
        if m.match_len >= l_min:
            out.append(m)
    else:
        for c_sp in range(new_sp, new_ep):
            if not sp_set.insert(c_sp):
                continue
            m = MemRst()
            bwt_single_search(idx, c_sp, ptr, bin2, max(0, l_max - match_len), sp_set, m)
            m.match_len += match_len + 1
            if m.match_len >= l_min:
                out.append(m)
    return len(out) - n0


# ------------------------------------------------------------ map_seed ----
def get_new_ed(idx, q_off, t_off, l_read, q_b, is_fwd):
    """Per-occurrence re-extension (get_new_ed, cly.c:624-689).

    Returns (ed, len, l_mem_ext). q_b is the direction's bin read array."""
    l_mem_ext = 0
    if is_fwd:
        if q_off < 0:
            q_off = 0
        max_len = q_off
        ln = min(12, max_len)
        q = np.array([q_b[q_off - k] for k in range(ln)], dtype=np.uint8)
    else:
        max_len = l_read - q_off
        ln = min(12, max_len)
        q = np.asarray(q_b[q_off : q_off + ln], dtype=np.uint8)
        qpos = q_off
    t = idx.get_ref(t_off, ln, not is_fwd)
    if ln > 0 and t[0] == q[0]:
        while True:
            mtc = 0
            while mtc < ln and t[mtc] == q[mtc]:
                mtc += 1
            if mtc == 0:
                break
            l_mem_ext += mtc
            max_len -= mtc
            ln = min(12, max_len)
            if is_fwd:
                q_off -= mtc
                t_off -= mtc
                q = np.array([q_b[q_off - k] for k in range(ln)], dtype=np.uint8)
            else:
                t_off += mtc
                qpos += mtc
                q = np.asarray(q_b[qpos : qpos + ln], dtype=np.uint8)
            t = idx.get_ref(t_off, ln, not is_fwd)
    ed = lv_extd(t, ln, q, ln)
    return ed, ln, l_mem_ext


def map_seed(idx: OracleIndex, m: MemRst, bin_read, read_len, seed_id, direction, anchors):
    """Seed -> anchors (map_seed, cly.c:701-934). Returns max anchor score."""
    b_p = m.sp
    q_off = m.read_offset
    l_m = m.match_len
    q_b = bin_read
    uni = None
    u_off = t_off = 0
    l_pre = l_suf = d_pre = d_suf = 0
    s = 0
    max_s = 0
    broke = False
    while True:  # do { ... } while(0)
        l_pre = min(q_off + 1, LV_L)
        q_pre = np.array([q_b[q_off - k] for k in range(l_pre)], dtype=np.uint8)
        t_pre = np.zeros(LV_L + 1, dtype=np.uint8)
        s_l = 0
        if m.sa_sp != -1:
            uni, t_off, u_off = idx.get_uni(m.sa_sp, m.sa_sp_l)
        else:
            while True:
                if (b_p & 7) == 0:
                    break
                c, v = idx.occ_cur(b_p)
                new_sp = v + int(idx.rank[c])
                if c == 4:
                    break
                if s_l < t_pre.size:
                    t_pre[s_l] = c
                s_l += 1
                b_p = new_sp
                if s_l >= l_pre:
                    break
            if (b_p & 7) == 0:
                uni, t_off, u_off = idx.get_uni(b_p, s_l)
            else:
                l_pre = s_l
        if uni is not None:
            if idx.uni_length(uni) < MIN_UNI_L:
                broke = True
                break
            l_pre = min(l_pre, u_off)
            t_pre = idx.get_ref(t_off - 1, l_pre, False)
        d_pre = lv_extd(t_pre, l_pre, q_pre, l_pre)
        s = int(idx.q_mem[l_m]) + int(idx.q_lv[d_pre][l_pre])
        if s < MIN_S_1 and l_pre == LV_L and uni is None:
            s = 0
            broke = True
            break
        # step2: suffix
        if uni is None:
            while b_p & 7:
                c, v = idx.occ_cur(b_p)
                b_p = v + int(idx.rank[c])
                s_l += 1
            uni, t_off, u_off = idx.get_uni(b_p, s_l)
            if idx.uni_length(uni) < MIN_UNI_L:
                s = 0
                broke = True
                break
        q_off_r = q_off + l_m + 1
        # unsigned arithmetic + MIN (cly.c:793)
        l_max_suf = min(u32(idx.uni_length(uni) - u_off - l_m), u32(read_len - q_off_r))
        if l_max_suf != 0:
            l_suf = min(l_max_suf, LV_L)
            qpos = q_off_r
            t_suf = idx.get_ref(t_off + l_m, l_suf, True)
            q_suf = np.asarray(q_b[qpos : qpos + l_suf], dtype=np.uint8)
            if l_suf > 0 and t_suf.size and t_suf[0] == q_suf[0]:
                while True:
                    mtc = 0
                    while mtc < l_suf and mtc < q_suf.size and t_suf[mtc] == q_suf[mtc]:
                        mtc += 1
                    if mtc == 0:
                        break
                    l_m += mtc
                    s = int(idx.q_mem[l_m]) + int(idx.q_lv[d_pre][l_pre])
                    l_max_suf -= mtc
                    l_suf = min(l_max_suf, LV_L)
                    qpos += mtc
                    t_suf = idx.get_ref(t_off + l_m, l_suf, True)
                    q_suf = np.asarray(q_b[qpos : qpos + l_suf], dtype=np.uint8)
            d_suf = lv_extd(t_suf, l_suf, q_suf, l_suf)
            s += int(idx.q_lv[d_suf][l_suf])
        else:
            l_suf = d_suf = 0
        if s <= MIN_S_2 and l_suf == LV_L:
            s = 0
            broke = True
        break

    if s > 0:
        am = dict(mtch_len=l_m, score=s, left_len=l_pre, left_ED=d_pre,
                  rigt_len=l_suf, rigt_ED=d_suf)
        rp_s, rp_e = idx.uni_refpos_range(uni)
        ref_search_l = l_pre < LV_L or d_pre == 0
        ref_search_r = l_suf < LV_L or d_suf == 0
        duplicate = False
        if rp_e - rp_s > 50:  # super repeat (cly.c:842-883)
            if rp_e - rp_s >= 1000:
                return 50
        for rp in range(rp_s, rp_e):
            g = int(idx.refpos_global[rp])
            a_left_len, a_left_ED = am["left_len"], am["left_ED"]
            a_rigt_len, a_rigt_ED = am["rigt_len"], am["rigt_ED"]
            a_mtch = am["mtch_len"]
            a_score = am["score"]
            l_m_ext_l = 0
            if ref_search_l or ref_search_r:
                if ref_search_l:
                    ed_l, len_l, l_m_ext_l = get_new_ed(
                        idx, q_off, g + u_off - 1, read_len, q_b, True
                    )
                    a_left_len, a_left_ED = len_l, ed_l
                a_mtch = l_m + l_m_ext_l
                if ref_search_r:
                    ed_r, len_r, l_m_ext_r = get_new_ed(
                        idx, q_off + l_m + 1, g + u_off + l_m, read_len, q_b, False
                    )
                    a_rigt_len, a_rigt_ED = len_r, ed_r
                    a_mtch += l_m_ext_r
                a_score = (
                    int(idx.q_mem[min(a_mtch, idx.q_mem.size - 1)])
                    + int(idx.q_lv[a_left_ED][a_left_len])
                    + int(idx.q_lv[a_rigt_ED][a_rigt_len])
                )
                if a_score < MIN_S_2:
                    continue
            max_s = max(max_s, a_score)
            a = Anchor(
                mtch_len=a_mtch,
                score=a_score,
                left_len=a_left_len,
                left_ED=a_left_ED,
                rigt_len=a_rigt_len,
                rigt_ED=a_rigt_ED,
                direction=direction,
                index_in_read=q_off + 1 - l_m_ext_l,
                global_offset=g + u_off - l_m_ext_l,
                ref_ID=int(idx.refpos_refid[rp]),
                seed_ID=seed_id,
                duplicate=duplicate,
            )
            a.ref_offset = u32(a.global_offset - int(idx.ref_offset[a.ref_ID]))
            anchors.append(a)
    return max_s


# ------------------------------------------------------------ chaining ----
def chain_insert_meta(a: Anchor, c: Chain, new_chain: bool, dis_minus: int):
    """cly.c:71-111."""
    ref_l = a.ref_offset
    ref_r = u32(ref_l + a.mtch_len)
    read_l = a.index_in_read
    read_r = u32(read_l + a.mtch_len)
    if new_chain:
        a.chain_id = c.chain_id
        a.chain_anchor_pre = None
        c.ref_ID = a.ref_ID
        c.direction = a.direction
        c.q_t_dis = i32(a.ref_offset - a.index_in_read)
        c.t_st, c.t_ed = ref_l, ref_r
        c.q_st, c.q_ed = read_l, read_r
        c.with_top_anchor = 0 if a.anchor_useless else 1
        c.anchor_number = 1
        c.sum_score = 1 if a.duplicate else a.score
        c.indel = 0
        c.chain_anchor_cur = a
    else:
        a.chain_id = c.chain_id
        c.with_top_anchor |= 0 if a.anchor_useless else 1
        if c.q_ed >= read_r:
            return
        c.t_ed = max(ref_r, c.t_ed)
        c.q_ed = read_r
        a.chain_anchor_pre = c.chain_anchor_cur
        c.chain_anchor_cur = a
        c.q_t_dis = i32(a.ref_offset - a.index_in_read)
        c.indel = u32(c.indel + dis_minus)
        c.anchor_number += 1
        c.sum_score = u32(c.sum_score + (1 if a.duplicate else a.score))


def chain_insert_m2(a: Anchor, chains: list):
    """Linear-scan chain insert (chain_insert_M2, cly.c:200-223)."""
    dis = i32(a.ref_offset - a.index_in_read)
    for c in chains:
        if c.direction == a.direction and c.ref_ID == a.ref_ID:
            dis_minus = abs(dis - c.q_t_dis)
            if dis_minus < MAX_DIS_MINUS and abs_u(c.t_ed, a.ref_offset) < MAX_WAITING_LEN:
                chain_insert_meta(a, c, False, dis_minus)
                return
    c = Chain(chain_id=len(chains))
    chains.append(c)
    chain_insert_meta(a, c, True, 0)


def abs_u(a, b):
    return a - b if a > b else b - a


def chain_insert_m3(anchors: list, chains: list):
    """Sparse-DP chaining for >=50 anchors (chain_insert_M3, cly.c:237-322)."""
    alist = qsort_list(
        anchors, SZ_ANCHOR,
        lambda x, y: (
            int(x.ref_ID > y.ref_ID) if x.ref_ID != y.ref_ID
            else int(x.direction > y.direction) if x.direction != y.direction
            else int(x.ref_offset > y.ref_offset)
        ),
    )
    anchors[:] = alist
    n = len(alist)
    st = 0
    while st < n:
        ed = st + 1
        ref_ID = alist[st].ref_ID
        direction = alist[st].direction
        while (
            ed < n
            and alist[ed].ref_ID == ref_ID
            and alist[ed].direction == direction
            and u32(alist[ed].ref_offset - alist[ed - 1].ref_offset) < 2000
        ):
            ed += 1
        if ed - st > 1024:
            ed = st + 1024
        score_v = [0] * (ed - st)
        max_anchor = None
        max_score = 0
        for ci in range(st, ed):
            c_a = alist[ci]
            c_a.chain_anchor_pre = None
            anchor_max = c_a.score
            max_t = u32(c_a.ref_offset + MAX_ANCHOR_OVERLAP)
            max_q = u32(c_a.index_in_read + MAX_ANCHOR_OVERLAP)
            for pi in range(ci - 1, st - 1, -1):
                pre = alist[pi]
                if u32(pre.index_in_read + pre.mtch_len) > max_q:
                    continue
                if u32(pre.ref_offset + pre.mtch_len) > max_t:
                    continue
                if u32(pre.index_in_read + 1000) < max_q:
                    break
                if u32(pre.ref_offset + 1000) < max_t:
                    break
                indel = i32(
                    u32(pre.index_in_read) - u32(pre.ref_offset) - u32(max_q - max_t)
                )
                if abs(indel) > 200:
                    continue
                new_score = (
                    score_v[pi - st]
                    + c_a.mtch_len
                    - (abs(indel) >> 4)
                    - (i32(max_q - pre.index_in_read) >> 8)
                )
                if new_score > anchor_max:
                    anchor_max = new_score
                    c_a.chain_anchor_pre = pre
            score_v[ci - st] = anchor_max
            if max_score < anchor_max:
                max_score = anchor_max
                max_anchor = c_a
        # build chain from max_anchor backwards
        sum_indel = 0
        anchor_number = 1
        pre = max_anchor
        sum_score = 1 if max_anchor.duplicate else max_anchor.score
        with_top = 0 if max_anchor.anchor_useless else 1
        while pre.chain_anchor_pre is not None:
            pre_ = pre.chain_anchor_pre
            sum_indel += i32(
                u32(pre.index_in_read - pre_.index_in_read)
                - u32(pre.ref_offset - pre_.ref_offset)
            )
            with_top |= 0 if pre.anchor_useless else 1
            sum_score += 1 if pre.duplicate else pre.score
            pre = pre_
            anchor_number += 1
        c = Chain(
            chain_id=len(chains),
            ref_ID=ref_ID,
            direction=direction,
            q_t_dis=i32(max_anchor.ref_offset - max_anchor.index_in_read),
            t_st=pre.ref_offset,
            t_ed=u32(max_anchor.ref_offset + max_anchor.mtch_len),
            q_st=pre.index_in_read,
            q_ed=u32(max_anchor.index_in_read + max_anchor.mtch_len),
            with_top_anchor=with_top,
            anchor_number=anchor_number,
            sum_score=u32(sum_score),
            indel=u32(sum_indel),
            chain_anchor_cur=max_anchor,
        )
        chains.append(c)
        st = ed


def chain_cmp_by_score(a: Chain, b: Chain) -> int:
    """cly.c:37-51."""
    if a.with_top_anchor != b.with_top_anchor:
        return -1 if a.with_top_anchor else 1
    sa = i32(a.sum_score + u32((u32(a.q_ed - a.q_st)) << 1)) - i32(u32(a.indel << 2))
    sb = i32(b.sum_score + u32((u32(b.q_ed - b.q_st)) << 1)) - i32(u32(b.indel << 2))
    if sa < sb:
        return 1
    if sa > sb:
        return -1
    return 0


def resolve_tree(result: ReadResult, anchors: list):
    """resolve_tree (cly.c:325-348)."""
    result.hits = []
    if len(anchors) < CHAIN_M3_THRESHOLD:
        for a in anchors:
            chain_insert_m2(a, result.hits)
    else:
        chain_insert_m3(anchors, result.hits)
    if len(result.hits) > 1:
        result.hits = qsort_list(result.hits, SZ_CHAIN, chain_cmp_by_score)
    rst_num = min(5, len(result.hits))
    while rst_num < len(result.hits) and result.hits[rst_num].with_top_anchor == 1:
        rst_num += 1
    del result.hits[rst_num:]
