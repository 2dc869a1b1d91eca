"""M2 sparse-match rescoring + filtering + primary detection (a copy of
desamba_tpu/oracle/rescore.py).

Faithful model of get_score_M2 and friends (cly.c:2156-2844), the chain
filter delete_small_score_rst (cly.c:2878-2988) and detect_primary
(cly.c:2990-3053). All position arithmetic follows the reference's
uint32/int mixing.
"""
from __future__ import annotations

from ..constants import (
    FILTER_MIN_SCORE_2G,
    FILTER_MIN_SCORE_SHORT_3G,
    MAX_SMS_OVERLAP,
    MIN_SCORE_MEM,
    NGS_MAX_READ_L,
    OVER_SEARCH_M2,
    PRIMARY,
    S_A_KMER_L,
    SECONDARY,
    SHORT_3G_READ_L,
    SUPPLEMENTARY,
)
from .classify import (
    FORWARD,
    REVERSE,
    SZ_CHAIN,
    Chain,
    OracleIndex,
    ReadResult,
    abs_u,
    i32,
    u32,
)
from .cqsort import qsort_list


class OracleAbort(RuntimeError):
    """Raised where the reference would xassert-abort or wild-read."""


# ------------------------------------------------------------ read hash ----
def build_hash_table_m2(sd0, sd1, hits, q_len):
    """9-mer read hash per direction (build_hash_table_M2, cly.c:2168-2219).

    Returns (key_len, {FORWARD: kmer->pos-list, REVERSE: ...}). Position
    lists are in increasing position order (the C chained-hash append order).
    """
    hash_size = [
        0x1, 0x2, 0x4, 0x8, 0x10, 0x20, 0x40, 0x80, 0x100, 0x200,
        0x400, 0x800, 0x1000, 0x2000, 0x4000, 0x8000, 0x10000, 0x20000,
        0x40000, 0x80000,
    ]
    key_len = 10
    while key_len < 18:
        if hash_size[key_len] >= q_len:
            break
        key_len += 1
    both = 0
    for h in hits:
        both |= 2 if h.direction == FORWARD else 1
        if both == 3:
            break
    tables = {}
    for c_dir in (2, 1):
        if not (c_dir & both):
            continue
        direction = REVERSE if c_dir == 1 else FORWARD
        sd = sd0 if sd0.direction == direction else sd1
        tbl: dict[int, list[int]] = {}
        b = sd.bin_read
        kmer = 0
        for i in range(S_A_KMER_L - 1):
            kmer = (kmer << 2) | int(b[i])
        mask = (1 << (2 * S_A_KMER_L)) - 1
        for c_pos in range(q_len - S_A_KMER_L + 1):
            kmer = ((kmer << 2) | int(b[c_pos + S_A_KMER_L - 1])) & mask
            tbl.setdefault(kmer, []).append(c_pos)
        tables[direction] = tbl
    return key_len, tables


class CBuf:
    """The classify bin-read buffer with its heap surroundings modeled.

    The reference reads before buff->bin_read during left MEM extensions
    (q index -1 and below, e.g. sdp_match back search, cly.c:2416): those
    bytes are the glibc malloc chunk size header — deterministic. Bytes
    after arr (realloc'd garbage) are modeled as unmatchable."""

    def __init__(self, arr, prepad: bytes):
        self.arr = arr
        self.prepad = prepad  # 8 bytes at p-8..p-1 (little-endian size|flags)

    def __len__(self):
        return len(self.arr)

    def get(self, i):
        if 0 <= i < len(self.arr):
            return int(self.arr[i])
        if -8 <= i < 0:
            return int(self.prepad[8 + i])
        return -9


def _rd(a, i):
    """Read a[i]; out-of-range models unmatchable garbage."""
    if isinstance(a, (_OffsetView, CBuf)):
        return a.get(i)
    if 0 <= i < len(a):
        return int(a[i])
    return -9


def mem_search(a, ai, b, bi, forward, maxlen):
    """MEM_search (cly.c:1805-1813): count equal chars stepping +-1.

    a, b: arrays; out-of-range reads never match."""
    n = 0
    step = 1 if forward else -1
    while n < maxlen:
        ca = _rd(a, ai)
        cb = _rd(b, bi)
        if ca != cb or ca < 0:
            break
        n += 1
        ai += step
        bi += step
    return n


def sdp_match(q_bg, q_ed, q, q_off, t, t_len, tbl, sms, t_st, is_forward):
    """9-mer scan of a target window vs the read hash (sdp_match,
    cly.c:2330-2435). q: the 2L bin buffer, q_off: direction base offset.
    Matches appended to sms as dicts."""
    q_bg, q_ed = u32(q_bg), u32(q_ed)
    t_kmer_num = t_len - S_A_KMER_L + 1
    if is_forward:
        rng = range(4, t_kmer_num)
        tpos_of = lambda i: i
    else:
        rng = range(4, t_kmer_num)
        tpos_of = lambda i: t_len - S_A_KMER_L - i
    for i in rng:
        if (i & 3) != 0:
            continue
        tp = tpos_of(i)
        kmer = 0
        valid = True
        for k in range(S_A_KMER_L):
            c = _rd(t, tp + k)
            if c < 0 or c > 3:
                valid = False
                break
            kmer = (kmer << 2) | c
        if not valid:
            continue
        for q_pos in tbl.get(kmer, ()):
            if not (q_pos >= q_bg and q_pos <= q_ed):
                continue
            if is_forward:
                back_len = mem_search(q, q_off + q_pos - 1, t, tp - 1, False, 4)
                if back_len < 4 or i == 4:
                    max_search = u32(q_ed - q_pos - 1)
                    max_search = min(max_search, t_len - i - 1) + OVER_SEARCH_M2
                    fwd_len = mem_search(
                        q, q_off + q_pos + S_A_KMER_L, t, tp + S_A_KMER_L, True, max_search
                    )
                    total = back_len + fwd_len + 1
                    if total >= 4:
                        sms.append(
                            dict(
                                len=total,
                                q_pos=u32(q_pos - back_len),
                                t_pos=u32(i - back_len + t_st),
                                score=0,
                            )
                        )
            else:
                fwd_len = mem_search(
                    q, q_off + q_pos + S_A_KMER_L, t, tp + S_A_KMER_L, True, 4
                )
                if fwd_len < 4 or i == 4:
                    max_search = min(q_pos, tp) + OVER_SEARCH_M2
                    back_len = mem_search(q, q_off + q_pos - 1, t, tp - 1, False, max_search)
                    total = back_len + fwd_len + 1
                    if total >= 4:
                        sms.append(
                            dict(
                                len=total,
                                q_pos=u32(q_pos - back_len),
                                t_pos=u32(tp - back_len + t_st),
                                score=0,
                            )
                        )


def sc_hash_build(hits):
    """Chain-endpoint hash (sc_hash_idx, cly.c:1686-1705) as ordered buckets."""
    buckets: dict[int, list[tuple[int, int]]] = {}
    for ci, c in enumerate(hits):
        for i in (1, 0):  # 1: left(start), 0: right(end)
            key = u32(c.t_st - c.q_st if i == 1 else c.t_ed - c.q_ed) & 0xFF
            buckets.setdefault(key, []).append((ci + 1, i))
    return buckets


def combine_chain(hits, chain_id, sc_hash, dis, isleft, c_q_pos):
    """combine_chain (cly.c:1758-1803). Returns zeroed chain or None."""
    key = u32(dis) & 0xFF
    c_h = hits[chain_id]
    for seed_id, s_or_e in sc_hash.get(key, ()):
        c = hits[seed_id - 1]
        dis_con = i32(u32(c.t_ed - c.q_ed) if isleft else u32(c.t_st - c.q_st))
        q_pos_con = c.q_st if not isleft else u32(c.q_ed - S_A_KMER_L)
        if (
            i32(dis) == dis_con
            and c is not c_h
            and (1 if isleft else 0) != s_or_e
            and abs_u(i32(c_q_pos), i32(q_pos_con)) < 8
            and c_h.ref_ID == c.ref_ID
            and c_h.direction == c.direction
            and c.sum_score != 0
            and seed_id - 1 > chain_id
        ):
            c_h.sum_score = u32(c_h.sum_score + c.sum_score)
            c_h.anchor_number += c.anchor_number
            c_h.indel = u32(c_h.indel + c.indel)
            c_h.q_st = min(c_h.q_st, c.q_st)
            c_h.t_st = min(c_h.t_st, c.t_st)
            c_h.q_ed = max(c_h.q_ed, c.q_ed)
            c_h.t_ed = max(c_h.t_ed, c.t_ed)
            c.sum_score = 0
            c.t_st = c.t_ed = c.q_st = c.q_ed = 0
            return c
    return None


def sdp_middle_m2(idx, c_a, tbl, q, q_off):
    """Gap-fill scoring along a chain (sdp_middle_M2, cly.c:2439-2525)."""
    score = 10000
    t_offset = int(idx.ref_offset[c_a.ref_ID])
    while c_a is not None:
        pre_a = c_a.chain_anchor_pre
        if pre_a is not None:
            pre_mch = pre_a.mtch_len
            pre_refoffset = i32(u32(pre_a.ref_offset) - 3)
            total_ref_len = i32(u32(c_a.ref_offset) - u32(pre_refoffset + pre_mch) + 3)
            sms = [
                dict(
                    score=score,
                    q_pos=pre_a.index_in_read,
                    t_pos=pre_a.ref_offset,
                    len=pre_a.mtch_len - S_A_KMER_L + 1,
                )
            ]
            if total_ref_len > 12:
                if total_ref_len >= 2000:
                    raise OracleAbort("sdp_middle_M2 total_ref_len >= 2000")
                ref_offset = pre_refoffset + t_offset + pre_mch
                ref = idx.get_ref(ref_offset, total_ref_len, True)
                sdp_match(
                    u32(pre_a.index_in_read + pre_mch - 8),
                    u32(c_a.index_in_read - 1),
                    q, q_off, ref, total_ref_len, tbl, sms,
                    u32(pre_refoffset + pre_mch), True,
                )
            sms.append(
                dict(
                    score=0,
                    q_pos=c_a.index_in_read,
                    t_pos=c_a.ref_offset,
                    len=c_a.mtch_len - S_A_KMER_L + 1,
                )
            )
            if len(sms) > 1:
                for ci in range(1, len(sms)):
                    c_spd = sms[ci]
                    max_score = c_spd["len"]
                    max_q = u32(c_spd["q_pos"] + MAX_SMS_OVERLAP)
                    max_t = u32(c_spd["t_pos"] + MAX_SMS_OVERLAP)
                    for pi in range(ci - 1, -1, -1):
                        p = sms[pi]
                        pre_q_ed = i32(p["q_pos"] + p["len"] + S_A_KMER_L - 1)
                        pre_t_ed = i32(p["t_pos"] + p["len"] + S_A_KMER_L - 1)
                        if u32(pre_q_ed) > max_q:
                            continue
                        if u32(pre_t_ed) > max_t:
                            continue
                        indel = i32(u32(p["q_pos"]) - u32(p["t_pos"]) - u32(max_q - max_t))
                        if abs(indel) > 200:
                            continue
                        new_score = p["score"] + c_spd["len"] - (abs(indel) >> 3)
                        if u32(pre_q_ed) > c_spd["q_pos"] or u32(pre_t_ed) > c_spd["t_pos"]:
                            overlap_q = i32(pre_q_ed - i32(c_spd["q_pos"]))
                            overlap_t = i32(pre_t_ed - i32(c_spd["t_pos"]))
                            new_score -= max(overlap_q, overlap_t)
                        max_score = max(max_score, new_score)
                    score = max(max_score, score)
                    c_spd["score"] = max_score
        else:
            score += c_a.mtch_len - S_A_KMER_L + 1
        c_a = pre_a
    return score - 10000


def sdp_right_m2(idx, tbl, q, q_off, hits, chain_id, l_read, sc_hash, score_ori):
    """Right-end extension (sdp_right_M2, cly.c:2527-2672)."""
    score_ori += 10000
    total_max = score_ori
    max_sms_id = 0
    c_h = hits[chain_id]
    sms = [dict(score=score_ori, q_pos=c_h.q_ed, t_pos=c_h.t_ed, len=1 - S_A_KMER_L)]
    current = 1
    t_offset_global = int(idx.ref_offset[c_h.ref_ID])
    t_length = int(idx.ref_len[c_h.ref_ID])
    c_t_offset = u32(c_h.t_ed - 3)
    last_search = False
    while True:
        if len(sms) == current:
            next_step = u32(t_length - c_t_offset)
            if next_step < MIN_SCORE_MEM:
                break
            if u32(l_read - c_h.q_ed) < 600:
                if last_search:
                    break
                last_search = True
                max_search_ref = u32(l_read - c_h.q_ed + 60)
            else:
                max_search_ref = u32(t_length - c_t_offset)
            max_search_ref = min(600, max_search_ref)
            ref = idx.get_ref(c_t_offset + t_offset_global, max_search_ref + OVER_SEARCH_M2, True)
            # MIN/MAX mix int with uint32 -> unsigned compare (cly.c:2585-2587)
            search_q_ed = i32(min(u32(i32(sms[max_sms_id]["q_pos"]) + 1000), u32(l_read)))
            search_q_st = i32(max(u32(search_q_ed - 2000), u32(c_h.q_st - 8)))
            sdp_match(search_q_st, search_q_ed, q, q_off, ref, max_search_ref,
                      tbl, sms, c_t_offset, True)
            c_t_offset = u32(c_t_offset + max_search_ref - S_A_KMER_L - 3)
            if len(sms) == current:
                break
            if u32(sms[current]["t_pos"]) > u32(sms[max_sms_id]["t_pos"] + 1000):
                break
        c_sms = sms[current]
        current += 1
        max_score = c_sms["len"]
        max_pre_q = u32(c_sms["q_pos"] + MAX_SMS_OVERLAP)
        max_pre_t = u32(c_sms["t_pos"] + MAX_SMS_OVERLAP)
        for pi in range(current - 2, -1, -1):
            p = sms[pi]
            pre_q_ed = i32(p["q_pos"] + p["len"] + S_A_KMER_L - 1)
            pre_t_ed = i32(p["t_pos"] + p["len"] + S_A_KMER_L - 1)
            if u32(pre_q_ed) > max_pre_q:
                continue
            if u32(pre_t_ed) > max_pre_t:
                continue
            if u32(p["t_pos"] + 600) < max_pre_t:
                break
            indel = i32(u32(p["q_pos"]) - u32(p["t_pos"]) - u32(max_pre_q - max_pre_t))
            if abs(indel) > 200:
                continue
            new_score = p["score"] + c_sms["len"] - (abs(indel) >> 3)
            if u32(pre_q_ed) > c_sms["q_pos"] or u32(pre_t_ed) > c_sms["t_pos"]:
                overlap_q = i32(pre_q_ed - i32(c_sms["q_pos"]))
                overlap_t = i32(pre_t_ed - i32(c_sms["t_pos"]))
                new_score -= max(overlap_q, overlap_t)
            max_score = max(max_score, new_score)
        c_sms["score"] = max_score
        if c_sms["len"] >= 8:
            combined = combine_chain(
                hits, chain_id, sc_hash,
                i32(u32(c_sms["t_pos"]) - u32(c_sms["q_pos"])), False, c_sms["q_pos"]
            )
            if combined is not None:
                total_max = (
                    max(score_ori, max_score)
                    - c_sms["len"]
                    + sdp_middle_m2(idx, combined.chain_anchor_cur, tbl, q, q_off)
                )
                score_ori = total_max
                max_sms_id = 0
                sms = [dict(score=total_max, q_pos=c_h.q_ed, t_pos=c_h.t_ed, len=-S_A_KMER_L)]
                current = 1
                c_t_offset = c_h.t_ed
                continue
        if total_max < max_score:
            total_max = max_score
            max_sms_id = current - 1
        if u32(c_sms["t_pos"]) > u32(sms[max_sms_id]["t_pos"] + 1000):
            break
    c_h.q_ed = u32(sms[max_sms_id]["q_pos"] + sms[max_sms_id]["len"] + S_A_KMER_L)
    c_h.t_ed = u32(sms[max_sms_id]["t_pos"] + sms[max_sms_id]["len"] + S_A_KMER_L)
    return total_max - 10000


def sdp_left_m2(idx, tbl, q, q_off, hits, chain_id, l_read, sc_hash, score_ori):
    """Left-end extension (sdp_left_M2, cly.c:2674-2814)."""
    score_ori += 10000
    total_max = score_ori
    max_sms_id = 0
    c_h = hits[chain_id]
    sms = [dict(score=score_ori, q_pos=c_h.q_st, t_pos=c_h.t_st, len=0)]
    current = 1
    t_offset_global = int(idx.ref_offset[c_h.ref_ID])
    c_t_offset = u32(c_h.t_st + 3)
    last_search = False
    while True:
        if len(sms) == current:
            next_step = c_t_offset
            if next_step < MIN_SCORE_MEM:
                break
            if c_h.q_st < 600:
                if last_search:
                    break
                last_search = True
                max_search_ref = u32(c_h.q_st + 60)
            else:
                max_search_ref = c_t_offset
            max_search_ref = min(600, max_search_ref)
            if t_offset_global == 0 and c_t_offset < OVER_SEARCH_M2 + max_search_ref:
                # "//bug" branch (cly.c:2719-2720): only max_search_ref bytes
                # are filled, yet sdp_match still scans from ref+50 below —
                # reading 50 bytes into the filled data and 50 past its end
                ref = idx.get_ref(
                    c_t_offset + t_offset_global - max_search_ref, max_search_ref, True
                )
            else:
                ref = idx.get_ref(
                    c_t_offset + t_offset_global - max_search_ref - OVER_SEARCH_M2,
                    max_search_ref + OVER_SEARCH_M2, True,
                )
            # MAX(int,int) here but MIN mixes int with uint32 (cly.c:2734-2736)
            search_q_st = max(i32(sms[max_sms_id]["q_pos"]) - 1000, 0)
            search_q_ed = i32(min(u32(search_q_st + 2000), u32(c_h.q_st - 1)))
            # C always scans from `ref + OVER_SEARCH_M2` (cly.c:2737)
            sdp_match(search_q_st, search_q_ed, q, q_off,
                      _OffsetView(ref, OVER_SEARCH_M2),
                      max_search_ref, tbl, sms, u32(c_t_offset - max_search_ref), False)
            c_t_offset = u32(c_t_offset - max_search_ref + S_A_KMER_L + 3)
            if len(sms) == current:
                break
            if u32(sms[current]["t_pos"] + 1000) < u32(sms[max_sms_id]["t_pos"]):
                break
        c_sms = sms[current]
        current += 1
        max_score = c_sms["len"]
        min_pre_q = u32(c_sms["q_pos"] + c_sms["len"] - MAX_SMS_OVERLAP + S_A_KMER_L - 1)
        min_pre_t = u32(c_sms["t_pos"] + c_sms["len"] - MAX_SMS_OVERLAP + S_A_KMER_L - 1)
        for pi in range(current - 2, -1, -1):
            p = sms[pi]
            if u32(p["q_pos"]) < min_pre_q:
                continue
            if u32(p["t_pos"]) < min_pre_t:
                continue
            if u32(min_pre_t + 600) < u32(p["t_pos"]):
                break
            indel = i32(u32(p["q_pos"]) - u32(p["t_pos"]) - u32(min_pre_q - min_pre_t))
            if abs(indel) > 200:
                continue
            new_score = p["score"] + c_sms["len"] - (abs(indel) >> 3)
            if u32(min_pre_q + MAX_SMS_OVERLAP) > u32(p["q_pos"]) or u32(
                min_pre_t + MAX_SMS_OVERLAP
            ) > u32(p["t_pos"]):
                overlap_q = i32(u32(min_pre_q + MAX_SMS_OVERLAP) - u32(p["q_pos"]))
                overlap_t = i32(u32(min_pre_t + MAX_SMS_OVERLAP) - u32(p["t_pos"]))
                new_score -= max(overlap_q, overlap_t)
            max_score = max(max_score, new_score)
        c_sms["score"] = max_score
        if c_sms["len"] >= 8:
            combined = combine_chain(
                hits, chain_id, sc_hash,
                i32(u32(c_sms["t_pos"]) - u32(c_sms["q_pos"])), True,
                u32(c_sms["q_pos"] + c_sms["len"]),
            )
            if combined is not None:
                total_max = (
                    max(score_ori, max_score)
                    - c_sms["len"]
                    + sdp_middle_m2(idx, combined.chain_anchor_cur, tbl, q, q_off)
                )
                score_ori = total_max
                max_sms_id = 0
                sms = [dict(score=total_max, q_pos=c_h.q_st, t_pos=c_h.t_st, len=0)]
                current = 1
                c_t_offset = c_h.t_st
                continue
        if total_max < max_score:
            total_max = max_score
            max_sms_id = current - 1
        if u32(c_sms["t_pos"] + 1000) < u32(sms[max_sms_id]["t_pos"]):
            break
    c_h.q_st = u32(sms[max_sms_id]["q_pos"])
    c_h.t_st = u32(sms[max_sms_id]["t_pos"])
    return total_max - 10000


class _OffsetView:
    """View of an array with a base offset; index -k reaches base-k.

    Models the C pointer `ref + OVER_SEARCH_M2` where negative indexing is
    defined because the extra bytes were loaded before the pointer."""

    def __init__(self, arr, base):
        self.arr = arr
        self.base = base

    def __len__(self):
        return len(self.arr) - self.base

    def get(self, k):
        j = self.base + k
        if 0 <= j < len(self.arr):
            return int(self.arr[j])
        return -9


def get_score_m2(idx, sd0, sd1, l_read, result, sc_hash, bin2, off):
    """get_score_M2 (cly.c:2816-2844).

    bin2: the combined forward|reverse read buffer (the reference allocates
    both directions contiguously, cly.c:1236-1255, so MEM extensions that
    run past one direction's end read the other direction's bytes);
    off: {direction: base offset in bin2}."""
    key_len, tables = build_hash_table_m2(sd0, sd1, result.hits, l_read)
    for i, h in enumerate(result.hits):
        if h.sum_score == 0:
            continue
        tbl = tables[h.direction]
        q = bin2
        q_off = off[h.direction]
        score = sdp_middle_m2(idx, h.chain_anchor_cur, tbl, q, q_off)
        score = sdp_right_m2(idx, tbl, q, q_off, result.hits, i, l_read, sc_hash, score)
        score = sdp_left_m2(idx, tbl, q, q_off, result.hits, i, l_read, sc_hash, score)
        h.sum_score = u32(score)


def chain_cmp_by_pos(a: Chain, b: Chain) -> int:
    """cly.c:2848-2865."""
    if a.ref_ID > b.ref_ID:
        return 1
    if a.ref_ID < b.ref_ID:
        return -1
    if a.t_st > b.t_st:
        return 1
    if a.t_st < b.t_st:
        return -1
    if a.sum_score < b.sum_score:
        return 1
    if a.sum_score > b.sum_score:
        return -1
    return 0


def chain_cmp_by_mem_score(a: Chain, b: Chain) -> int:
    """cly.c:53-63 (ties return sum_score%2 — glibc-order dependent)."""
    sa = i32(u32(a.sum_score << 5))
    sb = i32(u32(b.sum_score << 5))
    if sa < sb:
        return 1
    if sa > sb:
        return -1
    return int(a.sum_score % 2)


def delete_small_score_rst(idx: OracleIndex, result: ReadResult, sd0, sd1, buff, bin2, off):
    """delete_small_score_rst (cly.c:2878-2988)."""
    hits = result.hits
    if not hits:
        return
    if len(hits) > 200:
        rst_num = 200
        while rst_num < len(hits) and hits[rst_num].sum_score > 50:
            rst_num += 1
        del hits[rst_num:]
    del hits[400:]
    l_read = len(result.seq)
    sc_hash = sc_hash_build(hits)
    get_score_m2(idx, sd0, sd1, l_read, result, sc_hash, bin2, off)
    if len(hits) > 1:
        result.hits = hits = qsort_list(hits, SZ_CHAIN, chain_cmp_by_pos)
    n = len(hits)
    for ci in range(n - 1):
        c_c = hits[ci]
        if c_c.sum_score == 0:
            continue
        for ni in range(ci + 1, n):
            next_c = hits[ni]
            if c_c.ref_ID == next_c.ref_ID:
                if c_c.direction != next_c.direction:
                    continue
                if next_c.sum_score == 0:
                    continue
                if (
                    next_c.t_st < u32(c_c.t_st + 5)
                    and next_c.q_st < u32(c_c.q_st + 5)
                    and next_c.sum_score < u32(c_c.sum_score + 5)
                ):
                    next_c.sum_score = 0
                    next_c.q_ed = next_c.q_st
                    next_c.t_ed = next_c.t_st
                    continue
                dis_t = i32(u32(next_c.t_st - c_c.t_ed))
                dis_q = i32(u32(next_c.q_st - c_c.q_ed))
                dis_t_q = abs(dis_t - dis_q)
                if -20 < dis_t < 1000 and -20 < dis_q < 1000 and dis_t_q < 200:
                    c_c.t_ed = max(c_c.t_ed, next_c.t_ed)
                    c_c.q_ed = max(c_c.q_ed, next_c.q_ed)
                    c_c.sum_score = u32(c_c.sum_score + next_c.sum_score)
                    next_c.sum_score = 0
                    next_c.q_ed = next_c.q_st
                    next_c.t_ed = next_c.t_st
            else:
                break
    buff["max_read_l"] = max(buff.get("max_read_l", 0), l_read)
    if buff["max_read_l"] < NGS_MAX_READ_L:
        for c in hits:
            score = i32(u32(c.sum_score + (u32(c.q_ed - c.q_st) >> 5)))
            if score < FILTER_MIN_SCORE_2G:
                c.sum_score = 0
    elif l_read < SHORT_3G_READ_L:
        for c in hits:
            score = i32(u32(c.sum_score + (u32(c.q_ed - c.q_st) >> 5)))
            if score < FILTER_MIN_SCORE_SHORT_3G:
                c.sum_score = 0
    else:
        for c in hits:
            score = i32(u32(c.sum_score + (u32(c.q_ed - c.q_st) >> 5)))
            if score < idx.filter_min_score_lv3 and (
                u32(c.q_ed - c.q_st) < idx.filter_min_length
                or score < idx.filter_min_score
            ):
                c.sum_score = 0
    if len(hits) > 1:
        result.hits = hits = qsort_list(hits, SZ_CHAIN, chain_cmp_by_mem_score)
    cut = len(hits)
    for i, c in enumerate(hits):
        if c.sum_score == 0:
            cut = i
            break
    del hits[cut:]


def detect_primary(hits, read_len):
    """detect_primary (cly.c:2990-3053)."""
    if not hits:
        return
    primary_v = [0]
    primary_v_idx = {0: 0}
    hits[0].pri_index = 0
    hits[0].primary = PRIMARY
    for c in hits:
        if c.q_st > 4294960000:
            c.q_st = 0
    for hi in range(1, len(hits)):
        c_hit = hits[hi]
        overlap = False
        for i in range(len(primary_v)):
            p = hits[primary_v[i]]
            if p.direction == c_hit.direction:
                primary_st, primary_ed = i32(p.q_st), i32(p.q_ed)
            else:
                primary_st = i32(read_len - p.q_ed)
                primary_ed = i32(read_len - p.q_st)
            overlap_st = max(u32(c_hit.q_st), u32(primary_st))
            overlap_ed = min(u32(c_hit.q_ed), u32(primary_ed))
            if overlap_st < overlap_ed and (
                u32((overlap_ed - overlap_st) << 1) >= u32(c_hit.q_ed - c_hit.q_st)
            ):
                overlap = True
            if overlap:
                c_hit.primary = SECONDARY
                primary_v_idx[i] = (primary_v_idx[i] + 1) & 0xFF  # uint8
                c_hit.pri_index = primary_v_idx[i]
                max_gap = max(u32(p.sum_score) >> 6, 5)
                if u32(c_hit.sum_score + max_gap) > p.sum_score:
                    c_hit.pri_index = 1
                if primary_v_idx[i] == 255:
                    primary_v_idx[i] = 254
                break
        if not overlap:
            c_hit.primary = SUPPLEMENTARY
            c_hit.pri_index = 0
            primary_v_idx[len(primary_v)] = 0
            primary_v.append(hi)
            if len(primary_v) > 750:
                del primary_v[750:]
