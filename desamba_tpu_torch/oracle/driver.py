"""SAM formatting of a classified read (output_one_result_sam,
cly_mt.c:229-327): a copy of format_sam from desamba_tpu/oracle/driver.py.
"""
from __future__ import annotations

from ..constants import DEFAULT_MAX_SEC_N
from .classify import OracleIndex, ReadResult, i32, u32


def format_sam(idx: OracleIndex, r: ReadResult, output_seq: bool,
               max_sec_n: int = DEFAULT_MAX_SEC_N) -> str:
    """output_one_result_sam (cly_mt.c:229-327), byte-for-byte."""
    out = []
    seq_s = r.seq.decode() if output_seq else "*"
    qual_s = (r.qual.decode() if r.qual else "") if output_seq else "*"
    if not r.hits:
        out.append(f"{r.name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_s}\t{qual_s}\t\n")
        return "".join(out)
    read_l = len(r.seq)
    c_s = r.hits[0]
    flag = 0 if c_s.direction else 0x10
    if len(r.hits) == 1 or u32(c_s.sum_score - r.hits[1].sum_score) > 5:
        mapq_pri = 30
    else:
        mapq_pri = i32(u32(c_s.sum_score - r.hits[1].sum_score) << 2)
    name0 = idx.ref_names[c_s.ref_ID]
    out.append(
        f"{r.name}\t{flag}\t{name0}\t{i32(c_s.t_st)}\t{mapq_pri}\t"
        f"{i32(c_s.q_st)}S{i32(u32(c_s.q_ed - c_s.q_st))}M{i32(u32(read_l - c_s.q_ed))}S\t"
        f"*\t0\t0\t{seq_s}\t{qual_s}\tAS:i:{i32(c_s.sum_score)}\t\n"
    )
    for loop in (0, 1):
        for c in r.hits[1:]:
            show = False
            flag = 0 if c.direction else 0x10
            mapq = 0
            if loop == 0 and c.pri_index == 0:
                show = True
                flag += 0x800
                mapq = min(30, mapq_pri)
            elif loop == 1 and 0 < c.pri_index <= max_sec_n:
                show = True
                flag += 0x100
            if show:
                hs = "H" if loop == 0 else "S"
                out.append(
                    f"{r.name}\t{flag}\t{idx.ref_names[c.ref_ID]}\t{i32(c.t_st)}\t{mapq}\t"
                    f"{i32(c.q_st)}{hs}{i32(u32(c.q_ed - c.q_st))}M{i32(u32(read_l - c.q_ed))}{hs}\t"
                    f"*\t0\t0\t*\t*\tAS:i:{i32(c.sum_score)}\t\n"
                )
    return "".join(out)
