"""DES / DES_FULL output formats (output_one_result_des / _full,
cly_mt.c:144-227): the reference's debug-oriented result dumps.

The port's copy of desamba_tpu/io/sam.py. The SAM formats live in
oracle/driver.py (format_sam); this module covers the other two output
modes of `classify -f`.
"""
from __future__ import annotations

from ..oracle.classify import ReadResult, i32

PRIMARY_STRING = ["PRI", "SEC", "SUP"]


def _print_hit(c, ref_names, rst_cnt) -> str:
    """print_hit (cly_mt.c:47-92)."""
    return (
        f"{rst_cnt:3d} "
        f"{PRIMARY_STRING[c.primary - 1]} "
        f"{'F' if c.direction else 'R'} "
        f"{ref_names[c.ref_ID]:>20} "
        f"ts:{i32(c.t_st):<10d} "
        f"te:{i32(c.t_ed):<10d} "
        f"qs:{i32(c.q_st):<10d} "
        f"qe:{i32(c.q_ed):<10d} "
        f"{i32(c.sum_score):<5d}\t"
        f"{i32(c.indel)}\t"
        "\n"
    )


def _header(r: ReadResult) -> str:
    return (
        f"{r.name}\t"
        f"{'CLASSIFY' if r.hits else 'UNCLASSIFY'}\t"
        f"{'FAST' if r.fast_classify else 'SLOW'}\t"
        f"{len(r.seq)}\t"
        f"n_rst:[{len(r.hits)}]\t"
        f"n_anc:[{r.n_anchor}]\t"
        "\n"
    )


def format_des(ref_names, r: ReadResult, max_sec_n: int) -> str:
    """OUTPUT_MODE_DES (cly_mt.c:144-185)."""
    out = [_header(r)]
    rst_cnt = 0
    for c in r.hits:
        if c.pri_index == 0:
            out.append(_print_hit(c, ref_names, rst_cnt))
            rst_cnt += 1
    for c in r.hits:
        if 0 < c.pri_index <= max_sec_n:
            out.append(_print_hit(c, ref_names, rst_cnt))
            rst_cnt += 1
    out.append("\n")
    return "".join(out)


def format_des_full(ref_names, r: ReadResult) -> str:
    """OUTPUT_MODE_DES_FULL (cly_mt.c:187-227): all secondaries shown."""
    out = [_header(r)]
    rst_cnt = 0
    for c in r.hits:
        if c.pri_index == 0:
            out.append(_print_hit(c, ref_names, rst_cnt))
            rst_cnt += 1
    for c in r.hits:
        if c.pri_index > 0:
            out.append(_print_hit(c, ref_names, rst_cnt))
            rst_cnt += 1
    out.append("\n")
    return "".join(out)
