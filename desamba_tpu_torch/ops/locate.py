"""BWT-row -> reference-position resolution.

Counterpart of desamba_tpu/ops/locate.py (get_uni analog, cly.c:466-491,
plus the SA-sample walk of bwt_single_search, cly.c:1353-1359): LF-step
to a sampled row (row % 8 == 0), map (sa_uni, sa_off + steps + 1) into the
concatenated unitig string, then a right-side searchsorted into the
unitig starts, then up to P reference occurrences of the unitig.

`locate` (resolve_rows then expand_refpos, as stage 3 calls them) has a
hand-written CUDA kernel (csrc/locate.cu, which verifies the unitig the
SA sample names before it searches) and a plain torch version,
`locate_plain`. The wrapper runs the plain version for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Both take
uni_start non-decreasing, as searchsorted does; LocArrays builds it as a
cumulative sum.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .fm import FmArrays, jax_index, lf_cur


class LocArrays:
    """Locate tables: uni_start (cumulative unitig starts, each unitig
    followed by one sentinel), uni_len, reflist, refpos_global,
    refpos_refid, ref_offset — all int32."""

    FIELDS = ("uni_start", "uni_len", "reflist", "refpos_global",
              "refpos_refid", "ref_offset")

    def __init__(self, **tensors):
        for k in self.FIELDS:
            setattr(self, k, tensors[k])

    @classmethod
    def from_tensor_index(cls, ti, device="cpu"):
        ul = np.asarray(ti.uni_len, dtype=np.int64)
        starts = np.zeros(ul.size + 1, dtype=np.int64)
        np.cumsum(ul + 1, out=starts[1:])
        if starts[-1] >= 2**31 or np.asarray(
                ti.refpos_global).max(initial=0) >= 2**31:
            raise NotImplementedError(
                "index shard exceeds int32 coordinate space; shard the index")

        def t(a):
            return torch.from_numpy(
                np.asarray(a).astype(np.int32)).to(device)

        return cls(uni_start=t(starts), uni_len=t(ul),
                   reflist=t(ti.uni_reflist),
                   refpos_global=t(ti.refpos_global),
                   refpos_refid=t(ti.refpos_refid),
                   ref_offset=t(ti.ref_offset))


def resolve_rows(fm: FmArrays, loc: LocArrays, rows, valid,
                 max_lf: int = 24):
    """Resolve BWT rows to unitig-string positions. Returns dict(pos, uni,
    u_off, ok, steps, row); lanes that meet a sentinel ('#'/'$') before a
    sampled row, or need more than max_lf steps, get ok=False. steps is
    the LF steps each lane took and row the row it stopped at."""
    r = rows.to(torch.int32)
    k = torch.zeros_like(r)
    done = torch.zeros_like(r, dtype=torch.bool)
    bad = ~valid.bool()
    n_pad = fm.pad.shape[0]
    for _ in range(max_lf + 1):
        done = done | ((r & 7) == 0)
        c, nxt = lf_cur(fm, r.clamp(0, n_pad - 1))
        stepping = ~done & ~bad
        bad = bad | (stepping & (c >= 4))
        adv = stepping & (c < 4)
        r = torch.where(adv, nxt, r)
        k = torch.where(adv, k + 1, k)
    ok = done & ~bad
    s = (r >> 3).clamp(0, fm.sa_uni.shape[0] - 1).long()
    uni0 = jax_index(fm.sa_uni[s].long(), loc.uni_start.shape[0])
    # text pos = sa_off + steps + 1 (the get_uni convention, cly.c:477)
    p = loc.uni_start[uni0] + fm.sa_off[s] + k + 1
    u = (torch.searchsorted(loc.uni_start, p, right=True) - 1).clamp(
        0, loc.uni_len.shape[0] - 1)
    u_off = p - loc.uni_start[u]
    return dict(pos=p, uni=u.to(torch.int32), u_off=u_off, ok=ok, steps=k,
                row=r)


def expand_refpos(loc: LocArrays, uni, u_off, ok, P: int = 4):
    """Up to P reference occurrences per resolved anchor (cly.c:698-741).
    Returns (ref_id int32[n, P], gpos int32[n, P], valid bool[n, P])."""
    n_rl = loc.reflist.shape[0]
    uni = uni.long()
    rp_s = loc.reflist[jax_index(uni, n_rl)]
    rp_e = loc.reflist[(uni + 1).clamp(0, n_rl - 1)]
    kk = torch.arange(P, dtype=torch.int32, device=uni.device)[None, :]
    rp = rp_s[:, None] + kk
    val = ok[:, None] & (rp < rp_e[:, None])
    rp_c = rp.clamp(0, loc.refpos_global.shape[0] - 1).long()
    gpos = loc.refpos_global[rp_c] + u_off[:, None]
    return loc.refpos_refid[rp_c], gpos, val


def locate_plain(fm: FmArrays, loc: LocArrays, rows, valid, P: int = 4,
                 max_lf: int = 24):
    """Plain torch version of the locate kernel: resolve_rows, then
    expand_refpos. Returns (ref_id int32[n, P], gpos int32[n, P],
    valid bool[n, P])."""
    r = resolve_rows(fm, loc, rows, valid, max_lf)
    return expand_refpos(loc, r["uni"], r["u_off"], r["ok"], P)


def locate(fm: FmArrays, loc: LocArrays, rows, valid, P: int = 4,
           max_lf: int = 24):
    """resolve_rows then expand_refpos on every lane. rows: int32[n] BWT
    rows; valid: bool[n]; every table contiguous and on rows' device."""
    n = rows.shape[0]
    dev = rows.device
    kernels.check("rows", rows, torch.int32, (n,), dev)
    kernels.check("valid", valid, torch.bool, (n,), dev)
    # a table of shape (numel,) is 1-D
    kernels.check("lfc", fm.lfc, torch.int32, (fm.lfc.numel(),), dev)
    kernels.check("pad", fm.pad, torch.uint8, (fm.pad.numel(),), dev)
    n_sa = fm.sa_uni.shape[0]
    kernels.check("sa_uni", fm.sa_uni, torch.int32, (n_sa,), dev)
    kernels.check("sa_off", fm.sa_off, torch.int32, (n_sa,), dev)
    n_ul = loc.uni_len.shape[0]
    kernels.check("uni_len", loc.uni_len, torch.int32, (n_ul,), dev)
    kernels.check("uni_start", loc.uni_start, torch.int32, (n_ul + 1,), dev)
    n_rl = loc.reflist.numel()
    kernels.check("reflist", loc.reflist, torch.int32, (n_rl,), dev)
    n_rp = loc.refpos_global.shape[0]
    kernels.check("refpos_global", loc.refpos_global, torch.int32, (n_rp,),
                  dev)
    kernels.check("refpos_refid", loc.refpos_refid, torch.int32, (n_rp,),
                  dev)
    if 0 in (fm.lfc.numel(), fm.pad.numel(), n_sa, n_ul, n_rl, n_rp):
        raise ValueError("locate: every table must be non-empty")
    if P < 1 or max_lf < 0:
        raise ValueError(f"P={P}, max_lf={max_lf}")
    if not kernels.launch_device(rows):
        return locate_plain(fm, loc, rows, valid, P, max_lf)
    ref = torch.empty((n, P), dtype=torch.int32, device=dev)
    gpos = torch.empty_like(ref)
    pvalid = torch.empty((n, P), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        kernels.call("locate", kernels.ptr(fm.lfc), fm.lfc.shape[0],
                     fm.pad.shape[0], kernels.ptr(fm.sa_uni),
                     kernels.ptr(fm.sa_off), n_sa,
                     kernels.ptr(loc.uni_start), n_ul + 1, n_ul,
                     kernels.ptr(loc.reflist), n_rl,
                     kernels.ptr(loc.refpos_global),
                     kernels.ptr(loc.refpos_refid), n_rp, kernels.ptr(rows),
                     kernels.ptr(valid), n, int(max_lf), int(P),
                     kernels.ptr(ref), kernels.ptr(gpos), kernels.ptr(pvalid),
                     kernels.stream(dev))
    kernels.launches["locate"] += 1
    return ref, gpos, pvalid
