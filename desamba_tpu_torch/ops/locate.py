"""BWT-row -> reference-position resolution.

Counterpart of desamba_tpu/ops/locate.py (get_uni analog, cly.c:466-491,
plus the SA-sample walk of bwt_single_search, cly.c:1353-1359): LF-step
to a sampled row (row % 8 == 0), map (sa_uni, sa_off + steps + 1) into the
concatenated unitig string, then a right-side searchsorted into the
unitig starts. Plain torch; no hand kernel yet.
"""
from __future__ import annotations

import numpy as np
import torch

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
    u_off, ok); lanes that meet a sentinel ('#'/'$') before a sampled row,
    or need more than max_lf steps, get ok=False."""
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
    return dict(pos=p, uni=u.to(torch.int32), u_off=u_off, ok=ok)


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
