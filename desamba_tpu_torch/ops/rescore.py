"""Stage 4 around the band scorer: the candidate-window gather before it
and the strand and candidate combine after it.

Counterpart of the plain parts of desamba_tpu/engine/fast_engine.py's
stage4. `band_windows` writes every argument that band_score_packed takes
but K; `combine` folds the strands and picks each read's best candidate
in the reference's tie order. Both have a hand-written CUDA kernel
(csrc/rescore.cu) and a plain torch version (`band_windows_plain`,
`combine_plain`). The wrappers run the plain version for tensors on the
CPU; for CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from .. import kernels
from .refwin import RefArrays

I32 = torch.int32
# candidates a read row at most: the kernel gives each of a row's
# candidates a lane of the row's warp (csrc/rescore.cu)
BAND_WINDOWS_MAX_C = 32
# the combine kernel's (csrc/rescore.cu): reads a block (kCombineReads),
# candidates a row at most (kCombineMaxC: a block's staged candidates fit
# 48 KB of shared memory) and ref_offset entries staged at most
# (kRefStageMax; above it the kernel gathers ref_offset at the pick)
COMBINE_READS = 32
COMBINE_MAX_C = 32
COMBINE_REFS_STAGED = 1024


def band_windows_plain(ra: RefArrays, read_w2, lengths2, ref_c, diag_c,
                       K: int):
    """Plain torch version of the band_windows kernel. Returns (read_w
    int32[B2*C, W/16], rlen int32[B2*C], win_w int32[B2*C, nw], rel_lo
    int32[B2*C], rel_hi int32[B2*C]), candidate b*C + c on read row b,
    nw = W/16 + K/16 + 1."""
    B2, C = ref_c.shape
    dev = ref_c.device
    W = 16 * read_w2.shape[1]
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
    return (read_w2[lane_f].contiguous(), lengths2[lane_f].contiguous(),
            win_w.contiguous(), rel_lo, rel_hi)


def _check_refs(ra: RefArrays, dev) -> int:
    n_ref = ra.ref_offset.shape[0]
    if n_ref == 0 or ra.ref_words_lsb.numel() == 0:
        raise ValueError("stage 4: the reference tables must be non-empty")
    kernels.check("ref_offset", ra.ref_offset, I32, (n_ref,), dev)
    kernels.check("ref_len", ra.ref_len, I32, (n_ref,), dev)
    kernels.check("ref_words_lsb", ra.ref_words_lsb, I32,
                  (ra.ref_words_lsb.numel(),), dev)
    return n_ref


def band_windows(ra: RefArrays, read_w2, lengths2, ref_c, diag_c, K: int):
    """The band scorer's inputs for every candidate (band_windows_plain).
    read_w2: int32[B2, W/16] packed read words; lengths2: int32[B2];
    ref_c, diag_c: int32[B2, C] with C <= BAND_WINDOWS_MAX_C; K the full
    band-score width, a multiple of 16 and at least 16; every table
    contiguous and on ref_c's device."""
    if ref_c.dim() != 2 or read_w2.dim() != 2:
        raise ValueError("band_windows: ref_c and read_w2 must be 2-D")
    B2, C = ref_c.shape
    Wq = read_w2.shape[1]
    dev = ref_c.device
    kernels.check("ref_c", ref_c, I32, (B2, C), dev)
    kernels.check("diag_c", diag_c, I32, (B2, C), dev)
    kernels.check("read_w2", read_w2, I32, (B2, Wq), dev)
    kernels.check("lengths2", lengths2, I32, (B2,), dev)
    n_ref = _check_refs(ra, dev)
    if K < 16 or K % 16:
        raise ValueError(f"band_windows: K={K}")
    if C > BAND_WINDOWS_MAX_C:
        raise ValueError(f"band_windows: C={C} candidates a row, at most "
                         f"{BAND_WINDOWS_MAX_C}")
    if not kernels.launch_device(ref_c):
        return band_windows_plain(ra, read_w2, lengths2, ref_c, diag_c, K)
    n = B2 * C
    nw = Wq + K // 16 + 1
    rw_f = torch.empty((n, Wq), dtype=I32, device=dev)
    win_w = torch.empty((n, nw), dtype=I32, device=dev)
    rl_rel = torch.empty((3, n), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        kernels.call("band_windows", kernels.ptr(ref_c), kernels.ptr(diag_c),
                     kernels.ptr(read_w2), kernels.ptr(lengths2),
                     kernels.ptr(ra.ref_words_lsb), ra.ref_words_lsb.numel(),
                     kernels.ptr(ra.ref_offset), kernels.ptr(ra.ref_len),
                     n_ref, n, C, Wq, nw, (K - 16) // 2, kernels.ptr(rw_f),
                     kernels.ptr(rl_rel[0]), kernels.ptr(win_w),
                     kernels.ptr(rl_rel[1]), kernels.ptr(rl_rel[2]),
                     kernels.stream(dev))
    kernels.launches["band_windows"] += 1
    return rw_f, rl_rel[0], win_w, rl_rel[1], rl_rel[2]


def combine_plain(ra: RefArrays, score, q_st, q_ed, ref_c, diag_c):
    """Plain torch version of the combine kernel: int32[6, B] rows score,
    ref, direction, cov, pos, score_alt (constants.PACK_KEYS) of each
    read's best candidate among its 2C (forward row b, then rc row B + b)
    in the reference's tie order."""
    B2, C = ref_c.shape
    B = B2 // 2
    n_ref = ra.ref_offset.shape[0]

    def fold(x):  # [B2, C] -> [B, 2C]: fwd candidates then rc
        return torch.cat([x[:B], x[B:]], 1)

    score4 = fold(score.reshape(B2, C))
    q_st = fold(q_st.reshape(B2, C))
    q_ed = fold(q_ed.reshape(B2, C))
    ref2 = fold(ref_c)
    diag2 = fold(diag_c)
    score4 = torch.where(ref2 >= 0, score4, -1)
    # the reference's tie order (cly.c:62): an odd best score takes the
    # highest tied ref_ID, an even one the lowest
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
    cov = q_ed.gather(1, cb)[:, 0] - q_st.gather(1, cb)[:, 0]
    cb = cb[:, 0]
    return torch.stack([
        torch.clamp(s_max, min=0),
        ref_b,
        torch.where(cb >= C, 0, 1).to(I32),  # 1 = forward (cly.h)
        torch.clamp(cov, min=0),
        torch.where(ref_b >= 0, pos, -1),
        torch.clamp(score_alt, min=0),
    ])


def combine(ra: RefArrays, score, q_st, q_ed, ref_c, diag_c):
    """combine_plain's int32[6, B]. score, q_st, q_ed: int32[B2*C], the
    band scorer's outputs for candidate b*C + c; ref_c, diag_c: int32[B2,
    C] with B2 even and 1 <= C <= COMBINE_MAX_C."""
    if ref_c.dim() != 2:
        raise ValueError("combine: ref_c must be 2-D")
    B2, C = ref_c.shape
    if B2 % 2 or not 1 <= C <= COMBINE_MAX_C:
        raise ValueError(f"combine: B2={B2}, C={C} (1 <= C <= "
                         f"{COMBINE_MAX_C})")
    dev = ref_c.device
    kernels.check("ref_c", ref_c, I32, (B2, C), dev)
    kernels.check("diag_c", diag_c, I32, (B2, C), dev)
    for name, t in (("score", score), ("q_st", q_st), ("q_ed", q_ed)):
        kernels.check(name, t, I32, (B2 * C,), dev)
    n_ref = _check_refs(ra, dev)
    if not kernels.launch_device(ref_c):
        return combine_plain(ra, score, q_st, q_ed, ref_c, diag_c)
    B = B2 // 2
    out = torch.empty((6, B), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        kernels.call("combine", kernels.ptr(score), kernels.ptr(q_st),
                     kernels.ptr(q_ed), kernels.ptr(ref_c),
                     kernels.ptr(diag_c), kernels.ptr(ra.ref_offset), n_ref,
                     B, C, kernels.ptr(out), kernels.stream(dev))
    kernels.launches["combine"] += 1
    return out
