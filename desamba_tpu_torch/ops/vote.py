"""Stage 3's windowed diagonal vote.

Counterpart of the vote in desamba_tpu/engine/fast_engine.py's stage3
(:363-418; the window vote of cly.c:200-223): the located anchors fill
A = nwR * P slots a read row (a dense [B2, A] layout in JAX and in the
plain version), each anchor is scored by the weights of the anchors of
its row on the same reference within the read's diagonal tolerance, and
three candidates are taken a row: the winner, the best on a far
diagonal and the best on another reference.

`vote` has a hand-written CUDA kernel (csrc/vote.cu: a slot map, then
one warp a read row) and a plain torch version, `vote_plain`. The
wrapper runs the plain version for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. The kernel's slot map is a scratch for
each device and stream (ops/compact.scan_scratch(dev, "vote")), whose
words each call tags with its own number, so that it needs no fill.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..constants import VOTE_TILE
from .compact import scan_scratch

I32 = torch.int32
# the most slots a read row (A = nwR * P) that the vote takes: the kernel
# keeps a row's anchors and scores in shared memory (csrc/vote.cu
# kMaxSlots); A = 664 at W = 8192, the widest bucket
VOTE_MAX_SLOTS = 1 << 13


def vote_plain(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2, B2: int,
               nwR: int):
    """Plain torch version of the vote kernel. Returns (ref_c, diag_c,
    vote_c), each int32[B2, 3]."""
    dev = ref.device
    P = ref.shape[1]
    A = nwR * P
    b_i = (sel // nwR).clamp(max=B2).long()  # B2 and above: dropped
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


def vote(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2, B2: int,
         nwR: int):
    """The vote on stage 2's NC compacted lanes after locate. ref, gpos:
    int32[NC, P] and pvalid bool[NC, P], as locate returns them; total_c,
    qleft_c, sel: int32[NC]; lengths2: int32[B2]. Lane c fills slots
    (sel[c] % nwR) * P + p of read row sel[c] // nwR; sel[c] >= B2 * nwR
    (stage 2 fills B2 * nwR) marks an unused lane, which is dropped, as
    JAX's scatter with mode="drop" drops it. The valid sel values (below
    B2 * nwR) are distinct and none is negative, as stage 2's row grid
    makes them; they may come in any order. A row has at most
    VOTE_MAX_SLOTS slots (nwR * P). Returns (ref_c, diag_c, vote_c), each
    int32[B2, 3]."""
    n, P = ref.shape
    dev = ref.device
    kernels.check("ref", ref, I32, (n, P), dev)
    kernels.check("gpos", gpos, I32, (n, P), dev)
    kernels.check("pvalid", pvalid, torch.bool, (n, P), dev)
    for name, t in (("total_c", total_c), ("qleft_c", qleft_c),
                    ("sel", sel)):
        kernels.check(name, t, I32, (n,), dev)
    kernels.check("lengths2", lengths2, I32, (B2,), dev)
    if P < 1 or nwR < 1 or nwR * P > VOTE_MAX_SLOTS or n >= 2**32:
        raise ValueError(f"vote: P={P}, nwR={nwR}, {n} lanes; P and nwR "
                         f"must be >= 1, and the kernel takes at most "
                         f"{VOTE_MAX_SLOTS} slots a row and 2^32 - 1 lanes")
    if not kernels.launch_device(ref):
        return vote_plain(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2,
                          B2, nwR)
    out = torch.empty((3, B2, 3), dtype=I32, device=dev)
    if B2:
        with torch.cuda.device(dev):
            # the slot map: a word a (row, window), tagged with the call
            words, call = scan_scratch(dev, "vote").take_words(B2 * nwR)
            kernels.call("vote", kernels.ptr(ref), kernels.ptr(gpos),
                         kernels.ptr(pvalid), kernels.ptr(total_c),
                         kernels.ptr(qleft_c), kernels.ptr(sel), n, P,
                         kernels.ptr(lengths2), B2, nwR, kernels.ptr(words),
                         call, kernels.ptr(out), kernels.stream(dev))
        kernels.launches["vote"] += 1
    return out[0], out[1], out[2]
