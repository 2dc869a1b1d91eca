"""SWAR banded match scorer on 2-bit packed words (stage 4).

Counterpart of desamba_tpu/ops/matchblock.py:band_score_packed. The
wrapper runs the plain torch version for tensors on the CPU; for CUDA
tensors it launches the hand-written kernel (csrc/band_score.cu) or
raises. Words are int32 tensors holding uint32 bits; the plain version
widens them to int64 and masks to 32 bits.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..constants import S_A_KMER_L
from .u64emu import M32, popcount32

EVEN = 0x55555555


def _pairmask(n: torch.Tensor) -> torch.Tensor:
    """Mask of the first n 2-bit code slots (n in [0, 16]), int64."""
    full = n >= 16
    return torch.where(full, M32, (1 << (2 * torch.where(full, 0, n))) - 1)


def _hibit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of x (x != 0)."""
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        has = t != 0
        r = r + torch.where(has, s, 0)
        x = torch.where(has, t, x)
    return r


def band_score_packed_plain(read_w, rlen, win_w, rel_lo, rel_hi, K: int):
    """Plain torch version of the K8 kernel (the JAX SWAR formulation)."""
    B, Wq = read_w.shape
    W = Wq * 16
    nj = K // 16
    dev = read_w.device
    rw = read_w.to(torch.int64) & M32
    ww = win_w.to(torch.int64) & M32
    rlen = rlen.to(torch.int64)
    rel_lo = rel_lo.to(torch.int64)
    rel_hi = rel_hi.to(torch.int64)
    wq = torch.arange(Wq, device=dev)[None, :]                    # [1, Wq]
    vr = _pairmask((rlen[:, None] - 16 * wq).clamp(0, 16))        # [B, Wq]
    m = torch.arange(16, device=dev)[None, :, None]               # [1,16,1]
    sh = 2 * m
    acc = torch.zeros((B, Wq), dtype=torch.int64, device=dev)
    for j in range(nj):
        w0 = ww[:, j : j + Wq][:, None, :]
        w1 = ww[:, j + 1 : j + 1 + Wq][:, None, :]
        a = torch.where(sh == 0, w0, ((w0 >> sh) | (w1 << (32 - sh))) & M32)
        x = (rw[:, None, :] ^ a) ^ M32
        eqc = x & (x >> 1) & EVEN                                 # [B,16,Wq]
        base = (16 * (wq + j))[:, None, :] + m
        s = (rel_lo[:, None, None] - base).clamp(0, 16)
        e = (rel_hi[:, None, None] - base).clamp(0, 16)
        eqc = eqc & (_pairmask(e) & ~_pairmask(s)) & vr[:, None, :]
        eqn = torch.nn.functional.pad(eqc[:, :, 1:], (0, 1))
        r9 = eqc
        for i in range(1, S_A_KMER_L):
            r9 = r9 & ((eqc >> (2 * i)) | ((eqn << (32 - 2 * i)) & M32))
        acc = acc | r9[:, 0]
        for t in range(1, 16):
            acc = acc | r9[:, t]
    # run-start bit at q -> run-end bit at q + 8
    accp = torch.nn.functional.pad(acc[:, :-1], (1, 0))
    h = 2 * (S_A_KMER_L - 1)
    acc_e = ((acc << h) & M32) | (accp >> (32 - h))
    score = popcount32(acc_e).sum(1)
    nz = acc_e != 0
    lsb = popcount32(((acc_e & ((acc_e ^ M32) + 1)) - 1) & M32) >> 1
    q_st = torch.where(nz, 16 * wq + lsb, W).amin(1)
    q_ed = torch.where(nz, 16 * wq + (_hibit(acc_e | 1) >> 1), -1).amax(1)
    has = score > 0
    i32 = torch.int32
    return dict(score=score.to(i32),
                q_st=torch.where(has, q_st, W).to(i32),
                q_ed=torch.where(has, q_ed, -1).to(i32))


def band_score_packed(read_w, rlen, win_w, rel_lo, rel_hi, K: int):
    """Banded score of each row: read_w int32[B, W/16] packed read codes
    (code t of word w at bits 2t), rlen int32[B], win_w int32[B, NW]
    packed window codes with NW >= W/16 + K/16 + 1, window codes outside
    [rel_lo, rel_hi) invalid, K a multiple of 16. Returns dict(score,
    q_st, q_ed) int32[B]: the number of read positions ending a >= 9-code
    diagonal run in the band, and the first/last such position (W / -1
    when none)."""
    B, Wq = read_w.shape
    NW = win_w.shape[1]
    if K % 16 or NW < Wq + K // 16 + 1:
        raise ValueError(f"band_score_packed: K={K}, NW={NW}, Wq={Wq}")
    dev = read_w.device
    i32 = torch.int32
    kernels.check("read_w", read_w, i32, (B, Wq), dev)
    kernels.check("win_w", win_w, i32, (B, NW), dev)
    for name, t in (("rlen", rlen), ("rel_lo", rel_lo), ("rel_hi", rel_hi)):
        kernels.check(name, t, i32, (B,), dev)
    if not kernels.launch_device(read_w):
        return band_score_packed_plain(read_w, rlen, win_w, rel_lo, rel_hi,
                                       K)
    out = torch.empty((3, B), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        kernels.call("band_score_packed", kernels.ptr(read_w),
                     kernels.ptr(rlen), kernels.ptr(win_w),
                     kernels.ptr(rel_lo), kernels.ptr(rel_hi), B, Wq, NW, K,
                     kernels.ptr(out[0]), kernels.ptr(out[1]),
                     kernels.ptr(out[2]), kernels.stream(dev))
    kernels.launches["band_score_packed"] += 1
    return dict(score=out[0], q_st=out[1], q_ed=out[2])
