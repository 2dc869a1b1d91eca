"""Seed selection from exist-filter probe maps, and stage 1 as one call.

Counterpart of desamba_tpu/ops/seeds.py (get_seed_vector_M2 analog,
cly.c:1157-1229): the run of consecutive probe hits ending at each grid
position, and the longest run per window, earliest position on ties.

`stage1` is the fast path's stage 1 (desamba_tpu/engine/fast_engine.py
:203-212): the exist-filter probe, the 13-base prefix of each probed
k-mer, the top seed of each window and the hit count of each row. For
CUDA tensors it launches the hand kernel (csrc/stage1.cu) in one launch
or raises; for tensors on the CPU it runs `stage1_plain`, which composes
the plain torch versions `_probe_reads`, `kmer_lo26` and `top_seeds`.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..constants import SEED_RANGE, STEP_EK
from .ekmer import _grid, _probe_reads, kmer_lo26


def run_lengths(exists: torch.Tensor) -> torch.Tensor:
    """int32[B, nk] run of consecutive 1s ending at each position."""
    ex = exists.to(torch.int32)
    nk = ex.shape[1]
    idx = torch.arange(nk, dtype=torch.int32, device=ex.device)[None, :]
    # last position with a zero at-or-before i (running max of masked iota)
    last0 = torch.cummax(torch.where(ex == 0, idx, -1), dim=1).values
    return torch.where(ex == 1, idx - last0, 0).to(torch.int32)


def top_seeds(exists: torch.Tensor, window: int = SEED_RANGE):
    """(kidx int32[B, n_win], runlen int32[B, n_win]): the grid index of
    the longest run's end in each window and its length (0 where the
    window has no hit)."""
    B, nk = exists.shape
    dev = exists.device
    r = run_lengths(exists)
    n_win = -(-nk // window)
    rp = torch.nn.functional.pad(r, (0, n_win * window - nk))
    # encode (run_len, prefer-earlier-position) for a single segment max
    pos_in_w = torch.arange(n_win * window, dtype=torch.int32,
                            device=dev) % window
    enc = rp * (window * 2) + (window - 1 - pos_in_w)[None, :]
    enc = torch.where(rp > 0, enc, -1)
    best = enc.view(B, n_win, window).amax(dim=2)
    has = best >= 0
    runlen = torch.where(has, best // (window * 2), 0)
    off_in_w = torch.where(has, (window - 1) - (best % (window * 2)), 0)
    base = (torch.arange(n_win, dtype=torch.int32, device=dev)
            * window)[None, :]
    kidx = torch.where(has, base + off_in_w, 0)
    return kidx.to(torch.int32), runlen.to(torch.int32)


WINDOW = SEED_RANGE // STEP_EK  # grid points per top-seed window


def stage1_plain(w01, codes2, lengths2, lek: int, sbm: int, mask_bits: int,
                 n_words0: int):
    """Plain torch version of the stage-1 kernel."""
    ex = _probe_reads(w01, codes2, lengths2, lek, sbm, mask_bits,
                      stride=STEP_EK, n_words0=n_words0)
    lo26 = kmer_lo26(codes2, lek, stride=STEP_EK)
    kidx, runlen = top_seeds(ex, WINDOW)
    return lo26, kidx, runlen, ex.sum(1, dtype=torch.int32)


def stage1(w01, codes2, lengths2, lek: int, sbm: int, mask_bits: int,
           n_words0: int):
    """Stage 1 on codes2 uint8[B2, W] (codes 0-3, padding past each row's
    length, also 0-3: the kernel rolls each k-mer from the one before it,
    which equals the plain version's full build only for 2-bit codes) and
    lengths2 int32[B2], probing the bloom bitmaps w01 int32
    (uint32 words of bitmap 1, then bitmap 2 from word n_words0) at
    mask_bits hash bits, on the grid p = (STEP_EK - 1) + STEP_EK*g of
    lek-base k-mers, with a top seed per WINDOW grid points. Returns
    (lo26 int32[B2, n_g], kidx int32[B2, n_win], runlen int32[B2, n_win],
    n_exist int32[B2])."""
    B2, W = codes2.shape
    dev = codes2.device
    n_g = _grid(W - lek + 1, STEP_EK)
    if n_g < 1 or not 13 <= lek <= 31 or not 5 <= mask_bits <= 35:
        raise ValueError(f"stage1: W={W}, lek={lek}, mask_bits={mask_bits}")
    # both bitmaps must hold every masked hash: word (h >> 5) of each;
    # word indices stay below 2^31 (a filter over 4 GiB is refused when
    # the tables are built)
    if w01.dim() != 1 or w01.numel() < n_words0 + (1 << (mask_bits - 5)):
        raise ValueError(f"stage1: w01 has {w01.numel()} words, needs "
                         f"{n_words0} + 2^{mask_bits - 5}")
    kernels.check("w01", w01, torch.int32, device=dev)
    kernels.check("codes2", codes2, torch.uint8, (B2, W), dev)
    kernels.check("lengths2", lengths2, torch.int32, (B2,), dev)
    if not kernels.launch_device(codes2):
        return stage1_plain(w01, codes2, lengths2, lek, sbm, mask_bits,
                            n_words0)
    n_win = -(-n_g // WINDOW)
    i32 = torch.int32
    lo26 = torch.empty((B2, n_g), dtype=i32, device=dev)
    seeds = torch.empty((2, B2, n_win), dtype=i32, device=dev)
    n_exist = torch.empty((B2,), dtype=i32, device=dev)
    if B2:
        with torch.cuda.device(dev):
            kernels.call("stage1", kernels.ptr(w01), n_words0,
                         kernels.ptr(codes2), kernels.ptr(lengths2), B2, W,
                         lek, sbm, mask_bits, STEP_EK, WINDOW,
                         kernels.ptr(lo26), kernels.ptr(seeds[0]),
                         kernels.ptr(seeds[1]), kernels.ptr(n_exist),
                         kernels.stream(dev))
        kernels.launches["stage1"] += 1
    return lo26, seeds[0], seeds[1], n_exist
