"""Seed selection from exist-filter probe maps.

Counterpart of desamba_tpu/ops/seeds.py (get_seed_vector_M2 analog,
cly.c:1157-1229): the run of consecutive probe hits ending at each grid
position, and the longest run per window, earliest position on ties.
Plain torch; no hand kernel yet.
"""
from __future__ import annotations

import torch

from desamba_tpu.constants import SEED_RANGE


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
