"""Packed reference words for the stage-4 band gather.

Counterpart of desamba_tpu/ops/refwin.py's RefArrays, carrying only what
the fast path reads: ref_words_lsb (the 2-bit reference as little-endian
uint32 words of 16 codes, code t at bits 2t, the read wire format's
order; stored as int32 with the same bits), ref_offset and ref_len.
"""
from __future__ import annotations

import numpy as np
import torch


def words_lsb(ref_bin: np.ndarray) -> np.ndarray:
    """MSB-first 2-bit bytes -> uint32 words with code t at bits 2t."""
    rb = np.asarray(ref_bin, dtype=np.uint8)
    b = np.arange(256, dtype=np.uint8)
    rev = (((b >> 6) & 3) | (((b >> 4) & 3) << 2)
           | (((b >> 2) & 3) << 4) | ((b & 3) << 6)).astype(np.uint8)
    return np.pad(rev[rb], (0, (-len(rb)) % 4)).view("<u4")


class RefArrays:
    def __init__(self, ref_words_lsb, ref_offset, ref_len):
        self.ref_words_lsb = ref_words_lsb
        self.ref_offset = ref_offset
        self.ref_len = ref_len

    @classmethod
    def from_tensor_index(cls, ti, device="cpu"):
        if np.asarray(ti.ref_offset).max(initial=0) + np.asarray(
                ti.ref_len).max(initial=0) >= 2**31:
            raise NotImplementedError(
                "reference > 2^31 bp per shard; shard the index")
        return cls(
            torch.from_numpy(words_lsb(ti.ref_bin).view(np.int32)).to(device),
            torch.from_numpy(
                np.asarray(ti.ref_offset).astype(np.int32)).to(device),
            torch.from_numpy(
                np.asarray(ti.ref_len).astype(np.int32)).to(device))
