"""Read codes for the validation engine.

Counterpart of the part of desamba_tpu/utils/codec.py that the validation
engine calls: the classifier's char-to-code table CLY_Bit (A/C/G/T and
a/c/g/t to 0..3, every other char to 'C' = 1; cly.c:16-34) and the
lookup that applies it.
"""
from __future__ import annotations

import numpy as np

CLY_BIT = np.full(256, 1, dtype=np.uint8)
for _j, _ch in enumerate("ACGT"):
    CLY_BIT[ord(_ch)] = CLY_BIT[ord(_ch.lower())] = _j


def seq_to_codes(seq, table: np.ndarray = CLY_BIT) -> np.ndarray:
    """uint8 codes of an ASCII sequence (bytes or a uint8 array)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return table[np.asarray(seq, dtype=np.uint8)]
