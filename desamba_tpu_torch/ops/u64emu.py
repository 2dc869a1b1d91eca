"""uint64 arithmetic on (hi, lo) 32-bit halves, for the exist-filter hashes.

Counterpart of desamba_tpu/ops/u64emu.py. torch has no usable uint32
arithmetic on the CPU, so each half is held in an int64 tensor whose value
stays in [0, 2^32): results are masked back to 32 bits after every `<<`,
`+` and `~`. Right shifts of a non-negative int64 are logical.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def popcount32(x):
    """Popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def add(a, b):
    lo = (a[1] + b[1]) & M32
    carry = (lo < a[1]).to(torch.int64)
    return ((a[0] + b[0] + carry) & M32, lo)


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def not_(a):
    return (a[0] ^ M32, a[1] ^ M32)


def shl(a, n: int):
    if n == 0:
        return a
    if n >= 64:
        z = torch.zeros_like(a[0])
        return (z, z)
    if n >= 32:
        return ((a[1] << (n - 32)) & M32, torch.zeros_like(a[1]))
    return (((a[0] << n) | (a[1] >> (32 - n))) & M32, (a[1] << n) & M32)


def shr(a, n: int):
    if n == 0:
        return a
    if n >= 64:
        z = torch.zeros_like(a[0])
        return (z, z)
    if n >= 32:
        return (torch.zeros_like(a[0]), a[0] >> (n - 32))
    return (a[0] >> n, ((a[1] >> n) | (a[0] << (32 - n))) & M32)


def and_mask_bits(a, bits: int):
    """a & ((1 << bits) - 1)."""
    if bits >= 64:
        return a
    if bits >= 32:
        return (a[0] & ((1 << (bits - 32)) - 1), a[1])
    return (torch.zeros_like(a[0]), a[1] & ((1 << bits) - 1))


def hash64_1(key):
    """lib/utils.c:1067-1077 on (hi, lo) pairs."""
    k = key
    k = add(not_(k), shl(k, 21))
    k = xor(k, shr(k, 24))
    k = add(add(k, shl(k, 3)), shl(k, 8))
    k = xor(k, shr(k, 14))
    k = add(add(k, shl(k, 2)), shl(k, 4))
    k = xor(k, shr(k, 28))
    k = add(k, shl(k, 31))
    return k


def hash64_2(key):
    """lib/utils.c:1080-1091."""
    k = key
    k = add(k, not_(shl(k, 32)))
    k = xor(k, shr(k, 22))
    k = add(k, not_(shl(k, 13)))
    k = xor(k, shr(k, 8))
    k = add(k, shl(k, 3))
    k = xor(k, shr(k, 15))
    k = add(k, not_(shl(k, 27)))
    k = xor(k, shr(k, 31))
    return k
