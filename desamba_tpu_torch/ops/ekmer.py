"""Exist-filter probe: rolling e-kmers, low-complexity filter and the
two-hash bloom test over [B, L] read-code matrices.

Counterpart of desamba_tpu/ops/ekmer.py. Both bitmaps live in one int32
tensor holding the uint32 words (w1's words after w0's), so the two probes
of a k-mer are one gather. `_probe_reads` and `kmer_lo26` are the plain
torch versions of two thirds of the stage-1 kernel (ops/seeds.stage1,
csrc/stage1.cu); `_probe_reads` at stride 1 is the plain version of the
validation engine's probe of every e-kmer (`probe_reads`, csrc/probe.cu).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import u64emu as u64
from .fm import _popcount_np


def _bitmap_load(w: np.ndarray) -> float:
    """Sampled fraction of set bits (the fold rule needs ~1% accuracy)."""
    s = np.asarray(w[:: max(1, w.size // (1 << 20))])
    return int(_popcount_np(s).sum()) / (s.size * 32)


def fold_words(w0: np.ndarray, w1: np.ndarray, mask_bits: int,
               fold_bits="auto"):
    """The bitmaps OR-folded by 2^k (k = fold_bits, or the "auto" rule:
    fold while a bitmap exceeds 8M words and its projected load stays
    under 35%). Folding is bit-exactly the bloom with mask_bits - k, since
    the address split takes the low bits of the hash.

    Returns (w0, w1, mask_bits, fold_bits)."""
    if fold_bits == "auto":
        fold_bits = 0
        load = max(_bitmap_load(w0), _bitmap_load(w1))
        while (w0.size >> fold_bits) > (8 << 20):
            next_load = 1 - (1 - load) ** 2
            if next_load > 0.35:
                break
            fold_bits += 1
            load = next_load
    for _ in range(fold_bits):
        w0 = w0[: w0.size // 2] | w0[w0.size // 2 : 2 * (w0.size // 2)]
        w1 = w1[: w1.size // 2] | w1[w1.size // 2 : 2 * (w1.size // 2)]
        mask_bits -= 1
    return w0, w1, mask_bits, fold_bits


class EkArrays:
    """Both bloom bitmaps in one device tensor plus the static probe
    parameters (n_words0 = w1's offset, mask_bits, lek, single_base_max)."""

    def __init__(self, w01: torch.Tensor, n_words0: int, mask_bits: int,
                 lek: int, single_base_max: int, fold_bits: int = 0):
        self.w01 = w01
        self.n_words0 = int(n_words0)
        self.mask_bits = int(mask_bits)
        self.lek = int(lek)
        self.single_base_max = int(single_base_max)
        self.fold_bits = int(fold_bits)

    @classmethod
    def from_tensor_index(cls, ti, device="cpu", fold_bits=0):
        w0 = np.asarray(ti.ek_words0).view(np.uint32)
        w1 = np.asarray(ti.ek_words1).view(np.uint32)
        w0, w1, mask_bits, fold_bits = fold_words(
            w0, w1, int(ti.ek_mask_bits), fold_bits)
        if (1 << mask_bits) > (1 << 35):
            raise NotImplementedError(
                "exist filters > 4 GiB need int64 word indexing; shard the "
                "index instead")
        w01 = np.concatenate([w0, w1]).view(np.int32)
        return cls(torch.from_numpy(w01).to(device), w0.size, mask_bits,
                   int(ti.ek_len), int(ti.ek_single_base_max), fold_bits)


def _grid(n_kmer: int, stride: int) -> int:
    """Stride-grid size: positions p(g) = (stride-1) + stride*g, the probe
    schedule of search_exist_kmer_M2 (cly.c:979)."""
    return (n_kmer - stride) // stride + 1


def _addr(h):
    """Hash -> (word index, bit shift within word): byte h>>3, bit 7-(h&7)
    (idx.c:1019), little-endian u32 words of 4 bytes."""
    hi, lo = h
    word_idx = ((lo >> 5) | (hi << 27)) & u64.M32
    bit = 7 - (lo & 7)
    return word_idx, ((lo >> 3) & 3) * 8 + bit


def _sub(x: torch.Tensor, j0: int, stride: int, n_g: int) -> torch.Tensor:
    """Columns j0 + stride*[0, n_g) of a [B, ...] tensor."""
    return x[:, j0 : j0 + stride * (n_g - 1) + 1 : stride]


def _probe_addrs(codes, lengths, lek: int, single_base_max: int,
                 mask_bits: int, stride: int = 1):
    """(want bool[B, n_g], (wi1, sh1), (wi2, sh2)): the grid points at
    offset (stride-1) + stride*g that must read the bitmaps (they pass the
    base-count filter, are not the zero k-mer and lie in the read), and the
    word index and bit shift of each point's two probes, flattened; wi2
    indexes the second bitmap."""
    B, L = codes.shape
    dev = codes.device
    n_g = _grid(L - lek + 1, stride)
    c = codes.to(torch.int64)
    p0 = stride - 1
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    fail = torch.zeros((B, n_g), dtype=torch.bool, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for base in range(4):
        is_b = ((c == base) & valid).to(torch.int32)
        ps = torch.cat([zero, torch.cumsum(is_b, 1, dtype=torch.int32)], 1)
        wc = _sub(ps, p0 + lek, stride, n_g) - _sub(ps, p0, stride, n_g)
        fail |= wc >= single_base_max
    hi = torch.zeros((B, n_g), dtype=torch.int64, device=dev)
    lo = torch.zeros((B, n_g), dtype=torch.int64, device=dev)
    for j in range(lek):
        cc = _sub(c, p0 + j, stride, n_g)
        hi = ((hi << 2) | (lo >> 30)) & u64.M32
        lo = ((lo << 2) | cc) & u64.M32
    pos = p0 + stride * torch.arange(n_g, device=dev)
    in_read = pos[None, :] + lek <= lengths[:, None]
    want = ~fail & ~((hi == 0) & (lo == 0)) & in_read
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    h1 = u64.and_mask_bits(u64.hash64_1((hi, lo)), mask_bits)
    h2 = u64.and_mask_bits(u64.hash64_2((hi, lo)), mask_bits)
    return want, _addr(h1), _addr(h2)


def _probe_reads(w01, codes, lengths, lek: int, single_base_max: int,
                 mask_bits: int, stride: int = 1, n_words0: int = 0):
    """uint8[B, n_g]: 1 where the e-kmer at grid offset (stride-1) +
    stride*g passes the base-count filter, is not the zero k-mer, lies in
    the read and hits both bloom bitmaps (get_exist_kmer). Both probes of
    a k-mer are one gather into the concatenated bitmaps."""
    want, (wi1, sh1), (wi2, sh2) = _probe_addrs(
        codes, lengths, lek, single_base_max, mask_bits, stride)
    n = wi1.shape[0]
    w = w01[torch.cat([wi1, wi2 + n_words0])].to(torch.int64)
    r1 = ((w[:n] >> sh1) & 1).bool()
    r2 = ((w[n:] >> sh2) & 1).bool()
    return (want & r1.view(want.shape) & r2.view(want.shape)).to(torch.uint8)


def kmer_lo26(codes, lek: int, stride: int = 1):
    """int32[B, n_g]: the last 13 bases (hash13 prefix value, idx.h:59) of
    the e-kmer at each grid offset, on _probe_reads' grid."""
    B, L = codes.shape
    n_g = _grid(L - lek + 1, stride)
    p0 = stride - 1
    c = codes.to(torch.int64)
    lo = torch.zeros((B, n_g), dtype=torch.int64, device=codes.device)
    for j in range(lek - 13, lek):
        lo = (lo << 2) | _sub(c, p0 + j, stride, n_g)
    return (lo & 0x3FFFFFF).to(torch.int32)


def probe_reads_plain(ek: EkArrays, codes, lengths) -> torch.Tensor:
    """Plain torch version of the probe_reads kernel: _probe_reads at
    stride 1."""
    return _probe_reads(ek.w01, codes, lengths, ek.lek, ek.single_base_max,
                        ek.mask_bits, stride=1, n_words0=ek.n_words0)


def probe_reads(ek: EkArrays, codes, lengths) -> torch.Tensor:
    """uint8[B, W - lek + 1]: the exist-filter hit of the e-kmer at every
    offset of every row (stride 1), as JAX's probe_reads. codes:
    uint8[B, W] (codes 0-3, W >= lek), lengths int32[B], on the bitmaps'
    device. On CUDA tensors the hand kernel runs; on the CPU, its plain
    version."""
    dev = ek.w01.device
    kernels.check("w01", ek.w01, torch.int32, device=dev)
    if ek.w01.dim() != 1 or ek.w01.numel() < ek.n_words0 + (
            1 << max(0, ek.mask_bits - 5)):
        raise ValueError(f"probe_reads: w01 has {ek.w01.numel()} words, "
                         f"needs {ek.n_words0} + 2^{ek.mask_bits - 5}")
    if codes.dim() != 2 or codes.shape[1] < ek.lek:
        raise ValueError(f"probe_reads: codes of shape "
                         f"{tuple(codes.shape)}, need [B, >= {ek.lek}]")
    B, W = codes.shape
    kernels.check("codes", codes, torch.uint8, device=dev)
    kernels.check("lengths", lengths, torch.int32, (B,), dev)
    if not kernels.launch_device(codes):
        return probe_reads_plain(ek, codes, lengths)
    out = torch.empty((B, W - ek.lek + 1), dtype=torch.uint8, device=dev)
    if B:
        with torch.cuda.device(dev):
            kernels.call("probe_reads", kernels.ptr(ek.w01), ek.n_words0,
                         kernels.ptr(codes), kernels.ptr(lengths), B, W,
                         ek.lek, ek.single_base_max, ek.mask_bits,
                         kernels.ptr(out), kernels.stream(dev))
        kernels.launches["probe_reads"] += 1
    return out
