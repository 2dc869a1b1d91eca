"""Loader of the on-disk index, in the C reference's own file format.

An index directory holds the reference's ten `deSAMBA.*` files (write_bwt,
bwt.c:206-267; write_idx, idx.c:1046-1101). `load_index` reads the ones
the classify path needs and returns one `HostIndex` of numpy arrays: what
`convert.build_tables` lays out on the device and what the native replay
(`engine/native.py`) hands to the C++ engine.

It is the counterpart of three steps of the JAX package, read together:
the reader `index/format_ref.py:RefFormatIndex`, the array preparation of
`oracle/classify.py:OracleIndex.__init__` (codes, cum, L, dollar_pos, the
extended unitig tables, the MAPQ tables of `oracle/mapq.py`) and
`index/tensor_index.py:from_oracle_index` (the occ bit-planes). Field names
and dtypes are from_oracle_index's; `cum` and `n_unitig` are what the
native engine needs beyond them.
"""
from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass

import numpy as np

from ..constants import (BLOCK_BYTES, BP_PER_BLOCK, EK_SIZE_LADDER,
                         L_PRE_IDX, MAX_LV_R_LEN, MAX_LV_WRONG, P_E,
                         Q_MEM_MAX, SINGLE_BASE_MAX_RATIO)

HASH_SIZE = (1 << (2 * L_PRE_IDX)) + 1


@dataclass
class HostIndex:
    # FM index
    bwt_base: np.ndarray      # int32[n_blk, 8] counts of A,C,G,T,# before
                              # each 256-row block (lanes 5-7 zero)
    bwt_bits: np.ndarray      # uint32[n_blk, 5, 8] one-hot bit-planes of
                              # the codes, pad rows (>= L) zeroed
    bwt_pad: np.ndarray       # uint8[n_blk*256] raw code stream, pad
                              # nibbles included
    cum: np.ndarray           # int64[6, n_blk*256 + 1] count of code c in
                              # rows [0, r), flat past L
    rank: np.ndarray          # int64[6]
    hash13: np.ndarray        # int32[4^13 + 1] (int64 if >= 2^31)
    sa_uni: np.ndarray        # int32 sampled SA: unitig
    sa_off: np.ndarray        # int32 sampled SA: offset
    dollar_pos: int
    L: int                    # BWT rows
    n_unitig: int             # real unitigs (the file's count less the
                              # build's dummy)
    # unitigs and references
    uni_len: np.ndarray       # int32[n_unitig + 2], zero-extended
    uni_reflist: np.ndarray   # int64[n_unitig + 3], extended
    refpos_global: np.ndarray  # int64
    refpos_refid: np.ndarray  # int32
    ref_names: list
    ref_len: np.ndarray       # int64
    ref_offset: np.ndarray    # int64
    ref_bin: np.ndarray       # uint8, 4 bases a byte
    # exist filter
    ek_words0: np.ndarray     # the two bitmaps' bytes as uint32 words
    ek_words1: np.ndarray     # (as uint8 bytes if not a multiple of 4)
    ek_mask_bits: int
    ek_len: int
    ek_single_base_max: int
    # MAPQ tables of the native engine
    q_mem: np.ndarray         # int32[Q_MEM_MAX]
    q_lv: np.ndarray          # int32[MAX_LV_WRONG, MAX_LV_R_LEN]


def _path(dir_path: str, ext: str) -> str:
    return os.path.join(dir_path, "deSAMBA" + ext)


def _u64(f) -> int:
    return struct.unpack("<Q", f.read(8))[0]


def bitplanes(codes: np.ndarray):
    """(bwt_base int32[n_blk, 8], bwt_bits uint32[n_blk, 5, 8]) of a code
    stream of whole 256-row blocks (tensor_index.py:63-76)."""
    n_blk = codes.size // BP_PER_BLOCK
    c = codes.reshape(n_blk, 8, 32)
    bits = np.zeros((n_blk, 5, 8), dtype=np.uint32)
    shift = np.arange(32, dtype=np.uint32)
    per = np.zeros((n_blk, 5), dtype=np.int64)
    for ch in range(5):
        eq = c == ch
        bits[:, ch, :] = (eq.astype(np.uint32) << shift).sum(
            axis=2, dtype=np.uint32)
        per[:, ch] = eq.sum(axis=(1, 2))
    base = np.zeros((n_blk, 8), dtype=np.int32)
    base[1:, :5] = np.cumsum(per, axis=0)[:-1].astype(np.int32)
    return base, bits


def mapq_tables(l_ref: int, p_e: float = P_E):
    """Q_MEM[i] and Q_LV[ed][len] with C's double-to-int truncation
    (calculate_MAPQ_TABLE, cly_mt.c:396-420; oracle/mapq.py)."""
    ref_size_penalty = -10.0 * math.log(float(l_ref)) / math.log(10.0)
    match_score = -10.0 * math.log(0.25 / (1.0 - p_e)) / math.log(10.0)
    mismatch_penalty = -10.0 * math.log(0.75 / p_e) / math.log(10.0)
    q_mem = np.array([int(ref_size_penalty + i * match_score + 0.5)
                      for i in range(Q_MEM_MAX)], dtype=np.int32)
    q_lv = np.empty((MAX_LV_WRONG, MAX_LV_R_LEN), dtype=np.int32)
    for j in range(MAX_LV_R_LEN):
        for i in range(MAX_LV_WRONG):
            v = int((j - i) * match_score + i * mismatch_penalty + 0.5)
            q_lv[i, j] = max(v + 15 if j < 5 else v, -8)
    return q_mem, q_lv


def load_index(dir_path: str) -> HostIndex:
    """Read an index directory in the reference's format."""
    with open(_path(dir_path, ".bwt"), "rb") as f:
        n_bytes = _u64(f)
        blob = np.frombuffer(f.read(n_bytes), np.uint8).reshape(
            -1, BLOCK_BYTES)
        rank = np.zeros(6, dtype=np.int64)
        rank[:5] = np.frombuffer(f.read(40), "<u8").astype(np.int64)
        rank[5] = rank[0] - 1
        hash13 = np.frombuffer(f.read(HASH_SIZE * 8), "<u8").astype(np.int64)
    block_codes = blob[:, 40:]
    codes = np.empty(block_codes.shape[0] * BP_PER_BLOCK, dtype=np.uint8)
    codes[0::2] = (block_codes & 0xF).reshape(-1)
    codes[1::2] = (block_codes >> 4).reshape(-1)
    del blob, block_codes
    with open(_path(dir_path, ".sa"), "rb") as f:
        inter = np.frombuffer(f.read(_u64(f) * 8), "<u4")
    sa_uni = inter[0::2].astype(np.int32)
    sa_off = inter[1::2].astype(np.int32)
    with open(_path(dir_path, ".exki"), "rb") as f:
        ek_size = _u64(f)
    _, mask_bits, lek = next((s, b, k) for _, s, b, k in EK_SIZE_LADDER
                             if s == ek_size)
    ek0 = np.fromfile(_path(dir_path, ".exk0"), dtype=np.uint8)
    ek1 = np.fromfile(_path(dir_path, ".exk1"), dtype=np.uint8)
    with open(_path(dir_path, ".unv"), "rb") as f:
        n = _u64(f)  # unitigs + the build's dummy + the file's tail
        rec = np.frombuffer(f.read(n * 8), "<u4")
    reflist = rec[0::2].astype(np.int64)
    uni_len = rec[1::2][: n - 1].astype(np.int64)
    N = n - 2
    L = int(uni_len.sum()) + N
    with open(_path(dir_path, ".ref_b"), "rb") as f:
        ref_bin = np.frombuffer(f.read(_u64(f)), dtype=np.uint8)
    names, rl, ro = [], [], []
    with open(_path(dir_path, ".ref_i"), "rb") as f:
        for _ in range(_u64(f)):
            names.append(f.read(128).split(b"\0", 1)[0].decode())
            sl, so = struct.unpack("<QQ", f.read(16))
            rl.append(sl)
            ro.append(so)
    with open(_path(dir_path, ".ref_p"), "rb") as f:
        v = np.frombuffer(f.read(_u64(f) * 8), "<u8")
    # REF_POS bitfield: global_offset:40 | ref_ID:23 | direction:1 (idx.h:42)
    refpos_global = (v & np.uint64((1 << 40) - 1)).astype(np.int64)
    refpos_refid = ((v >> np.uint64(40))
                    & np.uint64((1 << 23) - 1)).astype(np.int32)

    cum = np.zeros((6, codes.size + 1), dtype=np.int64)
    for c in range(6):
        cum[c, 1 : L + 1] = np.cumsum(codes[:L] == c)
        cum[c, L + 1 :] = cum[c, L]
    clean = codes.copy()
    clean[L:] = 0  # pad nibbles become code 0 in the bit-planes only;
    # no occ query reads past row L
    bwt_base, bwt_bits = bitplanes(clean)
    del clean
    q_mem, q_lv = mapq_tables(ref_bin.size * 4)
    words = lambda b: b.view(np.uint32) if b.size % 4 == 0 else b
    return HostIndex(
        bwt_base=bwt_base, bwt_bits=bwt_bits, bwt_pad=codes, cum=cum,
        rank=rank,
        hash13=hash13.astype(np.int32) if hash13.max(initial=0) < 2**31
        else hash13,
        sa_uni=sa_uni, sa_off=sa_off, dollar_pos=N - 1, L=L, n_unitig=N,
        uni_len=np.concatenate([uni_len, [0]]).astype(np.int32),
        uni_reflist=np.concatenate(
            [reflist, [reflist[-1] + 1 + uni_len[-1] if uni_len.size
                       else 0]]).astype(np.int64),
        refpos_global=refpos_global, refpos_refid=refpos_refid,
        ref_names=names, ref_len=np.array(rl, dtype=np.int64),
        ref_offset=np.array(ro, dtype=np.int64), ref_bin=ref_bin,
        ek_words0=words(ek0), ek_words1=words(ek1),
        ek_mask_bits=mask_bits, ek_len=lek,
        ek_single_base_max=int(SINGLE_BASE_MAX_RATIO * lek),
        q_mem=q_mem, q_lv=q_lv)
