"""Batched FM-index primitives: tables, occ, LF, and the two stage-2 loops.

Counterpart of desamba_tpu/ops/fm.py. `interval_search` and `row_walks`
each have a hand-written CUDA kernel (csrc/fm_search.cu, csrc/row_walks.cu)
and a plain torch version; so does `row_walks` with its row trace
(`row_walks_trace`, the validation engine's form). The wrapper runs the
plain version for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.

The carries are packed int32 tensors: [8, n] for the interval search
(sp, ep, nsp, nep, match_len, ptr, done, status) and [5, n] for the row
walks (sp, ptr, n, done, bad). Both loops resume through an index list
`sel` (ops/compact.compact's output): only the listed lanes step, and the
returned carry keeps every other lane as it was, which is JAX's gather of
the compacted carry, resume and scatter back. Tables holding uint32
words (occ32, lfc) are stored as int32 with the same bits; plain
versions widen them to int64 and mask to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .u64emu import M32, popcount32

LFC_SHIFT = 29          # char in bits 29-31, next row in bits 0-28
LFC_ROW_MASK = (1 << LFC_SHIFT) - 1
L_PRE = 13
LFC_CHUNK = 1 << 24     # rows per step of the host-side lfc build


def _popcount_np(a: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0
        return np.bitwise_count(a).astype(np.int64)
    return np.unpackbits(a.view(np.uint8), axis=-1).reshape(
        *a.shape, 32).sum(axis=-1, dtype=np.int64)


def jax_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index rule: negative counts from the end, then clamp."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def occ32_layout(bwt_base: np.ndarray, bwt_bits: np.ndarray):
    """The 256 bp checkpoint blocks re-laid as 32 bp blocks whose
    (cumulative count, bit word) pairs sit adjacent: returns
    (occ32 uint32[n_blk*8, 5, 2], base32 uint32[n_blk*8, 5],
    bits32 uint32[n_blk*8, 5])."""
    base = np.asarray(bwt_base, dtype=np.int64)[:, :5]     # [n_blk, 5]
    bits = np.asarray(bwt_bits, dtype=np.uint32)           # [n_blk, 5, 8]
    n_blk = bits.shape[0]
    pc = _popcount_np(bits)
    excl = np.cumsum(pc, axis=2) - pc                      # within-block
    base32 = (base[:, :, None] + excl).astype(np.uint32)   # [n_blk, 5, 8]
    occ32 = np.stack([base32, bits], axis=3).transpose(0, 2, 1, 3)
    return (np.ascontiguousarray(occ32.reshape(n_blk * 8, 5, 2)),
            base32.transpose(0, 2, 1).reshape(n_blk * 8, 5),
            bits.transpose(0, 2, 1).reshape(n_blk * 8, 5))


def build_lfc(pad: np.ndarray, base32: np.ndarray, bits32: np.ndarray,
              rank: np.ndarray, dollar_pos: int, L: int) -> np.ndarray:
    """Fused LF table: lfc[r] = (char(r) << 29) | LF(r), uint32.

    char 0-5 as in the raw stream; pad nibbles (> 5) and rows >= L store
    char 7 with next = 0. Built in row chunks to bound host memory."""
    n_rows = pad.shape[0]
    if L + int(rank[5]) >= (1 << LFC_SHIFT):
        raise NotImplementedError(
            "index shard exceeds 2^29 BWT rows; shard the index")
    rank = np.asarray(rank, dtype=np.int64)
    out = np.empty(n_rows, dtype=np.uint32)
    for r0 in range(0, n_rows, LFC_CHUNK):
        r = np.arange(r0, min(n_rows, r0 + LFC_CHUNK), dtype=np.int64)
        c = pad[r0 : r0 + r.size].astype(np.int64)
        bad = (c > 5) | (r >= L)
        cs = np.where(bad, 0, c)
        c_occ = np.minimum(cs, 4)
        w = r >> 5
        mask = (np.uint32(1) << (r & 31).astype(np.uint32)) - np.uint32(1)
        v = (base32[w, c_occ].astype(np.int64)
             + _popcount_np(bits32[w, c_occ] & mask))
        v = np.where(cs == 5, dollar_pos, v)
        nxt = v + rank[np.minimum(cs, 5)]
        out[r0 : r0 + r.size] = np.where(
            bad, np.uint32(7) << LFC_SHIFT,
            (cs.astype(np.uint32) << LFC_SHIFT) | nxt.astype(np.uint32))
    return out


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """uint32/int32 numpy -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


class FmArrays:
    """Device-resident FM index tables (counterpart of ops/fm.py FmArrays).

    occ32 int32[n_blk*8, 5, 2] (uint32 bits), pad uint8[rows], rank
    int32[6], hash13 int32[2^26+1], sa_uni/sa_off int32, lfc int32[rows]
    (uint32 bits), and the host ints L and dollar_pos."""

    def __init__(self, occ32, pad, rank, hash13, sa_uni, sa_off, lfc,
                 L: int, dollar_pos: int):
        self.occ32, self.pad, self.rank = occ32, pad, rank
        self.hash13, self.sa_uni, self.sa_off = hash13, sa_uni, sa_off
        self.lfc = lfc
        self.L, self.dollar_pos = int(L), int(dollar_pos)

    @classmethod
    def from_tensor_index(cls, ti, device="cpu"):
        occ32, base32, bits32 = occ32_layout(ti.bwt_base, ti.bwt_bits)
        pad = np.asarray(ti.bwt_pad, dtype=np.uint8)
        lfc = build_lfc(pad, base32, bits32,
                        np.asarray(ti.rank, dtype=np.int64),
                        int(ti.dollar_pos), int(ti.L))
        return cls(
            occ32=_i32(occ32, device),
            pad=torch.from_numpy(pad).to(device),
            rank=torch.from_numpy(np.asarray(ti.rank).astype(np.int32)).to(
                device),
            hash13=torch.from_numpy(
                np.asarray(ti.hash13).astype(np.int32)).to(device),
            sa_uni=torch.from_numpy(
                np.asarray(ti.sa_uni).astype(np.int32)).to(device),
            sa_off=torch.from_numpy(
                np.asarray(ti.sa_off).astype(np.int32)).to(device),
            lfc=_i32(lfc, device), L=int(ti.L),
            dollar_pos=int(ti.dollar_pos))


def occ(fm: FmArrays, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Count of char c (0..4) in rows [0, r), int32."""
    r = r.to(torch.int64)
    blk = jax_index(r >> 5, fm.occ32.shape[0])
    pair = fm.occ32[blk, c.to(torch.int64)].to(torch.int64) & M32
    m = (1 << (r & 31)) - 1
    return ((pair[:, 0] + popcount32(pair[:, 1] & m)) & M32).to(torch.int32)


def lf_cur(fm: FmArrays, r: torch.Tensor):
    """(char, next_row) per lane from the fused lfc word; char > 5 comes
    back as 7 for pad nibbles and rows past L."""
    w = fm.lfc[jax_index(r.to(torch.int64), fm.lfc.shape[0])].to(
        torch.int64) & M32
    return (w >> LFC_SHIFT).to(torch.int32), (w & LFC_ROW_MASK).to(
        torch.int32)


# ------------------------------------------------------ interval search --
def iv_init(sp0, ep0, s_idx) -> torch.Tensor:
    """Initial [8, n] interval-search carry."""
    z = torch.zeros_like(sp0, dtype=torch.int32)
    return torch.stack([
        sp0.to(torch.int32), ep0.to(torch.int32), z, z,
        torch.full_like(z, L_PRE), s_idx.to(torch.int32) - L_PRE, z, z])


def _resume(loop, state, sel, lanes, *per_lane):
    """loop(lanes, *per_lane, carry) on the carry's columns listed in sel
    (entries outside [0, n) skipped), scattered into a copy of state."""
    n = state.shape[1]
    idx = sel[(sel >= 0) & (sel < n)].long()
    out = state.clone()
    out[:, idx] = loop(lanes[idx], *(t[idx] for t in per_lane),
                       state[:, idx])
    return out


def interval_search_plain(fm: FmArrays, codes, lanes, max_rst, l_min,
                          l_max, state, max_steps: int,
                          sel=None) -> torch.Tensor:
    """Plain torch version of the K1 kernel: the JAX lockstep loop; with
    sel, on the listed lanes only (gather, loop, scatter)."""
    if sel is not None:
        return _resume(
            lambda *a: interval_search_plain(fm, codes, *a, max_steps),
            state, sel, lanes, max_rst, l_min, l_max)
    sp, ep, nsp, nep, ml, ptr, done, status = state.clone().unbind(0)
    done = done.bool()
    n = sp.shape[0]
    W = codes.shape[1]
    lanes = lanes.to(torch.int64)
    it = 0
    while it < max_steps and not bool(done.all()):
        ok = (ptr >= 0) & (ptr < W)
        ch = torch.where(ok, codes[lanes, ptr.clamp(0, W - 1).long()], 255)
        valid_c = ch <= 5
        cc = ch.clamp(0, 5).long()
        c_occ = cc.clamp(0, 4)
        both = occ(fm, torch.cat([sp, ep]), torch.cat([c_occ, c_occ]))
        rk = fm.rank[cc]
        s = torch.where(valid_c, rk + both[:n], 0)
        e = torch.where(valid_c, rk + both[n:], 0)
        brk1 = (ml >= l_min - 1) & (s + max_rst >= e)
        ret0 = (ml >= l_min - 1) & ~brk1 & (ml >= l_max)
        brk2 = ~brk1 & ~ret0 & (s + 1 >= e)
        stop = brk1 | ret0 | brk2
        act = ~done
        go = act & ~stop
        sp = torch.where(go, s, sp)
        ep = torch.where(go, e, ep)
        nsp = torch.where(act & stop, s, nsp)
        nep = torch.where(act & stop, e, nep)
        ml = torch.where(go, ml + 1, ml)
        ptr = torch.where(act, ptr - 1, ptr)
        done = done | (act & stop)
        status = torch.where(act & ret0, 1, status)
        it += 1
    return torch.stack([sp, ep, nsp, nep, ml, ptr, done.to(torch.int32),
                        status]).to(torch.int32)


def interval_search_state(fm: FmArrays, codes, lanes, max_rst, l_min,
                          l_max, state, max_steps: int,
                          sel=None) -> torch.Tensor:
    """Run up to max_steps steps of the backward search on every live lane
    of an [8, n] carry (with sel, int32[m] of distinct lane indices, on the
    listed lanes only); returns the new carry. With sel, the CUDA route
    updates `state` in place and returns it (no copy of the carry;
    unlisted lanes stay as they are); the CPU route returns a new carry
    and leaves `state` as it was. Callers use the returned carry and
    never `state` after a resume. Without sel, both routes return a new
    carry. codes: int32[B2, W] read codes; lanes/max_rst/l_min/l_max:
    int32[n]; all contiguous, on one device."""
    n = state.shape[1]
    dev = state.device
    kernels.check("occ32", fm.occ32, torch.int32, device=dev)
    if fm.occ32.dim() != 3 or tuple(fm.occ32.shape[1:]) != (5, 2):
        raise ValueError(f"occ32: shape {tuple(fm.occ32.shape)}")
    kernels.check("rank", fm.rank, torch.int32, (6,), dev)
    kernels.check("codes", codes, torch.int32, device=dev)
    for name, t in (("lanes", lanes), ("max_rst", max_rst), ("l_min", l_min),
                    ("l_max", l_max)):
        kernels.check(name, t, torch.int32, (n,), dev)
    kernels.check("state", state, torch.int32, (8, n), dev)
    if sel is not None:
        kernels.check("sel", sel, torch.int32, (sel.numel(),), dev)
    if not kernels.launch_device(state):
        return interval_search_plain(fm, codes, lanes, max_rst, l_min, l_max,
                                     state, max_steps, sel)
    out = torch.empty_like(state) if sel is None else state
    with torch.cuda.device(dev):
        kernels.call("interval_search", kernels.ptr(fm.occ32),
                     fm.occ32.shape[0], kernels.ptr(fm.rank),
                     kernels.ptr(codes), codes.shape[1], kernels.ptr(lanes),
                     kernels.ptr(max_rst), kernels.ptr(l_min),
                     kernels.ptr(l_max), kernels.ptr(state),
                     kernels.ptr(out), n, kernels.ptr(sel),
                     n if sel is None else sel.numel(), int(max_steps),
                     kernels.stream(dev))
    kernels.launches["interval_search"] += 1
    return out


# ------------------------------------------------------------ row walks --
def rw_init(start_rows, ptrs) -> torch.Tensor:
    """Initial [5, n] row-walk carry."""
    z = torch.zeros_like(start_rows, dtype=torch.int32)
    return torch.stack([start_rows.to(torch.int32), ptrs.to(torch.int32),
                        z, z, z])


def row_walks_plain(fm: FmArrays, codes, lanes, max_lens, state,
                    trace_cap: int, sel=None, trace=None) -> torch.Tensor:
    """Plain torch version of the K2 kernel: the JAX no-trace loop; with
    sel, on the listed slots only (gather, loop, scatter). With trace
    (int32 [n, trace_cap] of -1, and no sel), the row each lane reached
    at each step it took is written into it, JAX's with_trace=True."""
    if sel is not None:
        return _resume(
            lambda *a: row_walks_plain(fm, codes, *a, trace_cap),
            state, sel, lanes, max_lens)
    sp, ptr, cnt, done, bad = state.clone().unbind(0)
    done, bad = done.bool(), bad.bool()
    W = codes.shape[1]
    lanes = lanes.to(torch.int64)
    it = 0
    while it < trace_cap and not bool(done.all()):
        c, nxt = lf_cur(fm, sp)
        ok = (ptr >= 0) & (ptr < W)
        want = torch.where(ok, codes[lanes, ptr.clamp(0, W - 1).long()], -1)
        is_bad = c > 5
        match = (c == want) & (cnt < max_lens) & ~is_bad
        act = ~done
        go = act & match
        if trace is not None:
            trace[:, it] = torch.where(go, nxt, -1)
        bad = bad | (act & is_bad & (cnt < max_lens))
        sp = torch.where(go, nxt, sp)
        ptr = torch.where(go, ptr - 1, ptr)
        cnt = torch.where(go, cnt + 1, cnt)
        done = done | (act & ~match)
        it += 1
    return torch.stack([sp, ptr, cnt, done.to(torch.int32),
                        bad.to(torch.int32)]).to(torch.int32)


def row_walks_state(fm: FmArrays, codes, lanes, max_lens, state,
                    trace_cap: int, sel=None) -> torch.Tensor:
    """Run up to trace_cap LF steps on every live lane of a [5, n] carry
    (with sel, int32[m] of distinct slot indices, on the listed slots
    only); returns the new carry. With sel, the CUDA route updates `state`
    in place and returns it (no copy of the carry; unlisted slots stay as
    they are); the CPU route returns a new carry and leaves `state` as it
    was. Callers use the returned carry and never `state` after a
    resume."""
    n = state.shape[1]
    dev = state.device
    kernels.check("lfc", fm.lfc, torch.int32, device=dev)
    kernels.check("codes", codes, torch.int32, device=dev)
    kernels.check("lanes", lanes, torch.int32, (n,), dev)
    kernels.check("max_lens", max_lens, torch.int32, (n,), dev)
    kernels.check("state", state, torch.int32, (5, n), dev)
    if sel is not None:
        kernels.check("sel", sel, torch.int32, (sel.numel(),), dev)
    if not kernels.launch_device(state):
        return row_walks_plain(fm, codes, lanes, max_lens, state, trace_cap,
                               sel)
    out = torch.empty_like(state) if sel is None else state
    with torch.cuda.device(dev):
        kernels.call("row_walks", kernels.ptr(fm.lfc), fm.lfc.shape[0],
                     kernels.ptr(codes), codes.shape[1], kernels.ptr(lanes),
                     kernels.ptr(max_lens), kernels.ptr(state),
                     kernels.ptr(out), n, kernels.ptr(sel),
                     n if sel is None else sel.numel(), int(trace_cap),
                     kernels.stream(dev))
    kernels.launches["row_walks"] += 1
    return out


# ------------------------------------------------------- traced walks --
# rows of the traced walks' int32 [6, n] result, beside the trace
TRACE_KEYS = ("final_sp", "final_ptr", "steps", "bad_char", "overflow",
              "stop_max")


def row_walks_trace_plain(fm: FmArrays, codes, lanes, start_rows, ptrs,
                          max_lens, trace_cap: int = 96) -> dict:
    """Plain torch version of the traced-walk kernel: JAX's row_walks with
    with_trace=True, through row_walks_plain. Lanes that stopped take no
    more steps, so the loop ends once every lane has stopped and the rest
    of the trace is -1."""
    trace = torch.full((start_rows.shape[0], trace_cap), -1,
                       dtype=torch.int32, device=start_rows.device)
    sp, ptr, cnt, done, bad = row_walks_plain(
        fm, codes, lanes, max_lens, rw_init(start_rows, ptrs), trace_cap,
        trace=trace)
    res = torch.stack([sp, ptr, cnt, bad, 1 - done,
                       (cnt >= max_lens).to(torch.int32)])
    return dict(trace=trace, **dict(zip(TRACE_KEYS, res)))


def row_walks_trace(fm: FmArrays, codes, lanes, start_rows, ptrs, max_lens,
                    trace_cap: int = 96) -> dict:
    """Walk each lane from BWT row start_rows[i], matching codes[lanes[i],
    ptr] with ptr from ptrs[i] down, for at most max_lens[i] steps and
    trace_cap lockstep rounds (bwt_single_search without the sp_set
    dedup, which the host replays from the trace). codes: int32[B, W]
    (a ptr outside [0, W) matches nothing); lanes, start_rows, ptrs,
    max_lens: int32[n]. Returns a dict of int32 tensors: trace [n,
    trace_cap] (the row reached at each step taken, else -1) and the
    TRACE_KEYS rows, each [n]."""
    n = start_rows.shape[0]
    dev = start_rows.device
    kernels.check("lfc", fm.lfc, torch.int32, device=dev)
    if codes.dim() != 2 or trace_cap < 0:
        raise ValueError(f"row_walks_trace: codes of shape "
                         f"{tuple(codes.shape)}, trace_cap {trace_cap}")
    kernels.check("codes", codes, torch.int32, device=dev)
    for name, t in (("lanes", lanes), ("start_rows", start_rows),
                    ("ptrs", ptrs), ("max_lens", max_lens)):
        kernels.check(name, t, torch.int32, (n,), dev)
    if not kernels.launch_device(start_rows):
        return row_walks_trace_plain(fm, codes, lanes, start_rows, ptrs,
                                     max_lens, trace_cap)
    trace = torch.empty((n, trace_cap), dtype=torch.int32, device=dev)
    res = torch.empty((len(TRACE_KEYS), n), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            kernels.call("row_walks_trace", kernels.ptr(fm.lfc),
                         fm.lfc.shape[0], kernels.ptr(codes), codes.shape[1],
                         kernels.ptr(lanes), kernels.ptr(start_rows),
                         kernels.ptr(ptrs), kernels.ptr(max_lens), n,
                         int(trace_cap), kernels.ptr(trace), kernels.ptr(res),
                         kernels.stream(dev))
        kernels.launches["row_walks_trace"] += 1
    return dict(trace=trace, **dict(zip(TRACE_KEYS, res)))
