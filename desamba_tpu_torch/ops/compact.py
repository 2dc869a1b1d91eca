"""Stage 2's capped, stable prefix compactions.

Counterpart of the cumsum / scatter-with-drop compactions inside
desamba_tpu/engine/fast_engine.py's stage 2 (:237-264, :287-341).
`compact` keeps the first `cap` live lanes of a carry, in lane order;
`row_grid` keeps the first `cap` valid rows of the seed lanes' final
intervals and writes the row walks' start carry. Each has a hand-written
CUDA kernel (csrc/compact.cu, one single-pass scan, one launch a call)
and a plain torch version; the wrapper runs the plain version for
tensors on the CPU, and for CUDA tensors it launches the kernel or
raises. The kernels share a scratch for each device and stream
(ScanScratch), which the wrappers keep.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..constants import ROWS_PER_SEARCH as R
from .fm import rw_init

I32 = torch.int32
# entries a block of the kernels' scan over a dense row (compact.cu: 1,024
# threads of kDenseItems = 4) and over a source list (kListItems = 1), and
# slots of the fill a fill block writes (kFillSpan)
SCAN_BLOCK = 4096
LIST_BLOCK = 1024
FILL_SPAN = 4096
# call numbers run 1 .. CALL_LIMIT - 1 (compact.cu kCallLimit: 30 bits of
# a flag word)
CALL_LIMIT = 1 << 30


def scan_blocks(m: int, block: int = SCAN_BLOCK) -> int:
    """Scan blocks of `block` entries over m entries: at least one, whose
    prefix is the live total."""
    return max(1, -(-m // block))


class ScanScratch:
    """The scan's scratch on one device and stream: `words`, int64 holding
    uint64 bits, word 0 the ticket and word 1 + b block b's flag
    ((call << 34) | (status << 32) | value), and `call`, the number of the
    last call. Zeroed once when made; a call needs no memset, because
    each call tags its flags with a number no earlier flag carries. When
    the number would reach CALL_LIMIT, take() zeroes the words (one memset
    on the stream, once in 2^30 - 1 calls) and numbering starts again at
    1, so no flag of an earlier cycle can read as ready. The vote's slot
    map (ops/vote.py) is another such scratch: its words are tagged
    (call << 32) | lane, and it takes them with take_words."""

    def __init__(self, device, call: int = 0):
        self.words = torch.zeros(2, dtype=torch.int64, device=device)
        self.call = call

    def take(self, m: int, block: int = SCAN_BLOCK) -> tuple[torch.Tensor,
                                                            int]:
        """(words, call number) for a call over m entries in blocks of
        `block`; the words grow (zeroed) to hold the call's blocks."""
        return self.take_words(1 + scan_blocks(m, block))

    def take_words(self, need: int) -> tuple[torch.Tensor, int]:
        """(words, call number) for a call that uses `need` words; the
        words grow (zeroed) to hold them."""
        if self.words.numel() < need:
            self.words = torch.zeros(max(need, 2 * self.words.numel()),
                                     dtype=torch.int64,
                                     device=self.words.device)
        self.call += 1
        if self.call >= CALL_LIMIT:
            self.words.zero_()
            self.call = 1
        return self.words, self.call


_scratch: dict = {}  # (kind, device index, stream handle) -> ScanScratch


def scan_scratch(dev, kind: str = "scan") -> ScanScratch:
    """The ScanScratch of dev's current stream for the kernels of `kind`
    ("scan": compact and row_grid; "vote": the vote's slot map): calls on
    one stream run in order, so they can share it."""
    dev = torch.device(dev)
    if dev.index is None:  # "cuda": the current device, as a tensor names it
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (kind, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _scratch:
        _scratch[key] = ScanScratch(dev)
    return _scratch[key]


def _first(live: torch.Tensor, vals: torch.Tensor, cap: int,
           fill: int) -> torch.Tensor:
    """int32[cap]: vals of the first cap live entries in order, then fill
    (JAX's cumsum positions and .at[tgt].set(mode="drop"))."""
    pos = torch.cumsum(live.to(I32), 0, dtype=I32) - 1
    tgt = torch.where(live & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), fill, dtype=I32, device=live.device)
    out.scatter_(0, tgt.long(), vals.to(I32))
    return out[:cap]


def compact_plain(done: torch.Tensor, cap: int,
                  src: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the compact kernel. done: int32[n], a carry's
    done row. Without src, the lanes j with done[j] == 0; with src
    (int32[m], an earlier compaction), its entries j with
    0 <= src[j] < n and done[src[j]] == 0, as src[j]. Returns int32[cap]:
    the first cap of them in order, then n."""
    n = done.shape[0]
    if src is None:
        return _first(done == 0, torch.arange(n, dtype=I32,
                                              device=done.device), cap, n)
    ok = (src >= 0) & (src < n)
    live = ok & (done[src.clamp(0, max(n - 1, 0)).long()] == 0) if n else ok
    return _first(live, src, cap, n)


def compact(done: torch.Tensor, cap: int,
            src: torch.Tensor | None = None) -> torch.Tensor:
    """compact_plain's function: int32[cap] of the first cap live lanes of
    done (int32[n]) or of the source list src (int32[m]), fill n."""
    n = done.shape[0]
    dev = done.device
    kernels.check("done", done, I32, (n,), dev)
    if src is not None:
        kernels.check("src", src, I32, (src.numel(),), dev)
    if cap < 1:
        raise ValueError(f"cap={cap}")
    if not kernels.launch_device(done):
        return compact_plain(done, cap, src)
    m = n if src is None else src.numel()
    if m >= 2**31:
        raise ValueError(f"{m} entries: int32 slots")
    out = torch.empty(cap, dtype=I32, device=dev)
    with torch.cuda.device(dev):
        words, call = scan_scratch(dev).take(
            m, SCAN_BLOCK if src is None else LIST_BLOCK)
        kernels.call("compact", kernels.ptr(done), n, kernels.ptr(src), m,
                     int(cap), kernels.ptr(words), words.numel(), call,
                     kernels.ptr(out), kernels.stream(dev))
    kernels.launches["compact"] += 1
    return out


def row_grid_plain(state: torch.Tensor, seed_ok: torch.Tensor,
                   lane: torch.Tensor, s_idx: torch.Tensor, cap: int):
    """Plain torch version of the row_grid kernel (JAX's lines :287-313
    and the epilogue's gathers). state: the [8, S] interval-search carry
    (nsp, nep, match_len, ptr in rows 2-5); seed_ok bool[S]; lane, s_idx
    int32[S]. With R = ROWS_PER_SEARCH, the grid entry s * R + k is the
    row nsp + k, valid where seed_ok & (nsp < nep) & (nsp + k < nep), in
    int32 arithmetic that wraps. Returns (sel int32[cap], the
    first cap valid entries then S * R; the walks' [5, cap] start carry;
    int32[4, cap] lane, walk length (max(s_idx - match_len, 0), 0 in
    unused slots), match_len, s_idx), gathered through
    seli = min(sel, S * R - 1)."""
    S = state.shape[1]
    sp, ep, ml, ptr = state[2], state[3], state[4], state[5]
    rowk = torch.arange(R, dtype=I32, device=state.device)
    rows = (sp[:, None] + rowk[None, :]).reshape(-1)
    srch_ok = seed_ok & (sp < ep)
    valid = (srch_ok[:, None] & (rows.reshape(S, R) < ep[:, None])).reshape(
        -1)
    SR = S * R
    sel = _first(valid, torch.arange(SR, dtype=I32, device=state.device),
                 cap, SR)
    seli = sel.clamp(max=SR - 1).long()
    si = seli // R
    rem = torch.clamp(s_idx - ml, min=0)
    wl = torch.stack([lane[si], torch.where(sel < SR, rem[si], 0), ml[si],
                      s_idx[si]]).to(I32)
    return sel, rw_init(rows[seli], ptr[si]), wl


def row_grid(state: torch.Tensor, seed_ok: torch.Tensor, lane: torch.Tensor,
             s_idx: torch.Tensor, cap: int):
    """row_grid_plain's function on S >= 1 seed lanes: (sel int32[cap],
    walk start carry int32[5, cap], int32[4, cap] lane / walk length /
    match_len / s_idx of each slot)."""
    S = state.shape[1]
    dev = state.device
    kernels.check("state", state, I32, (8, S), dev)
    kernels.check("seed_ok", seed_ok, torch.bool, (S,), dev)
    kernels.check("lane", lane, I32, (S,), dev)
    kernels.check("s_idx", s_idx, I32, (S,), dev)
    if S < 1 or cap < 1 or S * R >= 2**31:
        raise ValueError(f"S={S}, cap={cap}")
    if not kernels.launch_device(state):
        return row_grid_plain(state, seed_ok, lane, s_idx, cap)
    sel = torch.empty(cap, dtype=I32, device=dev)
    walk = torch.empty((5, cap), dtype=I32, device=dev)
    wl = torch.empty((4, cap), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        words, call = scan_scratch(dev).take(S * R)
        kernels.call("row_grid", kernels.ptr(state), kernels.ptr(seed_ok),
                     kernels.ptr(lane), kernels.ptr(s_idx), S, int(R),
                     int(cap), kernels.ptr(words), words.numel(), call,
                     kernels.ptr(sel), kernels.ptr(walk), kernels.ptr(wl),
                     kernels.stream(dev))
    kernels.launches["row_grid"] += 1
    return sel, walk, wl
