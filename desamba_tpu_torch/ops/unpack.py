"""Stage 0: decode of the 2-bit wire format.

Counterpart of desamba_tpu/engine/fast_engine.py's stage0_unpack and
_read_words, with the int32 copy of the codes that stage 2 reads
(`codes2.astype(int32)` in _build_full). `unpack` has a hand-written CUDA
kernel (csrc/unpack.cu) that writes all four outputs in one launch, and a
plain torch version, `unpack_plain`, which composes the three steps
unchanged. The wrapper runs the plain version for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import kernels

I32 = torch.int32


def stage0_unpack(packed: torch.Tensor, lens: torch.Tensor):
    """packed uint8[Bp, W//2] (per read row: W//4 bytes of forward codes,
    then W//4 of reverse-complement codes, 4 codes per byte LSB-first) ->
    (codes2 uint8[2Bp, W], lengths2 int32[2Bp]), fwd rows then rc rows."""
    Bp, Wq2 = packed.shape
    Wq = Wq2 // 2
    both = torch.cat([packed[:, :Wq], packed[:, Wq:]], 0)
    codes2 = torch.stack([(both >> s) & 3 for s in (0, 2, 4, 6)], 2)
    lens = lens.to(I32)
    return codes2.reshape(2 * Bp, 4 * Wq), torch.cat([lens, lens])


def read_words(packed: torch.Tensor) -> torch.Tensor:
    """int32[2Bp, W/16] packed code words (uint32 bits, code t of each
    word at bits 2t), fwd rows then rc: the wire bytes viewed as
    little-endian 32-bit words."""
    Wq = packed.shape[1] // 2
    both = torch.cat([packed[:, :Wq], packed[:, Wq:]], 0).contiguous()
    return both.view(I32)


def unpack_plain(packed: torch.Tensor, lens: torch.Tensor):
    """Plain torch version of the unpack kernel: (codes2 uint8[2Bp, W],
    codes_i int32[2Bp, W], read_w2 int32[2Bp, W/16], lengths2
    int32[2Bp])."""
    codes2, lengths2 = stage0_unpack(packed, lens)
    return codes2, codes2.to(I32), read_words(packed), lengths2


def unpack(packed: torch.Tensor, lens: torch.Tensor):
    """Every row decoded, padding rows included, whatever its length.
    packed: uint8[Bp, W/2] with W % 16 == 0; lens: int32[Bp]. Returns
    unpack_plain's four outputs."""
    if packed.dim() != 2 or packed.shape[1] % 8:
        raise ValueError(f"unpack: packed shape {tuple(packed.shape)}, "
                         "expected [Bp, W/2] with W % 16 == 0")
    Bp, Wq2 = packed.shape
    dev = packed.device
    kernels.check("packed", packed, torch.uint8, (Bp, Wq2), dev)
    kernels.check("lens", lens, I32, (Bp,), dev)
    if not kernels.launch_device(packed):
        return unpack_plain(packed, lens)
    W = 2 * Wq2
    codes2 = torch.empty((2 * Bp, W), dtype=torch.uint8, device=dev)
    codes_i = torch.empty((2 * Bp, W), dtype=I32, device=dev)
    read_w2 = torch.empty((2 * Bp, W // 16), dtype=I32, device=dev)
    lengths2 = torch.empty((2 * Bp,), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        kernels.call("unpack", kernels.ptr(packed), kernels.ptr(lens), Bp, W,
                     kernels.ptr(codes2), kernels.ptr(codes_i),
                     kernels.ptr(read_w2), kernels.ptr(lengths2),
                     kernels.stream(dev))
    kernels.launches["unpack"] += 1
    return codes2, codes_i, read_w2, lengths2
