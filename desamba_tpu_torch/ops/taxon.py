"""The abundance report's taxon-weight reduction (K13).

Counterpart of the shard-local body of
desamba_tpu/parallel/collectives.py's taxon_weight_step (:26-32): each
read's taxon id, clipped to [0, max_tid - 1], adds its int32 weight into
a dense int32 [max_tid] vector; sums wrap at 2^31, as JAX's int32
scatter-add does. parallel/collectives.taxon_weight_step runs it on a
process's share of the reads and sums the vectors over the mesh.

`taxon_weights` has a hand-written CUDA kernel (csrc/taxon.cu) and a plain
torch version, `taxon_weights_plain`. The wrapper runs the plain version
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import kernels

I32 = torch.int32
_INTEGER = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def taxon_weights_plain(tids, weights, max_tid: int) -> torch.Tensor:
    """Plain torch version of the kernel. tids, weights: int32[B]; returns
    int32[max_tid]."""
    t = tids.clamp(0, max_tid - 1).to(torch.int64)
    return torch.zeros(max_tid, dtype=I32, device=tids.device).index_add_(
        0, t, weights)


def taxon_weights(tids, weights, max_tid: int) -> torch.Tensor:
    """int32[max_tid]: the sum of the weights whose tid, clipped to
    [0, max_tid - 1], equals each index (taxon_weights_plain's function).
    tids: int32[B]; weights: integers [B] on the same device, cast to
    int32 with wraparound as JAX's astype casts them; 1 <= max_tid <
    2^31."""
    if not 1 <= max_tid < 2**31:
        raise ValueError(f"taxon_weights: max_tid={max_tid} out of range "
                         "[1, 2^31)")
    if tids.dim() != 1:
        raise ValueError(f"taxon_weights: tids shape {tuple(tids.shape)}, "
                         "expected [B]")
    dev = tids.device
    kernels.check("tids", tids, I32, tids.shape, dev)
    if weights.dtype not in _INTEGER:
        raise ValueError(f"taxon_weights: weights dtype {weights.dtype}, "
                         "expected an integer type")
    w = weights if weights.dtype == I32 else weights.to(I32)
    kernels.check("weights", w, I32, tids.shape, dev)
    if not kernels.launch_device(tids):
        return taxon_weights_plain(tids, w, max_tid)
    out = torch.empty(max_tid, dtype=I32, device=dev)
    args = (kernels.ptr(tids), kernels.ptr(w), tids.numel(), max_tid,
            kernels.ptr(out))
    if dev.index == torch.cuda.current_device():
        kernels.call("taxon_weights", *args, kernels.stream(dev))
    else:
        with torch.cuda.device(dev):
            kernels.call("taxon_weights", *args, kernels.stream(dev))
    kernels.launches["taxon_weights"] += 1
    return out
