"""Collectives of the classify and analysis pipeline over the data mesh.

Counterpart of desamba_tpu/parallel/collectives.py's taxon_weight_step:
the abundance report's node_count accumulation (cly_mt.c:1192-1222) is a
scatter-add over a dense [max_tid] vector on each rank (the K13 kernel,
ops/taxon.py) and one all_reduce over the 'data' ranks. JAX's
gather_candidates_step has no counterpart: only a test of the JAX
package runs it, and the genome-sharded engine has its own merge.
"""
from __future__ import annotations

import torch


def taxon_weight_step(mesh, max_tid: int):
    """fn(tids, weights) -> int32[max_tid]: the taxon weights of every
    rank's reads, on every rank (JAX's replicated psum output). tids and
    weights are this process's reads (int32 tensors or arrays of any
    length, as make_array_from_process_local_data feeds JAX's step); the
    scatter-add runs on mesh.device, then the vectors are summed over
    mesh.group, on the stream the kernel ran on. Weights are cast to
    int32 with wraparound; the sums wrap at 2^31, as JAX's do (one batch
    is <= 10 MB of bases, cly_mt.c:23, so a batch's weights stay below)."""
    import torch.distributed as dist

    from ..ops.taxon import taxon_weights

    def fn(tids, weights):
        t = torch.as_tensor(tids).to(mesh.device)
        w = torch.as_tensor(weights).to(mesh.device)
        out = taxon_weights(t.contiguous(), w.contiguous(), max_tid)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out

    return fn
