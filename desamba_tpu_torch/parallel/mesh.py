"""The data-parallel mesh over processes.

Counterpart of desamba_tpu/parallel/mesh.py's data axis. JAX puts several
devices in one process and a mesh names them; PyTorch runs one process a
card, so here the 'data' axis is the ranks of a torch.distributed
process group and each rank holds one device. The reference's read
parallelism (the kt_for analog, cly_mt.c:372) maps onto it: a batch's
rows are split over the ranks, and the index is replicated.

The port has no virtual devices: a mesh is only as large as the process
group, and one card runs one rank (or, over gloo, several ranks that share
it). JAX's `put_replicated`, `put_batch`, `replicated` and `data_sharded`
have no counterpart: each rank builds its own tables on its own device
with `convert.build_tables(idx, mesh.device)` (FastClassifier does), and
hands its own rows to the pipeline. The 'index' axis (genome shards) is
engine/sharded_fast.py's, run one shard after another on one card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch


def as_device(device) -> torch.device:
    """torch.device of `device`, a CUDA device given its index."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None, device=None) -> None:
    """torch.distributed.init_process_group over TCP: `coordinator` is
    "host:port" of rank 0's store, with the world size and this process's
    rank. Without a coordinator the environment's cluster is used
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); a no-op when it names
    none, as JAX's initialize is without a coordinator address. The
    backend is nccl for a CUDA device and gloo for the CPU (`device`, or
    CUDA where torch sees a card), unless `backend` names one."""
    import torch.distributed as dist

    if coordinator is None and not ("MASTER_ADDR" in os.environ
                                    and "WORLD_SIZE" in os.environ):
        return
    if backend is None:
        cuda = (torch.device(device).type == "cuda" if device is not None
                else torch.cuda.is_available())
        backend = "nccl" if cuda else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs "
                         "num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@dataclass(frozen=True)
class DataMesh:
    """A 'data' axis of `n_data` ranks in `group`; this process is `rank`
    and computes on `device`."""
    group: object
    rank: int
    n_data: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.n_data}


def make_mesh(n_data: int | None = None, *, device) -> DataMesh:
    """The mesh of every rank of the initialized default process group
    (init_distributed), this process computing on `device`. n_data, when
    given, must equal the world size: the port has no virtual devices to
    make up a larger mesh, and a smaller one would leave ranks out."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "make_mesh: no process group; call init_distributed first (the "
            "port has no virtual devices: a mesh is one rank a process)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(
            f"make_mesh: n_data={n_data}, but the process group has {world} "
            "ranks; the port has no virtual devices, so n_data must equal "
            "the world size")
    return DataMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    n_data=n_data, device=as_device(device))


def pad_batch(n: int, n_data: int) -> int:
    """Rows to pad a batch of n reads so it splits evenly over 'data'."""
    return (-n) % n_data
