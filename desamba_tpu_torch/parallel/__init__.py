"""Distributed layer: data-parallel reads over processes
(mesh.py, collectives.py) and the genome-sharded index's host engine
(shard_index.py; the device classifier over the same shards is
engine/sharded_fast.py)."""
from .collectives import taxon_weight_step  # noqa: F401
from .mesh import (  # noqa: F401
    DataMesh,
    init_distributed,
    make_mesh,
    pad_batch,
)

__all__ = [
    "make_mesh", "init_distributed", "pad_batch", "DataMesh",
    "taxon_weight_step",
]
