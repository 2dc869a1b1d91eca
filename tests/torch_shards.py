"""Genome-sharded indexes for the port's tests (not a test module).

`built_shards` builds a FASTA's references into genome shards with the
JAX package's builder (numpy only), under a directory of pytest's
temporary directory, and removes them when its block ends. A shard's
index takes ~800 MB of disk whatever its size (its BWT file and two
exist-filter bitmaps), and pytest keeps its last three base temporary
directories, so a shard directory left behind stays on the disk through
two more whole runs.
"""
import contextlib
import os
import shutil

GOLD_FA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "ref.fa")


@contextlib.contextmanager
def built_shards(parent, fa: str = GOLD_FA, n_shards: int = 2):
    """The shards.json directory of fa's references in n_shards genome
    shards, built under parent (default: the golden references) and
    removed at the end of the block."""
    from desamba_tpu.parallel.shard_index import build_sharded_index

    root = os.path.join(str(parent), f"shards{n_shards}")
    try:
        build_sharded_index(fa, root, n_shards=n_shards, n_jobs=1)
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)
