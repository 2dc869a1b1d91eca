"""Classify against a genome-sharded index and merge the candidates.

Counterpart of the host engine of desamba_tpu/parallel/shard_index.py
(`MANIFEST`, `_MergedIndexView`, `ShardedEngine`). Each shard is a complete
index in the C reference's format over a subset of the reference genomes,
in a directory named by the manifest `shards.json`. A read is classified
against every shard by the bit-exact native engine; the shards' chains are
mapped to the global ref numbering, capped and sorted as a monolithic run
sorts them, and primary/secondary/supplementary detection runs over the
union (detect_primary, cly.c:2990-3053) before SAM output.

The index builder (`partition_references`, `build_sharded_index`) is not
ported yet (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import json
import os

from ..oracle.classify import ReadResult

MANIFEST = "shards.json"


class _MergedIndexView:
    """ref_names view over the shards in global order (for the SAM
    formatter)."""

    def __init__(self, ref_names):
        self.ref_names = ref_names


class ShardedEngine:
    """Classify against every shard, merge candidates, re-detect primaries.

    Per-shard filtering (delete_small_score_rst, cly.c:2878-2988) runs in
    each shard's engine. Its pos-sort chain merge only ever combines chains
    of one ref_ID (cly.c:2913-2952) and refs are disjoint across shards,
    so it decomposes; its 200/400 candidate caps are global in a
    monolithic run, so they are applied again to the union here. Shard-
    local ref_IDs map to the manifest's `ref_order` (the monolithic fasta
    numbering) when it has one, else to shard-concatenation order, so the
    merge's glibc qsort under chain_cmp_by_mem_score (with its
    sum_score % 2 tie quirk, cly.c:62) orders ties as a monolithic run
    would."""

    def __init__(self, shard_root: str, n_threads: int = 1,
                 backend: str = "native"):
        if backend != "native":
            raise NotImplementedError(
                f"backend={backend!r}: the oracle engine is not ported yet "
                "(ROADMAP queue 1 item 4b); use backend='native'")
        from ..engine.native import NativeClassifier
        from ..index.loader import load_index

        with open(os.path.join(shard_root, MANIFEST)) as f:
            man = json.load(f)
        self.engines = []
        self.ref_id_map = []  # per shard: local ref -> global ref
        shard_names = []
        for sh in man["shards"]:
            idx = load_index(os.path.join(shard_root, sh["dir"]))
            self.engines.append(NativeClassifier(idx, n_threads=n_threads))
            shard_names.append(list(idx.ref_names))
        if "ref_order" in man:  # the monolithic numbering
            names = list(man["ref_order"])
            pos = {n: g for g, n in enumerate(names)}
            self.ref_id_map = [[pos[n] for n in sn] for sn in shard_names]
        else:  # shard-concatenation order
            names = []
            for sn in shard_names:
                self.ref_id_map.append(list(range(len(names),
                                                  len(names) + len(sn))))
                names.extend(sn)
        self.merged_view = _MergedIndexView(names)

    def classify_batch(self, reads) -> list[ReadResult]:
        from ..oracle.classify import SZ_CHAIN, chain_cmp_by_score
        from ..oracle.cqsort import qsort_list
        from ..oracle.rescore import (chain_cmp_by_mem_score,
                                      chain_cmp_by_pos, detect_primary)

        reads = list(reads)
        per_shard = [eng.classify_batch(reads) for eng in self.engines]
        out = []
        for i, (name, seq, qual) in enumerate(reads):
            merged = ReadResult(name=name, seq=seq, qual=qual or b"")
            merged.aborted = False
            cands = []
            for s, res_list in enumerate(per_shard):
                r = res_list[i]
                if r.aborted:
                    merged.aborted = True
                for c in r.hits:
                    c.ref_ID = self.ref_id_map[s][c.ref_ID]
                    cands.append(c)
            # the monolithic final sort (delete_small_score_rst's last
            # qsort, cly.c:2986) over the union. chain_cmp_by_mem_score's
            # % 2 tie quirk makes glibc's permutation depend on the input
            # order, which monolithically is chain_cmp_by_pos order, so
            # that order is rebuilt first
            if len(cands) > 1:
                # the 200/400 caps on the union: monolithically they see
                # the list in chain_cmp_by_score order (cly.c:343) and only
                # drop its low-score tail
                if len(cands) > 200:
                    cands = qsort_list(cands, SZ_CHAIN, chain_cmp_by_score)
                    keep = 200
                    while keep < len(cands) and cands[keep].sum_score > 50:
                        keep += 1
                    del cands[keep:]
                    del cands[400:]
                cands = qsort_list(cands, SZ_CHAIN, chain_cmp_by_pos)
                cands = qsort_list(cands, SZ_CHAIN, chain_cmp_by_mem_score)
            merged.hits = cands
            detect_primary(merged.hits, len(seq))
            out.append(merged)
        return out

    def classify_to_sam(self, reads, output_seq: bool = False,
                        max_sec_n: int = 5) -> str:
        from ..oracle.driver import format_sam

        return "".join(format_sam(self.merged_view, r, output_seq, max_sec_n)
                       for r in self.classify_batch(reads) if not r.aborted)
