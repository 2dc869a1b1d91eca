"""The fast classifier over a genome-sharded index, on one device.

Counterpart of desamba_tpu/engine/sharded_fast.py. When the reference set
exceeds one device, the index is sharded by genome: each shard is a
complete index over a subset of the reference sequences, in the C
reference's format, named by a `shards.json` manifest. Sharding by genome
keeps every gather of stages 1-4 inside one shard's tables, and lifts the
per-index walls of the device tables: the 4 GiB exist filter (ops/ekmer),
the 2^31 unitig-string coordinates (ops/locate) and the 2^31 bp
reference (ops/refwin) each hold per shard.

JAX puts the shards on the 'index' axis of a ('data', 'index') mesh,
edge-padded to the largest shard and stacked, and all_gathers the
shards' stage-4 results. Here the shards run one after another on one
device, each over its own tables (no padding: every gather that JAX's
padding reaches clamps to the shard's last element, which is what the
padding repeats): stage 0 runs once a chunk, stages 1-4 once a shard with
the shard's tables, and one merge kernel (ops/merge.shard_merge, K11)
maps the shards' local refs to global IDs and picks each read's result
under the monolithic stage 4's odd/even tie rule.

With exact_fallback=True, ambiguous reads replay through the host
ShardedEngine (parallel/shard_index.py): the native engine on each shard,
then the global merge.
"""
from __future__ import annotations

import json
import os
from types import SimpleNamespace

import torch

from ..constants import (AMB_LARGE_L, AMB_MARGIN, AMB_MARGIN_LARGE,
                         DEFAULT_FILTER_MIN_LENGTH, DEFAULT_MIN_SCORE,
                         ROWS_PER_SEARCH, _band)
from ..ops.merge import ref_maps, shard_merge, shard_merge_plain
from .fast_engine import (KERNEL_OPS, PLAIN_OPS, DeviceResult, FastClassifier,
                          build_stages)


def build_sharded_full(lek: int, sbm: int, mask_bits: int, min_match: int,
                       nw0: int = 0, ops=KERNEL_OPS, merge=shard_merge):
    """The sharded pipeline as one call: full(shards, maps, map_off, nref,
    packed, lens) -> int32[7, Bp], shards being one (fm, ek, loc, ra) table
    set a shard, maps / map_off the shards' global ref IDs
    (ops/merge.ref_maps). Stage 0 runs once; stages 1-4 once a shard, each
    shard's [7, Bp] result (local refs, the strand-folded n_exist) into one
    stacked tensor; then `merge`."""
    s1, s2, s3, s4 = build_stages(lek, sbm, mask_bits, min_match, nw0, ops)
    s0 = ops["unpack"]

    def full(shards, maps, map_off, nref, packed, lens):
        codes2, codes_i, read_w2, lengths2 = s0(packed, lens)
        B2, W = codes2.shape
        B = B2 // 2
        K = 2 * _band(W) + 16
        res = []
        for fm, ek, loc, ra in shards:
            lo26, kidx, runlen, n_exist = s1(ek.w01, codes2, lengths2)
            fsp, hit, tot, qleft, sel = s2(fm, codes_i, lengths2, lo26,
                                           kidx, runlen)
            nwR = kidx.shape[1] * ROWS_PER_SEARCH
            ref_c, diag_c, vote_c = s3(fm, loc, lengths2, fsp, hit, tot,
                                       qleft, sel, B2=B2, nwR=nwR)
            out = s4(ra, read_w2, lengths2, ref_c, diag_c, vote_c, B2=B2,
                     K=K)
            res.append(torch.stack([*out.values(),
                                    n_exist[:B] + n_exist[B:]]))
        return merge(torch.stack(res), maps, map_off, nref)

    return full


class ShardedFastClassifier(FastClassifier):
    """FastClassifier over a genome-sharded index on one torch `device`
    (required, never chosen for the caller).

    `idxs` are the shards' HostIndexes (index.loader.load_index) in
    manifest order. `ref_ids` (one int sequence a shard) maps shard-local
    ref r to its global ref_ID; pass the manifest's `ref_order` numbering
    so that the odd/even tie rule picks the genome a monolithic run would
    (load_sharded_fast does). The default is shard-concatenation order.
    Each shard's exist filter is unfolded, and all shards must share its
    parameters. `amb_margin` defaults from the total row count over the
    shards. With exact_fallback=True, ambiguous reads replay through the
    host ShardedEngine. plain=True runs the plain versions of the stage
    kernels and of the merge. `tables` (one table set a shard, as
    convert.build_tables gives it with fold_bits=0) reuses tables already
    on the device."""

    def __init__(self, idxs, min_score: int = DEFAULT_MIN_SCORE,
                 filter_min_length: int = DEFAULT_FILTER_MIN_LENGTH,
                 exact_fallback: bool = False,
                 fallback_threads: int | None = None, ref_ids=None,
                 amb_margin: int | None = None, *, device,
                 plain: bool = False, tables=None):
        from ..convert import build_tables

        if amb_margin is None:
            # on the total row count: sharding splits the rows, not the
            # genome neighbourhood a read competes against
            total_l = sum(int(ix.L) for ix in idxs)
            amb_margin = (AMB_MARGIN if total_l < AMB_LARGE_L
                          else AMB_MARGIN_LARGE)
        self.device = torch.device(device)
        self.idxs = list(idxs)
        if tables is None:
            tables = [build_tables(ix, self.device, fold_bits=0)
                      for ix in self.idxs]
        self.shards = list(tables)
        params = [(t[1].lek, t[1].single_base_max, t[1].mask_bits,
                   t[1].n_words0) for t in self.shards]
        if len(set(params)) != 1:
            raise ValueError(
                "shards have heterogeneous exist-filter params (lek, "
                f"single_base_max, mask_bits, n_words0) {params}; rebuild "
                "the shards balanced so every shard lands in the same size "
                "bucket")
        lek, sbm, mb, nw0 = params[0]
        self.ek = SimpleNamespace(lek=lek, single_base_max=sbm, mask_bits=mb,
                                  n_words0=nw0)
        # global ref numbering: the caller's (the monolithic fasta order)
        # or shard-concatenation order
        if ref_ids is None:
            ref_ids, b = [], 0
            for ix in self.idxs:
                ref_ids.append(list(range(b, b + len(ix.ref_names))))
                b += len(ix.ref_names)
        self.ref_ids = [[int(g) for g in ids] for ids in ref_ids]
        self.ref_names = [None] * sum(len(ix.ref_names) for ix in self.idxs)
        for ix, ids in zip(self.idxs, self.ref_ids, strict=True):
            if len(ids) != len(ix.ref_names):
                raise ValueError(f"ref_ids: {len(ids)} IDs for a shard of "
                                 f"{len(ix.ref_names)} refs")
            for r, g in enumerate(ids):
                self.ref_names[g] = ix.ref_names[r]
        self.maps, self.map_off = ref_maps(self.ref_ids, self.device)
        self._full = build_sharded_full(
            lek, sbm, mb, min_match=20, nw0=nw0,
            ops=PLAIN_OPS if plain else KERNEL_OPS,
            merge=shard_merge_plain if plain else shard_merge)
        self._init_host(min_score, filter_min_length, exact_fallback,
                        fallback_threads, max_width=8192,
                        amb_margin=amb_margin)

    def _run(self, packed, lens):
        p = torch.from_numpy(packed).to(self.device)
        ln = torch.from_numpy(lens).to(self.device)
        return DeviceResult(self._full(self.shards, self.maps, self.map_off,
                                       len(self.ref_names), p, ln))

    def _replay_engine(self):
        """The host ShardedEngine over the shards' indexes, each shard's
        local refs mapped to the global numbering (its classify_batch maps
        them before the merge's qsort, so ties order by the IDs a
        monolithic run uses)."""
        from ..parallel.shard_index import ShardedEngine
        from .native import NativeClassifier

        eng = ShardedEngine.__new__(ShardedEngine)
        eng.engines = [NativeClassifier(ix, n_threads=self._fallback_threads)
                       for ix in self.idxs]
        eng.ref_id_map = self.ref_ids
        return eng

    def tid_of(self, ref_ID: int) -> int:
        """tid from the 'tid|NNN|...' naming of the global ref; 0 when
        unclassified or unnamed."""
        if ref_ID < 0:
            return 0
        parts = self.ref_names[ref_ID].split("|")
        return int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0


def load_sharded_fast(shard_root: str, *, device, **kw):
    """ShardedFastClassifier on `device` from a shards.json directory, with
    the manifest's `ref_order` as the global ref numbering where it has
    one."""
    from ..index.loader import load_index
    from ..parallel.shard_index import MANIFEST

    with open(os.path.join(shard_root, MANIFEST)) as f:
        man = json.load(f)
    idxs = [load_index(os.path.join(shard_root, sh["dir"]))
            for sh in man["shards"]]
    ref_ids = None
    if "ref_order" in man:  # the monolithic numbering (tie order)
        pos = {n: g for g, n in enumerate(man["ref_order"])}
        ref_ids = [[pos[n] for n in ix.ref_names] for ix in idxs]
    return ShardedFastClassifier(idxs, ref_ids=ref_ids, device=device, **kw)
