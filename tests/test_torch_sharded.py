"""The torch port's genome-sharded classifier and host sharded engine
against the JAX package's, on the CPU.

The golden references are built into 2 genome shards in a temporary
directory (never the shared golden-index cache), removed after the
module's tests (tests/torch_shards.py). The JAX
sharded classifier runs on a ('data', 'index') mesh of 1 x 2 virtual CPU
devices: with one data shard it sizes stage 2's compaction caps from the
whole chunk, as the port on one device does, so both compute the same
integer function and the tolerance is exact equality everywhere.
"""
import copy
import os
from dataclasses import fields, replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_merge import (ALT, NE, REF, SCORE, case_maps,
                              check_merge_coverage, merge_cases)
from torch_shards import built_shards

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _reads():
    from desamba_tpu.io.fastx import read_fastx

    return [(r.name, r.seq, r.qual)
            for r in read_fastx(os.path.join(GOLD, "reads.fq"))]


def _tuples(res):
    return [(r.name, r.ref_ID, r.direction, r.score, r.read_len, r.pos)
            for r in res]


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    """The golden shards, removed after the module's tests."""
    with built_shards(tmp_path_factory.mktemp("shards")) as root:
        yield root


@pytest.fixture(scope="module")
def jax_sharded(shard_root):
    from desamba_tpu.engine.sharded_fast import load_sharded_fast
    from desamba_tpu.parallel import make_mesh

    return load_sharded_fast(shard_root, mesh=make_mesh(n_data=1, n_index=2))


@pytest.fixture(scope="module", params=["kernel_ops", "plain_ops"])
def torch_sharded(request, shard_root):
    from desamba_tpu_torch.engine.sharded_fast import load_sharded_fast

    return load_sharded_fast(shard_root, device="cpu",
                             plain=request.param == "plain_ops")


@pytest.mark.parametrize("fallback", [False, True])
def test_sharded_results_equal_jax(jax_sharded, torch_sharded, fallback):
    """Every FastResult field of the 72 golden reads and the stats, with
    and without the exact replay, with the plain and the default ops."""
    reads = _reads()
    jax_sharded.exact_fallback = torch_sharded.exact_fallback = fallback
    jax_sharded.stats = dict(n_reads=0, n_fallback=0)
    torch_sharded.stats = dict(n_reads=0, n_fallback=0)
    try:
        ref = jax_sharded.classify_batch(reads)
        got = torch_sharded.classify_batch(reads)
    finally:
        jax_sharded.exact_fallback = torch_sharded.exact_fallback = False
    assert _tuples(got) == _tuples(ref)
    assert torch_sharded.stats == jax_sharded.stats
    assert torch_sharded.ref_names == jax_sharded.ref_names
    assert [torch_sharded.tid_of(r.ref_ID) for r in got] == [
        jax_sharded.tid_of(r.ref_ID) for r in ref]
    assert sum(r.ref_ID >= 0 for r in got) > len(got) // 2
    assert (torch_sharded.amb_margin, torch_sharded.max_width) == (
        jax_sharded.amb_margin, jax_sharded.max_width)
    assert vars(torch_sharded.ek) == vars(jax_sharded.ek)


@pytest.mark.parametrize("W", [1024, 2048])
def test_sharded_chunk_pack_equal_jax(jax_sharded, torch_sharded, W):
    """The raw [7, Bp] result of one chunk (global refs, merged, n_exist
    the shard-max), with padding rows (no ref in any shard)."""
    reads = [r for r in _reads() if W // 2 < len(r[1]) <= W]
    assert reads
    packed, lens_p, _ = torch_sharded._encode(reads, W=W,
                                              Bp=2 * len(reads))
    ref = np.asarray(jax_sharded._run_mesh(packed, lens_p))
    got = np.asarray(torch_sharded._run(packed, lens_p))
    assert got.dtype == np.int32 and got.shape == (7, packed.shape[0])
    assert np.array_equal(got, ref)
    assert (got[1] >= 0).any() and (got[1] < 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_plain_equals_jax_b5(jax_sharded, seed):
    """shard_merge_plain against JAX's b5 (the classifier's own _sm5 on the
    1 x 2 mesh), after b4's remap through edge-padded maps and with
    n_exist's shard-max, on merge_cases at 2 shards."""
    from desamba_tpu.engine.sharded_fast import _edge_pad_stack
    from desamba_tpu_torch.ops.merge import ref_maps, shard_merge_plain

    res, maps, nref = merge_cases(2, seed=seed)
    assert maps == case_maps(2) and nref == len(jax_sharded.ref_names)
    check_merge_coverage(res, maps)
    # b4's remap (sharded_fast.py:255-257) on JAX's edge-padded map stack
    ref_map = jnp.asarray(_edge_pad_stack([np.asarray(m, np.int32)
                                           for m in maps]))
    rl = jnp.asarray(res[:, REF])
    g = jnp.where(rl >= 0, jnp.take_along_axis(
        ref_map, jnp.clip(rl, 0, ref_map.shape[1] - 1), axis=1), -1)
    keys = ("score", "ref", "direction", "cov", "pos", "score_alt")
    stacked = {k: jnp.asarray(res[:, i]) for i, k in enumerate(keys)}
    stacked["ref"] = g
    out = jax_sharded._sm5(stacked)
    ref = np.stack([np.asarray(out[k]) for k in keys]
                   + [res[:, NE].max(0)])
    m, off = ref_maps(maps, "cpu")
    got = shard_merge_plain(torch.from_numpy(res), m, off, nref).numpy()
    assert np.array_equal(got, ref)
    assert res[:, SCORE].min() < 0 and res[:, ALT].max() > 100


def _hit_fields(h):
    return tuple(getattr(h, f) for f in (
        "ref_ID", "direction", "t_st", "t_ed", "q_st", "q_ed", "sum_score",
        "pri_index", "primary", "anchor_number", "indel", "q_t_dis"))


def test_sharded_engine_equals_jax(shard_root):
    """The host ShardedEngine: its SAM byte for byte and every hit's
    twelve columns, per read, equal JAX's."""
    from desamba_tpu.parallel.shard_index import ShardedEngine as JEngine
    from desamba_tpu_torch.parallel.shard_index import ShardedEngine

    reads = _reads()
    eng, jeng = ShardedEngine(shard_root, n_threads=2), JEngine(
        shard_root, n_threads=2)
    assert eng.ref_id_map == jeng.ref_id_map
    assert eng.merged_view.ref_names == jeng.merged_view.ref_names
    sam = eng.classify_to_sam(reads)
    assert sam == jeng.classify_to_sam(reads)
    assert len(sam.splitlines()) >= len(reads)
    got, ref = eng.classify_batch(reads), jeng.classify_batch(reads)
    for g, r in zip(got, ref, strict=True):
        assert (g.name, g.seq, g.qual, g.aborted) == (
            r.name, r.seq, r.qual, getattr(r, "aborted", False))
        assert [_hit_fields(h) for h in g.hits] == [
            _hit_fields(h) for h in r.hits]
    assert sum(len(g.hits) > 1 for g in got) > 0
    with pytest.raises(NotImplementedError, match="4b"):
        ShardedEngine(shard_root, backend="oracle")


def test_sharded_replay_equals_jax(jax_sharded, torch_sharded):
    """The exact replay of the first 8 golden reads through the host
    ShardedEngine with the concat -> global ref map."""
    reads = _reads()[:8]
    ref = jax_sharded._replay(reads)
    got = torch_sharded._replay(reads)
    assert _tuples(got) == _tuples(ref)
    assert any(r.ref_ID >= 0 for r in got)


def test_heterogeneous_exist_filters_are_refused(shard_root):
    """Shards whose exist-filter parameters differ are refused, as JAX
    refuses them (here one shard's exist-kmer length changed)."""
    from desamba_tpu.engine.sharded_fast import ShardedFastClassifier as JSF
    from desamba_tpu.index.format_ref import RefFormatIndex
    from desamba_tpu.oracle.classify import OracleIndex
    from desamba_tpu.parallel import make_mesh
    from desamba_tpu_torch.engine.sharded_fast import ShardedFastClassifier
    from desamba_tpu_torch.index.loader import load_index

    dirs = [os.path.join(shard_root, f"shard{s}") for s in range(2)]
    idxs = [load_index(d) for d in dirs]
    idxs[1] = copy.copy(idxs[1])
    idxs[1].ek_len -= 1
    with pytest.raises(ValueError, match="heterogeneous"):
        ShardedFastClassifier(idxs, device="cpu")
    ois = [OracleIndex(RefFormatIndex(d)) for d in dirs]
    ois[1] = copy.copy(ois[1])
    ois[1].ek = replace(ois[1].ek, len_e_kmer=ois[1].ek.len_e_kmer - 1)
    with pytest.raises(ValueError, match="heterogeneous"):
        JSF(ois, make_mesh(n_data=1, n_index=2))


def test_native_record_equals_jax(shard_root):
    """The binding's hits carry all twelve columns of the engine's record,
    equal to the JAX binding's, on each golden shard (on the monolithic
    golden index: tests/test_torch_host.py)."""
    from desamba_tpu.engine.native import NativeClassifier as JNative
    from desamba_tpu.index.format_ref import RefFormatIndex
    from desamba_tpu.oracle.classify import OracleIndex
    from desamba_tpu_torch.engine.native import NativeClassifier
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.oracle.classify import Chain

    reads = _reads()
    for d in (os.path.join(shard_root, f"shard{s}") for s in range(2)):
        got = NativeClassifier(load_index(d), n_threads=2).classify_batch(
            reads)
        ref = JNative(OracleIndex(RefFormatIndex(d)),
                      n_threads=2).classify_batch(reads)
        for g, r in zip(got, ref, strict=True):
            assert (g.name, g.seq, g.qual, g.aborted) == (
                r.name, r.seq, r.qual, r.aborted)
            assert all(type(h) is Chain for h in g.hits)
            assert [tuple(getattr(h, f.name) for f in fields(Chain))
                    for h in g.hits] == [
                tuple(getattr(h, f.name) for f in fields(Chain))
                for h in r.hits]
        assert any(h.q_t_dis != 0 for g in got for h in g.hits)
