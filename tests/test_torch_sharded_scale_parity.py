"""The port's genome-sharded classifier against the JAX package's on the
3.28 Mbp community of tests/test_torch_scale_parity.py in 2 genome
shards, on the CPU.

The community (COMMUNITY there: 5 genomes, four species of genus 0, one
with a 99-99.5% identity sibling strain) is split by the JAX package's
build_sharded_index into 2 shards under pytest's temporary directory,
removed when the module's tests end (tests/torch_shards.py). JAX's
sharded classifier runs on a ('data', 'index') mesh of 1 x 2 virtual CPU
devices, which sizes stage 2's compaction caps from the whole chunk, as
the port on one device does; the port runs with device="cpu", whose
wrappers run the kernels' plain versions. All values are integers, so
the tolerance is exact equality: every one of the N_READS reads'
FastResult tuple and the stats, with the exact replay off and on (the
replay runs through each package's host ShardedEngine).
"""
import pytest

from scale_data import make_community, make_reads_vec
from test_torch_scale_parity import BLOCK, COMMUNITY, N_READS, _tuples
from torch_shards import built_shards


@pytest.fixture(scope="module")
def sharded_scale(tmp_path_factory):
    """(reads, shards.json directory) of the community in 2 shards."""
    from desamba_tpu.io.fastx import write_fasta

    root = tmp_path_factory.mktemp("sharded_scale")
    refs, _tax = make_community(**COMMUNITY)
    fa = str(root / "ref.fa")
    write_fasta(fa, refs)
    reads = make_reads_vec(refs, seed=99, n_reads=N_READS,
                           read_len=(1_200, 3_000), err=0.10)
    with built_shards(root, fa) as shards:
        yield reads, shards


@pytest.fixture(scope="module")
def sharded_classifiers(sharded_scale):
    from desamba_tpu.engine.sharded_fast import (
        load_sharded_fast as jax_load)
    from desamba_tpu.parallel import make_mesh
    from desamba_tpu_torch.engine.sharded_fast import load_sharded_fast

    _, shards = sharded_scale
    return (jax_load(shards, mesh=make_mesh(n_data=1, n_index=2)),
            load_sharded_fast(shards, device="cpu"))


@pytest.mark.parametrize("fallback", [False, True])
def test_sharded_scale_results_equal_jax(sharded_scale, sharded_classifiers,
                                         fallback):
    """Every read's FastResult and the stats on 2 shards, the replay off
    and on; the reads are called to more than one genome, and with the
    replay on some go through it."""
    reads, _ = sharded_scale
    jcl, tcl = sharded_classifiers
    for cl in (jcl, tcl):
        cl.exact_fallback = fallback
        cl.stats = dict(n_reads=0, n_fallback=0)
    ref = jcl.classify_batch(reads, block=BLOCK)
    got = tcl.classify_batch(reads, block=BLOCK)
    differ = [(a, b) for a, b in zip(_tuples(got), _tuples(ref)) if a != b]
    assert not differ, (len(differ), differ[:3])
    assert len(got) == len(ref) == N_READS
    assert tcl.stats == jcl.stats
    assert tcl.stats["n_reads"] == N_READS
    assert tcl.ref_names == jcl.ref_names
    if fallback:
        assert tcl.stats["n_fallback"] > 0
    called = {r.ref_ID for r in got if r.ref_ID >= 0}
    assert len(called) > 1
