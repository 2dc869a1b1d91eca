"""The port's fast classifier against the JAX package's on a built index
of about 3 Mbp, on the CPU.

The golden index holds 72 reads; this file holds the port to JAX at a
scale nearer the bench's: a community from
tests/scale_data.make_community (COMMUNITY below: 5 genomes, 3.28 Mbp,
four species of genus 0, one with a 99-99.5% identity sibling strain, so
that near-tied cross-genome scores occur) and N_READS reads from
make_reads_vec at the bench's error rate and lengths (1.2-3 kb, 10%),
indexed by the JAX package's builder into a temporary directory, as
bench.prepare builds the bench index (never into the golden-index
cache; the directory is removed when the module's tests end, since an
index takes about 1 GB of disk). Both FastClassifiers run on the CPU:
JAX under JAX_PLATFORMS=cpu (tests/conftest.py), the port with
device="cpu", whose wrappers run the kernels' plain versions. All values
are integers, so the tolerance is exact equality: every read's
FastResult tuple, the stats and the raw [7, Bp] of the first chunk of
each width bucket, with the exact replay off and on. With the replay on,
near-ties send some reads through it (4 of the 512; n_fallback > 0 is
asserted, so that the comparison covers the replay too).
"""
import shutil

import numpy as np
import pytest

from scale_data import make_community, make_reads_vec

COMMUNITY = dict(seed=21, n_genera=16, genome_len=(300_000, 700_000),
                 species_per_genus=(3, 5), target_total=3e6)
N_READS = 512
BLOCK = 64


@pytest.fixture(scope="module")
def scale_data(tmp_path_factory):
    """(reads, index directory) of the community; the index is built by
    the JAX package's builder and removed after the module's tests."""
    from desamba_tpu.index.build import build_index
    from desamba_tpu.index.format_ref import save_ref_format
    from desamba_tpu.io.fastx import write_fasta

    root = tmp_path_factory.mktemp("scale_parity")
    refs, _tax = make_community(**COMMUNITY)
    assert sum(len(s) for _, s in refs) >= 3e6
    fa = str(root / "ref.fa")
    write_fasta(fa, refs)
    idx_dir = str(root / "idx")
    save_ref_format(build_index(fa), idx_dir)
    reads = make_reads_vec(refs, seed=99, n_reads=N_READS,
                           read_len=(1_200, 3_000), err=0.10)
    yield reads, idx_dir
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def classifiers(scale_data):
    from desamba_tpu.engine.fast_engine import FastClassifier as JaxCl
    from desamba_tpu.index.format_ref import RefFormatIndex
    from desamba_tpu.oracle.classify import OracleIndex
    from desamba_tpu_torch.engine.fast_engine import FastClassifier
    from desamba_tpu_torch.index.loader import load_index

    _, idx_dir = scale_data
    return (JaxCl(OracleIndex(RefFormatIndex(idx_dir))),
            FastClassifier(load_index(idx_dir), device="cpu"))


def _tuples(res):
    return [(r.name, r.ref_ID, r.direction, r.score, r.read_len, r.pos)
            for r in res]


@pytest.mark.parametrize("fallback", [False, True])
def test_scale_results_equal_jax(scale_data, classifiers, fallback):
    """Every read's FastResult and the stats, the replay off and on."""
    reads, _ = scale_data
    jcl, tcl = classifiers
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
    if fallback:
        assert tcl.stats["n_fallback"] > 0
    # the community's reads are called, and not all to one genome
    called = {r.ref_ID for r in got if r.ref_ID >= 0}
    assert len(called) > 1


def test_scale_first_chunks_raw_equal_jax(scale_data, classifiers):
    """The packed chunk and the raw [7, Bp] of the first full chunk of
    each width bucket, as classify_batch encodes it."""
    from desamba_tpu_torch.constants import _bucket

    reads, _ = scale_data
    jcl, tcl = classifiers
    by_w: dict = {}
    for r in reads:
        by_w.setdefault(_bucket(max(len(r[1]), tcl.ek.lek + 2)), []).append(r)
    assert len(by_w) >= 2
    for W, rs in sorted(by_w.items()):
        chunk = rs[:BLOCK]
        jp, jl, _ = jcl._encode(chunk, W=W, Bp=BLOCK)
        tp, tl, _ = tcl._encode(chunk, W=W, Bp=BLOCK)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jl, tl)
        ref = np.asarray(jcl._run(jp, jl))
        got = np.asarray(tcl._run(tp, tl))
        assert ref.shape == got.shape == (7, BLOCK)
        assert (got == ref).all(), (W, int((got != ref).any(0).sum()))
        assert (got[1] >= 0).any(), W
