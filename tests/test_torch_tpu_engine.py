"""The port's validation engine (`classify --engine tpu`) against the JAX
package's and against the C reference's golden SAM, on the CPU and the
golden index and reads. Everything is compared for exact equality:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tpu_engine.py -q

Its two device kernels (probe_reads, row_walks_trace) are held to JAX
through their plain versions, on the case builders of
tests/test_torch_kernels.py that the card's tests reuse; the test marked
`cuda` runs the engine on the card and skips without one.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_kernels import (check_probe_coverage,
                                check_walk_trace_coverage, probe_cases,
                                walk_trace_cases)
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")


@pytest.fixture(scope="module")
def host_index(golden_index_dir):
    from desamba_tpu_torch.index.loader import load_index

    return load_index(golden_index_dir)


@pytest.fixture(scope="module")
def jax_ti(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index

    return from_oracle_index(golden_oracle_index)


@pytest.fixture(scope="module")
def reads():
    from desamba_tpu_torch.io.fastx import read_fastx

    return [(r.name, r.seq, r.qual)
            for r in read_fastx(os.path.join(GOLD, "reads.fq"))]


# ----------------------------------------------------------- kernels --
@pytest.mark.parametrize("W", [64, 256, 4096])
def test_probe_reads_plain_equals_jax(host_index, jax_ti, W):
    """The stride-1 probe on the golden index's unfolded filter, with
    padding rows, reads shorter than lek + 1 and the filter's cases."""
    from desamba_tpu.ops.ekmer import EkArrays as JaxEkArrays
    from desamba_tpu.ops.ekmer import probe_reads as jax_probe_reads
    from desamba_tpu_torch.ops.ekmer import EkArrays, probe_reads

    ek = EkArrays.from_tensor_index(host_index, "cpu")
    codes, lens, groups = probe_cases(ek.lek, W)
    got = probe_reads(ek, torch.from_numpy(codes), torch.from_numpy(lens))
    ref = np.asarray(jax_probe_reads(JaxEkArrays(jax_ti), codes, lens))
    assert got.numpy().dtype == ref.dtype and (got.numpy() == ref).all()
    check_probe_coverage(ek, codes, lens, ref, groups)


def test_row_walks_trace_plain_equals_jax(host_index, jax_ti):
    """Traced walks on the golden index, each case asserted reached:
    overflow past the 96-step trace, a max_len stop, max_len reached at
    step 96 exactly, a stop at step 96, a pad nibble, ptr -1."""
    import jax.numpy as jnp

    from desamba_tpu.ops.fm import FmArrays as JaxFmArrays
    from desamba_tpu.ops.fm import row_walks
    from desamba_tpu_torch.ops.fm import FmArrays, row_walks_trace

    fm = FmArrays.from_tensor_index(host_index, "cpu")
    codes, lanes, rows, ptrs, mlen, groups = walk_trace_cases(fm)
    got = row_walks_trace(fm, codes, lanes, rows, ptrs, mlen)
    ref = row_walks(JaxFmArrays(jax_ti), jnp.asarray(codes.numpy()[lanes]),
                    rows.numpy(), ptrs.numpy(), mlen.numpy())
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert v.shape == tuple(got[k].shape), k
        assert (got[k].numpy() == v.astype(np.int32)).all(), k
    check_walk_trace_coverage(got, groups)


# ------------------------------------------------------------ oracle --
# attributes the oracle and the replay read: port name -> JAX name
ORACLE_FIELDS = {
    "rank": "rank", "N": "N", "L": "L", "dollar_pos": "dollar_pos",
    "uni_len_ext": "uni_len_ext", "reflist_ext": "reflist_ext",
    "sa_uni": "sa_uni", "sa_off": "sa_off", "hash13": "hash13",
    "refpos_global": "refpos_global", "refpos_refid": "refpos_refid",
    "ref_names": "ref_names", "ref_len": "ref_len",
    "ref_offset": "ref_offset", "ref_bin": "ref_bin", "codes": "codes",
    "cum": "cum", "q_mem": "q_mem", "q_lv": "q_lv",
    "filter_min_length": "filter_min_length",
    "filter_min_score": "filter_min_score",
    "filter_min_score_lv3": "filter_min_score_lv3"}


@pytest.mark.parametrize("name", sorted(ORACLE_FIELDS))
def test_oracle_index_field_equals_jax(host_index, golden_oracle_index,
                                       name):
    from desamba_tpu_torch.oracle.classify import OracleIndex

    got = getattr(OracleIndex(host_index), name)
    ref = getattr(golden_oracle_index, ORACLE_FIELDS[name])
    if isinstance(ref, np.ndarray):
        got = np.asarray(got)
        assert got.shape == ref.shape and (got == ref).all()
    else:
        assert got == ref


def test_oracle_index_shares_the_loader_arrays_and_methods_equal_jax(
        host_index, golden_oracle_index):
    """No array of the index is copied (cum is 6 x 8 B a row), and occ,
    occ_cur, get_ref, get_uni and the unitig lookups give JAX's answers."""
    from desamba_tpu_torch.oracle.classify import OracleIndex

    oi, jo = OracleIndex(host_index, 150, 50), golden_oracle_index
    assert oi.cum is host_index.cum and oi.codes is host_index.bwt_pad
    assert (oi.lek, oi.single_base_max) == (jo.ek.len_e_kmer,
                                            jo.ek.single_base_max)
    assert (oi.filter_min_length, oi.filter_min_score_lv3) == (150, 60)
    rng = np.random.default_rng(3)
    for r in rng.integers(0, oi.L, 200).tolist():
        assert oi.occ(r, r % 6) == jo.occ(r, r % 6)
        assert oi.occ_cur(r) == jo.occ_cur(r)
    total = oi.ref_bin.size * 4
    for off in [-5, 0, total - 3] + rng.integers(0, total, 20).tolist():
        for fwd in (True, False):
            assert (oi.get_ref(off, 17, fwd) == jo.get_ref(off, 17, fwd)
                    ).all()
    for pos in (rng.integers(0, oi.L // 8, 50) * 8).tolist():
        for sl in (0, 3):
            assert oi.get_uni(pos, sl) == jo.get_uni(pos, sl)
    for u in range(oi.N + 1):
        assert oi.uni_length(u) == jo.uni_length(u)
        assert oi.uni_refpos_range(u) == jo.uni_refpos_range(u)


@pytest.mark.parametrize("n,size", [(1, 40), (2, 56), (7, 40), (60, 56),
                                    (500, 40)])
def test_cqsort_equals_jax(n, size):
    """glibc qsort's order on lists with ties, under comparators that are
    not strict weak orders (a tie returns a % 2), as the reference's are."""
    from desamba_tpu.oracle.cqsort import qsort_list as jax_qsort
    from desamba_tpu_torch.oracle.cqsort import qsort_list

    rng = np.random.default_rng(n)
    items = [(int(a), i) for i, a in enumerate(rng.integers(0, 6, n))]
    cmps = (lambda a, b: b[0] - a[0],
            lambda a, b: (1 if a[0] < b[0] else -1 if a[0] > b[0]
                          else a[0] % 2),
            lambda a, b: int(a[0] > b[0]))
    for cmp in cmps:
        got = qsort_list(items, size, cmp)
        assert got == jax_qsort(items, size, cmp)
        assert sorted(got) == sorted(items)


# ------------------------------------------------------------- slice --
@pytest.fixture(scope="module")
def jax_run(golden_oracle_index, reads):
    """The JAX engine's SAM with each read's sequence, and its stats."""
    from desamba_tpu.engine.tpu_engine import TpuClassifier

    eng = TpuClassifier(golden_oracle_index)
    return eng.classify_to_sam(reads, output_seq=True), dict(eng.stats)


@pytest.fixture(scope="module")
def port_engine(host_index):
    from desamba_tpu_torch.engine.tpu_engine import TpuClassifier

    return TpuClassifier(host_index, device="cpu")


def test_tpu_classifier_sam_equals_golden(port_engine, reads):
    """The port's engine on the CPU (the plain versions) gives the C
    reference's SAM byte for byte, launching no kernel."""
    from desamba_tpu_torch import kernels

    before = dict(kernels.launches)
    port_engine.stats.clear()
    got = port_engine.classify_to_sam(reads)
    assert got == open(os.path.join(GOLD, "classify.sam")).read()
    assert kernels.launches == before
    s = port_engine.stats
    assert s["fm_searches"] > 100
    assert s["walk_fallback"] <= 0.05 * s["fm_walks"] + 5


def test_tpu_classifier_full_sam_and_stats_equal_jax(port_engine, reads,
                                                     jax_run):
    """output_seq=True equals the JAX engine's SAM (and the reference's
    SAM_FULL golden), and the engine's stats equal JAX's."""
    port_engine.stats.clear()
    got = port_engine.classify_to_sam(reads, output_seq=True)
    jax_sam, jax_stats = jax_run
    assert got == jax_sam
    assert got == open(os.path.join(GOLD, "classify_full.sam")).read()
    for k in ("fm_searches", "fm_walks", "walk_fallback", "cand_fallback"):
        assert port_engine.stats[k] == jax_stats.get(k, 0), k
    assert port_engine.stats["walk_fallback"] > 0


def test_plain_option_runs_the_plain_versions(host_index, reads,
                                              monkeypatch):
    """plain=True routes the three device calls to the plain versions;
    over sub-batches of 16 reads the SAM is the golden's first reads'."""
    from desamba_tpu_torch.engine import tpu_engine as te

    monkeypatch.setattr(te, "SUB_BATCH", 16)
    eng = te.TpuClassifier(host_index, device="cpu", plain=True)
    assert eng.ops is te.PLAIN_OPS
    assert te.TpuClassifier(host_index, device="cpu").ops is te.KERNEL_OPS
    names = {r[0] for r in reads[:20]}
    exp = "".join(ln for ln in open(os.path.join(GOLD, "classify.sam"))
                  if ln.split("\t")[0] in names)
    assert eng.classify_to_sam(reads[:20]) == exp


@pytest.mark.parametrize("fmt,golden", [("SAM", "classify.sam"),
                                        ("SAM_FULL", "classify_full.sam")])
def test_cli_tpu_engine_prints_the_golden_sam(golden_index_dir, fmt, golden):
    """`python -m desamba_tpu_torch.cli classify --engine tpu` prints the
    golden SAM, and the JAX CLI's stderr report."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    p = subprocess.run(
        [sys.executable, "-m", "desamba_tpu_torch.cli", "classify",
         "--engine", "tpu", "--device", "cpu", "-f", fmt, golden_index_dir,
         os.path.join(GOLD, "reads.fq")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout == open(os.path.join(GOLD, golden)).read()
    err = p.stderr.splitlines()
    assert err[0].startswith("Processing file: [")
    assert err[1].startswith("72 sequences processed in ")
    assert err[2].startswith("Classify CPU: ")
    assert err[3].startswith("Normal end program, MAX MEM:[")


@pytest.mark.cuda
def test_tpu_classifier_on_the_card_equals_golden(host_index, reads):
    """On the card (the hand kernels) the SAM is the golden's, and the
    three kernels were launched."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.tpu_engine import KERNEL_OPS, TpuClassifier

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    eng = TpuClassifier(host_index, device="cuda")
    kernels.reset_launches()
    assert eng.classify_to_sam(reads) == open(
        os.path.join(GOLD, "classify.sam")).read()
    assert all(kernels.launches[k] > 0 for k in KERNEL_OPS), kernels.launches
