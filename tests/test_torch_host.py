"""The port's own host side against the JAX package's, on the CPU and the
golden index and reads: the copied constants, the index loader (against
OracleIndex and from_oracle_index), the FASTA/FASTQ reader and the native
engine's binding. Everything is compared for exact equality.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import dataclasses
import gzip
import os
import shutil

import numpy as np
import pytest
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


# ---------------------------------------------------------- constants --
REF_CONSTANTS = [
    "L_PRE_IDX", "BP_PER_BLOCK", "BLOCK_BYTES", "SINGLE_BASE_MAX_RATIO",
    "EK_SIZE_LADDER", "STEP_EK", "SEED_RANGE", "S_A_KMER_L",
    "FILTER_MIN_SCORE_2G", "FILTER_MIN_SCORE_SHORT_3G", "NGS_MAX_READ_L",
    "SHORT_3G_READ_L", "DEFAULT_FILTER_MIN_LENGTH", "DEFAULT_MIN_SCORE",
    "P_E", "Q_MEM_MAX", "MAX_LV_WRONG", "MAX_LV_R_LEN", "N_NEEDED",
    # the validation engine's and its oracle's
    "PRE_IDX_MASK", "MIN_UNI_L", "MIN_READ_LEN", "MEM_SEARCH_FAST",
    "MIN_MEM_LEN_FAST", "MEM_SEARCH_SLOW", "MIN_MEM_LEN_SLOW", "LV_ERROR",
    "LV_L", "MIN_S_1", "MIN_S_2", "SP_SET_CAP", "MAX_DIS_MINUS",
    "MAX_WAITING_LEN", "MAX_ANCHOR_OVERLAP", "CHAIN_M3_THRESHOLD",
    "MIN_SCORE_MEM", "OVER_SEARCH_M2", "MAX_SMS_OVERLAP",
    "DEFAULT_MAX_SEC_N", "PRIMARY", "SECONDARY", "SUPPLEMENTARY"]
ENGINE_CONSTANTS = [
    "ROWS_PER_SEARCH", "FM_EXT_CAP", "REFPOS_PER_ANCHOR", "VOTE_TILE",
    "IV_BURST", "IV_MID", "WALK_BURST", "WALK_MID", "WALK_TAIL", "PACK_KEYS",
    "AMB_MARGIN", "AMB_MARGIN_LARGE", "AMB_LARGE_L", "AMB_MIN_EXIST"]


@pytest.mark.parametrize("name", REF_CONSTANTS + ENGINE_CONSTANTS)
def test_constant_equals_jax(name):
    import desamba_tpu.constants as jc
    import desamba_tpu.engine.fast_engine as jfe
    import desamba_tpu_torch.constants as tc

    src = jc if name in REF_CONSTANTS else jfe
    assert getattr(tc, name) == getattr(src, name)


def test_schedule_functions_and_long_overlap_equal_jax():
    import desamba_tpu.engine.fast_engine as jfe
    import desamba_tpu_torch.constants as tc

    assert tc.LONG_OVERLAP == jfe.FastClassifier.LONG_OVERLAP
    for n in [1, 7, 8, 9, 63, 64, 65, 200, 4096, 4097]:
        assert tc._pow2(n) == jfe._pow2(n) and tc._pow2(n, 8) == jfe._pow2(
            n, 8)
    for n in [1, 255, 256, 257, 1025, 2048, 2049, 3072, 3073, 8192, 9000]:
        assert tc._bucket(n) == jfe._bucket(n)
    for W in [256, 1024, 2048, 3072, 4096, 8192]:
        assert tc._band(W) == jfe._band(W)


# ------------------------------------------------------------- loader --
TI_FIELDS = [f.name for f in dataclasses.fields(
    __import__("desamba_tpu.index.tensor_index",
               fromlist=["TensorIndex"]).TensorIndex)]


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            (a == b).all())
    return a == b


@pytest.mark.parametrize("field", TI_FIELDS)
def test_loader_field_equals_from_oracle_index(host_index, jax_ti, field):
    """Same name, dtype, shape and values as the JAX TensorIndex."""
    assert _same(getattr(jax_ti, field), getattr(host_index, field))


# OracleIndex attribute -> HostIndex attribute holding the same values
ORACLE_FIELDS = {
    "codes": "bwt_pad", "cum": "cum", "rank": "rank", "hash13": "hash13",
    "sa_uni": "sa_uni", "sa_off": "sa_off", "uni_len_ext": "uni_len",
    "reflist_ext": "uni_reflist", "refpos_global": "refpos_global",
    "refpos_refid": "refpos_refid", "ref_len": "ref_len",
    "ref_offset": "ref_offset", "ref_bin": "ref_bin", "ek0": "ek_words0",
    "ek1": "ek_words1", "q_mem": "q_mem", "q_lv": "q_lv"}


@pytest.mark.parametrize("oracle_name", sorted(ORACLE_FIELDS))
def test_loader_array_equals_oracle_index(host_index, golden_oracle_index,
                                          oracle_name):
    a = np.asarray(getattr(golden_oracle_index, oracle_name))
    b = getattr(host_index, ORACLE_FIELDS[oracle_name])
    if oracle_name in ("ek0", "ek1"):  # the bitmap bytes, held as words
        b = b.view(np.uint8)
    assert a.shape == b.shape and (a == b).all()


def test_loader_scalars_equal_oracle_index(host_index, golden_oracle_index):
    oi = golden_oracle_index
    assert (oi.L, oi.N, oi.dollar_pos) == (
        host_index.L, host_index.n_unitig, host_index.dollar_pos)
    assert oi.ref_names == host_index.ref_names
    assert (oi.ek.mask_bits, oi.ek.len_e_kmer, oi.ek.single_base_max) == (
        host_index.ek_mask_bits, host_index.ek_len,
        host_index.ek_single_base_max)


# -------------------------------------------------------------- fastx --
def _records(reader, src):
    return [(r.name, r.comment, r.seq, r.qual) for r in reader(src)]


@pytest.mark.parametrize("name,gz", [("reads.fq", False), ("reads.fq", True),
                                     ("ref.fa", False), ("ref.fa", True)])
def test_read_fastx_equals_jax(tmp_path, name, gz):
    from desamba_tpu.io.fastx import read_fastx as jread
    from desamba_tpu_torch.io.fastx import read_fastx

    src = os.path.join(GOLD, name)
    if gz:
        dst = tmp_path / (name + ".gz")
        with open(src, "rb") as f, gzip.open(dst, "wb") as g:
            shutil.copyfileobj(f, g)
        src = str(dst)
    got = _records(read_fastx, src)
    assert got == _records(jread, src) and len(got) > 2
    with open(src, "rb") as f:
        assert _records(read_fastx, f.read()) == got


def test_read_fastx_multiline_and_comments():
    from desamba_tpu.io.fastx import read_fastx as jread
    from desamba_tpu_torch.io.fastx import read_fastx

    blob = (b">a one two\nACGT\nAC\n\n>b\nGG\n"
            b"@c x\nACG\nT\n+\nII\nII\n@d\n\n+\n\n")
    assert _records(read_fastx, blob) == _records(jread, blob)
    with pytest.raises(ValueError):
        list(read_fastx(b"ACGT\n"))


# ------------------------------------------------------------- native --
def test_native_binding_equals_jax(host_index, golden_oracle_index):
    """The port's binding gives the JAX binding's hits, all twelve columns
    of the engine's record, on every golden read."""
    from desamba_tpu.engine.native import NativeClassifier as JNative
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu_torch.engine.native import NativeClassifier

    reads = [(r.name, r.seq, r.qual)
             for r in read_fastx(os.path.join(GOLD, "reads.fq"))]
    got = NativeClassifier(host_index, n_threads=2).classify_batch(reads)
    ref = JNative(golden_oracle_index, n_threads=2).classify_batch(reads)
    fields = lambda h: (h.ref_ID, h.direction, h.t_st, h.t_ed, h.q_st,
                        h.q_ed, h.sum_score, h.pri_index, h.primary,
                        h.anchor_number, h.indel, h.q_t_dis)
    assert len(got) == len(ref) == len(reads)
    for g, r in zip(got, ref):
        assert (g.name, g.seq, g.aborted) == (r.name, r.seq, r.aborted)
        assert [fields(h) for h in g.hits] == [fields(h) for h in r.hits]
    assert sum(any(h.primary == 1 for h in g.hits) for g in got) > 36


def test_native_build_is_safe_for_concurrent_callers(tmp_path):
    """Two processes call the port's engine.native.ensure_built at once on
    a copy of native/ without the library: one builds it under the lock
    (make in a temporary copy, then os.replace), the other waits for it;
    both load the library and find its entry points, and no temporary
    build directory is left."""
    import subprocess
    import sys

    nat = tmp_path / "native"
    nat.mkdir()
    for name in ("Makefile", "classify_host.cpp"):
        shutil.copy2(os.path.join(ROOT, "native", name), nat)
    code = ("import ctypes, sys\n"
            "from desamba_tpu_torch.engine.native import ensure_built\n"
            "p = ensure_built(sys.argv[1])\n"
            "ctypes.CDLL(p).dsb_classify_batch\n"
            "print(p)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(nat)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lib = str(nat / "libdesamba_host.so")
    assert [o.strip() for o, _ in outs] == [lib, lib]
    assert not [f for f in os.listdir(nat) if "-build-" in f]
