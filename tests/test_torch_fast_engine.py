"""The torch port's fast classify path against the JAX package's, on the
CPU: every stage output, the [7, Bp] result pack, FastResult tuples and
stats on the golden reads, and the port's CLI. The port's classifier
stands alone and reads the index with its own loader; the JAX classifier
takes the JAX package's OracleIndex of the same directory. All values are
integers, so the tolerance is exact equality everywhere.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")


def _golden_reads(max_len=None, min_len=None):
    from desamba_tpu.io.fastx import read_fastx

    reads = [(r.name, r.seq, r.qual) for r in
             read_fastx(os.path.join(GOLD, "reads.fq"))]
    if max_len:
        reads = [r for r in reads if len(r[1]) <= max_len]
    if min_len:
        reads = [r for r in reads if len(r[1]) >= min_len]
    return reads


@pytest.fixture(scope="module")
def jax_cl(golden_oracle_index):
    from desamba_tpu.engine.fast_engine import FastClassifier

    return FastClassifier(golden_oracle_index)


@pytest.fixture(scope="module")
def host_index(golden_index_dir):
    from desamba_tpu_torch.index.loader import load_index

    return load_index(golden_index_dir)


@pytest.fixture(scope="module")
def torch_cl(host_index):
    from desamba_tpu_torch.engine.fast_engine import FastClassifier

    return FastClassifier(host_index, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _eq(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a == b).all(), (what, int((a != b).sum()))


@pytest.fixture(scope="module", params=[1024, 2048])
def chunk(request, jax_cl, torch_cl):
    """One golden chunk at width bucket W through the JAX stages and the
    port's stages, with every intermediate kept."""
    from desamba_tpu.engine.fast_engine import (ROWS_PER_SEARCH, _band,
                                                _build_stages, _read_words,
                                                stage0_unpack)
    from desamba_tpu_torch.engine import fast_engine as tfe

    W = request.param
    reads = _golden_reads(min_len=W // 2 + 1, max_len=W)
    assert reads
    packed, lens_p, _ = torch_cl._encode(reads, W=W)
    ek = jax_cl.ek
    js = _build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                       ek.n_words0)
    ts = tfe.build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                          ek.n_words0)
    out = {}
    codes2, l2 = stage0_unpack(jnp.asarray(packed), jnp.asarray(lens_p))
    tcodes2, tl2 = tfe.stage0_unpack(torch.from_numpy(packed),
                                     torch.from_numpy(lens_p))
    out["stage0"] = ((codes2, l2), (tcodes2, tl2))
    s1 = jax.jit(js[0])(ek.w01, codes2, l2)
    t1 = ts[0](torch_cl.ek.w01, tcodes2, tl2)
    out["stage1"] = (s1, t1)
    ci = codes2.astype(jnp.int32)
    s2 = jax.jit(js[1])(jax_cl.fm, ci, l2, *s1[:3])
    t2 = ts[1](torch_cl.fm, tcodes2.to(torch.int32), tl2, *t1[:3])
    out["stage2"] = (s2, t2)
    B2 = codes2.shape[0]
    nwR = s1[1].shape[1] * ROWS_PER_SEARCH
    s3 = jax.jit(js[2], static_argnames=("B2", "nwR"))(
        jax_cl.fm, jax_cl.loc, l2, *s2, B2=B2, nwR=nwR)
    t3 = ts[2](torch_cl.fm, torch_cl.loc, tl2, *t2, B2=B2, nwR=nwR)
    out["stage3"] = (s3, t3)
    K = 2 * _band(W) + 16
    s4 = jax.jit(js[3], static_argnames=("B2", "K"))(
        jax_cl.ra, _read_words(jnp.asarray(packed)), l2, *s3, B2=B2, K=K)
    t4 = ts[3](torch_cl.ra, tfe._read_words(torch.from_numpy(packed)), tl2,
               *t3, B2=B2, K=K)
    out["stage4"] = (s4, t4)
    out["packed"] = (packed, lens_p)
    return out


@pytest.mark.parametrize("stage", ["stage0", "stage1", "stage2", "stage3"])
def test_stage_outputs_equal(chunk, stage):
    ref, got = chunk[stage]
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        _eq(a, b, f"{stage}[{i}]")


def test_stage4_outputs_equal(chunk):
    ref, got = chunk["stage4"]
    assert set(ref) == set(got)
    for k in ref:
        _eq(ref[k], got[k], f"stage4[{k}]")


def test_stage3_plain_ops_equal_jax(chunk, torch_cl):
    """Stage 3 built with PLAIN_OPS (locate_plain in place of the locate
    wrapper) equals JAX's stage 3 on the golden chunk's stage-2 output."""
    from desamba_tpu_torch.constants import ROWS_PER_SEARCH
    from desamba_tpu_torch.engine import fast_engine as tfe

    ek = torch_cl.ek
    s3 = tfe.build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                          ek.n_words0, ops=tfe.PLAIN_OPS)[2]
    tcodes2, tl2 = chunk["stage0"][1]
    nwR = chunk["stage1"][1][1].shape[1] * ROWS_PER_SEARCH
    got = s3(torch_cl.fm, torch_cl.loc, tl2, *chunk["stage2"][1],
             B2=tcodes2.shape[0], nwR=nwR)
    for i, (a, b) in enumerate(zip(chunk["stage3"][0], got, strict=True)):
        _eq(a, b, f"stage3[{i}]")


def test_stage0_and_stage4_plain_ops_equal_jax(chunk, torch_cl):
    """unpack_plain equals JAX stage0_unpack, its int32 codes and
    _read_words, and stage 4 built with PLAIN_OPS equals JAX's stage 4, on
    the golden chunk."""
    import jax.numpy as jnp

    from desamba_tpu.engine.fast_engine import _read_words
    from desamba_tpu_torch.constants import _band
    from desamba_tpu_torch.engine import fast_engine as tfe

    packed, lens_p = chunk["packed"]
    codes2, l2 = chunk["stage0"][0]
    got = tfe.unpack_plain(torch.from_numpy(packed), torch.from_numpy(lens_p))
    ref = (codes2, codes2.astype(jnp.int32),
           _read_words(jnp.asarray(packed)), l2)
    for i, (a, b) in enumerate(zip(ref, got, strict=True)):
        b = b.numpy()
        _eq(a, b.view(np.uint32) if i == 2 else b, f"unpack[{i}]")
    ek = torch_cl.ek
    s4 = tfe.build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                          ek.n_words0, ops=tfe.PLAIN_OPS)[3]
    B2, W = got[0].shape
    out = s4(torch_cl.ra, got[2], got[3], *chunk["stage3"][1], B2=B2,
             K=2 * _band(W) + 16)
    ref4 = chunk["stage4"][0]
    assert set(out) == set(ref4)
    for k in ref4:
        _eq(ref4[k], out[k], f"stage4[{k}]")


def test_stage2_has_live_hits(chunk):
    """The stage-2 comparison is not vacuous: the chunk yields anchors."""
    _, got = chunk["stage2"]
    assert int(got[1].sum()) > 0


def test_full_pack_equal(chunk, jax_cl, torch_cl):
    packed, lens_p = chunk["packed"]
    ref = np.asarray(jax_cl._run(packed, lens_p))
    got = np.asarray(torch_cl._run(packed, lens_p))
    assert got.dtype == np.int32 and got.shape == (7, packed.shape[0])
    _eq(ref, got, "pack")


def _tuples(res):
    return [(r.name, r.ref_ID, r.direction, r.score, r.read_len, r.pos)
            for r in res]


@pytest.mark.parametrize("fallback", [False, True])
def test_fast_results_equal_on_golden_reads(jax_cl, torch_cl, fallback):
    reads = _golden_reads()
    jax_cl.exact_fallback = torch_cl.exact_fallback = fallback
    jax_cl.stats = dict(n_reads=0, n_fallback=0)
    torch_cl.stats = dict(n_reads=0, n_fallback=0)
    try:
        ref = jax_cl.classify_batch(reads)
        got = torch_cl.classify_batch(reads)
    finally:
        jax_cl.exact_fallback = torch_cl.exact_fallback = True
    assert _tuples(got) == _tuples(ref)
    assert torch_cl.stats == jax_cl.stats
    assert sum(r.ref_ID >= 0 for r in got) > len(got) // 2


def test_long_read_block_partitioning_equal(golden_oracle_index,
                                            host_index):
    """A >8 kb read split into max_width=2048 segments, both strands."""
    from desamba_tpu.engine.fast_engine import FastClassifier as JaxFC
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu_torch.engine.fast_engine import FastClassifier
    from testdata import mutate_read

    rng = np.random.default_rng(5)
    genome = [r.seq for r in read_fastx(GOLD + "/ref.fa")][1]
    code = np.zeros(256, np.uint8)
    for j, b in enumerate(b"ACGT"):
        code[b] = j
    seq = mutate_read(rng, code[np.frombuffer(genome[1000:9400], np.uint8)],
                      err=0.08)
    comp = bytes(seq).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
    reads = [("long_fwd", seq, None), ("long_rc", comp, None)]
    assert len(seq) > 8192
    ref = JaxFC(golden_oracle_index, exact_fallback=False,
                max_width=2048).classify_batch(reads)
    got = FastClassifier(host_index, exact_fallback=False,
                         max_width=2048, device="cpu").classify_batch(reads)
    assert _tuples(got) == _tuples(ref)
    assert got[0].ref_ID == 1 and got[0].direction == 1
    assert got[1].ref_ID == 1 and got[1].direction == 0


@pytest.mark.parametrize("fallback", [False, True])
def test_graft_long_read_equal(golden_oracle_index, jax_cl, torch_cl,
                               fallback):
    """The >8 kb read of __graft_entry__ (two segments at the default
    max_width of 8192) beside short golden reads, with and without the
    exact replay: FastResults and stats equal the JAX classifier's."""
    from __graft_entry__ import _make_long_read

    reads = _golden_reads(max_len=400)[:6] + [
        _make_long_read(golden_oracle_index)]
    assert len(reads[-1][1]) > torch_cl.max_width == 8192
    jax_cl.exact_fallback = torch_cl.exact_fallback = fallback
    jax_cl.stats = dict(n_reads=0, n_fallback=0)
    torch_cl.stats = dict(n_reads=0, n_fallback=0)
    try:
        ref = jax_cl.classify_batch(reads)
        got = torch_cl.classify_batch(reads)
    finally:
        jax_cl.exact_fallback = torch_cl.exact_fallback = True
    assert _tuples(got) == _tuples(ref)
    assert torch_cl.stats == jax_cl.stats
    assert got[-1].ref_ID >= 0


def test_batch_padding_consistency(torch_cl):
    """Results do not depend on batch composition (padding, bucketing)."""
    reads = _golden_reads(max_len=250)[:5]
    solo = [torch_cl.classify_batch([r])[0] for r in reads]
    assert _tuples(torch_cl.classify_batch(reads)) == _tuples(solo)


def test_device_is_required(host_index):
    from desamba_tpu_torch.engine.fast_engine import FastClassifier

    with pytest.raises(TypeError):
        FastClassifier(host_index)
    cl = FastClassifier(host_index, device="cpu",
                        tables=(None, _FakeEk(), None, None))
    assert cl.device == torch.device("cpu") and cl.mesh is None
    # with a mesh, its device is the default and any other is refused
    from desamba_tpu_torch.parallel import DataMesh

    mesh = DataMesh(group=None, rank=0, n_data=1, device=torch.device("cpu"))
    cl = FastClassifier(host_index, mesh=mesh,
                        tables=(None, _FakeEk(), None, None))
    assert cl.device == torch.device("cpu") and cl.mesh is mesh
    with pytest.raises(ValueError):
        FastClassifier(host_index, device="cuda:0", mesh=mesh,
                       tables=(None, _FakeEk(), None, None))


class _FakeEk:
    lek, single_base_max, mask_bits, n_words0 = 16, 12, 20, 0


def _write_fq(path, reads):
    with open(path, "w") as f:
        for name, seq, _ in reads:
            q = seq.decode()
            f.write(f"@{name}\n{q}\n+\n{'I' * len(q)}\n")
    return str(path)


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", module, "classify", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_lines_match_jax_classifier(tmp_path, golden_index_dir, jax_cl):
    """The port's CLI writes name, ref, direction, score and read length
    per read, as the JAX CLI's fast engine does."""
    reads = _golden_reads(max_len=250)[:6]
    fq = _write_fq(tmp_path / "r.fq", reads)
    out = tmp_path / "out.txt"
    p = _cli("desamba_tpu_torch.cli", "--engine", "fast", "--device", "cpu",
             "-o", str(out), golden_index_dir, fq)
    assert p.returncode == 0, p.stderr
    names = jax_cl.oi.ref_names
    exp = [f"{r.name}\t{names[r.ref_ID] if r.ref_ID >= 0 else '*'}\t"
           f"{r.direction}\t{r.score}\t{r.read_len}"
           for r in jax_cl.classify_batch(reads)]
    assert out.read_text().splitlines() == exp


# the JAX CLI's stderr report, line by line (desamba_tpu/cli.py:243-246,
# utils/timers.py:28-31, 51-54)
_STDERR_LINES = [
    ("processing", r"Processing file: \[(?P<path>.+)\]\."),
    ("processed", r"(?P<n>\d+) sequences processed in \d+\.\d{3}s "
                  r"\(\d+\.\d Kseq/m\)\."),
    ("cpu", r"Classify CPU: \d+\.\d{3} sec"),
    ("timer", r"(?P<name>\w+):\[\d+\.\d{6}\] n=(?P<n>\d+)"),
    ("maxmem", r"Normal end program, MAX MEM:\[\d+\.\d{6}\]Gbp\."),
    ("blank", r""),
]


# a runtime's own log record (glog format), which neither CLI writes
_RUNTIME_LOG = re.compile(r"[IWEF]\d{4} \d\d:\d\d:\d\d\.\d+ +\d+ \S+:\d+\] ")


def _stderr_shape(text):
    """[(kind, fields)] of each stderr line, in order, runtime log records
    left out; a line that fits no kind of the JAX CLI's report fails."""
    out = []
    for line in text.split("\n")[:-1]:
        if _RUNTIME_LOG.match(line):
            continue
        for kind, pat in _STDERR_LINES:
            m = re.fullmatch(pat, line)
            if m:
                out.append((kind, m.groupdict()))
                break
        else:
            raise AssertionError(f"unexpected stderr line {line!r}")
    return out


def test_cli_stdout_and_stderr_match_jax_cli(tmp_path, golden_index_dir):
    """Both CLIs on the same reads, with --timers: equal stdout; stderr
    with the same lines in the same order (the timer lines, which sort by
    time, as a set of names and counts), read_reads among the timers, and
    the peak-RSS line and its blank line last."""
    reads = _golden_reads()
    fqs = [_write_fq(tmp_path / "a.fq", reads[:40]),
           _write_fq(tmp_path / "b.fq", reads[40:])]
    jp = _cli("desamba_tpu.cli", "--engine", "fast", "--timers",
              golden_index_dir, *fqs)
    tp = _cli("desamba_tpu_torch.cli", "--engine", "fast", "--device", "cpu",
              "--timers", golden_index_dir, *fqs)
    assert jp.returncode == 0, jp.stderr
    assert tp.returncode == 0, tp.stderr
    assert tp.stdout == jp.stdout and len(tp.stdout.splitlines()) == 72
    js, ts = _stderr_shape(jp.stderr), _stderr_shape(tp.stderr)
    strip = lambda sh: [x for x in sh if x[0] != "timer"]
    timers = lambda sh: sorted((f["name"], f["n"]) for k, f in sh
                               if k == "timer")
    assert strip(ts) == strip(js)
    assert timers(ts) == timers(js)
    assert ("read_reads", "2") in timers(ts)
    assert [k for k, _ in ts][-5:] == ["timer"] * 3 + ["maxmem", "blank"]
    assert ts[2] == ("processed", {"n": "72"})


def test_cli_profile_writes_a_trace(tmp_path, golden_index_dir):
    """--profile DIR leaves a torch.profiler trace in DIR and says where."""
    fq = _write_fq(tmp_path / "r.fq", _golden_reads(max_len=250)[:3])
    prof = tmp_path / "prof"
    p = _cli("desamba_tpu_torch.cli", "--engine", "fast", "--device", "cpu",
             "--profile", str(prof), golden_index_dir, fq)
    assert p.returncode == 0, p.stderr
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert f"torch profiler trace written to {traces[0]}" in p.stderr
    assert len(p.stdout.splitlines()) == 3


@pytest.mark.parametrize("args", [(), ("-f", "SAM_FULL"), ("-f", "DES"),
                                  ("-f", "DES_FULL"), ("-t", "1")],
                         ids=["SAM", "SAM_FULL", "DES", "DES_FULL", "t1"])
def test_cli_native_default_equals_jax_cli(golden_index_dir, args):
    """With no --engine both CLIs run the native engine: the same stdout
    byte for byte in each -f format, and with one thread as with the
    default four (which equal a single-threaded run); stderr with the
    same lines in the same order."""
    fq = os.path.join(GOLD, "reads.fq")
    jp = _cli("desamba_tpu.cli", *args, golden_index_dir, fq)
    tp = _cli("desamba_tpu_torch.cli", *args, golden_index_dir, fq)
    assert jp.returncode == 0, jp.stderr
    assert tp.returncode == 0, tp.stderr
    assert tp.stdout == jp.stdout and tp.stdout
    assert _stderr_shape(tp.stderr) == _stderr_shape(jp.stderr)
    assert [k for k, _ in _stderr_shape(tp.stderr)] == [
        "processing", "processed", "cpu", "maxmem", "blank"]
    if args == ("-t", "1"):
        assert tp.stdout == _cli("desamba_tpu_torch.cli", golden_index_dir,
                                 fq).stdout
    elif not args:
        assert tp.stdout == open(os.path.join(GOLD, "classify.sam")).read()


def test_cli_sends_a_sharded_index_to_the_sharded_engine(tmp_path):
    """A directory with shards.json (the golden references in 2 genome
    shards, built under pytest's temporary directory and removed after
    the test, torch_shards.built_shards) goes to the host
    ShardedEngine whatever --engine says, as in the JAX CLI: the same SAM
    on stdout, and the same stderr lines."""
    from torch_shards import built_shards

    with built_shards(tmp_path) as root:
        fq = os.path.join(GOLD, "reads.fq")
        jp = _cli("desamba_tpu.cli", root, fq)
        assert jp.returncode == 0, jp.stderr
        assert len(jp.stdout.splitlines()) >= 72
        for args in ((), ("--engine", "fast", "--device", "cpu"),
                     ("-f", "SAM_FULL")):
            tp = _cli("desamba_tpu_torch.cli", *args, root, fq)
            assert tp.returncode == 0, tp.stderr
            want = jp.stdout if not args or args[0] != "-f" else _cli(
                "desamba_tpu.cli", *args, root, fq).stdout
            assert tp.stdout == want, args
            assert _stderr_shape(tp.stderr) == _stderr_shape(jp.stderr)


def test_cli_reports_peak_memory_after_a_failure(tmp_path):
    """A run that fails (here, an index directory without its files) still
    prints the peak-RSS line in both CLIs."""
    d = tmp_path / "empty"
    d.mkdir()
    fq = _write_fq(tmp_path / "r.fq", _golden_reads(max_len=250)[:1])
    maxmem = re.compile(_STDERR_LINES[4][1], re.M)
    for args in (("desamba_tpu.cli", "--engine", "fast"),
                 ("desamba_tpu_torch.cli", "--engine", "fast", "--device",
                  "cpu")):
        p = _cli(*args, str(d), fq)
        assert p.returncode != 0, args
        assert maxmem.search(p.stderr), (args, p.stderr)
