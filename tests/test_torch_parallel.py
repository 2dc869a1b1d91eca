"""The port's data-parallel classifier and taxon-weight step against the
JAX package's, on the CPU.

The port's 'data' axis is the ranks of a torch.distributed process group
(gloo on the CPU), one process a rank. No test starts a process group in
its own process: one module-scoped fixture runs a job of 1 rank and a
job of 2 ranks of tests/torch_dist_worker.py at once, and each rank
writes what the tests compare to an .npz. JAX's counterpart runs here on
make_mesh(n_data=n) of the virtual CPU devices: its shard_map gives each
shard its own rows, and stage 2's compaction caps scale with those rows,
as the port's ranks do, so both compute the same integer function and
the tolerance is exact equality everywhere.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import os
import subprocess
import sys

import jax  # noqa: F401  (the conftest keeps it on the CPU)
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from test_torch_taxon import expected, taxon_cases
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BURSTS = {"defaults": None, "bursts0": 0}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, golden_index_dir):
    """{n: [rank r's npz as a dict]} of the 1-rank and the 2-rank job."""
    out = {n: tmp_path_factory.mktemp(f"world{n}") for n in (1, 2)}
    jobs = {n: worker.spawn(n, out[n], golden_index_dir) for n in (1, 2)}
    got = {}
    for n, procs in jobs.items():
        for r, (rc, so, se) in enumerate(worker.wait(procs)):
            assert rc == 0 and f"TORCH_DIST_WORKER_OK {r}" in so, se[-3000:]
        got[n] = [dict(np.load(out[n] / f"rank{r}.npz")) for r in range(n)]
    return got


@pytest.fixture(scope="module")
def jax_mesh_cl(golden_oracle_index):
    """{n: JAX's FastClassifier on make_mesh(n_data=n)}, pure device."""
    from desamba_tpu.engine.fast_engine import FastClassifier
    from desamba_tpu.parallel import make_mesh

    return {n: FastClassifier(golden_oracle_index, mesh=make_mesh(n_data=n),
                              exact_fallback=False) for n in (1, 2)}


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("case", [c[0] for c in taxon_cases()])
def test_taxon_plain_equals_jax(case, k):
    """taxon_weights_plain, and the wrapper's CPU route, on each case
    against JAX's taxon_weight_step on k virtual devices (the case padded
    with tid 0, weight 0 to a multiple of k)."""
    from desamba_tpu.parallel import make_mesh
    from desamba_tpu.parallel.collectives import taxon_weight_step
    from desamba_tpu_torch.ops.taxon import taxon_weights, taxon_weights_plain

    _, t, w, m = next(c for c in taxon_cases() if c[0] == case)
    pad = (-t.size) % k
    tp = np.concatenate([t, np.zeros(pad, np.int32)])
    wp = np.concatenate([w, np.zeros(pad, w.dtype)])
    ref = np.asarray(taxon_weight_step(make_mesh(n_data=k), m)(tp, wp))
    tt, tw = torch.from_numpy(t), torch.from_numpy(w)
    got = taxon_weights_plain(tt, tw.to(torch.int32), m).numpy()
    assert ref.dtype == got.dtype == np.int32
    assert np.array_equal(got, ref)
    assert np.array_equal(taxon_weights(tt, tw, m).numpy(), ref)
    assert np.array_equal(expected(t, w, m), ref)


def test_taxon_step_over_ranks_equals_jax(ranks):
    """tests/dist_worker.py's check on the port: each rank's process-local
    tids [r + 1, r + 1, 5, 0] with weights [1, 1, 1, 0] give, on every
    rank, the expected vector, which JAX's step gives on the
    concatenation."""
    from desamba_tpu.parallel import make_mesh
    from desamba_tpu.parallel.collectives import taxon_weight_step

    for n, zs in ranks.items():
        want = np.zeros(8, np.int32)
        for p in range(n):
            want[p + 1] += 2
            want[5] += 1
        tids = np.concatenate([[p + 1, p + 1, 5, 0] for p in range(n)])
        w = np.tile(np.array([1, 1, 1, 0], np.int32), n)
        ref = np.asarray(taxon_weight_step(make_mesh(n_data=n), 8)(
            tids.astype(np.int32), w))
        assert np.array_equal(ref, want)
        for z in zs:
            assert np.array_equal(z["dist_taxon"], want), n


@pytest.mark.parametrize("bursts", list(BURSTS))
@pytest.mark.parametrize("W", worker.WIDTHS)
@pytest.mark.parametrize("n", [1, 2])
def test_run_mesh_equals_jax(ranks, jax_mesh_cl, monkeypatch, n, W, bursts):
    """The raw [7, Bp] of _run_mesh on every rank, with the default ops and
    with PLAIN_OPS, equals JAX's FastClassifier(mesh=make_mesh(n_data=n))
    ._run_mesh on the same rows, all seven rows; with stage 2's bursts at
    0 in both packages the caps bind, and at 2 ranks the result then
    differs from one device's, which shows that the caps scale with a
    rank's rows as they do with a JAX shard's."""
    from desamba_tpu.engine import fast_engine as jfe
    from desamba_tpu.engine.fast_engine import FastClassifier
    from desamba_tpu.parallel import make_mesh

    cl = jax_mesh_cl[n]
    key = "" if BURSTS[bursts] is None else "b0_"
    if BURSTS[bursts] is not None:
        for name in worker.BURSTS:
            monkeypatch.setattr(jfe, name, BURSTS[bursts])
        cl = FastClassifier(cl.oi, mesh=make_mesh(n_data=n),
                            exact_fallback=False)
    z0 = ranks[n][0]
    ref = np.asarray(cl._run_mesh(z0[f"packed_{W}"], z0[f"lens_{W}"]))
    assert ref.shape == (7, z0[f"packed_{W}"].shape[0])
    for z in ranks[n]:
        assert np.array_equal(z[f"packed_{W}"], z0[f"packed_{W}"])
        for ops in ("kernel", "plain"):
            got = z[f"raw_{key}{W}_{ops}"]
            assert got.dtype == np.int32 and got.shape == ref.shape
            bad = np.argwhere(got != ref)
            assert bad.size == 0, (ops, bad[:5])
    if n == 2 and key:
        assert (ref != z0[f"single_{key}{W}"]).any()


@pytest.mark.parametrize("fallback", [False, True])
def test_mesh_results_equal_jax(ranks, golden_oracle_index, fallback):
    """classify_batch on the dryrun read set (the golden reads of <= 250
    and 1025-2048 bp and a > 8 kb read) at 2 ranks: every FastResult field
    on every rank, and the stats, equal JAX's on make_mesh(n_data=2),
    with and without the exact replay."""
    from desamba_tpu.engine.fast_engine import FastClassifier
    from desamba_tpu.parallel import make_mesh
    from desamba_tpu_torch.parallel.dryrun import dryrun_reads

    reads = dryrun_reads()
    cl = FastClassifier(golden_oracle_index, mesh=make_mesh(n_data=2),
                        exact_fallback=fallback)
    res = cl.classify_batch(reads)
    rows = np.array([(r.ref_ID, r.direction, r.score, r.read_len, r.pos)
                     for r in res])
    assert res[-1].read_len > cl.max_width and res[-1].ref_ID >= 0
    f = int(fallback)
    for z in ranks[2]:
        assert z["names"].tolist() == [r.name for r in res]
        assert np.array_equal(z[f"res_{f}"], rows)
        assert z[f"stats_{f}"].tolist() == [cl.stats["n_reads"],
                                            cl.stats["n_fallback"]]
    if fallback:
        assert cl.stats["n_fallback"] > 0


def test_make_mesh_refuses_a_missing_group_or_a_wrong_n_data(ranks,
                                                            monkeypatch):
    """Without a process group make_mesh raises (and init_distributed,
    with neither a coordinator nor a cluster in the environment, starts
    none); in a group, n_data other than the world size raises, as does a
    classifier on another device than the mesh's."""
    import torch.distributed as dist

    from desamba_tpu_torch.parallel import init_distributed, make_mesh

    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is None and not dist.is_initialized()
    with pytest.raises(ValueError, match="virtual devices"):
        make_mesh(device="cpu")
    for zs in ranks.values():
        for z in zs:
            assert int(z["refused_n_data"]) == 1
            assert int(z["refused_device"]) == 1


@pytest.mark.parametrize("n", [0, 1, 5, 8, 13])
def test_pad_batch_and_exports_equal_jax(n):
    """pad_batch is JAX's; the parallel package exports the names of
    JAX's that the port has, and taxon_weight_step."""
    import desamba_tpu.parallel as jp
    import desamba_tpu_torch.parallel as tp

    for k in (1, 2, 3, 8):
        assert tp.pad_batch(n, k) == jp.pad_batch(n, k)
    assert set(tp.__all__) == ({"make_mesh", "init_distributed", "pad_batch"}
                               | {"DataMesh", "taxon_weight_step"})
    assert set(tp.__all__) - {"DataMesh", "taxon_weight_step"} <= set(
        jp.__all__)


def test_dryrun_two_cpu_ranks_exits_0(golden_index_dir):
    """python -m desamba_tpu_torch.parallel.dryrun --nproc 2 --device cpu:
    the mesh equals one device on every read, the long read is classified,
    the weights total the read count."""
    p = subprocess.run(
        [sys.executable, "-m", "desamba_tpu_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cpu", "--index", golden_index_dir,
         "--timeout", "170"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    ok = [ln for ln in p.stdout.splitlines()
          if ln.startswith("dryrun_multichip: ok on 2 processes;")]
    assert len(ok) == 1 and "48 golden reads" in ok[0], p.stdout
    assert "taxon all_reduce total 48" in ok[0]
