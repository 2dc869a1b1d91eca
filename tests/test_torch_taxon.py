"""The taxon-weight reduction (K13, ops/taxon.taxon_weights) against its
plain torch version and an int64 numpy sum, and the data-parallel
classifier on the card.

`taxon_cases` builds inputs that reach each rule of the reduction (tids
below 0 and at or past max_tid clip to the end bins; zero and negative
weights; every read on one tid; max_tid = 1; int64 weights that wrap when
cast to int32; a bin whose sum wraps past 2^31); `check_taxon_coverage`
asserts that they do. tests/test_torch_parallel.py holds the plain
version to JAX's taxon_weight_step on them. This file imports no JAX, so
its tests marked `cuda` also run on the card:

    python -m pytest tests/test_torch_taxon.py -m cuda -q

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from desamba_tpu_torch import kernels
from desamba_tpu_torch.ops.taxon import taxon_weights, taxon_weights_plain
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I32_MIN, I32_MAX = -2**31, 2**31 - 1
NCBI_MAX_TID = 1 << 22  # NCBI taxonomy ids fit below 2^22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def taxon_cases() -> list:
    """[(name, tids int32[B], weights int32 or int64 [B], max_tid)]."""
    rng = np.random.default_rng(0)
    # tests/test_parallel.py::test_taxon_weight_psum's inputs
    cases = [("jax_random", rng.integers(0, 64, 160).astype(np.int32),
              rng.integers(1, 100, 160).astype(np.int32), 64)]
    r = np.random.default_rng(1)
    cases.append(("clip", np.array(
        [-1, I32_MIN, 0, 15, 16, 17, I32_MAX, -7, 3, 1000, 2, 15], np.int32),
        r.integers(1, 50, 12).astype(np.int32), 16))
    w = r.integers(-40, 40, 64).astype(np.int32)
    w[::5] = 0
    cases.append(("zero_and_negative_weights",
                  r.integers(0, 12, 64).astype(np.int32), w, 12))
    cases.append(("one_tid", np.full(48, 7, np.int32),
                  r.integers(1, 9, 48).astype(np.int32), 10))
    cases.append(("max_tid_1", r.integers(-5, 5, 24).astype(np.int32),
                  r.integers(-3, 30, 24).astype(np.int32), 1))
    cases.append(("int64_wrap", r.integers(0, 8, 16).astype(np.int32),
                  np.array([2**32 + 3, 2**31, -2**31 - 5, 2**40 + 1, -1,
                            2**33, 7, 2**31 - 1, -2**63, 2**63 - 1, 0, 5,
                            2**35 - 9, 11, -2**32, 3], np.int64), 8))
    cases.append(("sum_wrap", np.array([2, 3] * 8, np.int32),
                  np.full(16, 2**29 + 7, np.int32), 4))
    cases.append(("empty", np.zeros(0, np.int32), np.zeros(0, np.int32), 5))
    return cases


def expected(tids, weights, max_tid) -> np.ndarray:
    """The reduction in exact int64, then wrapped to int32."""
    acc = np.zeros(max_tid, np.int64)
    np.add.at(acc, np.clip(tids, 0, max_tid - 1),
              weights.astype(np.int32).astype(np.int64))
    return acc.astype(np.int32)


def check_taxon_coverage(cases) -> None:
    """Assert that the cases reach each rule of the reduction."""
    names = {c[0] for c in cases}
    assert "jax_random" in names
    assert any((t < 0).any() for _, t, _, _ in cases)
    assert any((t >= m).any() for _, t, _, m in cases)
    assert any((t == I32_MIN).any() and (t == I32_MAX).any()
               for _, t, _, _ in cases)
    assert any((w == 0).any() and (w < 0).any() for _, _, w, _ in cases)
    assert any(t.size > 1 and np.unique(np.clip(t, 0, m - 1)).size == 1
               and m > 1 for _, t, _, m in cases)
    assert any(m == 1 and t.size for _, t, _, m in cases)
    assert any(w.dtype == np.int64 and ((w < I32_MIN) | (w > I32_MAX)).any()
               for _, _, w, _ in cases)
    sums = [np.bincount(np.clip(t, 0, m - 1), minlength=m,
                        weights=w.astype(np.int32).astype(np.float64))
            for _, t, w, m in cases]
    assert any((s > I32_MAX).any() or (s < I32_MIN).any() for s in sums)
    assert any(t.size == 0 for _, t, _, _ in cases)


def test_taxon_cases_reach_every_case():
    check_taxon_coverage(taxon_cases())


@pytest.mark.parametrize("case", [c[0] for c in taxon_cases()])
def test_taxon_plain_and_cpu_route_equal_the_exact_sum(case):
    """The plain version and the wrapper on CPU tensors equal the int64
    sum wrapped to int32; the CPU route launches nothing."""
    _, t, w, m = next(c for c in taxon_cases() if c[0] == case)
    want = expected(t, w, m)
    tt, tw = torch.from_numpy(t), torch.from_numpy(w)
    got = taxon_weights_plain(tt, tw.to(torch.int32), m)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    before = dict(kernels.launches)
    got = taxon_weights(tt, tw, m)
    assert np.array_equal(got.numpy(), want)
    assert kernels.launches == before


def test_taxon_input_checks():
    t = torch.zeros(4, dtype=torch.int32)
    w = torch.ones(4, dtype=torch.int32)
    for bad in (
            lambda: taxon_weights(t, w, 0),
            lambda: taxon_weights(t, w, 2**31),
            lambda: taxon_weights(t.to(torch.int64), w, 3),
            lambda: taxon_weights(t.view(2, 2), w.view(2, 2), 3),
            lambda: taxon_weights(t, w[:3], 3),
            lambda: taxon_weights(t, w.float(), 3),
            lambda: taxon_weights(t, w.bool(), 3),
            lambda: taxon_weights(torch.zeros(8, dtype=torch.int32)[::2], w,
                                  3),
            lambda: taxon_weights(t, w.to("meta"), 3),
            lambda: taxon_weights(t.to("meta"), w.to("meta"), 3)):
        with pytest.raises(ValueError):
            bad()
    # int8 and uint8 weights are cast as JAX's astype casts them
    t = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    for dt, vals, want in ((torch.uint8, [255, 2, 1, 0], [257, 1, 0]),
                           (torch.int8, [-1, 2, 127, -128], [1, 127, -128])):
        got = taxon_weights(t, torch.tensor(vals, dtype=dt), 3)
        assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.cuda
def test_taxon_kernel_cases(cuda):
    """The kernel equals its plain version on every case and at NCBI's
    2^22 taxids, one launch a call."""
    rng = np.random.default_rng(2)
    cases = taxon_cases() + [(
        "ncbi", rng.integers(-10, NCBI_MAX_TID + 10, 8192).astype(np.int32),
        rng.integers(0, 3, 8192).astype(np.int32), NCBI_MAX_TID)]
    for name, t, w, m in cases:
        tt = torch.from_numpy(t).to(cuda)
        tw = torch.from_numpy(w).to(cuda)
        before = kernels.launches["taxon_weights"]
        got = taxon_weights(tt, tw, m)
        torch.cuda.synchronize()
        assert kernels.launches["taxon_weights"] == before + 1
        want = taxon_weights_plain(tt, tw.to(torch.int32), m)
        assert torch.equal(got, want), name
        assert np.array_equal(got.cpu().numpy(), expected(t, w, m)), name


@pytest.mark.cuda
@pytest.mark.parametrize("max_tid", [100_106, NCBI_MAX_TID])
@pytest.mark.parametrize("B", [1 << 16, 1 << 19])
def test_taxon_kernel_large_batch(cuda, B, max_tid):
    """Far past a batch's few thousand pairs (every block of the kernel
    reads them all): exact, one launch by the count, one taxon_bins_kernel
    row and no memset in the profile. Hot bins (most pairs on 90 tids)
    and a bin that wraps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(B)
    t = rng.integers(-5, max_tid + 5, B).astype(np.int32)
    t[: B // 2] = rng.integers(0, 90, B // 2) * (max_tid // 100)
    w = rng.integers(-3, 9, B).astype(np.int32)
    w[:3], t[:3] = 2**30, 7          # bin 7 sums past 2^31 and wraps
    tt, tw = torch.from_numpy(t).to(cuda), torch.from_numpy(w).to(cuda)
    taxon_weights(tt, tw, max_tid)
    torch.cuda.synchronize()
    for _ in range(3):  # torch.profiler at times reports no kernel row
        before = kernels.launches["taxon_weights"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = taxon_weights(tt, tw, max_tid)
            torch.cuda.synchronize()
        assert kernels.launches["taxon_weights"] == before + 1
        assert np.array_equal(got.cpu().numpy(), expected(t, w, max_tid))
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if rows:
            break
    kern = [e for e in rows if "taxon_" in e.key]
    memset = [e for e in rows if "memset" in e.key.lower()]
    assert len(kern) == 1 and kern[0].count == 1, [e.key for e in rows]
    assert "taxon_bins_kernel" in kern[0].key and not memset


@pytest.mark.cuda
def test_mesh_world1_nccl_equals_one_device(cuda, tmp_path, golden_index_dir):
    """One rank over NCCL: _run_mesh's [7, Bp] equals one device's _run on
    all seven rows (also with stage 2's caps binding), classify_batch
    equals one device's, every kernel of the path and K13 launched, and
    the taxon step is the dist_worker's vector."""
    procs = worker.spawn(1, tmp_path, golden_index_dir, device="cuda",
                         backend="nccl")
    (rc, out, err), = worker.wait(procs)
    assert rc == 0 and "TORCH_DIST_WORKER_OK 0" in out, err[-3000:]
    z = np.load(tmp_path / "rank0.npz")
    for W in worker.WIDTHS:
        assert np.array_equal(z[f"raw_{W}_kernel"], z[f"single_{W}"]), W
        assert np.array_equal(z[f"raw_{W}_plain"], z[f"single_{W}"]), W
        assert np.array_equal(z[f"raw_b0_{W}_kernel"], z[f"single_b0_{W}"])
    assert np.array_equal(z["res_0"], z["single_res_0"])
    launches = json.loads(str(z["launches"]))
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    assert all(launches[k] > 0 for k in (*KERNEL_OPS, "taxon_weights")), \
        launches
    # rank 0 alone: tids [1, 1, 5, 0], weights [1, 1, 1, 0]
    assert z["dist_taxon"].tolist() == [0, 2, 0, 0, 0, 1, 0, 0]


@pytest.mark.cuda
def test_dryrun_two_ranks_over_gloo_on_one_card(cuda, golden_index_dir):
    """Two ranks share the card over gloo (NCCL takes one card a rank):
    the dryrun passes and each rank launched the kernels."""
    p = subprocess.run(
        [sys.executable, "-m", "desamba_tpu_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cuda", "--backend", "gloo", "--index",
         golden_index_dir, "--timeout", "170"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "dryrun_multichip: ok on 2 processes" in p.stdout
    ranks = [json.loads(ln.split(" launches ", 1)[1])
             for ln in p.stdout.splitlines() if " launches " in ln]
    assert len(ranks) == 2 and all(r.get("taxon_weights", 0) > 0
                                   and r.get("stage1", 0) > 0
                                   for r in ranks), ranks
