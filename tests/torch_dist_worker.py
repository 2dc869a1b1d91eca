"""One rank of the port's data-parallel classifier, for the tests.

    python tests/torch_dist_worker.py --rank R --nproc N --port P
        --out DIR --index DIR --device cpu|cuda [--backend gloo|nccl]

Not collected by pytest (its name does not start with test_). The tests
never start a process group in their own process: `spawn` starts the N
ranks of one job, each running this file, and `wait` collects them. Each
rank joins a process group over TCP on 127.0.0.1:P, makes the mesh and
writes DIR/rank<R>.npz with:
  * refused_n_data, refused_device: make_mesh with n_data = N + 1 and a
    FastClassifier on another device than the mesh's raised ValueError;
  * dist_taxon: the analog of tests/dist_worker.py, taxon_weight_step
    over process-local tids [R + 1, R + 1, 5, 0] with weights
    [1, 1, 1, 0] into 8 bins;
  * packed_W, lens_W, raw_W_kernel, raw_W_plain, single_W (W = 1024,
    2048): the golden reads of width bucket W encoded as one chunk, the
    [7, Bp] of _run_mesh with the default ops and with PLAIN_OPS, and of
    one device's _run on the same rows;
  * names, res_F, stats_F (F = 0, 1 for exact_fallback False, True): the
    FastResults of classify_batch on the dryrun read set
    (parallel.dryrun.dryrun_reads), as (ref_ID, direction, score,
    read_len, pos) rows, and the stats; single_res_0: one device's;
  * launches: JSON of the kernel launches of the mesh classify_batch
    (exact_fallback False) and the dist_taxon step, counts set to 0 just
    before.
It asserts that it imported neither jax nor the JAX package, and prints
TORCH_DIST_WORKER_OK <rank> last.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
WIDTHS = (1024, 2048)
BURSTS = ("IV_BURST", "IV_MID", "WALK_BURST", "WALK_MID")


def spawn(nproc, out, index, device="cpu", backend=None):
    """Start the nproc ranks of one job (on a free port); returns the
    Popen list for `wait`."""
    sys.path.insert(0, ROOT)
    from desamba_tpu_torch.parallel.dryrun import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT,
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // 4)))
    args = [sys.executable, os.path.abspath(__file__), "--nproc", str(nproc),
            "--port", str(port), "--out", str(out), "--index", str(index),
            "--device", device] + (["--backend", backend] if backend else [])
    return [subprocess.Popen(args + ["--rank", str(r)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(nproc)]


def wait(procs, timeout=180.0):
    """[(returncode, stdout, stderr)] of each rank; a rank still running
    at the timeout is killed (returncode then negative)."""
    deadline = time.time() + timeout
    outs = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, e = p.communicate()
            e += f"\nkilled after {timeout} s"
        outs.append((p.returncode, o, e))
    return outs


def _golden_reads():
    from desamba_tpu_torch.io.fastx import read_fastx

    return [(r.name, r.seq, r.qual)
            for r in read_fastx(os.path.join(GOLD, "reads.fq"))]


def _rows(res):
    import numpy as np

    return np.array([(r.ref_ID, r.direction, r.score, r.read_len, r.pos)
                     for r in res], np.int64)


def main():
    ap = argparse.ArgumentParser()
    for k in ("--rank", "--nproc", "--port"):
        ap.add_argument(k, type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch
    import torch.distributed as dist

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.constants import _pow2
    from desamba_tpu_torch.engine.fast_engine import FastClassifier
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.parallel import (init_distributed, make_mesh,
                                            taxon_weight_step)
    from desamba_tpu_torch.parallel.dryrun import dryrun_reads

    init_distributed(f"127.0.0.1:{a.port}", a.nproc, a.rank,
                     backend=a.backend, device=a.device)
    out = {}
    mesh = make_mesh(a.nproc, device=a.device)
    idx = load_index(a.index)
    try:
        make_mesh(a.nproc + 1, device=a.device)
        out["refused_n_data"] = 0
    except ValueError:
        out["refused_n_data"] = 1
    other = "cuda:0" if mesh.device.type == "cpu" else "cpu"
    try:
        FastClassifier(idx, mesh=mesh, device=other)
        out["refused_device"] = 0
    except ValueError:
        out["refused_device"] = 1

    cl = FastClassifier(idx, mesh=mesh, exact_fallback=False)
    tabs = (cl.fm, cl.ek, cl.loc, cl.ra)
    plain = FastClassifier(idx, mesh=mesh, exact_fallback=False, plain=True,
                           tables=tabs)
    one = FastClassifier(idx, device=mesh.device, exact_fallback=False,
                         tables=tabs)
    reads = _golden_reads()
    for W in WIDTHS:
        sub = [r for r in reads if W // 2 < len(r[1]) <= W or (
            W == WIDTHS[0] and len(r[1]) <= W)]
        Bp = _pow2(len(sub), 8)
        Bp += (-Bp) % mesh.n_data
        packed, lens_p, _ = cl._encode(sub, W=W, Bp=Bp)
        out[f"packed_{W}"], out[f"lens_{W}"] = packed, lens_p
        out[f"raw_{W}_kernel"] = np.asarray(cl._run_mesh(packed, lens_p))
        out[f"raw_{W}_plain"] = np.asarray(plain._run_mesh(packed, lens_p))
        out[f"single_{W}"] = np.asarray(one._run(packed, lens_p))

    # with stage 2's bursts before the cuts at 0, the compaction caps bind
    # (tests/test_torch_stage2.py); they scale with a rank's rows
    from desamba_tpu_torch.engine import fast_engine as tfe

    saved = {k: getattr(tfe, k) for k in BURSTS}
    for k in BURSTS:
        setattr(tfe, k, 0)
    try:
        for W in WIDTHS:
            packed, lens_p = out[f"packed_{W}"], out[f"lens_{W}"]
            out[f"raw_b0_{W}_kernel"] = np.asarray(
                cl._run_mesh(packed, lens_p))
            out[f"raw_b0_{W}_plain"] = np.asarray(
                plain._run_mesh(packed, lens_p))
            out[f"single_b0_{W}"] = np.asarray(one._run(packed, lens_p))
    finally:
        for k, v in saved.items():
            setattr(tfe, k, v)

    dreads = dryrun_reads()
    out["names"] = np.array([r[0] for r in dreads])
    kernels.reset_launches()
    res = cl.classify_batch(dreads)
    out["dist_taxon"] = taxon_weight_step(mesh, 8)(
        np.array([a.rank + 1, a.rank + 1, 5, 0], np.int32),
        np.array([1, 1, 1, 0], np.int32)).cpu().numpy()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = json.dumps(kernels.launches)
    out["res_0"], out["stats_0"] = _rows(res), [cl.stats[k] for k in (
        "n_reads", "n_fallback")]
    cl.exact_fallback = True
    cl.stats = dict(n_reads=0, n_fallback=0)
    out["res_1"] = _rows(cl.classify_batch(dreads))
    out["stats_1"] = [cl.stats["n_reads"], cl.stats["n_fallback"]]
    out["single_res_0"] = _rows(one.classify_batch(dreads))
    np.savez(os.path.join(a.out, f"rank{a.rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "desamba_tpu", "bench")]
    assert not bad, bad
    print(f"TORCH_DIST_WORKER_OK {a.rank}", flush=True)


if __name__ == "__main__":
    main()
