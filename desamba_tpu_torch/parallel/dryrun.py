"""The data-parallel classifier over N processes, on the golden read set.

    python -m desamba_tpu_torch.parallel.dryrun --nproc N
        --device cpu|cuda [--backend nccl|gloo] --index DIR [--timeout S]

The port's counterpart of the data axis of __graft_entry__'s
dryrun_multichip. It starts N ranks of one process group over TCP on
127.0.0.1 (each a process running this module with --rank), with the
index in DIR (the golden references, tests/golden/ref.fa, in the C
reference's format) replicated on every rank's device. Each rank reads
tests/golden/reads.fq and keeps the same selection as dryrun_multichip:
the reads of <= 250 bp, those of 1025-2048 bp and one > 8 kb read cut
from ref.fa (`long_read`), so that the long-read block partitioning runs
on the mesh too. Each rank classifies them with FastClassifier on the mesh
(exact_fallback=False), then sums the taxon weights of its share of the
results with parallel.taxon_weight_step, and prints its kernel launches
of that run (counts set to 0 just before it). Rank 0 checks (ref_ID,
score, direction) of every read against a FastClassifier on one device,
that the long read is classified and that the weights total the read
count, and prints one `dryrun_multichip: ok on N processes; ...` line.
The command exits 0 when every rank does; a rank's failure or the
timeout ends every rank and exits nonzero. NCCL needs a card a rank:
several ranks on one card run over gloo.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLD = os.path.join(ROOT, "tests", "golden")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def long_read() -> tuple:
    """A > 8 kb read from the golden references: 10,000 bases of the first
    genome from offset 2,000 with ~2% substitutions from numpy's
    default_rng(5), as __graft_entry__._make_long_read makes it."""
    import numpy as np

    from ..io.fastx import read_fastx

    g0 = next(iter(read_fastx(os.path.join(GOLD, "ref.fa")))).seq
    frag = bytearray(g0[2000 : 2000 + 10_000])
    rng = np.random.default_rng(5)
    bases = b"ACGT"
    for p in rng.integers(0, len(frag), len(frag) // 50):
        frag[p] = bases[(bases.index(frag[p : p + 1]) + 1) % 4] \
            if frag[p : p + 1] in b"ACGT" else frag[p]
    return ("longread_1", bytes(frag), None)


def dryrun_reads() -> list:
    """The golden reads of <= 250 bp, of 1025-2048 bp, then long_read()."""
    from ..io.fastx import read_fastx

    reads = [(r.name, r.seq, r.qual)
             for r in read_fastx(os.path.join(GOLD, "reads.fq"))]
    short = [r for r in reads if len(r[1]) <= 250]
    full = [r for r in reads if 1024 < len(r[1]) <= 2048]
    return (short + full + [long_read()]) if full else reads


def say(line: str) -> None:
    """Print one line in one write: the ranks share the launcher's stdout,
    and an unbuffered print writes the newline apart, so that another
    rank's line could land between."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def rank_main(a) -> int:
    import numpy as np
    import torch.distributed as dist

    from .. import kernels
    from ..engine.fast_engine import FastClassifier
    from ..index.loader import load_index
    from . import init_distributed, make_mesh, taxon_weight_step

    init_distributed(f"127.0.0.1:{a.port}", a.nproc, a.rank,
                     backend=a.backend, device=a.device)
    try:
        mesh = make_mesh(a.nproc, device=a.device)
        idx = load_index(a.index)
        reads = dryrun_reads()
        cl = FastClassifier(idx, mesh=mesh, exact_fallback=False)
        kernels.reset_launches()
        res = cl.classify_batch(reads)
        tids = np.array([cl.tid_of(r.ref_ID) for r in res], np.int32)
        max_tid = int(tids.max()) + 2
        lo = mesh.rank * len(tids) // mesh.n_data
        hi = (mesh.rank + 1) * len(tids) // mesh.n_data
        w = taxon_weight_step(mesh, max_tid)(
            tids[lo:hi], np.ones(hi - lo, np.int32)).cpu().numpy()
        launches = {k: v for k, v in kernels.launches.items() if v}
        say(f"rank {mesh.rank} launches {json.dumps(launches)}")
        if mesh.rank == 0:
            one = FastClassifier(idx, device=a.device, exact_fallback=False,
                                 tables=(cl.fm, cl.ek, cl.loc, cl.ra))
            r1 = one.classify_batch(reads)
            n_diff = sum((x.ref_ID, x.score, x.direction)
                         != (y.ref_ID, y.score, y.direction)
                         for x, y in zip(res, r1))
            if n_diff:
                raise AssertionError(f"{n_diff}/{len(reads)} reads differ "
                                     "from one device")
            lr = res[-1]
            if not (lr.read_len > cl.max_width and lr.ref_ID >= 0):
                raise AssertionError("the block-partitioned long read is "
                                     f"not classified: {lr}")
            if int(w.sum()) != len(reads):
                raise AssertionError(f"taxon weights total {w.sum()}, not "
                                     f"{len(reads)}")
            n_cls = sum(r.ref_ID >= 0 for r in res)
            say(f"dryrun_multichip: ok on {a.nproc} processes; "
                f"{len(reads)} golden reads, {n_cls} classified, mesh == "
                f"single-device, taxon all_reduce total {int(w.sum())} "
                f"({dist.get_backend()} on {a.device})")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def launch(a) -> int:
    """Start the ranks and wait for all of them; on a failure or the
    timeout, end the others."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # the ranks share the host's cores: torch's CPU threads split them
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // a.nproc)))
    args = ["--nproc", str(a.nproc), "--device", a.device, "--index",
            a.index, "--port", str(port)]
    if a.backend:
        args += ["--backend", a.backend]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "desamba_tpu_torch.parallel.dryrun", *args,
         "--rank", str(r)], cwd=ROOT, env=env) for r in range(a.nproc)]
    deadline = time.time() + a.timeout
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                print(f"dryrun: a rank exited {rc}", file=sys.stderr)
                break
            if time.time() > deadline:
                rc = 124
                print(f"dryrun: timed out after {a.timeout} s",
                      file=sys.stderr)
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc or next((p.returncode for p in procs if p.returncode), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="desamba_tpu_torch.parallel.dryrun")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--device", required=True, choices=["cpu", "cuda"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="[nccl for cuda, gloo for cpu]")
    ap.add_argument("--index", required=True,
                    help="the golden references' index directory")
    ap.add_argument("--timeout", type=float, default=300,
                    help="seconds for all ranks [300]")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.nproc < 1:
        ap.error("--nproc must be >= 1")
    return rank_main(a) if a.rank is not None else launch(a)


if __name__ == "__main__":
    sys.exit(main())
