"""Time the stage-1 kernel (K4 + K5) and the row walks (K2) against an
earlier commit's, in turns, on the chunks of chip_smoke.py, on one GPU.

    mkdir -p build/parent
    for f in stage1.cu row_walks.cu bloom.cuh; do
      git show <commit>:desamba_tpu_torch/csrc/$f > build/parent/$f; done
    python3 tools/kernel_ab.py build/parent

Builds the parent's stage1.cu and row_walks.cu with kernels.NVCC_FLAGS
into that directory and puts their C entry points, loaded with the
argtypes of kernels.KERNELS, under the port's own wrappers
(parent_kernels): the C interfaces are the same. The parent's resume
wrote into a copy of the carry that its wrapper made; parent_kernels
hands the wrapper that copy (copy=True). Makes the smoke's bench data
(chip_smoke.make_data, cached under build/bench_cache) and captures the
kernels' calls on the first chunk of each width bucket
(chip_smoke.kernel_inputs: stage 1's call and K2's burst, mid and tail
resume). Both kernels' outputs must equal the plain versions', or the run
fails. Then, with L2 evicted before each call (chip_smoke.cuda_ms, median
of 20): each call parent, current, current, parent (the resumes' parent
also without its copy, parent_kernel_ms), and the host's time a call
(host_us: the wrapper's enqueue, median of 200, in the same turns); the
parent's K2 sweep over chip_smoke.WALK_SWEEP_CAPS beside the bare pointer
chase (chip_smoke.walk_sweep) on the first chunk's burst carry; and
pure-device classify_batch reads/s of all reads in N_PAIRS pairs, the
parent first in every other pair, three calls a side, whose results must
be equal. Prints the card line and one JSON line, `kernel_ab {...}`.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

NAMES = ("stage1", "row_walks")
N_PAIRS = 10  # pairs of (parent, current) pure-device classify_batch turns


def build_parent(pdir: str) -> tuple[dict, dict]:
    """({kernel: ctypes function}, chip_smoke.ptxas_report) of the
    parent's sources in pdir."""
    from desamba_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for name in NAMES:
        src = kernels.KERNELS[name][0]
        lib = os.path.join(pdir, f"lib{name}-parent.so")
        procs[name] = lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(pdir, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        logs[name] = dict(log=log)
        _, entry, argtypes = kernels.KERNELS[name]
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns, cs.ptxas_report(logs)


@contextlib.contextmanager
def parent_kernels(fns: dict, copy: bool = True):
    """The port's wrappers on the parent's C entry points fns; with copy,
    K2's resume runs on a copy of the carry, as the parent's wrapper
    made one (state.clone()) for its kernel to write."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine import fast_engine

    for name in NAMES:
        kernels._fn(name)  # the current entry points, loaded
    saved = {k: kernels._fns[k] for k in NAMES}
    rw = fast_engine.KERNEL_OPS["row_walks"]

    def rw_copy(fm, codes, lanes, max_lens, state, cap, sel=None):
        return rw(fm, codes, lanes, max_lens,
                  state if sel is None else state.clone(), cap, sel=sel)

    kernels._fns.update(fns)
    if copy:
        fast_engine.KERNEL_OPS["row_walks"] = rw_copy
    try:
        yield
    finally:
        kernels._fns.update(saved)
        fast_engine.KERNEL_OPS["row_walks"] = rw


def main() -> int:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine import fast_engine
    from desamba_tpu_torch.engine.fast_engine import (FastClassifier,
                                                      PLAIN_OPS)
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.io.fastx import read_fastx

    card = cs.card_line()
    print(card, flush=True)
    info = kernels.build_all(extra=("measure.cu",))
    fns, parent_ptxas = build_parent(sys.argv[1])
    ptxas = cs.ptxas_report(info)
    _, fq, idx_dir = cs.make_data()
    cl = FastClassifier(load_index(idx_dir), device="cuda")
    reads = [(r.name, r.seq, r.qual) for r in read_fastx(fq)]
    chunks = cs.first_chunks(cl, reads)
    res = dict(card=card, ptxas={k: ptxas[k] for k in NAMES},
               parent_ptxas=parent_ptxas, stage1={}, row_walks={})

    def host_us(fn) -> float:
        """Median host time (µs) of fn over 200 calls, each timed alone;
        the card's queue takes the launches, so no call waits on it."""
        t = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn()
            t.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return sorted(t)[len(t) // 2] * 1e6

    def turns(fn, prep=None) -> dict:
        """fn parent, current, current, parent: cuda_ms cold, median of
        20, and host_us."""
        t, h = [], []
        for parent in (True, False, False, True):
            with parent_kernels(fns) if parent else contextlib.nullcontext():
                t.append(cs.cuda_ms(fn, 20, cold=True, prep=prep))
                h.append(host_us(fn))
        return dict(parent_ms=[t[0], t[3]], ms=[t[1], t[2]],
                    parent_host_us=[h[0], h[3]], host_us=[h[1], h[2]])

    for W in sorted(chunks):
        cap = cs.kernel_inputs(cl, *chunks[W][:2])
        for key in ("stage1", "row_walks", "row_walks[sel]",
                    "row_walks[sel]#2"):
            args, kw = cap[key]
            name = key.split("[")[0]
            # looked up at each call, so that parent_kernels' copy applies
            fn, prep = cs.in_place_call(
                name, lambda *a, **k: fast_engine.KERNEL_OPS[name](*a, **k),
                args, kw)
            ref = PLAIN_OPS[name](*args, **kw)
            for parent in (False, True):
                with (parent_kernels(fns) if parent
                      else contextlib.nullcontext()):
                    if prep is not None:
                        prep()
                    err = cs.max_abs_err(fn(), ref)
                if err:
                    raise AssertionError(f"{key} at W={W}: the "
                                         f"{'parent' if parent else 'new'} "
                                         f"kernel differs (max abs err "
                                         f"{err})")
            r = turns(fn, prep)
            if name == "stage1":
                r["bound_ms"], r["bound_by"] = cs.bound("stage1", args, ref)
                r["bound_old_ms"] = cs.stage1_old_bound(args, ref)
                res["stage1"][f"W={W}"] = r
            else:
                r["shape"] = f"n={args[4].shape[1]} cap={args[5]}"
                if kw:
                    with parent_kernels(fns, copy=False):
                        r["parent_kernel_ms"] = cs.cuda_ms(fn, 20, cold=True,
                                                           prep=prep)
                res["row_walks"][f"{key} W={W}"] = r
            cs.log(f"kernel_ab: {key} W={W}: {r}")
        if W == min(chunks):
            with parent_kernels(fns):
                res["row_walks_parent_sweep"] = cs.walk_sweep(
                    info["measure.cu"]["path"], cap["row_walks"][0])
        del cap

    # pure-device reads/s of every read, parent and current in pairs
    cl.exact_fallback = False
    cl.classify_batch(reads, block=cs.BLOCK)
    rates = dict(parent=[], current=[])
    first = None
    for parent in [p for i in range(N_PAIRS)
                   for p in ((True, False) if i % 2 == 0 else (False, True))]:
        with parent_kernels(fns) if parent else contextlib.nullcontext():
            for _ in range(3):
                t0 = time.time()
                out = cl.classify_batch(reads, block=cs.BLOCK)
                torch.cuda.synchronize()
                rates["parent" if parent else "current"].append(
                    len(reads) / (time.time() - t0))
        first = first or cs.tup(out)
        if cs.tup(out) != first:
            raise AssertionError("the parent's and the current kernels' "
                                 "results differ")
    res["device_reads_per_s"] = rates
    cs.log(f"kernel_ab: pure-device reads/s {rates}")
    print("kernel_ab " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
