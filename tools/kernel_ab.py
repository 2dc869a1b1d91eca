"""Time the stage-1 kernel (K4 + K5), the interval search (K1), the row
walks (K2), locate (K6), the compaction scan (K3: compact, row_grid),
the vote (K7), stage 0's unpack (K10), stage 4's window gather (K9a) and
combine (K9b), and the sharded classifier's merge (K11) against an
earlier commit's, in turns, on the chunks of chip_smoke.py, on one GPU.

    mkdir -p build/parent build/tmp
    git archive <commit> desamba_tpu_torch/csrc | tar -x -C build/tmp
    cp build/tmp/desamba_tpu_torch/csrc/* build/parent/
    python3 tools/kernel_ab.py build/parent

Builds the parent's sources of NAMES with kernels.NVCC_FLAGS into that
directory and puts their C entry points, loaded with the argtypes of
kernels.KERNELS, under the port's own wrappers (parent_kernels); an
entry point whose arguments changed since (PARENT_ADAPTERS: the merge's
n_maps) gets its old argtypes and the current arguments mapped onto
them. A parent's resume of K1 or K2 wrote into a copy of the carry that
its wrapper made; the current wrappers update the carry in place
(chip_smoke.IN_PLACE), so parent_kernels hands them that copy
(copy=True). Makes the smoke's bench data and its genome shards
(chip_smoke.make_data, cached under build/bench_cache) and captures the
kernels' calls on the first chunk of each width bucket
(chip_smoke.kernel_inputs: unpack's call, stage 1's call, K1's and K2's
burst, mid and tail resume, locate's call, compact's first call and
first through a source list, row_grid's call, the vote's call,
band_windows' call, combine's call), and the merge's call on each chunk
of the sharded classifier's batch (chip_smoke.record_merges). Both
sides' outputs must equal the plain versions', or the run fails. Then,
with L2 evicted before each call (chip_smoke.cuda_ms, median of 20):
each call parent, current, current, parent (the resumes' parent also
without its copy, parent_kernel_ms; K1's calls also each side's C entry
point in place beside the chain alone, chip_smoke.k1_floor; the vote's
launches each alone, kernel_rows_ms; combine and the merge beside their
floors, chip_smoke.kernel_floors), and the host's time a call (host_us:
the wrapper's enqueue, median of 200, in the same turns); each side's
hand kernels in one profiled pure-device classify_batch of the
monolithic classifier (path) and of the sharded one (path_sharded):
device ms and launches of each CUDA function of PATH_NAMES; the
parent's K2 sweep over chip_smoke.WALK_SWEEP_CAPS beside the bare
pointer chase (chip_smoke.walk_sweep) on the first chunk's burst carry;
and pure-device classify_batch reads/s of all reads in N_PAIRS pairs,
the parent first in every other pair, three calls a side, whose results
must be equal, then the same pairs with the parent against itself, the
current against itself, and the current kernels under parent_kernels
against the current as they stand (controls: they read the pairing's
and parent_kernels' own bias). Prints the card line and one JSON line,
`kernel_ab {...}`.
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

NAMES = ("unpack", "stage1", "interval_search", "row_walks", "locate",
         "compact", "row_grid", "vote", "band_windows", "combine",
         "shard_merge")
# the calls of each chunk timed in turns (chip_smoke.kernel_inputs' keys)
KEYS = ("unpack", "stage1", *cs.K1_CALLS, "row_walks", "row_walks[sel]",
        "row_walks[sel]#2", "locate", "compact", "compact[src]",
        "row_grid", "vote", "band_windows", "combine")
# the hand kernels whose CUDA functions the path profile reports (the
# merge's in the sharded classifier's batch)
PATH_NAMES = ("interval_search", "vote", "unpack", "band_windows",
              "combine", "shard_merge")
# the short kernels timed beside their floors (chip_smoke.kernel_floors)
FLOORS = ("combine", "shard_merge")
N_PAIRS = 10  # pairs of (parent, current) pure-device classify_batch turns
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points whose arguments changed: a parent whose source lacks the
# marker gets the old argtypes, and the current wrapper's arguments are
# mapped onto them (dsb_shard_merge took no n_maps before the merge's
# maps were staged in shared memory)
PARENT_ADAPTERS = {
    "shard_merge": (
        "n_maps", [_P, _I, _LL, _P, _P, _I, _P, _P],
        lambda fn: lambda res, n, Bp, maps, n_maps, off, nref, out, st: fn(
            res, n, Bp, maps, off, nref, out, st)),
}


def function_name(key: str) -> str:
    """A CUDA kernel's function name from a profiler row's key."""
    import re

    hit = re.search(r"(\w+)(<[^()]*>)?\(",
                    key.replace("(anonymous namespace)", ""))
    return hit.group(1) if hit else key[:60]


def kernel_rows_ms(fn, match: str, n: int = 20) -> dict:
    """{CUDA function: device ms a launch} of fn's kernels whose profiler
    row names `match`, over n calls, each after an L2 flush (the flush's
    own kernels are not counted): the parts of a call of several
    launches, each cold."""
    import torch

    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    fn()

    def calls():
        for _ in range(n):
            flush.zero_()
            fn()

    return {function_name(e.key): e.self_device_time_total / 1e3
            / max(1, e.count)
            for e in cs.device_rows(calls) if match in e.key}


def build_parent(pdir: str) -> tuple[dict, dict]:
    """({kernel: ctypes function}, chip_smoke.ptxas_report) of the
    parent's sources in pdir."""
    from desamba_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for src in sorted({kernels.KERNELS[name][0] for name in NAMES}):
        lib = os.path.join(pdir, f"lib{os.path.splitext(src)[0]}-parent.so")
        procs[src] = lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(pdir, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for src, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {src}:\n{log}")
        libs[src] = lib, log
    fns, logs = {}, {}
    for name in NAMES:
        src, entry, argtypes = kernels.KERNELS[name]
        logs[name] = dict(log=libs[src][1])
        fn = getattr(ctypes.CDLL(libs[src][0]), entry)
        adapt = None
        if name in PARENT_ADAPTERS:
            marker, old, adapter = PARENT_ADAPTERS[name]
            with open(os.path.join(pdir, src)) as f:
                if marker not in f.read():
                    argtypes, adapt = old, adapter
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn if adapt is None else adapt(fn)
    return fns, cs.ptxas_report(logs)


@contextlib.contextmanager
def parent_kernels(fns: dict, copy: bool = True):
    """The port's wrappers on the parent's C entry points fns; with copy,
    a resume that the current wrapper makes in place (chip_smoke.IN_PLACE:
    K1's and K2's) runs on a copy of the carry, as the parent's wrapper
    made one (state.clone()) for its kernel to write."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine import fast_engine

    for name in NAMES:
        kernels._fn(name)  # the current entry points, loaded
    saved = {k: kernels._fns[k] for k in NAMES}
    ops = {k: fast_engine.KERNEL_OPS[k] for k in cs.IN_PLACE}

    def copying(name):
        kern, i = ops[name], cs.IN_PLACE[name]

        def call(*a, sel=None):
            if sel is not None:
                a = (*a[:i], a[i].clone(), *a[i + 1:])
            return kern(*a, sel=sel)
        return call

    kernels._fns.update(fns)
    if copy:
        for name in cs.IN_PLACE:
            fast_engine.KERNEL_OPS[name] = copying(name)
    try:
        yield
    finally:
        kernels._fns.update(saved)
        fast_engine.KERNEL_OPS.update(ops)


def merge_turns(scl, reads, fns: dict, turns, measure: str) -> dict:
    """The merge on each chunk of the sharded classifier scl's batch of
    reads (chip_smoke.record_merges): both sides held to
    shard_merge_plain, then turns(fn) (parent, current, current, parent)
    beside its bound and its floors (chip_smoke.kernel_floors, of the
    library measure)."""
    from desamba_tpu_torch.ops.merge import shard_merge, shard_merge_plain

    out = {}
    for i, a in enumerate(cs.record_merges(scl, reads)):
        ref = shard_merge_plain(*a)
        fn = lambda a=a: shard_merge(*a)  # noqa: E731
        for parent in (False, True):
            with (parent_kernels(fns) if parent
                  else contextlib.nullcontext()):
                err = cs.max_abs_err(fn(), ref)
            if err:
                raise AssertionError(f"shard_merge on chunk {i}: the "
                                     f"{'parent' if parent else 'new'} "
                                     f"kernel differs (max abs err {err})")
        r = turns(fn)
        r["shape"] = f"n_index={a[0].shape[0]} Bp={a[0].shape[2]}"
        r["bound_ms"], r["bound_by"] = cs.bound("shard_merge", a, ref)
        r.update(cs.kernel_floors(measure, "shard_merge", a, ref))
        out[f"chunk {i}"] = r
        cs.log(f"kernel_ab: shard_merge chunk {i}: {r}")
    return out


def main() -> int:
    import torch

    args = sys.argv[1:]
    if len(args) != 1 or args[0].startswith("-") or not (
            torch.cuda.is_available()):
        print(__doc__, file=sys.stderr)
        return 2
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine import fast_engine
    from desamba_tpu_torch.engine.fast_engine import (FastClassifier,
                                                      PLAIN_OPS)
    from desamba_tpu_torch.engine.sharded_fast import load_sharded_fast
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.io.fastx import read_fastx

    card = cs.card_line()
    print(card, flush=True)
    info = kernels.build_all(extra=("measure.cu",))
    fns, parent_ptxas = build_parent(args[0])
    ptxas = cs.ptxas_report(info)
    _, fq, idx_dir, shard_root, _ = cs.make_data(shards=True)
    cl = FastClassifier(load_index(idx_dir), device="cuda")
    reads = [(r.name, r.seq, r.qual) for r in read_fastx(fq)]
    chunks = cs.first_chunks(cl, reads)
    res = dict(card=card, ptxas={k: ptxas[k] for k in NAMES},
               parent_ptxas=parent_ptxas, **{k: {} for k in NAMES})

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

    measure = info["measure.cu"]["path"]
    for W in sorted(chunks):
        cap = cs.kernel_inputs(cl, *chunks[W][:2])
        for key in KEYS:
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
            r["shape"] = cs.SHAPES[name](args) + "".join(
                f" {k}={v.numel()}" for k, v in kw.items())
            r["bound_ms"], r["bound_by"] = cs.bound(name, args, ref, **kw)
            if name == "stage1":
                r["bound_old_ms"] = cs.stage1_old_bound(args, ref)
            if name == "row_walks" and kw:
                with parent_kernels(fns, copy=False):
                    r["parent_kernel_ms"] = cs.cuda_ms(fn, 20, cold=True,
                                                       prep=prep)
            if name == "interval_search":
                r["floor"] = cs.k1_floor(measure, args, kw)
                r["parent_kernel_ms"] = cs.k1_floor(
                    measure, args, kw, fn=fns[name])["kernel_ms"]
            if name == "vote":
                r["rows_ms"] = kernel_rows_ms(fn, "vote")
                with parent_kernels(fns):
                    r["parent_rows_ms"] = kernel_rows_ms(fn, "vote")
            if name in FLOORS:
                r.update(cs.kernel_floors(measure, name, args, ref))
            res[name][f"{key} W={W}"] = r
            cs.log(f"kernel_ab: {key} W={W}: {r}")
        if W == min(chunks):
            with parent_kernels(fns):
                res["row_walks_parent_sweep"] = cs.walk_sweep(
                    info["measure.cu"]["path"], cap["row_walks"][0])
        del cap

    def path_rows(c) -> dict:
        """{CUDA function: [device ms, launches]} of PATH_NAMES' kernels
        in one profiled pure-device classify_batch of classifier c."""
        ev = cs.device_rows(lambda: c.classify_batch(reads, block=cs.BLOCK))
        return {function_name(e.key): [e.self_device_time_total / 1e3,
                                          e.count]
                for e in ev if any(k in e.key for k in PATH_NAMES)}

    # the merge (K11) on the stacked results of the bench's genome shards,
    # each chunk's as the sharded classifier's batch records them; then
    # its path profile
    scl = load_sharded_fast(shard_root, device="cuda", exact_fallback=False)
    res["shard_merge"] = merge_turns(scl, reads, fns, turns, measure)
    res["path_sharded"] = dict(current=path_rows(scl))
    with parent_kernels(fns):
        res["path_sharded"]["parent"] = path_rows(scl)
    del scl

    # pure-device reads/s of every read in pairs: parent and current, and
    # the controls, each side against itself
    cl.exact_fallback = False
    cl.classify_batch(reads, block=cs.BLOCK)
    first = cs.tup(cl.classify_batch(reads, block=cs.BLOCK))
    res["path"] = dict(current=path_rows(cl))
    with parent_kernels(fns):
        res["path"]["parent"] = path_rows(cl)
    cs.log(f"kernel_ab: path {res['path']} sharded {res['path_sharded']}")

    def pairs(a, b) -> dict:
        """reads/s of N_PAIRS pairs of three calls a side, side "a" first
        in every other pair; a side runs under parent_kernels with the
        entry points it names, or, where None, as it stands. Every
        call's results must equal the first's."""
        rates = dict(a=[], b=[])
        for side in [s for i in range(N_PAIRS)
                     for s in (("a", "b") if i % 2 == 0 else ("b", "a"))]:
            ep = dict(a=a, b=b)[side]
            with (parent_kernels(ep) if ep is not None
                  else contextlib.nullcontext()):
                for _ in range(3):
                    t0 = time.time()
                    out = cl.classify_batch(reads, block=cs.BLOCK)
                    torch.cuda.synchronize()
                    rates[side].append(len(reads) / (time.time() - t0))
                    if cs.tup(out) != first:
                        raise AssertionError("the parent's and the current "
                                             "kernels' results differ")
        return rates

    ab = pairs(fns, None)
    res["device_reads_per_s"] = dict(parent=ab["a"], current=ab["b"])
    # controls: each side against itself, and the current kernels under
    # parent_kernels (its swap and K2's copy) against the current as is
    res["device_reads_per_s_aa_parent"] = pairs(fns, fns)
    res["device_reads_per_s_aa_current"] = pairs(None, None)
    res["device_reads_per_s_harness"] = pairs(
        {n: kernels._fn(n) for n in NAMES}, None)
    cs.log("kernel_ab: pure-device reads/s " + json.dumps(
        {k: v for k, v in res.items() if k.startswith("device_reads")}))
    print("kernel_ab " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
