"""Smoke run of the torch port on one NVIDIA GPU: builds the hand CUDA
kernels, holds each against its plain torch version, drives the fast
classify path at the bench's scale, checks its calls, and says where the
card's time goes.

    python3 chip_smoke.py

The script's own process imports torch, numpy and the port, never jax,
the JAX package or bench.py (it asserts so at its end). The bench data is
made from bench.py's recipe (100 Mbp community, seed 2024; 8,192 reads of
1.2-3 kb at 10% error, seed 99; cached under build/bench_cache): building
the index is the index-build workload, which the port does not cover
yet, so a child process runs bench.prepare and writes the index in the C
reference's on-disk format. This process only reads those files, with
the port's own loader: the index's counterpart of loading a checkpoint
that the reference wrote.

Phases (any failure raises, and the script exits nonzero):
  1. the card (nvidia-smi name and power limit) and the software; nvcc
     builds the kernels and csrc/measure.cu's floors (timed, in
     parallel); stage 1's, K2's, combine's and the merge's registers,
     spills and stack from -Xptxas -v (the `ptxas` line)
  2. the bench data and its genome shards (child processes, the two
     builds at once), the port's index loader and FastClassifier on
     "cuda"; the stages run once on the first full
     chunk of the narrowest width bucket, recording each kernel's inputs
     there (its first call, and its calls through an index list: K1's
     and K2's mid and tail resumes, each from a copy of the carry, which
     the resume updates in place; compact's second cut), and each kernel
     is held
     against its plain version on them: equal exactly, both timed with
     CUDA events (median of 20, L2 flushed before each call, as the path
     finds the tables cold), beside the least time the card could take
     for the same work and, for compact, torch.nonzero on the same mask
     (stage 1 also beside the operation bound of the earlier full-build
     kernel, and beside its bloom reads alone, stage1_floor, a floor of
     csrc/measure.cu); K2 on the burst carry at each cap of
     WALK_SWEEP_CAPS, cold and warm, beside a bare pointer chase over
     the lfc table with the same gathers a lane (walk_sweep, the other
     floor of csrc/measure.cu); K1's three calls (the burst, the mid and
     the tail resume) each run in place through its C entry point beside
     dsb_occ_chase, the same lanes' occ32 gathers for the same steps and
     nothing else (k1_floor), on the first chunk of each width bucket
     (the `k1_floor` line); stage 1 on
     tests/test_torch_stage1.stage1_cases (every width bucket, lek 13-31,
     three bitmaps, every case reached); unpack, stage 1, K1's and K2's
     three calls each, compact's first call and first through a source
     list, row_grid, locate, the vote, band_windows and combine held and
     timed likewise on the first chunk of each other width bucket and on
     the W = 4096 and 8192 encodings below (check_chunk_calls; stage 1
     and K2 in the `stage1_row_walks` line); compact's, row_grid's, K1's
     and the vote's
     calls of every chunk launched back to back on one stream (their
     scratch, K1's carries in place), each equal to its plain version
     (check_back_to_back); locate on the first chunk of each width
     bucket split into its parts, each alone (the walk, the search and
     expansion from a verified guess as the kernel runs them; floors of
     csrc/measure.cu),
     with n_us, the guess's hit share and the routes of its misses
     (locate_split; the `locate_split` line);
     the vote (K7) also on the first BLOCK bench reads encoded at W = 4096
     and 8192 (the buckets of 3-8 kb reads and of long-read segments), and
     on tests/test_torch_kernels.vote_cases (on the golden index, built
     by a child process) at every width bucket up to 8192; the whole
     pipeline (build_full's [7, Bp]) of the kernels against that of the
     plain versions on those W = 4096 and 8192 encodings; the band scorer
     (K8) at every band the classifier makes: on the first chunk of each
     width bucket (W = 2048, K = 144; W = 3072, K = 208) and on the W =
     4096 and 8192 encodings (K = 272), one launch a call, timed cold
     beside the bound of its bit-plane formulation (band_ops) and the
     SWAR formulation's 25-op bound, its offset loop's SASS instructions
     a (read word, offset) (band_sass, cuobjdump), and on
     tests/test_torch_band_score.band_cases at each band, every case
     reached; then one warm classify_batch
  3. the main path: launch counts set to 0, classify_batch three times
     (end-to-end reads/s, fallback fraction), counts read, and every
     kernel must have launched (those of stages 0, 1, 3 and 4 and
     row_grid once a chunk, K1 and K2 three times, compact four); then
     three pure-device runs (reads/s) and
     the device-vs-native agreement through the port's binding of the
     native engine (gated at 0.99, bench.py's gate; truth accuracy)
  4. every read through a classifier running the plain versions
     (pure-device reads/s, three runs): FastResults identical to the
     kernel path's pure-device run; and every read through both paths at
     max_width = LONG_WIDTH, so that the reads above it take
     _classify_long: identical FastResults
  5. where the time goes: for the first full chunk of each width bucket,
     each stage's CUDA-event span (median of 10; it includes the host's
     launch gaps) beside its device time (the summed kernel rows of
     torch.profiler, per call, over 5 back-to-back calls, so L2 is warm)
     and, for stage 1, the kernel's bound, for the vote its kernel's time
     (L2 evicted) beside its bound, and stage 1's kernel cold, right
     after stage 0's kernel and warm (stage1_after_unpack: whether it
     finds unpack's codes2 in L2); every stage's and the fused chunk's
     device time, span and launches per chunk (stage 2 at most
     STAGE2_MAX_LAUNCHES, stage 3 at most STAGE3_MAX_LAUNCHES), and each
     kernel's device time in the fused chunk; then one
     pure-device classify_batch unprofiled and one under torch.profiler:
     device busy share = kernel time over the unprofiled wall, and each
     hand kernel's device time per launch as the path runs it
  6. the bit-exact validation engine (TpuClassifier, `classify --engine
     tpu`): on the golden index its SAM must equal
     tests/golden/classify.sam byte for byte; then the first N_VALIDATE
     bench reads, with the fast classifier's FM tables shared, through
     the kernels (launch counts set to 0 just before, read just after;
     each of the path's three kernels must launch; each device call timed
     from launch to sync, the rest host work) and through the plain
     versions: the two SAMs must be
     equal; reads/s of both, the engine's stats, the primary hit's
     agreement with the native engine on (ref, direction, score, pos),
     and each of the path's kernels (probe_reads, K1, row_walks_trace)
     held against its plain version on its first call, timed with L2
     evicted, beside its bound
  7. the genome-sharded classifier (engine/sharded_fast): the community
     split into N_SHARDS genome shards by a child process (the JAX
     package's build_sharded_index, timed; it runs in phase 2 beside the
     index build, before any measurement), loaded on the card; the merge
     kernel (K11) against its plain version on each chunk's stacked shard
     results, timed on the first with L2 evicted beside its bound; K1's
     three calls and the vote on each shard's first chunk held to their
     plain versions and timed (check_chunk_calls); launch
     counts set to 0 just before a pure-device classify_batch and read
     just after (each stage kernel N_SHARDS times a chunk, the merge
     once); pure-device and exact-replay reads/s (median of N_RATE_CALLS
     with the spread; the pure-device calls in turns with the monolithic
     classifier's) and the fallback fraction; the sharded kernel path
     identical to the sharded plain path on every read; agreement with
     the native engine (gated at 0.99), the reads called otherwise than by
     the monolithic classifier, truth accuracy; each stage's device time
     on the first chunk, shard by shard, and the batch's device time;
     locate on each shard's first chunk split as in phase 2
  8. the data-parallel classifier (parallel/, FastClassifier(mesh=...)):
     the taxon-weight kernel (K13; these checks run after phase 4, where
     torch.profiler still sees every kernel) against its plain version,
     exactly, on
     tests/test_torch_taxon.taxon_cases, on the tids of phase 3's results
     (max_tid = the largest + 2) and at NCBI's 2^22 taxids, one launch a
     call, timed with L2 evicted beside its bound and index_add_, its
     torch.profiler rows beside those of zeros + index_add_ (one kernel
     row and no memset), and at 2^22 on 2^17 and 2^19 pairs, hot and
     spread over the bins; K13's time on the mesh path (path_ms: CUDA
     events around its call in the taxon step); one rank over NCCL (a
     process group of this process alone) on phase 3's tables: the raw
     [7, Bp] of each first chunk equal to one device's, launch counts set
     to 0 just before a pure-device classify_batch and the taxon step and
     read just after (every fast-path kernel and K13 must launch), the
     results equal to phase 3's pure-device ones on every read, the
     weights equal to a host bincount of the tids; the mesh path's and
     the one-device path's pure-device reads/s in turns; then two ranks
     over gloo on this one card (parallel.dryrun on the golden index, in
     child processes), each of which must launch the kernels
After phase 7 it prints the `ranking` line: RANKED (stage 0's and stage
4's kernels outside the band scorer, and the merge) by launches a batch x
(cold ms - bound ms), the weight by which the kernel redesigns are
chosen, each with the share of its bound it reaches; combine and the
merge also with their floors at their grid (kernel_floors, of
csrc/measure.cu: launch_floor_ms, an empty kernel; one_round_ms, one
round of independent loads of the call's input bytes and one of stores
of its output bytes), taken on phase 2's first chunk and phase 7's.
Prints a `kernels` JSON line (the fast path's eleven kernels, the
validation engine's two, the sharded path's merge, then the data-parallel
path's taxon weights; K1's row also carries its validation-path call, the
vote's its checks at the other widths and on vote_cases), then
{"ok": true, "device": {...}} last.
Exits nonzero without a result when no CUDA device is visible or when
run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "bench_cache")
SCALE_BP = 100e6      # bench.py's community size
N_READS = 8192        # bench.py's read count
BLOCK = 4096          # bench.py's chunk size
AGREE_MIN = 0.99      # bench.py's accuracy gate
# NVIDIA H100 SXM peaks (datasheet): HBM bytes a
# second; int32 operations a second, a quarter of the 67 TFLOP/s float32
# rate, which counts an FMA as two on 128 lanes an SM where int32 has 64
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
SECTOR = 32           # bytes a random device-memory read moves at least
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: written to evict it
HIDE_HOST_CYCLES = 400_000  # ~0.2 ms of spin before a cold call's events
STAGE2_MAX_LAUNCHES = 46  # kernels a chunk of stage 2 on the kernel path
STAGE3_MAX_LAUNCHES = 3   # and of stage 3 (locate, then the vote's two)
N_SHARDS = 2          # phase 7's genome shards (SHARDED_r05.json's count)
N_RATE_CALLS = 3      # calls each of phase 7's rates is the median of
GOLDEN = os.path.join(ROOT, "tests", "golden")
GOLDEN_IDX = os.path.join(ROOT, "build", "golden_idx")
N_VALIDATE = 768      # bench reads through the validation engine (phase 6)
VOTE_WIDTHS = (4096, 8192)  # the vote's bench-read checks besides W = 2048
VOTE_CASE_ROWS = 101  # read rows of each vote_cases check
LONG_WIDTH = 2048     # phase 4's max_width: longer reads take _classify_long
NCBI_MAX_TID = 1 << 22  # phase 8: NCBI taxonomy ids fit below 2^22
BAND_RUN = 8          # csrc/band_score.cu kRun: plane words of one offset step
PHASE8_BUDGET_S = 60  # phase 8's share of the smoke's time
# the CUDA functions each fast-path kernel's wrapper launches (its
# profiler rows), once each a call
GLOBAL = {
    "unpack": ("unpack_kernel",),
    "stage1": ("stage1_kernel",),
    "interval_search": ("interval_search_kernel",),
    "compact": ("compact_kernel",),
    "row_grid": ("row_grid_kernel",),
    "row_walks": ("row_walks_kernel",),
    "locate": ("locate_kernel",),
    "vote": ("vote_kernel", "vote_map_kernel"),
    "band_windows": ("band_windows_kernel",),
    "band_score_packed": ("band_score_kernel",),
    "combine": ("combine_kernel",),
}
FAST_KERNELS = tuple(GLOBAL)
# and of the sharded path's merge
HAND_FUNCS = {**GLOBAL, "shard_merge": ("shard_merge_kernel",)}
# the calls through an index list that stage 2 makes, each held against
# its plain version besides its kernel's first call
INDEX_LIST_CALLS = ("interval_search[sel]", "interval_search[sel]#2",
                    "row_walks[sel]", "row_walks[sel]#2", "compact[src]")
# kernels whose every call a chunk is captured and checked (K1 and K2:
# the burst, then the mid and the tail resume); "name[sel]#2" is the
# second call through an index list
EVERY_CALL = ("interval_search", "row_walks")
# K1's calls of a chunk: the burst over all S lanes, then the mid and the
# tail resume through their index lists
K1_CALLS = ("interval_search", "interval_search[sel]",
            "interval_search[sel]#2")
# the caps of the K2 sweep on the burst carry (0 and 2 fix the intercept,
# 12 and 32 the slope), and the argument of a resume that it updates in
# place (K1's carry, args[6]; K2's, args[4])
WALK_SWEEP_CAPS = (0, 2, 12, 32)
IN_PLACE = {"interval_search": 6, "row_walks": 4}
REPLACES = {
    "unpack": "desamba_tpu/engine/fast_engine.py:141",
    "stage1": "desamba_tpu/engine/fast_engine.py:203",
    "interval_search": "desamba_tpu/ops/fm.py:165",
    "compact": "desamba_tpu/engine/fast_engine.py:242",
    "row_grid": "desamba_tpu/engine/fast_engine.py:288",
    "row_walks": "desamba_tpu/ops/fm.py:261",
    "locate": "desamba_tpu/ops/locate.py:59",
    "vote": "desamba_tpu/engine/fast_engine.py:363",
    "band_windows": "desamba_tpu/engine/fast_engine.py:420",
    "band_score_packed": "desamba_tpu/ops/matchblock.py:201",
    "combine": "desamba_tpu/engine/fast_engine.py:452",
    "probe_reads": "desamba_tpu/ops/ekmer.py:215",
    "row_walks_trace": "desamba_tpu/ops/fm.py:262",
    "shard_merge": "desamba_tpu/engine/sharded_fast.py:260",
    "taxon_weights": "desamba_tpu/parallel/collectives.py:18",
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if p.returncode != 0 or not p.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def software() -> dict:
    import torch

    from desamba_tpu_torch import kernels

    try:
        import triton

        tri = triton.__version__
    except ImportError:
        tri = "not installed"
    try:
        nvcc = kernels._nvcc()
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        nvcc = f"{nvcc} ({ver.splitlines()[-1] if ver else '?'})"
    except RuntimeError:
        nvcc = "not found"
    return dict(python=sys.version.split()[0], torch=torch.__version__,
                cuda=torch.version.cuda, triton=tri, nvcc=nvcc)


def tup(rs) -> list:
    """(name, ref_ID, direction, score, read_len, pos) of each FastResult."""
    return [(r.name, r.ref_ID, r.direction, r.score, r.read_len, r.pos)
            for r in rs]


def max_abs_err(x, y) -> int:
    import torch

    if isinstance(x, tuple):
        return max(max_abs_err(a, b) for a, b in zip(x, y, strict=True))
    if isinstance(x, dict):
        if set(x) != set(y):
            raise AssertionError(f"outputs {sorted(x)} vs {sorted(y)}")
        return max(max_abs_err(x[k], y[k]) for k in x)
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{x.shape} {x.dtype} vs {y.shape} {y.dtype}")
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def cuda_ms(fn, n: int = 10, cold: bool = False, prep=None) -> float:
    """Median ms of n calls of fn, CUDA events around each (after one
    untimed call); cold: L2 evicted before each call, outside the events,
    and the card then kept busy ~0.2 ms (torch.cuda._sleep) so that fn's
    launches are queued before the first event fires and the host's time
    to them (40-80 µs a wrapper call) is not counted; warm (spans), the
    host's launch gaps are counted; prep: run before each call, outside
    the events (a call that updates its input in place gets a fresh copy
    there)."""
    import statistics

    import torch

    if prep is not None:
        prep()
    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda") if cold else None
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        if prep is not None:
            prep()
        if cold:
            flush.zero_()
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def device_rows(fn):
    """Run fn once under torch.profiler; returns its CUDA kernel rows
    (memcpy and memset included). An operator's own row repeats its
    kernels' time, so only kernel rows are summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(fn, n: int = 5, by_kernel: bool = False):
    """(device ms per call, kernels per call) of fn over n profiled calls;
    by_kernel: also {fast-path kernel: its CUDA functions' device ms a
    call} (GLOBAL)."""
    fn()

    def calls():
        for _ in range(n):
            fn()

    ev = device_rows(calls)
    out = (sum(e.self_device_time_total for e in ev) / 1e3 / n,
           sum(e.count for e in ev) / n)
    if not by_kernel:
        return out
    return (*out, {k: sum(e.self_device_time_total for e in ev
                          if any(g in e.key for g in fs)) / 1e3 / n
                   for k, fs in GLOBAL.items()})


def checked_device_ms(fn, n: int = 5, tries: int = 3) -> dict:
    """fn's device time a call over n profiled calls (the summed kernel
    rows of torch.profiler) and its kernels a call, beside the hand
    kernels its wrappers launched in one call (kernels.launches, each
    launch's CUDA functions in HAND_FUNCS) and those the profiler saw.
    Late in the smoke the profiler has missed some: such a profile is
    taken again, up to `tries` in all, and device_ms is None where the
    last still saw fewer, since its sum then misses their time."""
    from desamba_tpu_torch import kernels

    before = dict(kernels.launches)
    fn()
    hand = sum((kernels.launches[k] - before[k]) * len(HAND_FUNCS.get(k, ()))
               for k in before)
    for _ in range(tries):
        ev = device_rows(lambda: [fn() for _ in range(n)])
        seen = sum(e.count for e in ev if any(
            g in e.key for fs in HAND_FUNCS.values() for g in fs)) / n
        if seen >= hand:
            break
    ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    return dict(device_ms=ms if seen >= hand else None,
                kernels_per_call=sum(e.count for e in ev) / n,
                hand_kernels_launched=hand, hand_kernels_seen=seen,
                rows=ev)


def first_chunks(cl, reads) -> dict:
    """{W: (packed, lens, n_reads)}: the first full chunk of each width
    bucket, encoded as classify_batch encodes it."""
    from desamba_tpu_torch.constants import _bucket

    by_w: dict = {}
    for r in reads:
        by_w.setdefault(_bucket(max(len(r[1]), cl.ek.lek + 2)), []).append(r)
    out = {}
    for W in sorted(by_w):
        chunk = by_w[W][:BLOCK]
        packed, lens, _ = cl._encode(chunk, W=W, Bp=BLOCK)
        out[W] = (packed, lens, len(chunk))
    return out


def stage_calls(cl, packed, lens, ops):
    """Run stages 0-4 once on an encoded chunk. Returns ({stage: fn},
    (stage 1's kernel arguments, its output)): each fn calls one stage on
    the saved output of the stage before it, "fused" the whole
    pipeline."""
    import torch

    from desamba_tpu_torch.constants import ROWS_PER_SEARCH, _band
    from desamba_tpu_torch.engine import fast_engine as tfe

    ek = cl.ek
    s1, s2, s3, s4 = tfe.build_stages(ek.lek, ek.single_base_max,
                                      ek.mask_bits, 20, ek.n_words0, ops)
    s0 = ops["unpack"]
    p = torch.from_numpy(packed).to(cl.device)
    ln = torch.from_numpy(lens).to(cl.device)
    codes2, ci, rw, l2 = s0(p, ln)
    o1 = s1(ek.w01, codes2, l2)
    o2 = s2(cl.fm, ci, l2, *o1[:3])
    B2, W = codes2.shape
    nwR = o1[1].shape[1] * ROWS_PER_SEARCH
    o3 = s3(cl.fm, cl.loc, l2, *o2, B2=B2, nwR=nwR)
    K = 2 * _band(W) + 16
    s4(cl.ra, rw, l2, *o3, B2=B2, K=K)
    fns = {
        "0 unpack": lambda: s0(p, ln),
        "1 probe+seeds": lambda: s1(ek.w01, codes2, l2),
        "2 FM search+walks": lambda: s2(cl.fm, ci, l2, *o1[:3]),
        "3 locate+vote": lambda: s3(cl.fm, cl.loc, l2, *o2, B2=B2, nwR=nwR),
        "4 band rescore": lambda: s4(cl.ra, rw, l2, *o3, B2=B2, K=K),
        "fused": lambda: cl._full(cl.fm, cl.loc, cl.ra, ek.w01, p, ln),
    }
    s1_io = ((ek.w01, codes2, l2, ek.lek, ek.single_base_max, ek.mask_bits,
              ek.n_words0), o1)
    return fns, s1_io


def kernel_inputs(cl, packed, lens) -> dict:
    """{kernel: (args, keyword args) of its first call} when the stages
    run on a chunk; "kernel[sel]" / "kernel[src]" for the first call
    through an index list."""
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    cap: dict = {}
    stage_calls(cl, packed, lens,
                {k: recording(cap, k, f) for k, f in KERNEL_OPS.items()})
    return cap


def recording(cap: dict, name: str, fn, every=EVERY_CALL):
    """fn, recording (args, keyword args) of its first call into cap, under
    name, or "name[kw,...]" for a call with keyword arguments; of a kernel
    in `every` every call, the second of a key as "key#2". A resume
    that updates its carry in place (IN_PLACE) is recorded with a copy of
    the carry as the call found it."""
    def call(*args, **kw):
        key = f"{name}[{','.join(kw)}]" if kw else name
        if name in every and key in cap:
            key += f"#{sum(k.split('#')[0] == key for k in cap) + 1}"
        if key not in cap:
            saved = list(args)
            if kw and name in IN_PLACE:
                saved[IN_PLACE[name]] = saved[IN_PLACE[name]].clone()
            cap[key] = (tuple(saved), kw)
        return fn(*args, **kw)
    return call


def in_place_call(name: str, kern, args, kw):
    """(fn, prep) that time kern on args: for a resume that updates its
    carry in place, fn runs on a copy of the carry that prep refreshes
    (outside the timed events), so every call starts from the captured
    carry."""
    if not (kw and name in IN_PLACE):
        return (lambda: kern(*args, **kw)), None
    i = IN_PLACE[name]
    work = args[i].clone()
    a = (*args[:i], work, *args[i + 1:])
    return (lambda: kern(*a, **kw)), (lambda: work.copy_(args[i]))


def work(name: str, args, out, sel=None, src=None) -> tuple[int, int]:
    """(bytes, int32 operations) the kernel's function needs on these
    inputs: each streamed input read once and each output written once,
    plus 32-byte sectors of the tables this run's data reads (counted
    from the inputs and outputs); sel / src: the index list of a resume /
    of compact's second cut."""
    import torch

    if name == "stage1":
        return stage1_work(args, out)
    if name == "probe_reads":
        from desamba_tpu_torch.ops.ekmer import _probe_addrs

        ek, codes, lengths = args
        want, *addrs = _probe_addrs(codes, lengths, ek.lek,
                                   ek.single_base_max, ek.mask_bits)
        return (nbytes(codes, lengths, out)
                + SECTOR * bloom_sectors(ek.w01, ek.n_words0, want, *addrs),
                out.numel() * (4 * ek.lek + 70))
    if name == "row_walks_trace":
        fm, codes, lanes, rows, ptrs, max_lens = args
        # an LF read (one sector) and a read code a step, and one more read
        # where a lane stopped; the lanes' inputs in, the trace and the
        # result rows out once
        reads = int(out["steps"].sum(dtype=torch.int64)
                    + (1 - out["overflow"]).sum(dtype=torch.int64))
        return (nbytes(lanes, rows, ptrs, max_lens, *out.values())
                + reads * (SECTOR + 4), reads * 20)
    if name == "interval_search":
        fm, codes, lanes, max_rst, l_min, l_max, state, _ = args
        steps = int((state[5] - out[5]).sum(dtype=torch.int64))
        # two occ words (one sector each) and a read code a step; the
        # carry in and out; through an index list (a resume in place), the
        # listed lanes' parameters and carry, each distinct sector once
        carry = ((state, out) if sel is None
                 else (*state.unbind(0), *out.unbind(0)))
        return (per_lane_bytes(sel, lanes, max_rst, l_min, l_max, *carry)
                + steps * (2 * SECTOR + 4), steps * 40)
    if name == "row_walks":
        fm, codes, lanes, max_lens, state, _ = args
        reads = int((out[2] - state[2]).sum(dtype=torch.int64)
                    + (out[3] & ~state[3]).sum(dtype=torch.int64))
        return (per_lane_bytes(sel, lanes, max_lens) + nbytes(state, out)
                + reads * (SECTOR + 4), reads * 20)
    if name == "compact":
        done, cap = args
        # the done row (or the list and each distinct done sector it
        # names) in, the slots out; ~10 operations an entry (compare,
        # ballot, popc, the prefix, the cap test, the store)
        if src is None:
            return nbytes(done, out), 10 * done.numel()
        ok = (src >= 0) & (src < done.numel())
        return (nbytes(src, out) + SECTOR * distinct_sectors(src[ok]),
                10 * src.numel())
    if name == "row_grid":
        from desamba_tpu_torch.constants import ROWS_PER_SEARCH as R

        state, seed_ok, lane, s_idx, cap = args
        # nsp, nep and seed_ok of every lane in; match_len, ptr, lane and
        # s_idx of the lanes that fill a slot (each distinct sector once);
        # the three outputs out; ~10 operations an entry of the S x R
        # grid and ~20 a slot
        S = state.shape[1]
        lanes = out[0].clamp(max=S * R - 1) // R
        return (nbytes(state[2], state[3], seed_ok, *out)
                + 4 * SECTOR * distinct_sectors(lanes),
                10 * S * R + 20 * cap)
    if name == "shard_merge":
        res, maps, map_off, _ = args
        # the stacked results and the maps in, the merged rows out; ~25
        # operations a (shard, read) over the three passes (the remap's
        # compare, clip and load, the maxima and the tie tests) and ~10 a
        # read for the picks
        return (nbytes(res, maps, map_off, out),
                25 * res.shape[0] * res.shape[2] + 10 * res.shape[2])
    if name == "locate":
        return locate_work(*args, out)
    if name == "vote":
        return vote_work(*args)
    if name == "unpack":
        # a few operations a code: shift, mask, and the stores
        return nbytes(*args, *out), out[0].numel() * 3
    if name == "band_windows":
        return band_windows_work(*args, out)
    if name == "combine":
        ra, score, q_st, q_ed, ref_c, diag_c = args
        # ~30 int32 operations a candidate over the combine's passes (index,
        # mask, compare, select), ~20 a read for its outputs
        return (nbytes(score, q_st, q_ed, ref_c, diag_c, out)
                + SECTOR * distinct_sectors(
                    out[1].clamp(0, ra.ref_offset.shape[0] - 1)),
                ref_c.numel() * 30 + out.shape[1] * 20)
    read_w, rlen, win_w, rel_lo, rel_hi, K = args
    return (nbytes(read_w, rlen, win_w, rel_lo, rel_hi, *out.values()),
            band_ops(read_w, rlen, rel_lo, rel_hi, K))


def stage1_work(args, out, rolled: bool = True) -> tuple[int, int]:
    """work("stage1"): the codes and lengths in and the outputs out once,
    the distinct bitmap sectors the probes need (bloom_sectors), and
    stage1_ops with this run's probed points."""
    from desamba_tpu_torch.constants import STEP_EK
    from desamba_tpu_torch.ops.ekmer import _probe_addrs

    w01, codes2, l2, lek, sbm, mb, nw0 = args
    want, *addrs = _probe_addrs(codes2, l2, lek, sbm, mb, stride=STEP_EK)
    return (nbytes(codes2, l2, *out)
            + SECTOR * bloom_sectors(w01, nw0, want, *addrs),
            stage1_ops(*out[0].shape, lek, int(want.sum()), rolled))


def stage1_ops(B2: int, n_g: int, lek: int, probed: int,
               rolled: bool = True) -> int:
    """int32 operations of stage 1 on B2 rows of n_g grid points, of which
    `probed` pass the gate (the filter, k != 0 and p + lek <= len): ~10 a
    point for the gate and the prefix, ~60 a probed point for the two
    64-bit hashes, the bitmap addresses and the bit tests, plus the k-mer
    and its base counts. The full build (the earlier kernel's, rolled=
    False) takes ~4 a code, 4 * lek a point. The rolled formulation
    (csrc/stage1.cu) builds a lane's first point in full (4 * lek), then
    takes 23 a point: for each of the STEP_EK = 3 codes that enter, a
    64-bit shift-or (3) and its count added and the leaving code's taken
    off (4), and the mask to 2 * lek bits (2). A row's points go in runs
    of ceil(n_g / 32), one a lane."""
    grid = B2 * n_g
    gate = grid * 10 + probed * 60
    if not rolled:
        return gate + grid * 4 * lek
    per = -(-n_g // 32)
    runs = B2 * -(-n_g // per)
    return gate + (grid - runs) * 23 + runs * 4 * lek


def band_ops(read_w, rlen, rel_lo, rel_hi, K: int) -> int:
    """int32 operations of the band scorer's bit-plane formulation
    (csrc/band_score.cu) on these rows: per (row, 32-code read word, band
    offset k) that the data needs, 11 = 2 funnel shifts of the window
    planes + 2 LOP3s for the match word e (the read-valid mask folded in)
    + 4 funnel shifts and 3 LOP3s for the 9-run test by tripling and the
    OR into acc; plus 2 (a funnel shift of the window's valid plane, a
    LOP3) for a word whose codes do not all meet valid window codes at k.
    That is 5.5 a (row, 16-code read word, band offset) where no mask
    bites (the SWAR formulation of PRs 2-18 counted ~25). A word is
    needed at k when one of its positions q < rlen has q + k in [rel_lo,
    rel_hi); other words are zero and cost nothing (the kernel's own
    overheads, the halo word of each run, the loop and the staging, are
    not counted)."""
    import torch

    W = 16 * read_w.shape[1]
    k = torch.arange(K, device=read_w.device, dtype=torch.int64)[None, :]
    rl = rlen.to(torch.int64).clamp(0, W)[:, None]
    a = (rel_lo.to(torch.int64)[:, None] - k).clamp(min=0)  # [B, K]
    b = torch.minimum(rel_hi.to(torch.int64)[:, None] - k, rl)
    live = b > a
    w_lo = a // 32
    w_hi = torch.where(live, (b + 31) // 32, w_lo)
    # fully valid words: 32 w >= rel_lo - k and 32 w + 32 <= rel_hi - k
    f_lo = torch.maximum(w_lo, (rel_lo.to(torch.int64)[:, None] - k + 31)
                         .div(32, rounding_mode="floor"))
    f_hi = torch.minimum(w_hi, (rel_hi.to(torch.int64)[:, None] - k)
                         .div(32, rounding_mode="floor"))
    n_words = (w_hi - w_lo).clamp(min=0)
    n_full = (f_hi - f_lo).clamp(min=0)
    return int((11 * n_words + 2 * (n_words - n_full)).sum())


def band_ops_swar(read_w, K: int) -> int:
    """The bound's operation count of PRs 2-18, kept for comparison:
    ~25 int32 operations per (row, read word, band offset), the SWAR
    compare, masks and the 9-code run test of the JAX formulation."""
    return read_w.numel() * K * 25


def sass_loops(lib: str, func: str) -> list:
    """The innermost loops of a CUDA function's SASS (cuobjdump -sass
    of the library): for each, its instructions, the shortest path in
    instructions from its head through its back branch (one iteration
    that takes no side branch) and that path's opcodes. [] when the
    toolkit has no cuobjdump."""
    import re
    import shutil as sh

    tool = sh.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120).stdout
    body, keep = [], False
    for ln in txt.splitlines():
        if "Function :" in ln:
            keep = func in ln
            continue
        if keep:
            body.append(ln)
    ins, labels, pend = [], {}, []
    for ln in body:
        m = re.match(r"\s*(\.L\w+):", ln)
        if m:
            pend.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            addr = int(m.group(1), 16)
            for lab in pend:
                labels[lab] = addr
            pend = []
            text = m.group(2).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            ins.append((addr, op, text))
    addrs = [a for a, _, _ in ins]

    def target(text):
        m = re.search(r"`\((\.L\w+)\)", text)
        if m:
            return labels.get(m.group(1))
        m = re.search(r"BRA\s+(0x[0-9a-f]+)", text)
        return int(m.group(1), 16) if m else None

    back = [(target(t), a) for a, op, t in ins if op.startswith("BRA")
            and target(t) is not None and target(t) <= a]
    inner = [(t, a) for t, a in back if not any(
        (t2, a2) != (t, a) and t <= t2 and a2 <= a for t2, a2 in back)]
    out = []
    for t, a in inner:
        lo, hi = addrs.index(t), addrs.index(a)
        seg = ins[lo : hi + 1]
        # shortest path over the loop's instructions (breadth first): a
        # step to the next instruction (unless after an unconditional
        # branch) or to a branch's target inside the loop
        prev = {0: None}
        queue = [0]
        for i in queue:
            if i == len(seg) - 1:
                break
            _, op, text = seg[i]
            nxt = []
            if not ((op.startswith("BRA") and not text.startswith("@"))
                    or op == "EXIT"):
                nxt.append(i + 1)
            tg = target(text) if op.startswith("BRA") else None
            if tg is not None and t < tg <= a:
                nxt.append(addrs.index(tg) - lo)
            for j in nxt:
                if j not in prev:
                    prev[j] = i
                    queue.append(j)
        path, i = [], len(seg) - 1 if len(seg) - 1 in prev else None
        while i is not None:
            path.append(seg[i][1].split(".")[0])
            i = prev[i]
        hist = lambda ops: {k: ops.count(k) for k in sorted(set(ops))}
        out.append(dict(start=hex(t), end=hex(a), instructions=len(seg),
                        shortest_iteration=len(path), opcodes=hist(path)))
    return out


def band_sass(lib: str) -> dict:
    """The band scorer's offset loops in SASS: the innermost loops of
    band_score_kernel whose one iteration holds an offset step (at least
    4 funnel shifts a plane word of a run of BAND_RUN); the one with the
    fewest instructions is the unmasked step, the other the masked. One
    shortest iteration is one band offset over BAND_RUN 32-code plane
    words and the halo; per (32-code word, offset) and per (16-code read
    word, offset). "not measured" without cuobjdump."""
    loops = [d for d in sass_loops(lib, "band_score_kernel")
             if d["opcodes"].get("SHF", 0) >= 4 * BAND_RUN]
    if not loops:
        return dict(per_read_word_offset="not measured")
    fast = min(loops, key=lambda d: d["shortest_iteration"])
    slow = max(loops, key=lambda d: d["shortest_iteration"])
    n = fast["shortest_iteration"]
    return dict(per_read_word_offset=n / (2 * BAND_RUN),
                per_plane_word_offset=n / BAND_RUN,
                masked_per_read_word_offset=slow["shortest_iteration"]
                / (2 * BAND_RUN), unmasked_loop=fast, masked_loop=slow)


def bloom_sectors(w01, nw0: int, want, addr1, addr2) -> int:
    """The distinct bitmap sectors the probes need, each moved once (a
    sector read again can come from L2): bitmap 1 at every point that
    passes the filter and lies in the read (want), bitmap 2 only where
    bitmap 1's bit is set; addr1, addr2: each point's (word index, bit
    shift) in the two bitmaps, as _probe_addrs gives them."""
    import torch

    m = want.reshape(-1)
    wi1, sh1 = addr1[0][m], addr1[1][m]
    set1 = ((w01[wi1].to(torch.int64) >> sh1) & 1).bool()
    return distinct_sectors(wi1, addr2[0][m][set1] + nw0)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def per_lane_bytes(sel, *per_lane) -> int:
    """Bytes of a loop's per-lane parameters: whole, or through sel each
    distinct sector of the listed lanes once."""
    if sel is None:
        return nbytes(*per_lane)
    n = per_lane[0].numel()
    return nbytes(sel) + len(per_lane) * SECTOR * distinct_sectors(
        sel[(sel >= 0) & (sel < n)])


def distinct_sectors(*idx) -> int:
    """Distinct 32-byte sectors that gathers of 4-byte elements at these
    indices touch."""
    import torch

    return torch.unique(torch.cat([i.reshape(-1).to(torch.int64)
                                   for i in idx]) // (SECTOR // 4)).numel()


def band_windows_work(ra, read_w2, lengths2, ref_c, diag_c, K,
                      out) -> tuple[int, int]:
    """(bytes, int32 operations) of the candidate-window gather: its
    tensor inputs read once and its five outputs written once, plus each
    distinct sector of ref_words_lsb that the windows read and of
    ref_offset and ref_len that the bounds read, once (a sector that
    windows share can come from L2). Operations: ~3 a word written, ~20 a
    candidate."""
    import torch

    band = (K - 16) // 2
    nw = out[2].shape[1]
    g0a = (diag_c.reshape(-1) - band) & ~15
    widx = ((g0a >> 4)[:, None] + torch.arange(
        nw, dtype=torch.int32, device=g0a.device)).clamp(
        0, ra.ref_words_lsb.shape[0] - 1)
    rc0 = ref_c.clamp(0, ra.ref_offset.shape[0] - 1)
    return (nbytes(read_w2, lengths2, ref_c, diag_c, *out)
            + SECTOR * (distinct_sectors(widx) + 2 * distinct_sectors(rc0)),
            3 * (out[0].numel() + out[2].numel()) + 20 * ref_c.numel())


def locate_guess(fm, loc, rows, valid, P) -> dict:
    """csrc/locate.cu's search on these lanes, by its numpy model
    (tests/test_torch_locate.tail_model) from the plain walk's rows,
    steps and ok: the model's dict (outputs, routes, probes), on the
    CPU."""
    from desamba_tpu_torch.ops.locate import resolve_rows

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_locate import model_tables, tail_model

    res = resolve_rows(fm, loc, rows, valid)
    return tail_model(model_tables(fm, loc, lfc=False),
                      res["row"].cpu().numpy(), res["steps"].cpu().numpy(),
                      res["ok"].cpu().numpy(), P)


def locate_work(fm, loc, rows, valid, P, out) -> tuple[int, int]:
    """(bytes, int32 operations) of resolve_rows then expand_refpos on
    these lanes. Bytes: the lanes in and the [n, P] outputs out once; one
    sector for each LF step taken (and for the step that met a sentinel)
    from each distinct start row, as lanes that start on one row walk the
    same chain and a walk's rows are random; and each distinct sector of
    the other tables once, since a sector read again, by another lane or
    by a deeper level of the same search, can come from L2: the sample
    pair (sa_uni, sa_off), the uni_start sectors the search reads, the
    reflist pairs and the P occurrences in refpos_global and
    refpos_refid. The search as csrc/locate.cu runs it (locate_guess): the
    start and next start of the unitig the sample names, its reflist
    pair, and, where the guess fails, the fallback's probes and the found
    unitig's start and reflist pair. Operations: ~20 a step, ~6 a search
    probe, ~40 a lane and ~10 an output slot."""
    import numpy as np
    import torch

    from desamba_tpu_torch.ops.locate import resolve_rows

    res = resolve_rows(fm, loc, rows, valid)
    # LF reads a lane makes: its steps, and one more where it met a
    # sentinel (not ok in under max_lf + 1 = 25 steps); counted once per
    # distinct valid start row
    reads = res["steps"] + (~res["ok"] & (res["steps"] < 25)).to(
        res["steps"].dtype)
    starts, first = torch.unique(rows[valid], return_inverse=True)
    steps = int(torch.zeros_like(starts).scatter_(
        0, first, reads[valid].to(starts.dtype)).sum(dtype=torch.int64))
    s = (res["row"] >> 3).clamp(0, fm.sa_uni.shape[0] - 1)
    us, p = loc.uni_start, res["pos"]
    n_us, n_rl = us.shape[0], loc.reflist.shape[0]
    u = res["uni"].to(torch.int64)
    m = locate_guess(fm, loc, rows, valid, P)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.int64)).to(rows.device)
    uni0, again = t(m["uni0"]), t(m["again"]).bool()
    us_idx = [uni0, (uni0 + 1).clamp(max=n_us - 1), t(m["probed"]),
              u[again]]
    rl_u = torch.cat([uni0.clamp(max=loc.uni_len.shape[0] - 1), u[again]])
    n_probes = int(m["probes"].sum()) + 2 * rows.numel()
    rp_s = loc.reflist[u.clamp(0, n_rl - 1)].to(torch.int64)
    rp_c = (rp_s[:, None] + torch.arange(P, device=u.device)).clamp(
        0, loc.refpos_global.shape[0] - 1)
    return (nbytes(rows, valid, *out) + SECTOR * (
                steps + 2 * distinct_sectors(s) + distinct_sectors(*us_idx)
                + distinct_sectors(rl_u.clamp(0, n_rl - 1),
                                   (rl_u + 1).clamp(0, n_rl - 1))
                + 2 * distinct_sectors(rp_c)),
            20 * steps + 6 * n_probes + rows.numel() * (40 + 10 * P))


def locate_split(lib: str, args, label: str) -> dict:
    """K6 on a captured call (args: fm, loc, rows, valid, P) split into its
    parts, each alone (csrc/measure.cu, library lib), cold ms (L2
    evicted, median of 20): the walk on the lanes' own rows
    (dsb_locate_walk) beside a bare pointer chase over lfc with the same
    gathers a lane (dsb_lf_chase: its steps, and one more where it met a
    sentinel), the search and expansion from the walk's rows, steps and
    ok as the path's kernel runs them (verified guess), and the path's
    kernel (the whole). The walk's outputs must equal
    resolve_rows', every part's outputs locate_plain's, and the path's
    kernel the numpy model's, or the run fails. Also n_us, the guess's
    hit share (of all lanes, of the ok ones, of the valid failed ones),
    the routes of the lanes it missed, the warps that run a search round
    and the most rounds a warp runs (locate_guess)."""
    import ctypes

    import numpy as np
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS
    from desamba_tpu_torch.ops.locate import locate_plain, resolve_rows

    fm, loc, rows, valid, P = args
    n = rows.numel()
    dev = rows.device
    dll = ctypes.CDLL(lib)
    Pt, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tab_types = kernels.KERNELS["locate"][2][:14]
    tabs = (kernels.ptr(fm.lfc), fm.lfc.shape[0], fm.pad.shape[0],
            kernels.ptr(fm.sa_uni), kernels.ptr(fm.sa_off),
            fm.sa_uni.shape[0], kernels.ptr(loc.uni_start),
            loc.uni_start.shape[0], loc.uni_len.shape[0],
            kernels.ptr(loc.reflist), loc.reflist.numel(),
            kernels.ptr(loc.refpos_global), kernels.ptr(loc.refpos_refid),
            loc.refpos_global.shape[0])

    def entry(name, more):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = tab_types + more, ctypes.c_int
        return lambda *a: _rc(name, fn(*tabs, *a, kernels.stream(dev)))

    walk_fn = entry("dsb_locate_walk", [Pt, Pt, LL, I, Pt, Pt, Pt, Pt])
    tail_fn = entry("dsb_locate_tail", [Pt, Pt, Pt, LL, I, Pt, Pt, Pt, Pt])
    chase = dll.dsb_lf_chase
    chase.argtypes = [Pt, LL, Pt, Pt, LL, Pt, Pt]
    chase.restype = ctypes.c_int
    res = resolve_rows(fm, loc, rows, valid)
    loads = (res["steps"] + (valid & ~res["ok"] & (res["steps"] < 25))).to(
        torch.int32).contiguous()
    sink = torch.empty_like(rows)
    r, k = torch.empty_like(rows), torch.empty_like(rows)
    ok = torch.empty_like(valid)
    tail = (torch.empty((n, P), dtype=torch.int32, device=dev),
            torch.empty((n, P), dtype=torch.int32, device=dev),
            torch.empty((n, P), dtype=torch.bool, device=dev))
    p = kernels.ptr
    runs = dict(
        walk=lambda: walk_fn(p(rows), p(valid), n, 24, p(r), p(k), p(ok)),
        tail=lambda: tail_fn(p(r), p(k), p(ok), n, P, *map(p, tail)),
        whole=lambda: KERNEL_OPS["locate"](*args),
        walk_chase=lambda: _rc("dsb_lf_chase", chase(
            p(fm.lfc), fm.lfc.shape[0], p(rows), p(loads), n, p(sink),
            kernels.stream(dev))))
    runs["walk"]()
    whole = runs["whole"]()
    runs["tail"]()
    ref = locate_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(r, res["row"]) and torch.equal(k, res["steps"])
            and torch.equal(ok, res["ok"])):
        raise AssertionError(f"locate split at {label}: the walk alone "
                             f"differs from resolve_rows")
    for g, got in (("tail", tail), ("whole", whole)):
        err = max_abs_err(got, ref)
        if err:
            raise AssertionError(f"locate split at {label}: {g} differs "
                                 f"from locate_plain (max abs err {err})")
    m = locate_guess(fm, loc, rows, valid, P)
    for name, g in zip(("ref", "gpos", "pvalid"), whole):
        if not (g.cpu().numpy().astype(np.int64)
                == m[name].astype(np.int64)).all():
            raise AssertionError(f"locate at {label}: the kernel differs "
                                 f"from its numpy model ({name})")
    ms = {g: cuda_ms(fn, 20, cold=True) for g, fn in runs.items()}
    v, okn = valid.cpu().numpy(), res["ok"].cpu().numpy()
    from test_torch_locate import GUESS, ROUTES  # on sys.path: locate_guess
    hit = m["route"] == GUESS
    out = dict(
        lanes=n, n_us=int(loc.uni_start.shape[0]), ms=ms,
        tail_share_of_whole=ms["tail"] / ms["whole"] if ms["whole"] else None,
        hit_share=float(hit.mean()),
        hit_share_ok=float(hit[okn].mean()) if okn.any() else None,
        hit_share_valid_failed=float(hit[v & ~okn].mean())
        if (v & ~okn).any() else None,
        valid=int(v.sum()), ok=int(okn.sum()),
        misses={name: int((m["route"] == i).sum())
                for i, name in enumerate(ROUTES) if i != GUESS},
        probes=int(m["probes"].sum()),
        walk_gathers=int(loads.sum(dtype=torch.int64)),
        warps_searching_share=float((m["warp_rounds"] > 0).mean()),
        max_warp_rounds=int(m["warp_rounds"].max()),
        lanes_at_25_steps=int((res["steps"] == 25).sum()))
    log(f"smoke: locate split at {label} [n={n}, n_us={out['n_us']}]: walk "
        f"{ms['walk']:.4f} ms (bare chase {ms['walk_chase']:.4f}), "
        f"search+expansion {ms['tail']:.4f}, path kernel "
        f"{ms['whole']:.4f}; guess "
        f"holds for {out['hit_share']:.4%} of lanes (ok "
        f"{out['hit_share_ok']}, failed {out['hit_share_valid_failed']}); "
        f"misses {out['misses']}; {out['warps_searching_share']:.2%} of "
        f"warps search, at most {out['max_warp_rounds']} rounds")
    return out


def _rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: cudaError {rc}")


def vote_work(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2, B2: int,
              nwR: int) -> tuple[int, int]:
    """(bytes, int32 operations) of the vote (K7) on these inputs. Bytes:
    the lanes in and the three [B2, 3] outputs out, once. Operations: 6 a
    pair (compare the refs, subtract the diagonals, abs, compare with
    tol, and, add the weight) over the pairs the scores need, each anchor
    with a ref against each anchor of nonzero weight of its read row (an
    anchor without a ref scores -1, and one of weight 0 adds nothing)."""
    import torch

    b = (sel // nwR).long().clamp(0, B2)
    n_i = torch.zeros(B2 + 1, dtype=torch.int64, device=sel.device)
    n_j = torch.zeros_like(n_i)
    n_i.index_add_(0, b, (pvalid & (ref >= 0)).sum(1))
    n_j.index_add_(0, b, (pvalid & (total_c != 0)[:, None]).sum(1))
    pairs = int((n_i[:B2] * n_j[:B2]).sum())
    return (nbytes(ref, gpos, pvalid, total_c, qleft_c, sel, lengths2)
            + 3 * 4 * B2 * 3, 6 * pairs)


def bound_of(b: int, ops: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for b bytes and ops int32 operations, the larger of the two."""
    t_b, t_o = b / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bound_terms(b: int, ops: int) -> dict:
    """Both terms of bound_of: ms for b bytes and for ops operations."""
    return dict(bytes_ms=b / HBM_BYTES_PER_S * 1e3,
                operations_ms=ops / INT32_OPS_PER_S * 1e3, bytes=b,
                operations=ops)


def bound(name: str, args, out, **kw) -> tuple[float, str]:
    """bound_of the kernel's work on these inputs."""
    return bound_of(*work(name, args, out, **kw))


# each kernel's call shape, from its captured arguments
SHAPES = {
    "stage1": lambda a: (f"rows={a[1].shape[0]} W={a[1].shape[1]} "
                         f"lek={a[3]} mask_bits={a[5]}"),
    "interval_search": lambda a: (f"n={a[6].shape[1]} "
                                  f"W={a[1].shape[1]} steps={a[7]}"),
    "compact": lambda a: f"n={a[0].shape[0]} cap={a[1]}",
    "row_grid": lambda a: f"S={a[0].shape[1]} cap={a[4]}",
    "row_walks": lambda a: f"n={a[4].shape[1]} cap={a[5]}",
    "locate": lambda a: f"n={a[2].shape[0]} P={a[4]}",
    "vote": lambda a: (f"NC={a[0].shape[0]} B2={a[7]} "
                       f"A={a[8] * a[0].shape[1]}"),
    "unpack": lambda a: f"Bp={a[0].shape[0]} W={2 * a[0].shape[1]}",
    "band_windows": lambda a: (f"rows={a[3].shape[0]} C={a[3].shape[1]} "
                               f"W={16 * a[1].shape[1]} K={a[5]}"),
    "combine": lambda a: (f"reads={a[4].shape[0] // 2} "
                          f"C={a[4].shape[1]}"),
    "band_score_packed": lambda a: (f"rows={a[0].shape[0]} "
                                    f"W={16 * a[0].shape[1]} K={a[5]}"),
}


# kernels whose bytes are mostly writes: each is timed beside a memset of
# as many bytes as its outputs hold, the card's write rate under the same
# cold protocol (the flush leaves L2 full of dirty lines)
WRITE_FLOORS = ("unpack", "band_windows")


def write_floor_ms(out) -> float:
    """Cold ms (median of 20) of one memset (zero_) over as many bytes as
    the tensors of the tuple out hold: writing them and nothing else."""
    import torch

    buf = torch.empty(nbytes(*out), dtype=torch.uint8, device="cuda")
    return cuda_ms(buf.zero_, 20, cold=True)


def floor_grid(name: str, args, out) -> tuple[list, int, int]:
    """(the kernel's input tensors, its blocks, its threads a block: one
    thread a read or read column) of a combine or shard_merge call."""
    from desamba_tpu_torch.ops.merge import MERGE_THREADS
    from desamba_tpu_torch.ops.rescore import COMBINE_READS

    if name == "combine":
        ra, score, q_st, q_ed, ref_c, diag_c = args
        ins, items, threads = ([score, q_st, q_ed, ref_c, diag_c,
                                ra.ref_offset], out.shape[1], COMBINE_READS)
    else:
        res, maps, map_off, _ = args
        ins, items, threads = [res, maps, map_off], res.shape[2], MERGE_THREADS
    return ins, -(-items // threads), threads


def kernel_floors(lib: str, name: str, args, out) -> dict:
    """The floors of one call of a short kernel at its grid, cold
    (cuda_ms(cold=True), median of 20): launch_floor_ms, an empty kernel
    (dsb_empty_launch), and one_round_ms, one round of independent
    16-byte loads of its input bytes (copied end to end into one buffer
    here, each input from a 16-byte boundary) and one round of stores of
    as many words as its output holds (dsb_one_round), both of
    csrc/measure.cu (library lib)."""
    import ctypes

    import torch

    from desamba_tpu_torch import kernels

    ins, blocks, threads = floor_grid(name, args, out)
    words = [-(-nbytes(t) // 16) * 4 for t in ins]
    buf = torch.zeros(sum(words), dtype=torch.int32, device="cuda")
    at = 0
    for t, w in zip(ins, words):
        flat = t.reshape(-1).view(torch.int32)
        buf[at:at + flat.numel()] = flat
        at += w
    sink = torch.empty(nbytes(out) // 4, dtype=torch.int32, device="cuda")
    lib_ = ctypes.CDLL(lib)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    empty, one = lib_.dsb_empty_launch, lib_.dsb_one_round
    empty.argtypes = [LL, ctypes.c_int, P]
    one.argtypes = [P, LL, P, LL, LL, ctypes.c_int, P]
    empty.restype = one.restype = ctypes.c_int
    st = kernels.stream(sink.device)

    def run_empty():
        _rc("dsb_empty_launch", empty(blocks, threads, st))

    def run_one():
        _rc("dsb_one_round", one(kernels.ptr(buf), buf.numel() // 4,
                                 kernels.ptr(sink), sink.numel(), blocks,
                                 threads, st))

    r = dict(launch_floor_ms=cuda_ms(run_empty, 20, cold=True),
             one_round_ms=cuda_ms(run_one, 20, cold=True),
             floor_grid=[blocks, threads], input_bytes=nbytes(*ins),
             output_bytes=nbytes(out))
    log(f"smoke: {name} floors at {blocks} x {threads}: launch "
        f"{r['launch_floor_ms']:.4f} ms, one round {r['one_round_ms']:.4f} "
        f"ms")
    return r


def check_kernels(cap: dict) -> dict:
    """Each kernel against its plain version on each of its captured
    calls, keyed as kernel_inputs keys them."""
    import torch

    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS, PLAIN_OPS

    missing = [k for k in (*KERNEL_OPS, *INDEX_LIST_CALLS) if k not in cap]
    if missing:
        raise AssertionError(f"no call of {missing} was captured")
    out = {}
    for key, (args, kw) in cap.items():
        name = key.split("[")[0]
        kern, plain = KERNEL_OPS[name], PLAIN_OPS[name]
        shape = SHAPES[name](args) + "".join(
            f" {k}={v.numel()}" for k, v in kw.items())
        fn, prep = in_place_call(name, kern, args, kw)
        if prep is not None:
            prep()
        got = fn()
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version (max abs err {err}) at {shape}")
        ms = cuda_ms(fn, 20, cold=True, prep=prep)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 20, cold=True)
        bound_ms, bound_by = bound(name, args, ref, **kw)
        library_ms = None
        if name == "compact" and not kw:
            # torch.nonzero: the live lanes' indices, without the cap and
            # the fill; it syncs with the host to size its output
            live = args[0] == 0
            library_ms = cuda_ms(lambda: torch.nonzero(live), 20, cold=True)
        out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms, shape=shape)
        if name == "stage1":
            out[key]["bound_old_ms"] = stage1_old_bound(args, ref)
        if name in WRITE_FLOORS:
            out[key]["write_floor_ms"] = write_floor_ms(ref)
        if name == "vote":
            out[key]["bound_terms"] = bound_terms(*vote_work(*args))
            log(f"smoke: vote bound terms {out[key]['bound_terms']}")
        log(f"smoke: {key} [{shape}] equal; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + (f", torch.nonzero {library_ms:.4f} ms"
               if library_ms is not None else "")
            + (f", earlier bound {out[key]['bound_old_ms']:.4f} ms"
               if "bound_old_ms" in out[key] else "")
            + (", a memset of its output bytes "
               f"{out[key]['write_floor_ms']:.4f} ms"
               if "write_floor_ms" in out[key] else ""))
    return out


def stage1_old_bound(args, out) -> float:
    """Stage 1's bound (ms) with the earlier kernel's full-build operation
    count (stage1_ops rolled=False) and the same bytes."""
    return bound_of(*stage1_work(args, out, rolled=False))[0]


# another chunk's calls that check_chunk_calls holds and times: stage 0,
# stage 1, K1's three and K2's three, the compactions' first and first
# through a source list, the row grid, locate, the vote and stage 4's
# window gather and combine
CHUNK_CALLS = ("unpack", "stage1", *K1_CALLS, "row_walks",
               "row_walks[sel]", "row_walks[sel]#2", "compact",
               "compact[src]", "row_grid", "locate", "vote", "band_windows",
               "combine")


# the calls that phase 7 holds and times on each shard's first chunk
SHARD_CALLS = (*K1_CALLS, "vote")


def check_chunk_calls(cap: dict, label: str, keys=CHUNK_CALLS) -> dict:
    """keys on another chunk's captured calls (kernel_inputs), each
    held to its plain version (equal exactly, one launch a call, or the
    run fails) and timed with L2 evicted beside its bound; stage 1 also
    beside the full-build bound."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS, PLAIN_OPS

    out = {}
    for key in keys:
        args, kw = cap[key]
        name = key.split("[")[0]
        fn, prep = in_place_call(name, KERNEL_OPS[name], args, kw)
        if prep is not None:
            prep()
        before = kernels.launches[name]
        got = fn()
        ref = PLAIN_OPS[name](*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0 or kernels.launches[name] != before + 1:
            raise AssertionError(f"{key} at {label}: kernel differs from its "
                                 f"plain version (max abs err {err}) or "
                                 f"launched other than once")
        bound_ms, bound_by = bound(name, args, ref, **kw)
        r = out[key] = dict(max_abs_err=err,
                            ms=cuda_ms(fn, 20, cold=True, prep=prep),
                            bound_ms=bound_ms, bound_by=bound_by,
                            shape=SHAPES[name](args) + "".join(
                                f" {k}={v.numel()}" for k, v in kw.items()))
        if name == "stage1":
            r["bound_old_ms"] = stage1_old_bound(args, ref)
        if name in WRITE_FLOORS:
            r["write_floor_ms"] = write_floor_ms(ref)
        log(f"smoke: {key} at {label} [{r['shape']}] equal; kernel "
            f"{r['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + (f", earlier bound {r['bound_old_ms']:.4f} ms"
               if "bound_old_ms" in r else "")
            + (f", a memset of its output bytes {r['write_floor_ms']:.4f} ms"
               if "write_floor_ms" in r else ""))
    return out


# the kernels whose calls check_back_to_back launches back to back: the
# scan's (their flags in one scratch a stream), K1's (its resumes update
# the carry in place) and the vote's (its slot map, one a stream)
BACK_TO_BACK = ("compact", "row_grid", "interval_search", "vote")


def check_back_to_back(caps: list) -> dict:
    """The BACK_TO_BACK kernels' captured calls of every chunk (caps: the
    kernel_inputs of each) launched back to back on one stream, with no
    synchronize between them, so that each call meets what the calls
    before it left in the scratch they share (the scan's flags, the
    vote's map words); a resume runs on its own copy of the carry, made
    before the first launch. Each must equal its plain version, one
    launch a call, or the run fails."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS, PLAIN_OPS

    calls = [(key, *c[key]) for c in caps for key in c
             if key.split("[")[0] in BACK_TO_BACK]
    runs = []
    for key, args, kw in calls:
        name = key.split("[")[0]
        if kw and name in IN_PLACE:
            i = IN_PLACE[name]
            args = (*args[:i], args[i].clone(), *args[i + 1:])
        runs.append((name, args, kw))
    before = dict(kernels.launches)
    got = [KERNEL_OPS[name](*args, **kw) for name, args, kw in runs]
    torch.cuda.synchronize()
    sizes = []
    for (key, args, kw), g in zip(calls, got):
        name = key.split("[")[0]
        err = max_abs_err(g, PLAIN_OPS[name](*args, **kw))
        if err:
            raise AssertionError(f"{key} back to back: kernel differs from "
                                 f"its plain version (max abs err {err})")
        sizes.append(f"{key}: {SHAPES[name](args)}")
    for name in BACK_TO_BACK:
        if kernels.launches[name] - before[name] != sum(
                k.split("[")[0] == name for k, _, _ in calls):
            raise AssertionError(f"{name} back to back: launched other "
                                 f"than once a call")
    log(f"smoke: {', '.join(BACK_TO_BACK)}: {len(calls)} calls back to "
        f"back on one stream, each equal to its plain version")
    return dict(calls=len(calls), shapes=sizes)


def check_stage1_cases() -> dict:
    """The stage-1 kernel against stage1_plain on
    tests/test_torch_stage1.stage1_cases at every (W, lek) of its
    WIDTH_LEK and each bitmap: equal exactly, one launch a call, every
    case reached, or the run fails."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.ops.seeds import stage1, stage1_plain

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_stage1 import (BITMAPS, WIDTH_LEK,
                                   check_stage1_coverage, stage1_args,
                                   stage1_cases)

    n = 0
    for W, lek in WIDTH_LEK:
        for bitmap in BITMAPS:
            case = stage1_cases(W, lek, bitmap)
            args = stage1_args(case, "cuda")
            before = kernels.launches["stage1"]
            got, ref = stage1(*args), stage1_plain(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, ref)
            if err != 0 or kernels.launches["stage1"] != before + 1:
                raise AssertionError(f"stage1 on stage1_cases W={W} lek={lek}"
                                     f" {bitmap}: max abs err {err}, or "
                                     f"launched other than once")
            check_stage1_coverage(case, got)
            n += 1
    log(f"smoke: stage1 on {n} stage1_cases calls equal, every case reached")
    return dict(calls=n, widths_leks=WIDTH_LEK, bitmaps=BITMAPS)


def stage1_floor(lib: str, args, out) -> dict:
    """The bloom reads of a stage-1 call alone (args: its captured call,
    out: its output): each probed point's bitmap-1 word and, where that
    bit is set, its bitmap-2 word, gathered by csrc/stage1.cu
    dsb_bloom_gather in csrc/measure.cu (library lib) from an address
    list made here;
    cold ms (L2 evicted, median of 20). The list is streamed in too (12
    bytes a point). The hits must add up to the call's n_exist, or the
    run fails."""
    import ctypes

    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.constants import STEP_EK
    from desamba_tpu_torch.ops.ekmer import _probe_addrs

    w01, codes2, l2, lek, sbm, mb, nw0 = args
    want, (wi1, sh1), (wi2, sh2) = _probe_addrs(codes2, l2, lek, sbm, mb,
                                                stride=STEP_EK)
    m = want.reshape(-1)
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    a1, a2 = i32(wi1[m]), i32(wi2[m] + nw0)
    sh = i32(sh1[m] | (sh2[m] << 8))
    n = a1.numel()
    sums = torch.zeros(-(-n // 32), dtype=torch.int32, device=a1.device)
    fn = ctypes.CDLL(lib).dsb_bloom_gather
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_longlong, P, P]
    fn.restype = ctypes.c_int

    def run():
        rc = fn(kernels.ptr(w01), kernels.ptr(a1), kernels.ptr(a2),
                kernels.ptr(sh), n, kernels.ptr(sums),
                kernels.stream(a1.device))
        if rc != 0:
            raise RuntimeError(f"dsb_bloom_gather: cudaError {rc}")

    run()
    hits = int(sums.sum(dtype=torch.int64))
    if hits != int(out[3].sum(dtype=torch.int64)):
        raise AssertionError(f"bloom floor: {hits} hits, stage 1 "
                             f"{int(out[3].sum())}")
    set1 = ((w01[a1].to(torch.int64) >> (sh & 31)) & 1).bool()
    r = dict(ms=cuda_ms(run, 20, cold=True), probed_points=n,
             bitmap2_reads=int(set1.sum()), hits=hits,
             streamed_bytes=12 * n + 4 * sums.numel())
    log(f"smoke: stage1 bloom floor [{n} probed points, "
        f"{r['bitmap2_reads']} bitmap-2 reads]: {r['ms']:.4f} ms")
    return r


def walk_sweep(lib: str, args, kern=None) -> dict:
    """K2 on the burst carry of a chunk (args: its captured call) at each
    cap of WALK_SWEEP_CAPS: cold (L2 evicted) and warm ms, median of 20;
    beside a bare pointer chase over fm.lfc (dsb_lf_chase in
    csrc/measure.cu, library lib) from the same start rows with the
    same gathers each lane makes at that cap (its steps, and one more
    where it stopped), the chain's floor on this card. Warm calls follow
    a ~0.1 ms spin of the card (torch.cuda._sleep), so that the host's
    launch is hidden and the events time the kernel. The intercept of
    ms against cap is launch plus start-up; the slope, a step. kern: the
    K2 call to sweep (default the port's row_walks_state)."""
    import ctypes

    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    fm, codes, lanes, max_lens, state, _ = args
    kern = kern or KERNEL_OPS["row_walks"]
    chase = ctypes.CDLL(lib).dsb_lf_chase
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    chase.argtypes = [P, LL, P, P, LL, P, P]
    chase.restype = ctypes.c_int
    n = state.shape[1]
    start = state[0].contiguous()
    sink = torch.empty(n, dtype=torch.int32, device=state.device)
    busy = lambda: torch.cuda._sleep(200_000)  # noqa: E731
    out = {}
    for c in WALK_SWEEP_CAPS:
        run = lambda: kern(fm, codes, lanes, max_lens, state, c)
        res = run()
        loads = ((res[2] - state[2])
                 + (res[3] & (1 - state[3]))).to(torch.int32).contiguous()

        def chased():
            rc = chase(kernels.ptr(fm.lfc), fm.lfc.shape[0],
                       kernels.ptr(start), kernels.ptr(loads), n,
                       kernels.ptr(sink), kernels.stream(state.device))
            if rc != 0:
                raise RuntimeError(f"dsb_lf_chase: cudaError {rc}")

        out[c] = dict(ms=cuda_ms(run, 20, cold=True),
                      warm_ms=cuda_ms(run, 20, prep=busy),
                      chase_ms=cuda_ms(chased, 20, cold=True),
                      chase_warm_ms=cuda_ms(chased, 20, prep=busy),
                      gathers=int(loads.sum(dtype=torch.int64)),
                      max_gathers=int(loads.max()))
        r = out[c]
        log(f"smoke: row_walks sweep cap={c}: kernel {r['ms']:.4f} ms cold, "
            f"{r['warm_ms']:.4f} warm; chase {r['chase_ms']:.4f} cold, "
            f"{r['chase_warm_ms']:.4f} warm; {r['gathers']} gathers, at most "
            f"{r['max_gathers']} a lane")
    return out


def k1_floor(lib: str, args, kw, fn=None) -> dict:
    """K1 on one captured call (args, kw: the burst, or a resume through
    sel) beside its chain alone, each cold (L2 evicted, median of 20):
    the C entry point fn (default the port's; an earlier commit's from
    tools/kernel_ab.py) run on a work copy of the carry in place, with no
    copy of the carry inside the events (the burst writes a new carry),
    and dsb_occ_chase (csrc/measure.cu, library lib) on the same lanes
    for the steps each took in that call (ptr's fall, the stopping step
    included), the same dependent occ32 gathers and nothing else. The
    in-place call must equal the plain version, or the run fails."""
    import ctypes

    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import PLAIN_OPS

    fm, codes, lanes, max_rst, l_min, l_max, state, max_steps = args
    sel = kw.get("sel")
    n = state.shape[1]
    dev = state.device
    ref = PLAIN_OPS["interval_search"](*args, **kw)
    took = state[5] - ref[5]
    if sel is None:
        m, steps = n, took.to(torch.int32).contiguous()
    else:
        ok = (sel >= 0) & (sel < n)
        m = sel.numel()
        steps = torch.where(ok, took[sel.clamp(0, n - 1).long()], 0).to(
            torch.int32).contiguous()
    fn = fn or kernels._fn("interval_search")
    work = state.clone()
    out = work if sel is not None else torch.empty_like(state)
    p = kernels.ptr

    def direct():
        _rc("dsb_interval_search", fn(
            p(fm.occ32), fm.occ32.shape[0], p(fm.rank), p(codes),
            codes.shape[1], p(lanes), p(max_rst), p(l_min), p(l_max),
            p(work), p(out), n, p(sel), m, int(max_steps),
            kernels.stream(dev)))

    chase = ctypes.CDLL(lib).dsb_occ_chase
    Pt, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    chase.argtypes = [Pt, LL, Pt, Pt, I, Pt, Pt, LL, Pt, LL, Pt, Pt, Pt]
    chase.restype = ctypes.c_int
    sink = torch.empty(max(m, 1), dtype=torch.int32, device=dev)

    def chased():
        _rc("dsb_occ_chase", chase(
            p(fm.occ32), fm.occ32.shape[0], p(fm.rank), p(codes),
            codes.shape[1], p(lanes), p(state), n, p(sel), m, p(steps),
            p(sink), kernels.stream(dev)))

    prep = lambda: work.copy_(state)  # noqa: E731
    prep()
    direct()
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    if err:
        raise AssertionError(f"interval_search in place "
                             f"({SHAPES['interval_search'](args)}): "
                             f"differs from its plain version (max abs "
                             f"err {err})")
    return dict(kernel_ms=cuda_ms(direct, 20, cold=True, prep=prep),
                chase_ms=cuda_ms(chased, 20, cold=True), lanes=m,
                steps=int(steps.sum(dtype=torch.int64)),
                max_steps=int(steps.max()) if m else 0)


def ptxas_report(info: dict) -> dict:
    """{kernel: [{function, registers, spill_stores, spill_loads,
    stack}]} from each library's nvcc -Xptxas -v output."""
    import re

    out = {}
    for name, d in info.items():
        funcs, cur = [], None
        for ln in d["log"].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = dict(function=m.group(1))
                funcs.append(cur)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        out[name] = funcs
    return out


def check_vote(cl, reads, gtabs) -> tuple[dict, dict, dict]:
    """The vote kernel against vote_plain beyond the W = 2048 chunk: on
    the first BLOCK bench reads encoded at each of VOTE_WIDTHS (the
    kernels' stages 0-2 and locate give its inputs), and on vote_cases
    (the golden tables gtabs, on the CPU) at every width bucket up to the
    classifier's max_width. Equal exactly, or the run fails. The bench
    calls are timed as check_kernels times them. Also the whole pipeline
    (build_full's [7, BLOCK]) of the kernels against that of the plain
    versions on each VOTE_WIDTHS encoding. Returns (the vote's checks,
    the pipeline's, {W: every kernel's first call on that encoding})."""
    import torch

    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR, _bucket
    from desamba_tpu_torch.engine.fast_engine import (KERNEL_OPS, PLAIN_OPS,
                                                      build_full)
    from desamba_tpu_torch.ops.locate import locate_plain

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_kernels import vote_cases

    kern, plain = KERNEL_OPS["vote"], PLAIN_OPS["vote"]
    ek = cl.ek
    plain_full = build_full(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                            ek.n_words0, PLAIN_OPS)
    calls, full, caps = {}, {}, {}
    for W in VOTE_WIDTHS:
        packed, lens, _ = cl._encode(reads[:BLOCK], W=W, Bp=BLOCK)
        caps[W] = kernel_inputs(cl, packed, lens)
        calls[f"W={W}"] = caps[W]["vote"][0]
        # the whole pipeline (stages 0-4 and the pack), kernels against
        # plain versions, on the same encoding
        p = torch.from_numpy(packed).to(cl.device)
        ln = torch.from_numpy(lens).to(cl.device)
        got = cl._full(cl.fm, cl.loc, cl.ra, ek.w01, p, ln)
        ref = plain_full(cl.fm, cl.loc, cl.ra, ek.w01, p, ln)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0:
            raise AssertionError(f"build_full at W={W}: the kernel path's "
                                 f"[7, {BLOCK}] differs from the plain "
                                 f"path's (max abs err {err})")
        full[f"W={W}"] = dict(max_abs_err=err, called=int((got[1] >= 0).sum()))
        log(f"smoke: build_full at W={W} ({BLOCK} reads): kernel path == "
            f"plain path, {full[f'W={W}']['called']} reads with a ref")
    fm, _, loc, _ = gtabs
    lek = cl.ek.lek
    for W in sorted({_bucket(max(n, lek + 2))
                     for n in range(1, cl.max_width + 1)}):
        *s2, l2, nwR, _ = vote_cases(fm, loc, W, lek, VOTE_CASE_ROWS)
        args = (*locate_plain(fm, loc, s2[0], s2[1], REFPOS_PER_ANCHOR),
                *s2[2:], l2)
        calls[f"vote_cases W={W}"] = (*(t.to(cl.device) for t in args),
                                      VOTE_CASE_ROWS, nwR)
    out = {}
    for key, args in calls.items():
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        shape = (f"NC={args[0].shape[0]} B2={args[7]} "
                 f"A={args[8] * args[0].shape[1]}")
        if err != 0:
            raise AssertionError(f"vote ({key}): kernel differs from its "
                                 f"plain version (max abs err {err}) at "
                                 f"{shape}")
        out[key] = dict(max_abs_err=err, shape=shape)
        if key.startswith("W="):
            bound_ms, bound_by = bound("vote", args, ref)
            out[key].update(
                ms=cuda_ms(lambda: kern(*args), 20, cold=True),
                plain_ms=cuda_ms(lambda: plain(*args), 5, cold=True),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_terms=bound_terms(*vote_work(*args)))
        log(f"smoke: vote ({key}) [{shape}] equal" + (
            f"; kernel {out[key]['ms']:.4f} ms, plain "
            f"{out[key]['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})" if key.startswith("W=") else ""))
    return out, full, caps


def check_band(cl, caps: dict, sass: dict) -> dict:
    """K8 against band_score_packed_plain at every band the classifier
    makes beyond check_kernels' W = 2048 call (K = 144): its first call
    on the first chunk of each other width bucket of the bench reads (W
    = 3072, K = 208) and on the first BLOCK bench reads encoded at W = 4096
    and 8192 (K = 272; caps: {W: kernel_inputs} of those), each timed
    cold (kernel median of 20, plain of 5) beside the bound of the
    bit-plane formulation (band_ops) and the SWAR formulation's 25-op
    bound; and on tests/test_torch_band_score.band_cases at each (K, W)
    of its BANDS and at (272, 8192), every case reached. Equal exactly, or
    the run fails; one launch a call. sass: band_sass, logged beside the
    times."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS, PLAIN_OPS

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_band_score import (BANDS, band_args, band_cases,
                                       check_band_coverage)

    kern, plain = KERNEL_OPS["band_score_packed"], PLAIN_OPS[
        "band_score_packed"]
    calls = {}
    for W, cap in sorted(caps.items()):
        calls[f"W={W}"] = cap["band_score_packed"][0]
    for K, W in (*BANDS, (272, 8192)):
        calls[f"band_cases K={K} W={W}"] = band_args(band_cases(K, W),
                                                     "cuda")
    out = {}
    for key, args in calls.items():
        before = kernels.launches["band_score_packed"]
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        shape = (f"rows={args[0].shape[0]} W={16 * args[0].shape[1]} "
                 f"K={args[5]}")
        if err != 0 or kernels.launches["band_score_packed"] != before + 1:
            raise AssertionError(f"band_score_packed ({key}): kernel "
                                 f"differs from its plain version (max abs "
                                 f"err {err}) at {shape}, or launched "
                                 f"other than once")
        out[key] = dict(max_abs_err=err, shape=shape)
        if key.startswith("band_cases"):
            K, W = (int(x.split("=")[1]) for x in key.split()[1:])
            check_band_coverage(band_cases(K, W),
                                {f: v.cpu() for f, v in got.items()})
            log(f"smoke: band_score_packed ({key}) [{shape}] equal, every "
                "case reached")
            continue
        bound_ms, bound_by = bound("band_score_packed", args, ref)
        out[key].update(
            ms=cuda_ms(lambda: kern(*args), 20, cold=True),
            plain_ms=cuda_ms(lambda: plain(*args), 5, cold=True),
            bound_ms=bound_ms, bound_by=bound_by,
            bound_old_ms=bound_of(0, band_ops_swar(args[0], args[5]))[0])
    for key, r in out.items():
        if "ms" in r:
            log(f"smoke: band_score_packed ({key}) [{r['shape']}] equal; "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), SWAR "
                f"25-op bound {r['bound_old_ms']:.4f} ms; SASS "
                f"{sass['per_read_word_offset']} instructions a (read "
                "word, offset)")
    return out


def where_time_goes(cl, chunks: dict, reads, card: str,
                    vote_first: dict) -> dict:
    """Per-stage event span and device time on each bucket's first full
    chunk, with the vote kernel's cold time and bound (vote_first: phase
    2's check of it on the first chunk); device busy share of one
    pure-device classify_batch, and each hand kernel's device time per
    launch in it."""
    import torch

    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    stages = {}
    for W, (packed, lens, n_chunk) in chunks.items():
        row = {}
        fns, s1_io = stage_calls(cl, packed, lens, KERNEL_OPS)
        for name, fn in fns.items():
            dev, nk, *by = device_ms(fn, by_kernel=name == "fused")
            row[name] = dict(span_ms=cuda_ms(fn), device_ms=dev,
                             kernels_per_call=nk)
            if by:
                row[name]["kernel_device_ms"] = by[0]
        row["1 probe+seeds"]["bound_ms"] = bound("stage1", *s1_io)[0]
        row["1 probe+seeds"]["bound_old_ms"] = stage1_old_bound(*s1_io)
        row["1 probe+seeds"]["after_unpack"] = stage1_after_unpack(
            cl, packed, lens, s1_io[0])
        # the vote kernel (L2 evicted) beside its bound (ms, "bytes" or
        # "operations"): phase 2 timed it on the first chunk
        if W == min(chunks):
            vote_ms = vote_first["ms"]
            vote_bound = (vote_first["bound_ms"], vote_first["bound_by"])
        else:
            vargs = kernel_inputs(cl, packed, lens)["vote"][0]
            vote_ms = cuda_ms(lambda: KERNEL_OPS["vote"](*vargs), 20,
                              cold=True)
            vote_bound = bound_of(*vote_work(*vargs))
        row["3 locate+vote"].update(
            vote_ms=vote_ms, vote_bound=vote_bound,
            vote_bound_terms=vote_first["bound_terms"] if W == min(chunks)
            else bound_terms(*vote_work(*vargs)))
        stages[f"W={W} ({n_chunk} reads)"] = row
    cl.exact_fallback = False
    torch.cuda.synchronize()
    t0 = time.time()
    cl.classify_batch(reads, block=BLOCK)
    torch.cuda.synchronize()
    wall = time.time() - t0
    box = {}

    def profiled():
        t1 = time.time()
        cl.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        box["wall"] = time.time() - t1

    ev = device_rows(profiled)
    cl.exact_fallback = True
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    top = [dict(ms=e.self_device_time_total / 1e3, count=e.count,
                kernel=e.key[:90])
           for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]]
    on_path = {}
    for name in KERNEL_OPS:
        rows = [e for e in ev if any(g in e.key for g in GLOBAL[name])]
        ms = sum(e.self_device_time_total for e in rows) / 1e3
        count = sum(e.count for e in rows if GLOBAL[name][0] in e.key)
        on_path[name] = dict(ms=ms, launches=count,
                             ms_per_launch=ms / max(1, count))
    return dict(card=card, stages=stages, batch=dict(
        reads=len(reads), wall_ms_unprofiled=wall * 1e3,
        wall_ms_profiled=box["wall"] * 1e3, device_ms=busy * 1e3,
        device_busy_share=busy / wall, top_kernels=top,
        hand_kernels=on_path))


def stage1_after_unpack(cl, packed, lens, s1_args) -> dict:
    """Stage 1's kernel on a chunk (s1_args: its captured call), each
    median of 20 with the host's launch time hidden: cold (L2 evicted),
    right after stage 0's kernel on the chunk (L2 evicted, then unpack,
    then stage 1 timed on unpack's codes2 and lengths2) and warm (L2 as
    the call before left it): whether stage 1 finds codes2 in L2."""
    import statistics

    import torch

    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    p = torch.from_numpy(packed).to(cl.device)
    ln = torch.from_numpy(lens).to(cl.device)
    w01, _, _, *rest = s1_args
    s1 = KERNEL_OPS["stage1"]
    box = {}

    def produce():
        box["out"] = KERNEL_OPS["unpack"](p, ln)

    def after():
        codes2, _, _, l2 = box["out"]
        return s1(w01, codes2, l2, *rest)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def spun(fn, evict: bool, before=None) -> float:
        """cuda_ms(cold=True)'s protocol, the eviction optional and before
        (fn's producer) run after it, outside the events"""
        if before is not None:
            before()
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            if evict:
                flush.zero_()
            if before is not None:
                before()
            torch.cuda._sleep(HIDE_HOST_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    out = dict(cold_ms=cuda_ms(lambda: s1(*s1_args), 20, cold=True),
               after_unpack_ms=spun(after, True, produce),
               warm_ms=spun(lambda: s1(*s1_args), False))
    log(f"smoke: stage 1 at W={packed.shape[1] * 2}: cold "
        f"{out['cold_ms']:.4f} ms, right after unpack "
        f"{out['after_unpack_ms']:.4f} ms, warm {out['warm_ms']:.4f} ms")
    return out


# the kernels that the ranking of redesigns weighs: stage 0's, stage 4's
# two around the band scorer, and the sharded path's merge
RANKED = ("unpack", "band_windows", "combine", "shard_merge")


def ranking(first: dict, more: dict, on_path: dict, launches: dict,
            merge: dict) -> list:
    """RANKED by launches a batch x (cold ms - bound ms) on the first
    chunk of the narrowest bucket (first: phase 2's checks; the merge on
    phase 7's first chunk), each with its cold ms and bound on the other
    chunks (more: check_chunk_calls' by chunk), its device ms a launch on
    the path (on_path: phase 5's; the merge's from phase 7) and the share
    of its bound it reaches cold. launches: phase 3's counts (three
    batches)."""
    out = []
    for k in RANKED:
        if k == "shard_merge":
            r, n, path, other = merge, merge["launches"], merge["path_ms"], {}
        else:
            r, n = first[k], launches[k] / 3
            path = on_path[k]["ms_per_launch"]
            other = {W: dict(ms=c[k]["ms"], bound_ms=c[k]["bound_ms"])
                     for W, c in more.items() if k in c}
        out.append(dict(name=k, launches=n, ms=r["ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        **{f: r[f] for f in ("launch_floor_ms",
                                             "one_round_ms", "floor_grid")
                           if f in r},
                        path_ms=path, share_of_bound=r["bound_ms"] / r["ms"],
                        weight_ms=n * (r["ms"] - r["bound_ms"]),
                        other_chunks=other))
    return sorted(out, key=lambda d: -d["weight_ms"])


def make_golden_index() -> str:
    """The index of tests/golden/ref.fa in the C reference's format,
    written under build/golden_idx by the JAX package's builder in a child
    process, as tests/conftest.py builds it (the port has no index builder
    yet)."""
    code = ("import sys\n"
            "from desamba_tpu.index.build import build_index\n"
            "from desamba_tpu.index.format_ref import save_ref_format\n"
            "save_ref_format(build_index(sys.argv[1]), sys.argv[2])\n")
    p = subprocess.run([sys.executable, "-c", code,
                        os.path.join(GOLDEN, "ref.fa"), GOLDEN_IDX],
                       cwd=ROOT, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"building the golden index failed:\n"
                           f"{p.stderr[-4000:]}")
    return GOLDEN_IDX


def primary_lines(sam: str) -> dict:
    """{read name: (ref name, forward, score, pos) of its first SAM line,
    the primary hit, or None where the read is unmapped}."""
    out = {}
    for ln in sam.splitlines():
        f = ln.split("\t")
        if f[0] not in out:
            out[f[0]] = None if f[1] == "4" else (
                f[2], not int(f[1]) & 0x10, int(f[11][5:]), int(f[3]))
    return out


def validation_phase(cl, reads, card: str, gidx, build_s: float) -> dict:
    """Phase 6: the validation engine (TpuClassifier, `classify --engine
    tpu`) on the card. The golden SAM on the golden index gidx (built in
    build_s seconds) byte for byte; then the first
    N_VALIDATE bench reads through the kernel route (launch counts set to
    0 just before, read just after; its device calls timed for where the
    time goes) and the plain route, whose SAMs must be equal, beside the
    native engine's primary hits; and each of the path's three kernels
    held against its plain version on its first call."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.native import NativeClassifier
    from desamba_tpu_torch.engine.tpu_engine import (KERNEL_OPS, PLAIN_OPS,
                                                     SUB_BATCH, TpuClassifier)
    from desamba_tpu_torch.io.fastx import read_fastx
    from desamba_tpu_torch.oracle.classify import i32

    greads = [(r.name, r.seq, r.qual)
              for r in read_fastx(os.path.join(GOLDEN, "reads.fq"))]
    t1 = time.time()
    gsam = TpuClassifier(gidx, device="cuda").classify_to_sam(greads)
    golden = dict(build_s=build_s, classify_s=time.time() - t1,
                  reads=len(greads))
    if gsam != open(os.path.join(GOLDEN, "classify.sam")).read():
        raise AssertionError("the validation engine's SAM on the card "
                             "differs from tests/golden/classify.sam")
    log(f"smoke: golden SAM equal on the card ({golden})")

    # each device call of the kernel route timed from its launch to a
    # sync (CUDA events for its device span), for where the time goes
    spent = {k: [0.0, 0.0, 0] for k in KERNEL_OPS}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t = time.time()
            a.record()
            out = fn(*args, **kw)
            b.record()
            b.synchronize()
            spent[name][0] += time.time() - t
            spent[name][1] += a.elapsed_time(b) / 1e3
            spent[name][2] += 1
            return out
        return call

    sub = reads[:N_VALIDATE]
    tc = TpuClassifier(cl.idx, device="cuda", fm=cl.fm)
    tc.ops = {k: timed(k, f) for k, f in tc.ops.items()}
    kernels.reset_launches()
    t0 = time.time()
    sam = tc.classify_to_sam(sub)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: kernels.launches[k] for k in KERNEL_OPS}
    if not all(launches.values()):
        raise AssertionError(f"a validation kernel was not launched: "
                             f"{launches}")
    stats = {k: tc.stats[k] for k in ("fm_searches", "fm_walks",
                                      "walk_fallback", "cand_fallback")}
    tp = TpuClassifier(cl.idx, device="cuda", plain=True, fm=cl.fm)
    cap: dict = {}
    tp.ops = {k: recording(cap, k, f, every=()) for k, f in tp.ops.items()}
    t0 = time.time()
    sam_plain = tp.classify_to_sam(sub)
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    if sam_plain != sam or {k: tp.stats[k] for k in stats} != stats:
        a, b = primary_lines(sam), primary_lines(sam_plain)
        raise AssertionError(
            f"validation engine: kernel and plain routes differ (stats "
            f"{stats} vs {dict(tp.stats)}; primary lines of "
            f"{sum(a[k] != b.get(k) for k in a)} reads)")
    del tp

    calls_s = sum(v[0] for v in spent.values())
    breakdown = {k: dict(wall_s=v[0], share=v[0] / wall,
                         event_ms_per_call=v[1] * 1e3 / max(1, v[2]),
                         calls=v[2]) for k, v in spent.items()}
    breakdown["host (encode, copies, replay, rescore, SAM)"] = dict(
        wall_s=wall - calls_s, share=1 - calls_s / wall)

    nat = NativeClassifier(cl.idx, n_threads=os.cpu_count() or 1)
    names = cl.idx.ref_names
    prim = primary_lines(sam)
    differ = []
    for r in nat.classify_batch(sub):
        h = next((h for h in r.hits if h.primary == 1), None)
        n = None if h is None else (names[h.ref_ID], bool(h.direction),
                                    i32(h.sum_score), i32(h.t_st))
        if prim.get(r.name) != n:
            differ.append(dict(read=r.name, tpu=prim.get(r.name), native=n))
    agree = 1 - len(differ) / len(sub)

    shapes = {"probe_reads": lambda a: (f"rows={a[1].shape[0]} "
                                        f"W={a[1].shape[1]} lek={a[0].lek} "
                                        f"mask_bits={a[0].mask_bits}"),
              "interval_search": lambda a: (f"n={a[6].shape[1]} "
                                            f"W={a[1].shape[1]} "
                                            f"max_steps={a[7]}"),
              "row_walks_trace": lambda a: (f"n={a[2].shape[0]} "
                                            f"W={a[1].shape[1]} cap=96")}
    checks = {}
    for name, (args, kw) in cap.items():
        kern, plain = KERNEL_OPS[name], PLAIN_OPS[name]
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0:
            raise AssertionError(f"{name} (validation engine): kernel differs"
                                 f" from its plain version (max abs err "
                                 f"{err}) at {shapes[name](args)}")
        bound_ms, bound_by = bound(name, args, ref)
        checks[name] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: kern(*args), 20, cold=True),
            plain_ms=cuda_ms(lambda: plain(*args), 5, cold=True),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape=shapes[name](args), launches=launches[name],
            path_ms=breakdown[name]["event_ms_per_call"])
        log(f"smoke: {name} (validation engine) [{checks[name]['shape']}] "
            f"equal; kernel {checks[name]['ms']:.4f} ms, plain "
            f"{checks[name]['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return dict(card=card, golden=golden, reads=len(sub),
                sub_batch=SUB_BATCH, reads_per_s=len(sub) / wall,
                plain_reads_per_s=len(sub) / wall_plain, wall_s=wall,
                plain_wall_s=wall_plain,
                stats=stats, launches=launches, breakdown=breakdown,
                native_agreement=agree, native_differ=differ[:20],
                n_native_differ=len(differ), checks=checks)


def start_sharded_index(fa: str):
    """(shard root, child process or None, start time): the community
    FASTA split into N_SHARDS genome shards under CACHE, once, by the JAX
    package's build_sharded_index (its size-balanced partition, one
    process a shard) in a child process, as make_data builds the
    monolithic index (the port has no index builder yet); None where the
    shards are there already. finish_sharded_index waits for it."""
    root = os.path.join(CACHE, f"shards{N_SHARDS}_"
                        f"{os.path.splitext(os.path.basename(fa))[0]}")
    if os.path.exists(os.path.join(root, "shards.json")):  # written last
        return root, None, time.time()
    code = ("import sys\n"
            "from desamba_tpu.parallel.shard_index import "
            "build_sharded_index\n"
            "build_sharded_index(sys.argv[1], sys.argv[2], int(sys.argv[3]))"
            "\n")
    return root, subprocess.Popen(
        [sys.executable, "-c", code, fa, root, str(N_SHARDS)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.time()


def finish_sharded_index(root: str, proc, t0: float) -> tuple[str, float]:
    """(shard root, seconds of the build; 0.0 where none ran)."""
    if proc is None:
        return root, 0.0
    err = proc.communicate()[1]
    if proc.returncode != 0:
        raise RuntimeError(f"build_sharded_index failed:\n{err[-4000:]}")
    return root, time.time() - t0


def spread(xs) -> dict:
    """Median, least and largest of a run's repeated rates."""
    import statistics

    return dict(median=statistics.median(xs), min=min(xs), max=max(xs),
                runs=list(xs))


def record_merges(scl, reads) -> list:
    """The merge's arguments (stacked shard results, maps, map_off, nref)
    of each chunk of one classify_batch of the sharded classifier scl."""
    from desamba_tpu_torch.engine.sharded_fast import build_sharded_full
    from desamba_tpu_torch.ops.merge import shard_merge

    cap, ek = [], scl.ek

    def rec(*a):
        cap.append(a)
        return shard_merge(*a)

    path_full = scl._full
    scl._full = build_sharded_full(ek.lek, ek.single_base_max, ek.mask_bits,
                                   20, ek.n_words0, merge=rec)
    try:
        scl.classify_batch(reads, block=BLOCK)
    finally:
        scl._full = path_full
    return cap


def sharded_phase(cl, reads, shard_index, card, res, res_dev, native_tids,
                  measure: str) -> dict:
    """Phase 7: the genome-sharded classifier (load_sharded_fast) on the
    card, the bench community in N_SHARDS genome shards. The merge (K11)
    against its plain version on each chunk's stacked shard results
    (recorded in a warm pass), timed on the first; launch counts set to 0
    just before a pure-device classify_batch and read just after (each
    stage kernel N_SHARDS times a chunk, the merge once); pure-device and
    exact_fallback rates (median of N_RATE_CALLS); the sharded kernel
    path against the sharded plain path on every read; agreement with the
    native engine's taxa (native_tids, phase 3's; gated at AGREE_MIN),
    reads whose call differs from the monolithic classifier's (res,
    res_dev: phase 3's), truth accuracy; where the time goes (the first
    chunk of the narrowest bucket, stage by stage and shard by shard, and
    one profiled classify_batch)."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS, build_full
    from desamba_tpu_torch.engine.sharded_fast import (ShardedFastClassifier,
                                                       load_sharded_fast)
    from desamba_tpu_torch.ops.merge import shard_merge, shard_merge_plain

    root, build_s = shard_index
    log(f"smoke: {N_SHARDS} genome shards built in {build_s:.1f} s (with "
        f"the index, phase 2)")
    t0 = time.time()
    scl = load_sharded_fast(root, device="cuda", exact_fallback=True)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    shards = [dict(refs=len(ix.ref_names), L=int(ix.L),
                   mask_bits=t[1].mask_bits, filter_bytes=nbytes(t[1].w01),
                   fm_bytes=nbytes(t[0].occ32, t[0].pad, t[0].hash13,
                                   t[0].sa_uni, t[0].sa_off, t[0].lfc))
              for ix, t in zip(scl.idxs, scl.shards)]
    log(f"smoke: sharded classifier loaded in {init_s:.1f} s; shards "
        f"{shards}; device memory {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB")
    n = len(reads)
    ek = scl.ek

    # the merge's inputs, chunk by chunk, from a warm pass (with the
    # replay, so that the host ShardedEngine is built before the rates)
    cap = record_merges(scl, reads)
    scl.exact_fallback = False
    err = 0
    for a in cap:
        got, ref = shard_merge(*a), shard_merge_plain(*a)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, ref))
        if err != 0:
            raise AssertionError(f"shard_merge differs from its plain "
                                 f"version (max abs err {err}) at "
                                 f"{tuple(a[0].shape)}")
    a0 = cap[0]
    shape = f"n_index={a0[0].shape[0]} Bp={a0[0].shape[2]}"
    bound_ms, bound_by = bound("shard_merge", a0, shard_merge_plain(*a0))
    merge = dict(max_abs_err=err, chunks_checked=len(cap),
                 ms=cuda_ms(lambda: shard_merge(*a0), 20, cold=True),
                 plain_ms=cuda_ms(lambda: shard_merge_plain(*a0), 20,
                                  cold=True),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 shape=shape, **kernel_floors(measure, "shard_merge", a0,
                                              shard_merge_plain(*a0)))
    log(f"smoke: shard_merge [{shape}] equal on {len(cap)} chunks; kernel "
        f"{merge['ms']:.4f} ms, plain {merge['plain_ms']:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")

    # the path: launches a chunk, then the rates
    rates_dev = []
    kernels.reset_launches()
    t0 = time.time()
    res_s_dev = scl.classify_batch(reads, block=BLOCK)
    torch.cuda.synchronize()
    rates_dev.append(n / (time.time() - t0))
    launches = dict(kernels.launches)
    chunks = launches["shard_merge"]
    per_chunk = dict(unpack=1, shard_merge=1, **{
        k: N_SHARDS * v for k, v in dict(
            stage1=1, interval_search=3, compact=4, row_grid=1, row_walks=3,
            locate=1, vote=1, band_windows=1, band_score_packed=1,
            combine=1).items()})
    if chunks != len(cap) or any(launches[k] != v * chunks
                                 for k, v in per_chunk.items()):
        raise AssertionError(f"sharded path: launches other than "
                             f"{per_chunk} a chunk over {len(cap)} chunks: "
                             f"{launches}")
    # the remaining pure-device calls in turns with the monolithic
    # classifier's (mono, sharded, sharded, mono, ...): calls on one card
    # differ by a fifth to a third, so only turns compare the two
    cl.exact_fallback = False
    rates_mono = []
    for k in range(2 * (N_RATE_CALLS - 1)):
        c, out = ((cl, rates_mono) if k % 4 in (0, 3)
                  else (scl, rates_dev))
        t0 = time.time()
        c.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        out.append(n / (time.time() - t0))
    cl.exact_fallback = True
    scl.exact_fallback = True
    rates, fallback = [], []
    for _ in range(N_RATE_CALLS):
        scl.stats = dict(n_reads=0, n_fallback=0)
        t0 = time.time()
        res_s = scl.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        rates.append(n / (time.time() - t0))
        fallback.append(scl.stats["n_fallback"] / max(1, scl.stats["n_reads"]))

    # the sharded plain path on the same tables
    sp = ShardedFastClassifier(scl.idxs, ref_ids=scl.ref_ids, device="cuda",
                               plain=True, tables=scl.shards)
    t0 = time.time()
    res_s_plain = sp.classify_batch(reads, block=BLOCK)
    torch.cuda.synchronize()
    plain_rate = n / (time.time() - t0)
    del sp
    if tup(res_s_dev) != tup(res_s_plain):
        bad = sum(x != y for x, y in zip(tup(res_s_dev), tup(res_s_plain)))
        raise AssertionError(f"sharded kernel path and sharded plain path "
                             f"differ on {bad} of {n} reads")

    # agreement, the monolithic classifier's calls, truth
    agree = sum(scl.tid_of(r.ref_ID) == t
                for r, t in zip(res_s, native_tids)) / n
    truth = [truth_tid(r[0]) for r in reads]
    name = lambda names, r: names[r.ref_ID] if r.ref_ID >= 0 else None  # noqa: E731
    mono = cl.idx.ref_names
    differ = [r.name for r, m in zip(res_s, res)
              if name(scl.ref_names, r) != name(mono, m)]
    differ_dev = sum(name(scl.ref_names, r) != name(mono, m)
                     for r, m in zip(res_s_dev, res_dev))

    # where the time goes: the first chunk of the narrowest bucket, stage
    # by stage on each shard (stage 0 is the sharded chunk's one call),
    # the sharded chunk whole, and one profiled pure-device batch; locate
    # on each shard split into its parts (locate_split)
    W, (packed, lens, n_chunk) = min(first_chunks(scl, reads).items())
    stages, splits, shard_calls = {}, {}, {}
    for s, (fm, ek_s, loc, ra) in enumerate(scl.shards):
        one = SimpleNamespace(fm=fm, ek=ek_s, loc=loc, ra=ra,
                              device=scl.device, _full=build_full(
                                  ek.lek, ek.single_base_max, ek.mask_bits,
                                  20, ek.n_words0))
        cap_s = kernel_inputs(one, packed, lens)
        splits[f"shard {s} W={W}"] = locate_split(
            measure, cap_s["locate"][0], f"shard {s} W={W}")
        # K1's three calls and the vote on the shard's tables
        shard_calls[f"shard {s} W={W}"] = check_chunk_calls(
            cap_s, f"shard {s} W={W}", SHARD_CALLS)
        del cap_s
        fns, _ = stage_calls(one, packed, lens, KERNEL_OPS)
        for st, fn in fns.items():
            if st == "0 unpack" and s > 0:
                continue
            row = checked_device_ms(fn)
            del row["rows"]
            stages[st if st == "0 unpack" else f"shard {s}: {st}"] = dict(
                span_ms=cuda_ms(fn), **row)
    p = torch.from_numpy(packed).to(scl.device)
    ln = torch.from_numpy(lens).to(scl.device)
    fused = lambda: scl._full(scl.shards, scl.maps, scl.map_off,  # noqa: E731
                              len(scl.ref_names), p, ln)
    row = checked_device_ms(fused)
    del row["rows"]
    stages["sharded chunk (fused)"] = dict(span_ms=cuda_ms(fused), **row)
    scl.exact_fallback = False
    t0 = time.time()
    batch = checked_device_ms(lambda: scl.classify_batch(reads, block=BLOCK),
                              n=1)
    wall_ms = (time.time() - t0) * 1e3  # one call unprofiled, one profiled
    scl.exact_fallback = True
    ev = batch.pop("rows")
    busy = batch["device_ms"]
    rows = [e for e in ev if "shard_merge_kernel" in e.key]
    m_ms = sum(e.self_device_time_total for e in rows) / 1e3
    m_n = sum(e.count for e in rows)
    merge.update(launches=launches["shard_merge"],
                 path_ms=m_ms / max(1, m_n))
    summary = dict(
        card=card, reads=n, shards=shards, n_shards=N_SHARDS, block=BLOCK,
        build_s=build_s, init_s=init_s, chunks=chunks, launches=launches,
        device_reads_per_s=spread(rates_dev),
        monolithic_device_reads_per_s_in_turns=spread(rates_mono),
        e2e_reads_per_s=spread(rates),
        fallback_fraction=fallback, plain_device_reads_per_s=plain_rate,
        agreement_vs_native=agree,
        truth_accuracy=sum(scl.tid_of(r.ref_ID) == t
                           for r, t in zip(res_s, truth)) / n,
        truth_accuracy_device_only=sum(scl.tid_of(r.ref_ID) == t
                                       for r, t in zip(res_s_dev, truth)) / n,
        differ_from_monolithic=len(differ),
        differ_from_monolithic_examples=differ[:10],
        differ_from_monolithic_device_only=differ_dev,
        stages_first_chunk=dict(W=W, reads=n_chunk, stages=stages),
        locate_split=splits, shard_calls=shard_calls,
        batch=dict(batch, device_busy_share=None if busy is None else
                   busy / (1e3 * n / spread(rates_dev)["median"]),
                   wall_ms_two_calls=wall_ms, merge_ms=m_ms,
                   merge_launches=m_n),
        merge=merge)
    if agree < AGREE_MIN:
        raise AssertionError(f"sharded path: agreement with native "
                             f"{agree:.4f} < {AGREE_MIN}")
    del scl
    return summary


def taxon_check(tids, weights, max_tid: int, timed: bool,
                want=None) -> dict:
    """K13 against its plain version (and want, where given) on CUDA
    copies of tids and weights (int32 numpy), exactly, one launch by the
    count; timed: the kernel's, the plain version's and index_add_'s cold
    ms (median of 20) beside the bound (each tid and weight read once,
    each bin written once), and the kernel's torch.profiler rows beside
    those of zeros + index_add_: one taxon_bins_kernel row and no
    memset."""
    import numpy as np
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.ops.taxon import taxon_weights, taxon_weights_plain

    t = torch.from_numpy(tids).to("cuda")
    w = torch.from_numpy(weights).to("cuda")
    before = kernels.launches["taxon_weights"]
    got = taxon_weights(t, w, max_tid)
    n_launch = kernels.launches["taxon_weights"] - before
    ref = taxon_weights_plain(t, w, max_tid)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    shape = f"B={tids.size} max_tid={max_tid}"
    if want is not None and not np.array_equal(got.cpu().numpy(), want):
        err = max(err, 1)
    if err != 0 or n_launch != 1:
        raise AssertionError(f"taxon_weights differs from its plain version "
                             f"or the exact sum (max abs err {err}) at "
                             f"{shape}, or launched {n_launch} times")
    out = dict(max_abs_err=err, shape=shape)
    if timed:
        clipped = t.clamp(0, max_tid - 1).to(torch.int64)
        bound_ms, bound_by = bound_of(8 * tids.size + 4 * max_tid, 0)
        lib = lambda: torch.zeros(max_tid, dtype=torch.int32,
                                  device="cuda").index_add_(0, clipped, w)
        out.update(
            ms=cuda_ms(lambda: taxon_weights(t, w, max_tid), 20, cold=True),
            plain_ms=cuda_ms(lambda: taxon_weights_plain(t, w, max_tid), 20,
                             cold=True),
            library_ms=cuda_ms(lib, 20, cold=True),
            bound_ms=bound_ms, bound_by=bound_by)
        rows = lambda fn: [dict(kernel=e.key[:60], count=e.count,
                                ms=e.self_device_time_total / 1e3)
                           for e in device_rows(fn)]
        for _ in range(3):  # the profiler has missed kernels (section 7)
            kern = rows(lambda: taxon_weights(t, w, max_tid))
            if any("taxon_" in r["kernel"] for r in kern):
                break
        named = [r for r in kern if "taxon_" in r["kernel"]]
        memset = [r for r in kern if "memset" in r["kernel"].lower()]
        if (len(named) != 1 or named[0]["count"] != 1
                or "taxon_bins_kernel" not in named[0]["kernel"] or memset):
            raise AssertionError(f"taxon_weights at {shape}: profiler rows "
                                 f"{kern}, expected one taxon_bins_kernel "
                                 "and no memset")
        out.update(device_rows=kern,
                   device_ms=named[0]["ms"],
                   library_device_rows=rows(lib))
        log(f"smoke: taxon_weights [{shape}] equal; kernel "
            f"{out['ms']:.4f} ms (device {out['device_ms']:.4f} ms, "
            f"{len(kern)} device rows), plain {out['plain_ms']:.4f} ms, "
            f"index_add_ {out['library_ms']:.4f} ms (device rows "
            f"{out['library_device_rows']}), bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return out


def taxon_phase(cl, res_dev) -> dict:
    """K13's checks of phase 8, run before phase 5 (late in the smoke
    torch.profiler has missed kernels, PERF.md section 7): against its
    plain version on test_torch_taxon.taxon_cases and the exact sum; on
    the tids of res_dev (max_tid = the largest + 2), at NCBI_MAX_TID, and
    at NCBI_MAX_TID on 2^17 and 2^19 pairs far past a batch (phase 3's
    tids repeated: hot bins; and tids spread over the bins, where
    index_add_'s atomic scatter gains on the kernel's blocks, each of
    which reads every pair), timed and profiled (taxon_check). Returns
    the main check with the others under other_calls, and max_tid."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_taxon import expected, taxon_cases

    cases = {}
    for name, t, w, m in taxon_cases():
        cases[name] = taxon_check(t, w.astype(np.int32), m, timed=False,
                                  want=expected(t, w, m))
    tids = np.array([cl.tid_of(r.ref_ID) for r in res_dev], np.int32)
    ones = np.ones(tids.size, np.int32)
    max_tid = int(tids.max()) + 2
    main = taxon_check(tids, ones, max_tid, timed=True)
    ncbi = taxon_check(tids, ones, NCBI_MAX_TID, timed=True)
    rng = np.random.default_rng(0)
    large = {f"B={B} {kind}": taxon_check(t.astype(np.int32),
                                          np.ones(B, np.int32),
                                          NCBI_MAX_TID, timed=True)
             for B in (1 << 17, 1 << 19)
             for kind, t in (("hot", np.resize(tids, B)),
                             ("spread", rng.integers(0, NCBI_MAX_TID, B)))}
    return dict(main, max_tid=max_tid, other_calls=dict(
        ncbi=ncbi, large=large, taxon_cases=cases))


def data_parallel_phase(cl, idx, reads, chunks: dict, res_dev,
                        gidx_dir: str, taxon: dict) -> dict:
    """Phase 8: the data-parallel classifier at one rank over NCCL on
    cl's tables, held to the one-device path, with K13's time on that
    path; two ranks over gloo on this card (parallel.dryrun, on the
    golden index in gidx_dir). taxon: taxon_phase's checks, returned
    under `taxon` with the mesh run's launches and the path time."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import FastClassifier
    from desamba_tpu_torch.ops import taxon as taxon_mod
    from desamba_tpu_torch.parallel import (init_distributed, make_mesh,
                                            taxon_weight_step)
    from desamba_tpu_torch.parallel.dryrun import free_port

    t_phase = time.time()
    n = len(reads)
    ones = np.ones(n, np.int32)
    max_tid = taxon["max_tid"]

    # one rank over NCCL: this process is the whole group
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(device="cuda")
        mcl = FastClassifier(idx, mesh=mesh, exact_fallback=False,
                             tables=(cl.fm, cl.ek, cl.loc, cl.ra))
        for W, (packed, lens, _) in chunks.items():
            got = np.asarray(mcl._run_mesh(packed, lens))
            ref = np.asarray(cl._run(packed, lens))
            if not np.array_equal(got, ref):
                raise AssertionError(f"_run_mesh at W={W} differs from one "
                                     f"device's _run on "
                                     f"{int((got != ref).any(0).sum())} rows")
        kernels.reset_launches()
        res_m = mcl.classify_batch(reads, block=BLOCK)
        tids_m = np.array([mcl.tid_of(r.ref_ID) for r in res_m], np.int32)
        wts = taxon_weight_step(mesh, max_tid)(tids_m, ones).cpu().numpy()
        torch.cuda.synchronize()
        launches = {k: kernels.launches[k]
                    for k in (*FAST_KERNELS, "taxon_weights")}
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the mesh path was not "
                                 f"launched: {launches}")
        if tup(res_m) != tup(res_dev):
            bad = sum(x != y for x, y in zip(tup(res_m), tup(res_dev)))
            raise AssertionError(f"the mesh path differs from one device's "
                                 f"on {bad} of {n} reads")
        if not (np.array_equal(wts, np.bincount(tids_m, minlength=max_tid))
                and int(wts.sum()) == n):
            raise AssertionError(f"taxon weights {wts.sum()} differ from "
                                 "the host bincount")
        # K13 on the path: CUDA events around its call in the taxon step
        # (median of 10 steps, after one)
        kern, ts = taxon_mod.taxon_weights, []

        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = kern(*args)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
            return out

        taxon_mod.taxon_weights = timed
        try:
            step = taxon_weight_step(mesh, max_tid)
            for _ in range(11):
                step(tids_m, ones)
        finally:
            taxon_mod.taxon_weights = kern
        path_ms = statistics.median(ts[1:])
        # pure-device reads/s in turns: one device, mesh, mesh, one device
        was = cl.exact_fallback
        cl.exact_fallback = False
        rates = {"one_device": [], "mesh_nccl_1": []}
        try:
            for key in ("one_device", "mesh_nccl_1", "mesh_nccl_1",
                        "one_device"):
                c = cl if key == "one_device" else mcl
                t0 = time.time()
                c.classify_batch(reads, block=BLOCK)
                torch.cuda.synchronize()
                rates[key].append(n / (time.time() - t0))
        finally:
            cl.exact_fallback = was
        backend = dist.get_backend()
        del mcl
    finally:
        dist.destroy_process_group()
    t_nccl = time.time() - t_phase
    log(f"smoke: mesh over {backend} (1 rank) == one device on all {n} "
        f"reads; reads/s one device {rates['one_device']}, mesh "
        f"{rates['mesh_nccl_1']}")

    # two ranks over gloo on this one card
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "desamba_tpu_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cuda", "--backend", "gloo", "--index",
         gidx_dir, "--timeout", "150"], cwd=ROOT, capture_output=True,
        text=True, timeout=170)
    if p.returncode != 0:
        raise RuntimeError(f"parallel.dryrun --nproc 2 failed "
                           f"({p.returncode}):\n{p.stderr[-4000:]}")
    rank_launches = [json.loads(ln.split(" launches ", 1)[1])
                     for ln in p.stdout.splitlines() if " launches " in ln]
    ok = [ln for ln in p.stdout.splitlines()
          if ln.startswith("dryrun_multichip: ok on 2 processes")]
    if len(rank_launches) != 2 or not all(
            sum(r.values()) and r.get("taxon_weights") for r in rank_launches):
        raise AssertionError(f"a rank launched no kernel: {rank_launches}")
    if len(ok) != 1:
        raise AssertionError(f"no ok line from the dryrun: {p.stdout}")
    log(f"smoke: {ok[0]}")
    secs = time.time() - t_phase
    log(f"smoke: phase 8 took {secs:.1f} s (budget {PHASE8_BUDGET_S} s)")
    return dict(
        taxon=dict({k: v for k, v in taxon.items() if k != "max_tid"},
                   launches=launches["taxon_weights"], path_ms=path_ms),
        mesh_nccl_world1=dict(
            backend=backend, reads=n, launches=launches,
            equal_to_one_device=True, raw_chunks_equal=sorted(chunks),
            taxon_total=int(wts.sum()), max_tid=max_tid,
            device_reads_per_s=rates, seconds=t_nccl),
        gloo_world2_one_card=dict(
            ok_line=ok[0], rank_launches=rank_launches,
            seconds=time.time() - t0),
        seconds=secs)


# bench.prepare in a child process, with its cache and sizes as arguments;
# FASTA_ONLY writes only the community FASTA, where bench.prepare writes
# it and as it does (bench.py:70-78; bench.prepare then finds it), and
# prints its path
PREPARE = ("import json, sys, bench\n"
           "bench.CACHE, bench.SCALE_BP, bench.N_READS = sys.argv[1], "
           "int(float(sys.argv[2])), int(sys.argv[3])\n")
FASTA_ONLY = ("import os\n"
              "from desamba_tpu.io.fastx import write_fasta\n"
              "from scale_data import make_community\n"
              "os.makedirs(bench.CACHE, exist_ok=True)\n"
              "fa = os.path.join(bench.CACHE, "
              "f'ref_{bench.SCALE_BP // 1_000_000}M.fa')\n"
              "if not os.path.exists(fa):\n"
              "    write_fasta(fa, make_community(\n"
              "        seed=2024, n_genera=64, "
              "target_total=bench.SCALE_BP)[0])\n"
              "print(json.dumps(fa))\n")


def prepare(code: str) -> str:
    """The last line that the child running PREPARE + code prints."""
    p = subprocess.run([sys.executable, "-c", PREPARE + code, CACHE,
                        str(SCALE_BP), str(N_READS)], cwd=ROOT,
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"bench.prepare failed:\n{p.stderr[-4000:]}")
    if p.stderr.strip():
        log(p.stderr.strip())
    return json.loads(p.stdout.strip().splitlines()[-1])


def make_data(shards: bool = False) -> tuple:
    """(community FASTA, reads FASTQ, index directory) of the bench data,
    made once under CACHE by bench.prepare in a child process. With
    shards, also (shard root, seconds): the community's N_SHARDS genome
    shards (start_sharded_index), built at the same time as the index,
    so that the two builds (~350-450 s and ~200-300 s on the card's host)
    overlap; a first child writes the FASTA, which both read, and the
    smoke's measurements start only after both."""
    if not shards:
        return tuple(prepare("print(json.dumps(bench.prepare()))\n"))
    build = start_sharded_index(prepare(FASTA_ONLY))
    fa, fq, idx_dir = prepare("print(json.dumps(bench.prepare()))\n")
    return (fa, fq, idx_dir, *finish_sharded_index(*build))


def truth_tid(name: str) -> int:
    """The simulated source taxon in a bench read's name (bench.py:58)."""
    return int(name.split("_")[1].split(".")[0])


def agreement(cl, reads, res) -> tuple[float, list]:
    """(share of reads whose taxon equals the native engine's primary
    hit's, the native taxa): the logic of bench.check_accuracy over all
    reads."""
    from desamba_tpu_torch.engine.native import NativeClassifier

    nat = NativeClassifier(cl.idx, n_threads=os.cpu_count() or 1)
    t0 = time.time()
    nres = nat.classify_batch(reads)
    dt = time.time() - t0
    nt = [cl.tid_of(next((h.ref_ID for h in r.hits if h.primary == 1), -1))
          for r in nres]
    agree = sum(cl.tid_of(r.ref_ID) == t for r, t in zip(res, nt)) / len(
        reads)
    acc_n = sum(t == truth_tid(r[0]) for r, t in zip(reads, nt)) / len(reads)
    log(f"smoke: native engine {len(reads)} reads in {dt:.1f} s; "
        f"agreement {agree:.4f}, native truth accuracy {acc_n:.4f}")
    return agree, nt


def main() -> int:
    if not (os.path.isdir(os.path.join(ROOT, "desamba_tpu_torch"))
            and os.path.isfile(os.path.join(ROOT, "bench.py"))
            and os.path.isdir(os.path.join(ROOT, "native"))):
        log("chip_smoke: not inside a checkout of the repository")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; needs a GPU")
        return 3
    sys.path.insert(0, ROOT)
    t_start = time.time()

    # ---- phase 1: card, software, kernel build
    card = card_line()
    print(card, flush=True)
    sw = software()
    print("software " + json.dumps(sw), flush=True)
    from desamba_tpu_torch import kernels

    t0 = time.time()
    info = kernels.build_all(extra=("measure.cu",))
    t_build = time.time() - t0
    print(f"kernels built in {t_build:.2f} s", flush=True)
    for name, d in info.items():
        regs = [ln.strip() for ln in d["log"].splitlines()
                if "registers" in ln]
        log(f"smoke: {name}: {' | '.join(regs) or d['log'][:200]}")
    ptxas = ptxas_report(info)
    print("ptxas " + json.dumps(
        {k: ptxas[k] for k in ("stage1", "row_walks", "combine",
                               "shard_merge")}), flush=True)
    sass = band_sass(info["band_score_packed"]["path"])
    print("band_score_packed SASS " + json.dumps(sass), flush=True)
    from desamba_tpu_torch.engine.native import ensure_built

    ensure_built()

    # ---- phase 2: data, classifier, kernel-vs-plain checks
    from desamba_tpu_torch.convert import build_tables
    from desamba_tpu_torch.engine.fast_engine import FastClassifier, PLAIN_OPS
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.io.fastx import read_fastx

    t0 = time.time()
    _, fq, idx_dir, *shard_index = make_data(shards=True)
    t_data = time.time() - t0
    t0 = time.time()
    idx = load_index(idx_dir)
    cl = FastClassifier(idx, device="cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    reads = [(r.name, r.seq, r.qual) for r in read_fastx(fq)]
    n = len(reads)
    print(f"data {SCALE_BP / 1e6:.1f} Mbp, L={idx.L}, "
          f"{len(idx.ref_names)} genomes, {n} reads: prepare (the index and "
          f"the shards at once) {t_data:.1f} s, "
          f"index load + tables on device {t_init:.1f} s", flush=True)

    chunks = first_chunks(cl, reads)
    cap = kernel_inputs(cl, *chunks[min(chunks)][:2])
    checks = check_kernels(cap)
    measure = info["measure.cu"]["path"]
    c_args = cap["combine"][0]
    checks["combine"].update(kernel_floors(
        measure, "combine", c_args, PLAIN_OPS["combine"](*c_args)))
    splits = {f"W={min(chunks)}": locate_split(measure, cap["locate"][0],
                                               f"W={min(chunks)}")}
    sweep = walk_sweep(measure, cap["row_walks"][0])
    k1_floors = {f"W={min(chunks)}": {key: k1_floor(measure, *cap[key])
                                      for key in K1_CALLS}}
    s1_args = cap["stage1"][0]
    floors = {f"W={min(chunks)}": stage1_floor(
        measure, s1_args, PLAIN_OPS["stage1"](*s1_args))}
    s1_cases = check_stage1_cases()
    t0 = time.time()
    gidx_dir = make_golden_index()
    gidx = load_index(gidx_dir)
    t_golden = time.time() - t0
    vote_checks, full_checks, caps = check_vote(cl, reads,
                                                build_tables(gidx, "cpu"))
    for W in sorted(chunks)[1:]:
        caps[W] = kernel_inputs(cl, *chunks[W][:2])
        k1_floors[f"W={W}"] = {key: k1_floor(measure, *caps[W][key])
                               for key in K1_CALLS}
        s1_args = caps[W]["stage1"][0]
        floors[f"W={W}"] = stage1_floor(measure, s1_args,
                                        PLAIN_OPS["stage1"](*s1_args))
    more = {f"W={W}": check_chunk_calls(c, f"W={W}")
            for W, c in sorted(caps.items())}
    for W in sorted(chunks)[1:]:
        splits[f"W={W}"] = locate_split(measure, caps[W]["locate"][0],
                                        f"W={W}")
    back_to_back = check_back_to_back([cap, *caps.values()])
    print("locate_split " + json.dumps(dict(card=card, **splits)),
          flush=True)
    print("k1_floor " + json.dumps(dict(card=card, **k1_floors)),
          flush=True)
    print("stage1_row_walks " + json.dumps(dict(
        card=card, first_chunk={k: checks[k] for k in checks
                                if k.startswith(("stage1", "row_walks"))},
        other_chunks={W: {k: v for k, v in c.items()
                          if k.startswith(("stage1", "row_walks"))}
                      for W, c in more.items()},
        row_walks_cap_sweep=sweep,
        stage1_bloom_floor=floors, stage1_cases=s1_cases)), flush=True)
    band_checks = check_band(cl, caps, sass)
    k8_args = cap["band_score_packed"][0]
    checks["band_score_packed"]["bound_old_ms"] = bound_of(
        0, band_ops_swar(k8_args[0], k8_args[5]))[0]
    log(f"smoke: band_score_packed (W={16 * k8_args[0].shape[1]}, first "
        f"chunk): SWAR 25-op bound "
        f"{checks['band_score_packed']['bound_old_ms']:.4f} ms; SASS "
        f"{sass['per_read_word_offset']} instructions a (read word, "
        "offset)")
    del cap, caps, k8_args
    t0 = time.time()
    cl.classify_batch(reads, block=BLOCK)
    log(f"smoke: warm pass {time.time() - t0:.1f} s")

    # ---- phase 3: the main path
    kernels.reset_launches()
    rates, fallback = [], []
    res = None
    for it in range(3):
        cl.stats = dict(n_reads=0, n_fallback=0)
        t0 = time.time()
        res = cl.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        dt = time.time() - t0
        rates.append(n / dt)
        fallback.append(cl.stats["n_fallback"] / max(1, cl.stats["n_reads"]))
        log(f"smoke: run {it}: {n} reads in {dt:.3f} s = {n / dt:.1f} "
            f"reads/s (fallback {fallback[-1]:.4f})")
    launches = {k: kernels.launches[k] for k in FAST_KERNELS}
    if not all(launches[k] > 0 for k in FAST_KERNELS):
        raise AssertionError(f"a kernel was not launched: {launches}")
    # launches a chunk (stage 1 launches once a chunk): stages 0, 3 and 4
    # (locate and the vote each) and stage 2's row grid once; the two
    # loops three times, the compactions four
    per_chunk = dict(unpack=1, interval_search=3, compact=4, row_grid=1,
                     row_walks=3, locate=1, vote=1, band_windows=1,
                     band_score_packed=1, combine=1)
    off = {k: v for k, v in per_chunk.items()
           if launches[k] != v * launches["stage1"]}
    if off:
        raise AssertionError(f"launches a chunk other than {per_chunk}: "
                             f"{launches}")
    print("launches per batch " + json.dumps(  # of the three runs
        {k: v / 3 for k, v in launches.items()}), flush=True)
    if len(res) != n or any(r is None for r in res):
        raise AssertionError("classify_batch left reads without a result")
    cl.exact_fallback = False
    rates_dev = []
    for it in range(3):
        t0 = time.time()
        res_dev = cl.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        rates_dev.append(n / (time.time() - t0))
    cl.exact_fallback = True
    agree, native_tids = agreement(cl, reads, res)
    truth = [truth_tid(r[0]) for r in reads]
    acc = sum(cl.tid_of(r.ref_ID) == t for r, t in zip(res, truth)) / n
    acc_dev = sum(cl.tid_of(r.ref_ID) == t
                  for r, t in zip(res_dev, truth)) / n
    summary = dict(card=card, reads=n, scale_mbp=SCALE_BP / 1e6,
                   block=BLOCK, e2e_reads_per_s=rates,
                   e2e_reads_per_s_best=max(rates),
                   device_reads_per_s=rates_dev,
                   device_reads_per_s_best=max(rates_dev),
                   fallback_fraction=fallback,
                   agreement_vs_native=agree, truth_accuracy=acc,
                   truth_accuracy_device_only=acc_dev,
                   build_s=t_build, prepare_s=t_data, init_s=t_init)
    print("main_path " + json.dumps(summary), flush=True)
    if agree < AGREE_MIN:
        raise AssertionError(f"device-vs-native agreement {agree:.4f} < "
                             f"{AGREE_MIN}")
    bad = [r for r in res if not (r.read_len > 0 and r.score >= 0
                                  and r.direction in (0, 1))]
    if bad:
        raise AssertionError(f"{len(bad)} malformed results, e.g. {bad[0]}")

    # ---- phase 4: kernel path == plain path, and what the kernels buy
    plain_cl = FastClassifier(idx, device="cuda", plain=True,
                              exact_fallback=False,
                              tables=(cl.fm, cl.ek, cl.loc, cl.ra))
    rates_plain = []
    for it in range(3):
        t0 = time.time()
        res_plain = plain_cl.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        rates_plain.append(n / (time.time() - t0))
    if tup(res_dev) != tup(res_plain):
        bad = sum(x != y for x, y in zip(tup(res_dev), tup(res_plain)))
        raise AssertionError(f"kernel path and plain path differ on {bad} "
                             f"of {n} reads")
    # every read above LONG_WIDTH through _classify_long (segments of
    # LONG_WIDTH at W = LONG_WIDTH), kernels against plain versions
    long_k, long_p = (FastClassifier(
        idx, device="cuda", plain=pl, exact_fallback=False,
        max_width=LONG_WIDTH, tables=(cl.fm, cl.ek, cl.loc, cl.ra))
        for pl in (False, True))
    res_long = long_k.classify_batch(reads, block=BLOCK)
    if tup(res_long) != tup(long_p.classify_batch(reads, block=BLOCK)):
        raise AssertionError(f"max_width={LONG_WIDTH}: kernel path and "
                             f"plain path differ")
    n_long = sum(len(r[1]) > LONG_WIDTH for r in reads)
    del long_k, long_p
    print("kernel path == plain path on all reads; plain_path "
          + json.dumps(dict(card=card, reads=n,
                            device_reads_per_s=rates_plain,
                            device_reads_per_s_best=max(rates_plain),
                            whole_pipeline_other_widths=full_checks,
                            long_reads_equal=dict(
                                max_width=LONG_WIDTH, long_reads=n_long))),
          flush=True)
    if n_long == 0:
        raise AssertionError(f"no read is longer than {LONG_WIDTH}")

    # K13's checks of phase 8, while torch.profiler sees every kernel
    taxon = taxon_phase(cl, res_dev)

    # ---- phase 5: where the time goes
    tg = where_time_goes(cl, chunks, reads, card, checks["vote"])
    print("time " + json.dumps(tg), flush=True)
    for key, row in tg["stages"].items():
        for st in ("0 unpack", "2 FM search+walks", "3 locate+vote",
                   "4 band rescore", "fused"):
            r = row[st]
            log(f"smoke: stage {st} at {key}: device {r['device_ms']:.3f} "
                f"ms, span {r['span_ms']:.3f} ms, "
                f"{r['kernels_per_call']:.0f} launches a call")
        r1 = row["1 probe+seeds"]
        log(f"smoke: stage 1 probe+seeds at {key}: device "
            f"{r1['device_ms']:.3f} ms, span {r1['span_ms']:.3f} ms, bound "
            f"{r1['bound_ms']:.4f} ms (full-build bound "
            f"{r1['bound_old_ms']:.4f} ms)")
        r3 = row["3 locate+vote"]
        log(f"smoke: vote (K7) at {key}: kernel {r3['vote_ms']:.4f} ms, "
            f"bound {r3['vote_bound'][0]:.4f} ms ({r3['vote_bound'][1]})")
        for st, most in (("2 FM search+walks", STAGE2_MAX_LAUNCHES),
                         ("3 locate+vote", STAGE3_MAX_LAUNCHES)):
            n_st = row[st]["kernels_per_call"]
            if n_st > most:
                raise AssertionError(f"stage {st} launched {n_st} kernels "
                                     f"a chunk at {key} (at most {most})")
    on_path = tg["batch"]["hand_kernels"]

    # ---- phase 6: the validation engine
    val = validation_phase(cl, reads, card, gidx, t_golden)
    print("validation " + json.dumps(
        {k: v for k, v in val.items() if k != "checks"}), flush=True)
    vc = val["checks"]

    rows = [dict(name=k, route="cuda", source=kernels.source_path(k),
                 replaces=REPLACES[k], launches=launches[k],
                 **{f: checks[k][f] for f in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "shape")},
                 path_ms=on_path[k]["ms_per_launch"],
                 index_list={key: checks[key] for key in checks
                             if key.startswith(k + "[")})
            for k in FAST_KERNELS]
    # K1 on the validation path: its first call there and its launches;
    # the vote's checks at the other widths and on vote_cases
    names = [r["name"] for r in rows]
    rows[names.index("interval_search")]["validation_path"] = vc[
        "interval_search"]
    rows[names.index("interval_search")].update(
        floor=k1_floors, other_calls={
            W: {k: v for k, v in c.items() if k.startswith("interval")}
            for W, c in more.items()})
    rows[names.index("vote")].update(
        other_calls=vote_checks,
        chunk_calls={W: c["vote"] for W, c in more.items()})
    rows[names.index("stage1")].update(
        bound_old_ms=checks["stage1"]["bound_old_ms"], ptxas=ptxas["stage1"],
        other_calls={W: c["stage1"] for W, c in more.items()},
        bloom_floor=floors, cases=s1_cases)
    rows[names.index("row_walks")].update(
        ptxas=ptxas["row_walks"], cap_sweep=sweep,
        other_calls={W: {k: v for k, v in c.items()
                         if k.startswith("row_walks")}
                     for W, c in more.items()})
    for k in ("compact", "row_grid", "locate", "unpack", "band_windows",
              "combine"):
        rows[names.index(k)]["other_calls"] = {
            W: {key: v for key, v in c.items() if key.split("[")[0] == k}
            for W, c in more.items()}
    for k in BACK_TO_BACK:
        rows[names.index(k)]["back_to_back"] = back_to_back
    rows[names.index("locate")]["split"] = splits
    k8 = rows[names.index("band_score_packed")]
    k8.update(bound_old_ms=checks["band_score_packed"]["bound_old_ms"],
              sass=sass, other_calls=band_checks)
    rows += [dict(name=k, route="cuda", source=kernels.source_path(k),
                  replaces=REPLACES[k], **vc[k])
             for k in ("probe_reads", "row_walks_trace")]

    # ---- phase 7: the genome-sharded classifier
    sh = sharded_phase(cl, reads, shard_index, card, res, res_dev,
                       native_tids, measure)
    rows[names.index("locate")]["split"].update(sh["locate_split"])
    for k in ("interval_search", "vote"):
        rows[names.index(k)]["shards"] = {
            label: {key: v for key, v in c.items() if key.startswith(k)}
            for label, c in sh["shard_calls"].items()}
    print("sharded " + json.dumps(sh), flush=True)
    rows.append(dict(name="shard_merge", route="cuda",
                     source=kernels.source_path("shard_merge"),
                     replaces=REPLACES["shard_merge"], **sh["merge"]))
    print("ranking " + json.dumps(dict(card=card, kernels=ranking(
        checks, more, on_path, launches, sh["merge"]))), flush=True)

    # ---- phase 8: the data-parallel classifier and K13
    dp = data_parallel_phase(cl, idx, reads, chunks, res_dev, gidx_dir,
                             taxon)
    print("data_parallel " + json.dumps(
        {k: v for k, v in dp.items() if k != "taxon"}), flush=True)
    rows.append(dict(name="taxon_weights", route="cuda",
                     source=kernels.source_path("taxon_weights"),
                     replaces=REPLACES["taxon_weights"], **dp["taxon"]))
    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "desamba_tpu",
                                      "bench")]
    if foreign:
        raise AssertionError(f"the smoke imported {foreign[:5]}")
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    # the cards torch sees (the smoke needs and uses one)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
