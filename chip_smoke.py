"""Smoke run of the torch port on one NVIDIA GPU: builds the hand CUDA
kernels, holds each against its plain torch version, drives the fast
classify path at the bench's scale, checks its calls, and says where the
card's time goes.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero):
  1. the card (nvidia-smi name and power limit) and the software; nvcc
     builds the kernels (timed)
  2. the bench's community index and reads (bench.prepare, cached under
     build/bench_cache), the port's FastClassifier on "cuda"; the stages
     run once on the first full chunk of the narrowest width bucket,
     recording each kernel's inputs there, and each kernel is held
     against its plain version on them: equal exactly, both timed with
     CUDA events (median of 20); then one warm classify_batch
  3. the main path: launch counts set to 0, classify_batch three times
     (end-to-end reads/s, fallback fraction), counts read; then three
     pure-device runs (reads/s) and bench.check_accuracy (device-vs-native
     agreement, gated at 0.99 as bench.py gates it; truth accuracy)
  4. every read through a classifier running the plain versions
     (pure-device reads/s, three runs): FastResults identical to the
     kernel path's pure-device run
  5. where the time goes: for the first full chunk of each width bucket,
     each stage's CUDA-event span (median of 10; it includes the host's
     launch gaps) beside its device time (the summed kernel rows of
     torch.profiler, per call, over 5 calls); then one pure-device
     classify_batch unprofiled and one under torch.profiler: device busy
     share = kernel time over the unprofiled wall
Prints a `kernels` JSON line, then {"ok": true, "device": {...}} last.
Exits nonzero without a result when no CUDA device is visible or when
run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE_BP = 100e6      # bench.py's community size
N_READS = 8192        # bench.py's read count
BLOCK = 4096          # bench.py's chunk size
AGREE_MIN = 0.99      # bench.py's accuracy gate
REPLACES = {
    "interval_search": "desamba_tpu/ops/fm.py:165",
    "row_walks": "desamba_tpu/ops/fm.py:261",
    "band_score_packed": "desamba_tpu/ops/matchblock.py:201",
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


def max_abs_err(x, y) -> int:
    import torch

    if isinstance(x, dict):
        if set(x) != set(y):
            raise AssertionError(f"outputs {sorted(x)} vs {sorted(y)}")
        return max(max_abs_err(x[k], y[k]) for k in x)
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{x.shape} {x.dtype} vs {y.shape} {y.dtype}")
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def cuda_ms(fn, n: int = 10) -> float:
    """Median ms of n calls of fn, CUDA events around each (after one
    untimed call)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
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


def device_ms(fn, n: int = 5):
    """(device ms per call, kernels per call) of fn over n profiled calls."""
    fn()

    def calls():
        for _ in range(n):
            fn()

    ev = device_rows(calls)
    return (sum(e.self_device_time_total for e in ev) / 1e3 / n,
            sum(e.count for e in ev) / n)


def first_chunks(cl, reads) -> dict:
    """{W: (packed, lens, n_reads)}: the first full chunk of each width
    bucket, encoded as classify_batch encodes it."""
    from desamba_tpu.engine.fast_engine import _bucket

    by_w: dict = {}
    for r in reads:
        by_w.setdefault(_bucket(max(len(r[1]), cl.ek.lek + 2)), []).append(r)
    out = {}
    for W in sorted(by_w):
        chunk = by_w[W][:BLOCK]
        packed, lens, _ = cl._encode(chunk, W=W, Bp=BLOCK)
        out[W] = (packed, lens, len(chunk))
    return out


def stage_calls(cl, packed, lens, ops) -> dict:
    """Run stages 0-4 once on an encoded chunk; returns {stage: fn}, each
    fn calling one stage on the saved output of the stage before it, and
    "fused" calling the whole pipeline."""
    import torch

    from desamba_tpu.engine.fast_engine import ROWS_PER_SEARCH, _band
    from desamba_tpu_torch.engine import fast_engine as tfe

    ek = cl.ek
    s1, s2, s3, s4 = tfe.build_stages(ek.lek, ek.single_base_max,
                                      ek.mask_bits, 20, ek.n_words0, ops)
    p = torch.from_numpy(packed).to(cl.device)
    ln = torch.from_numpy(lens).to(cl.device)
    codes2, l2 = tfe.stage0_unpack(p, ln)
    o1 = s1(ek.w01, codes2, l2)
    ci = codes2.to(torch.int32)
    o2 = s2(cl.fm, ci, l2, *o1[:3])
    B2, W = codes2.shape
    nwR = o1[1].shape[1] * ROWS_PER_SEARCH
    o3 = s3(cl.fm, cl.loc, l2, *o2, B2=B2, nwR=nwR)
    rw = tfe._read_words(p)
    K = 2 * _band(W) + 16
    return {
        "0 unpack": lambda: tfe.stage0_unpack(p, ln),
        "1 probe+seeds": lambda: s1(ek.w01, codes2, l2),
        "2 FM search+walks": lambda: s2(cl.fm, ci, l2, *o1[:3]),
        "3 locate+vote": lambda: s3(cl.fm, cl.loc, l2, *o2, B2=B2, nwR=nwR),
        "4 band rescore": lambda: s4(cl.ra, rw, l2, *o3, B2=B2, K=K),
        "fused": lambda: cl._full(cl.fm, cl.loc, cl.ra, ek.w01, p, ln),
    }


def kernel_inputs(cl, packed, lens) -> dict:
    """{kernel: args of its first call} when the stages run on a chunk."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    cap: dict = {}

    def recording(name, fn):
        def call(*args):
            cap.setdefault(name, args)
            return fn(*args)
        return call

    ops = tuple(recording(k, f) for k, f in zip(kernels.KERNELS, KERNEL_OPS))
    stage_calls(cl, packed, lens, ops)["4 band rescore"]()
    return cap


def check_kernels(cap: dict) -> dict:
    """Each kernel against its plain version on its captured inputs."""
    import torch

    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS, PLAIN_OPS

    shapes = {
        "interval_search": lambda a: (f"n={a[6].shape[1]} "
                                      f"W={a[1].shape[1]} steps={a[7]}"),
        "row_walks": lambda a: f"n={a[4].shape[1]} cap={a[5]}",
        "band_score_packed": lambda a: (f"rows={a[0].shape[0]} "
                                        f"W={16 * a[0].shape[1]} K={a[5]}"),
    }
    out = {}
    for name, kern, plain in zip(kernels.KERNELS, KERNEL_OPS, PLAIN_OPS):
        args = cap[name]
        shape = shapes[name](args)
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err}) at {shape}")
        ms = cuda_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 20)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         shape=shape)
        log(f"smoke: {name} [{shape}] equal; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
    return out


def where_time_goes(cl, chunks: dict, reads, card: str) -> dict:
    """Per-stage event span and device time on each bucket's first full
    chunk; device busy share of one pure-device classify_batch."""
    import torch

    from desamba_tpu_torch.engine.fast_engine import KERNEL_OPS

    stages = {}
    for W, (packed, lens, n_chunk) in chunks.items():
        row = {}
        for name, fn in stage_calls(cl, packed, lens, KERNEL_OPS).items():
            dev, nk = device_ms(fn)
            row[name] = dict(span_ms=cuda_ms(fn), device_ms=dev,
                             kernels_per_call=nk)
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
    return dict(card=card, stages=stages, batch=dict(
        reads=len(reads), wall_ms_unprofiled=wall * 1e3,
        wall_ms_profiled=box["wall"] * 1e3, device_ms=busy * 1e3,
        device_busy_share=busy / wall, top_kernels=top))


def main() -> int:
    if not (os.path.isdir(os.path.join(ROOT, "desamba_tpu_torch"))
            and os.path.isfile(os.path.join(ROOT, "bench.py"))):
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
    info = kernels.build_all()
    t_build = time.time() - t0
    print(f"kernels built in {t_build:.2f} s", flush=True)
    for name, d in info.items():
        regs = [ln.strip() for ln in d["log"].splitlines()
                if "registers" in ln]
        log(f"smoke: {name}: {' | '.join(regs) or d['log'][:200]}")
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"),
                    "libdesamba_host.so"], check=True, capture_output=True)

    # ---- phase 2: data, classifier, kernel-vs-plain checks
    import bench
    from desamba_tpu.index.format_ref import RefFormatIndex
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.oracle.classify import OracleIndex
    from desamba_tpu_torch.engine.fast_engine import FastClassifier

    bench.CACHE = os.path.join(ROOT, "build", "bench_cache")
    bench.SCALE_BP = int(SCALE_BP)
    bench.N_READS = N_READS
    t0 = time.time()
    _fa, fq, idx_dir = bench.prepare()
    t_data = time.time() - t0
    t0 = time.time()
    oi = OracleIndex(RefFormatIndex(idx_dir))
    cl = FastClassifier(oi, device="cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    reads = [(r.name, r.seq, r.qual) for r in read_fastx(fq)]
    n = len(reads)
    print(f"data {bench.SCALE_BP / 1e6:.1f} Mbp, L={oi.L}, "
          f"{len(oi.ref_names)} genomes, {n} reads: prepare {t_data:.1f} s, "
          f"index load + tables on device {t_init:.1f} s", flush=True)

    chunks = first_chunks(cl, reads)
    checks = check_kernels(kernel_inputs(cl, *chunks[min(chunks)][:2]))
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
    launches = dict(kernels.launches)
    if not all(launches[k] > 0 for k in kernels.KERNELS):
        raise AssertionError(f"a kernel was not launched: {launches}")
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
    agree = bench.check_accuracy(cl, reads, res)
    truth = [bench.truth_tid(r[0]) for r in reads]
    acc = sum(cl.tid_of(r.ref_ID) == t for r, t in zip(res, truth)) / n
    acc_dev = sum(cl.tid_of(r.ref_ID) == t
                  for r, t in zip(res_dev, truth)) / n
    summary = dict(card=card, reads=n, scale_mbp=bench.SCALE_BP / 1e6,
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
    plain_cl = FastClassifier(oi, device="cuda", plain=True,
                              exact_fallback=False,
                              tables=(cl.fm, cl.ek, cl.loc, cl.ra))
    rates_plain = []
    for it in range(3):
        t0 = time.time()
        res_plain = plain_cl.classify_batch(reads, block=BLOCK)
        torch.cuda.synchronize()
        rates_plain.append(n / (time.time() - t0))
    tup = lambda rs: [(r.name, r.ref_ID, r.direction, r.score, r.read_len,
                       r.pos) for r in rs]
    if tup(res_dev) != tup(res_plain):
        bad = sum(x != y for x, y in zip(tup(res_dev), tup(res_plain)))
        raise AssertionError(f"kernel path and plain path differ on {bad} "
                             f"of {n} reads")
    print("kernel path == plain path on all reads; plain_path "
          + json.dumps(dict(card=card, reads=n,
                            device_reads_per_s=rates_plain,
                            device_reads_per_s_best=max(rates_plain))),
          flush=True)

    # ---- phase 5: where the time goes
    print("time " + json.dumps(where_time_goes(cl, chunks, reads, card)),
          flush=True)

    jax_mods = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "jaxlib", "desamba_tpu.ops"))]
    if jax_mods:
        raise AssertionError(f"jax modules were imported: {jax_mods[:5]}")
    rows = [dict(name=k, route="cuda", source=kernels.source_path(k),
                 replaces=REPLACES[k], launches=launches[k],
                 max_abs_err=checks[k]["max_abs_err"], ms=checks[k]["ms"],
                 plain_ms=checks[k]["plain_ms"], shape=checks[k]["shape"])
            for k in kernels.KERNELS]
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
