"""Command line for the torch port: `classify`, with the engines of
desamba_tpu/cli.py's classify that the port has.

    python -m desamba_tpu_torch.cli classify
        [--engine native|tpu|sharded|fast] [-t 4] [-s 64] [-l 170] [-r 5]
        [-f SAM|SAM_FULL|DES|DES_FULL] [--device cuda] [-o out.txt]
        [--timers] [--profile DIR] <index_dir> <reads.fq> [...]

`--engine native` (the default) classifies with the bit-exact host C++
engine over `-t` threads and writes the reference's SAM (-f SAM_FULL
with each read's sequence and qualities) or its DES / DES_FULL dumps. An
index directory that holds shards.json is a genome-sharded index: it
goes to the host ShardedEngine, whatever --engine says, which writes the
native SAM. `--engine fast` runs the device pipeline on --device and
writes one `name<TAB>ref<TAB>direction<TAB>score<TAB>read_len` line per
read: a reader thread parses FASTQ batches into a bounded queue while
the main thread runs the pipeline and writes results. `--engine tpu`
writes the bit-exact validation engine's SAM, computed on --device. The
native and sharded engines ignore --device. Output and the stderr report
are those of `desamba_tpu.cli classify` with the same options.
"""
from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time

from .utils.timers import (SectionTimes, cputime, device_trace,
                           report_peak_rss)


def classify_args(argv):
    ap = argparse.ArgumentParser(prog="desamba_tpu_torch classify")
    ap.add_argument("index_dir")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-t", type=int, default=4,
                    help="threads (native engine workers)")
    ap.add_argument("-l", type=int, default=170, help="min matching length")
    ap.add_argument("-r", type=int, default=5,
                    help="max secondary alignments")
    ap.add_argument("-o", default=None, help="output file [stdout]")
    ap.add_argument("-s", type=int, default=64, help="min score")
    ap.add_argument("-f", default="SAM",
                    choices=["SAM", "SAM_FULL", "DES", "DES_FULL"])
    ap.add_argument("--engine", default="native",
                    choices=["native", "tpu", "sharded", "fast"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fast and tpu engines [cuda]")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the classify loop "
                    "(fast and tpu engines)")
    ap.add_argument("--timers", action="store_true",
                    help="print per-stage wall timers")
    return ap.parse_args(argv)


def cmd_classify(a):
    from .parallel.shard_index import MANIFEST

    out = open(a.o, "w") if a.o else sys.stdout
    st = SectionTimes()
    t0 = time.time()
    cpu0 = cputime()
    if os.path.exists(os.path.join(a.index_dir, MANIFEST)):
        a.engine = "sharded"
    if a.engine == "sharded":
        total = classify_sharded(a, out)
    elif a.engine == "native":
        total = classify_native(a, out)
    else:
        from .engine.fast_engine import FastClassifier
        from .engine.tpu_engine import TpuClassifier
        from .index.loader import load_index

        idx = load_index(a.index_dir)
        if a.engine == "tpu":
            eng = TpuClassifier(idx, filter_min_length=a.l,
                                filter_min_score=a.s, device=a.device)
        else:
            eng = FastClassifier(idx, min_score=a.s, device=a.device)
        with device_trace(a.profile, a.device):
            total = (classify_tpu(a, eng, out) if a.engine == "tpu"
                     else classify_fast(a, eng, out, st))
    secs = time.time() - t0
    print(f"{total} sequences processed in {secs:.3f}s "
          f"({total / 1.0e3 / (secs / 60):.1f} Kseq/m).", file=sys.stderr)
    # the reference's CPU-time report (cly_mt.c:558)
    print(f"Classify CPU: {cputime() - cpu0:.3f} sec", file=sys.stderr)
    if a.timers:
        st.report()
    if a.o:
        out.close()
    return 0


def _batches(path):
    """The reads of one file in batches of N_NEEDED, then the rest (empty
    when the count divides), as (name, seq, qual) triples."""
    from .constants import N_NEEDED
    from .io.fastx import read_fastx

    batch = []
    for r in read_fastx(path):
        batch.append((r.name, r.seq, r.qual))
        if len(batch) >= N_NEEDED:
            yield batch
            batch = []
    yield batch


def classify_sharded(a, out) -> int:
    """The host ShardedEngine's SAM on a genome-sharded index; returns the
    read count."""
    from .parallel.shard_index import ShardedEngine

    eng = ShardedEngine(a.index_dir, n_threads=a.t)
    total = 0
    for path in a.reads:
        print(f"Processing file: [{path}].", file=sys.stderr)
        for batch in _batches(path):
            total += len(batch)
            out.write(eng.classify_to_sam(batch, a.f == "SAM_FULL", a.r))
    return total


def classify_native(a, out) -> int:
    """The native engine's SAM, DES or DES_FULL; returns the read count."""
    from .engine.native import NativeClassifier
    from .index.loader import load_index
    from .io.sam import format_des, format_des_full
    from .oracle.classify import OracleIndex
    from .oracle.driver import format_sam

    host = load_index(a.index_dir)
    idx = OracleIndex(host, filter_min_length=a.l, filter_min_score=a.s)
    eng = NativeClassifier(host, n_threads=a.t,
                           filter_min_length=idx.filter_min_length,
                           filter_min_score=idx.filter_min_score)
    total = 0
    for path in a.reads:
        print(f"Processing file: [{path}].", file=sys.stderr)
        for batch in _batches(path):
            total += len(batch)
            for res in eng.classify_batch(batch):
                if res.aborted:
                    continue  # the reference binary would crash here
                if a.f == "DES":
                    out.write(format_des(idx.ref_names, res, a.r))
                elif a.f == "DES_FULL":
                    out.write(format_des_full(idx.ref_names, res))
                else:
                    out.write(format_sam(idx, res, a.f == "SAM_FULL", a.r))
    return total


def classify_tpu(a, eng, out) -> int:
    """The validation engine's SAM of each file's reads; returns the read
    count."""
    from .io.fastx import read_fastx

    total = 0
    for path in a.reads:
        print(f"Processing file: [{path}].", file=sys.stderr)
        reads = [(r.name, r.seq, r.qual) for r in read_fastx(path)]
        total += len(reads)
        out.write(eng.classify_to_sam(reads, output_seq=a.f == "SAM_FULL",
                                      max_sec_n=a.r))
    return total


def classify_fast(a, eng, out, st) -> int:
    """The fast engine, fed by a reader thread: one line a read; returns
    the read count."""
    from .constants import N_NEEDED
    from .io.fastx import read_fastx

    q: "queue.Queue" = queue.Queue(maxsize=4)

    def reader():
        for path in a.reads:
            print(f"Processing file: [{path}].", file=sys.stderr)
            batch = []
            with st.section("read_reads"):
                for r in read_fastx(path):
                    batch.append((r.name, r.seq, r.qual))
                    if len(batch) >= N_NEEDED:
                        q.put(batch)
                        batch = []
            if batch:
                q.put(batch)
        q.put(None)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    total = 0
    while (batch := q.get()) is not None:
        total += len(batch)
        with st.section("classify_device"):
            results = eng.classify_batch(batch)
        with st.section("output_results"):
            for res in results:
                ref = (eng.idx.ref_names[res.ref_ID] if res.ref_ID >= 0
                       else "*")
                out.write(f"{res.name}\t{ref}\t{res.direction}\t"
                          f"{res.score}\t{res.read_len}\n")
    th.join()
    return total


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "classify":
        print("usage: python -m desamba_tpu_torch.cli classify "
              "[--engine native|tpu|sharded|fast] [-t 4] [--device cuda] "
              "<index_dir> <reads...>", file=sys.stderr)
        return 1
    try:
        return cmd_classify(classify_args(argv[1:]))
    finally:
        # printed after a failure too, as the JAX CLI does
        report_peak_rss()


if __name__ == "__main__":
    sys.exit(main())
