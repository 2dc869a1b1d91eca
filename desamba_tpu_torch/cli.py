"""Command line for the torch port: `classify` with the fast engine or
the bit-exact validation engine.

    python -m desamba_tpu_torch.cli classify [--engine fast|tpu]
        [--device cuda] [-s 64] [-l 170] [-r 5] [-f SAM|SAM_FULL]
        [-o out.txt] [--timers] [--profile DIR] <index_dir> <reads.fq> [...]

`--engine fast` (the default) writes one
`name<TAB>ref<TAB>direction<TAB>score<TAB>read_len` line per read, and the
same stderr report, as `desamba_tpu.cli classify --engine fast` does: a
reader thread parses FASTQ batches into a bounded queue while the main
thread runs the device pipeline and writes results. `--engine tpu` writes
the reference's SAM (-f SAM_FULL with each read's sequence and
qualities), as `desamba_tpu.cli classify --engine tpu` does. A
genome-sharded index directory (one holding shards.json) is refused: the
port classifies on one through engine.sharded_fast, not the CLI yet.
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on [cuda]")
    ap.add_argument("-o", default=None, help="output file [stdout]")
    ap.add_argument("--engine", default="fast", choices=["fast", "tpu"],
                    help="fast: device calls; tpu: the bit-exact "
                    "validation engine's SAM [fast]")
    ap.add_argument("-s", type=int, default=64, help="min score")
    ap.add_argument("-l", type=int, default=170,
                    help="min matching length (tpu)")
    ap.add_argument("-r", type=int, default=5,
                    help="max secondary alignments (tpu)")
    ap.add_argument("-f", default="SAM", choices=["SAM", "SAM_FULL"],
                    help="output format (tpu) [SAM]")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the classify loop")
    ap.add_argument("--timers", action="store_true",
                    help="print per-stage wall timers")
    return ap.parse_args(argv)


def cmd_classify(a):
    from .engine.fast_engine import FastClassifier
    from .engine.tpu_engine import TpuClassifier
    from .index.loader import load_index

    out = open(a.o, "w") if a.o else sys.stdout
    st = SectionTimes()
    t0 = time.time()
    cpu0 = cputime()
    idx = load_index(a.index_dir)
    if a.engine == "tpu":
        eng = TpuClassifier(idx, filter_min_length=a.l, filter_min_score=a.s,
                            device=a.device)
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
              "[--engine fast|tpu] [--device cuda] <index_dir> <reads...>",
              file=sys.stderr)
        return 1
    show_mem = True
    try:
        a = classify_args(argv[1:])
        if os.path.exists(os.path.join(a.index_dir, "shards.json")):
            show_mem = False
            print(f"{a.index_dir} is a genome-sharded index (shards.json): "
                  "the CLI does not classify on one yet (ROADMAP queue 1 "
                  "item 6; the API is engine.sharded_fast."
                  "load_sharded_fast)", file=sys.stderr)
            return 2
        return cmd_classify(a)
    finally:
        # printed after a failure too, as the JAX CLI does
        if show_mem:
            report_peak_rss()


if __name__ == "__main__":
    sys.exit(main())
