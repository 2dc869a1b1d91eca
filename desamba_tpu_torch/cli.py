"""Command line for the torch port: `classify` with the fast engine.

    python -m desamba_tpu_torch.cli classify [--device cuda] [-s 64]
        [-o out.txt] <index_dir> <reads.fq> [...]

Writes one `name<TAB>ref<TAB>direction<TAB>score<TAB>read_len` line per
read, as `desamba_tpu.cli classify --engine fast` does. A reader thread
parses FASTQ batches into a bounded queue while the main thread runs the
device pipeline and writes results.
"""
from __future__ import annotations

import argparse
import contextlib
import queue
import sys
import threading
import time


class SectionTimes:
    """Wall seconds and entries per named section (the FUNC_GET_TIME
    analog, lib/utils.h:124-152; desamba_tpu/utils/timers.SectionTimes)."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, file=None) -> None:
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            print(f"{name}:[{t:f}] n={self.counts[name]}",
                  file=file or sys.stderr)


def cmd_classify(argv):
    ap = argparse.ArgumentParser(prog="desamba_tpu_torch classify")
    ap.add_argument("index_dir")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on [cuda]")
    ap.add_argument("-o", default=None, help="output file [stdout]")
    ap.add_argument("-s", type=int, default=64, help="min score")
    ap.add_argument("--timers", action="store_true",
                    help="print per-stage wall timers")
    a = ap.parse_args(argv)

    from .constants import N_NEEDED
    from .engine.fast_engine import FastClassifier
    from .index.loader import load_index
    from .io.fastx import read_fastx

    out = open(a.o, "w") if a.o else sys.stdout
    st = SectionTimes()
    t0 = time.time()
    idx = load_index(a.index_dir)
    eng = FastClassifier(idx, min_score=a.s, device=a.device)
    q: "queue.Queue" = queue.Queue(maxsize=4)

    def reader():
        for path in a.reads:
            print(f"Processing file: [{path}].", file=sys.stderr)
            batch = []
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
                ref = idx.ref_names[res.ref_ID] if res.ref_ID >= 0 else "*"
                out.write(f"{res.name}\t{ref}\t{res.direction}\t"
                          f"{res.score}\t{res.read_len}\n")
    th.join()
    secs = time.time() - t0
    print(f"{total} sequences processed in {secs:.3f}s on {a.device}.",
          file=sys.stderr)
    if a.timers:
        st.report()
    if a.o:
        out.close()
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "classify":
        print("usage: python -m desamba_tpu_torch.cli classify "
              "[--device cuda] <index_dir> <reads...>", file=sys.stderr)
        return 1
    return cmd_classify(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
