"""Run observability: peak RSS, CPU time, section timers, profiler trace.

Counterpart of desamba_tpu/utils/timers.py, the analogs of the
reference's self-measurement (lib/utils.c:355-390, the FUNC_GET_TIME
section timers of lib/utils.h:124-152, and the exit line of main.c:51),
with a torch.profiler trace in place of the jax.profiler one.
"""
from __future__ import annotations

import contextlib
import os
import resource
import sys
import time


def peakrss_kb() -> int:
    """Peak RSS in KB (ru_maxrss; lib/utils.c:383-388)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def cputime() -> float:
    """User + system CPU seconds (lib/utils.c:355-360)."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def report_peak_rss(file=None) -> None:
    """The reference's exit line, same spelling (main.c:51)."""
    print(f"Normal end program, MAX MEM:[{peakrss_kb() / 1024 / 1024:f}]"
          "Gbp.\n", file=file or sys.stderr)


class SectionTimes:
    """Wall seconds and entries per named section (FUNC_GET_TIME)."""

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


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device="cuda"):
    """torch.profiler trace of what runs inside, host and (on a CUDA
    device) card activity, written as a Chrome trace into trace_dir when
    it is set; without it no profiler runs."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, f"classify.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"torch profiler trace written to {path}", file=sys.stderr)
