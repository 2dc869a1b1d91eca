"""The port's golden index (tests/torch_golden.py) under concurrent
builders: several processes ask for it at once in a cold parent
directory, as the test workers of a fresh checkout do. Exactly one of
them builds it; every one loads a whole index with the port's loader,
the same tables in each process, equal to the finished directory's."""
import hashlib
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import torch_golden

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
N_PROCS = 3

# one worker: waits for the common start time, asks for the index (its
# builds counted through a wrapper around save_ref_format), loads it and
# prints the digest of the loaded tables
CHILD = """
import os, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import desamba_tpu.index.format_ref as fr
import torch_golden
from test_torch_golden import digest
from desamba_tpu_torch.index.loader import load_index

parent, start = sys.argv[3], float(sys.argv[4])
save = fr.save_ref_format


def counted(idx, out):
    with open(os.path.join(parent, "builds.log"), "a") as f:
        f.write(f"{os.getpid()}\\n")
    time.sleep(0.5)  # a slow builder: the others arrive mid-build
    return save(idx, out)


fr.save_ref_format = counted
time.sleep(max(0.0, start - time.time()))
path = torch_golden.golden_index(parent)
print(path, digest(load_index(path)))
"""


def digest(ix) -> str:
    """SHA-256 over every array field of a HostIndex and its scalars."""
    h = hashlib.sha256()
    for k, v in sorted(vars(ix).items()):
        h.update(k.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode() + str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def test_concurrent_builders_leave_one_whole_index(tmp_path):
    from desamba_tpu_torch.index.loader import load_index

    parent = str(tmp_path / "golden")
    os.makedirs(parent)
    start = time.time() + 3.0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, ROOT, TESTS, parent, str(start)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(N_PROCS)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        lines = [out.split() for out, _ in outs]
        final = torch_golden.golden_index(parent)
        want = digest(load_index(final))
        assert all(ln == [final, want] for ln in lines), lines
        with open(os.path.join(parent, "builds.log")) as f:
            assert len(f.read().split()) == 1
        # the build directory was renamed into place: no other entry
        # than the index, its lock and the log
        name = os.path.basename(final)
        assert sorted(os.listdir(parent)) == sorted(
            [name, name + ".lock", "builds.log"])
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(parent, ignore_errors=True)
