"""Build, load and count the hand-written CUDA kernels in csrc/.

Each csrc/*.cu file has a plain C entry point and is compiled by nvcc for
sm_90a into its own shared library, loaded with ctypes; csrc/*.cuh holds
device code that several sources include. The libraries go
under build/kernels/ at the repository root (or $DESAMBA_TORCH_BUILD_DIR),
named by a hash of the source and the flags, and are built at first use:
all missing ones at once, one nvcc process per source, in parallel. A
failed build raises.

`launches` counts, per kernel, the launches its wrapper made; the wrapper
adds one where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.environ.get(
    "DESAMBA_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(_PKG), "build", "kernels"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
# kernel name -> (source file, C entry point, argtypes), in pipeline order
KERNELS = {
    "unpack": (
        "unpack.cu", "dsb_unpack", [_P, _P, _LL, _LL, _P, _P, _P, _P, _P]),
    "stage1": (
        "stage1.cu", "dsb_stage1",
        [_P, _LL, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "interval_search": (
        "fm_search.cu", "dsb_interval_search",
        [_P, _LL, _P, _P, _I, _P, _P, _P, _P, _P, _P, _LL, _P, _LL, _I, _P]),
    "compact": (
        "compact.cu", "dsb_compact",
        [_P, _LL, _P, _LL, _I, _P, _LL, _U, _P, _P]),
    "row_grid": (
        "compact.cu", "dsb_row_grid",
        [_P, _P, _P, _P, _LL, _I, _I, _P, _LL, _U, _P, _P, _P, _P]),
    "row_walks": (
        "row_walks.cu", "dsb_row_walks",
        [_P, _LL, _P, _I, _P, _P, _P, _P, _LL, _P, _LL, _I, _P]),
    "locate": (
        "locate.cu", "dsb_locate",
        [_P, _LL, _LL, _P, _P, _LL, _P, _LL, _LL, _P, _LL, _P, _P, _LL, _P,
         _P, _LL, _I, _I, _P, _P, _P, _P]),
    "vote": (
        "vote.cu", "dsb_vote",
        [_P, _P, _P, _P, _P, _P, _LL, _I, _P, _LL, _I, _P, _U, _P, _P]),
    "band_windows": (
        "rescore.cu", "dsb_band_windows",
        [_P, _P, _P, _P, _P, _LL, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P,
         _P, _P, _P, _P, _P]),
    "band_score_packed": (
        "band_score.cu", "dsb_band_score",
        [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P]),
    "combine": (
        "rescore.cu", "dsb_combine",
        [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P]),
    # the genome-sharded classifier's (engine/sharded_fast.py)
    "shard_merge": (
        "merge.cu", "dsb_shard_merge",
        [_P, _I, _LL, _P, _LL, _P, _I, _P, _P]),
    # the data-parallel classifier's abundance weights
    # (parallel/collectives.py)
    "taxon_weights": (
        "taxon.cu", "dsb_taxon_weights", [_P, _P, _LL, _I, _P, _P]),
    # the validation engine's (engine/tpu_engine.py)
    "probe_reads": (
        "probe.cu", "dsb_probe_reads",
        [_P, _LL, _P, _P, _LL, _I, _I, _I, _I, _P, _P]),
    "row_walks_trace": (
        "row_walks.cu", "dsb_row_walks_trace",
        [_P, _LL, _P, _I, _P, _P, _P, _P, _LL, _I, _P, _P, _P]),
}

launches = {name: 0 for name in KERNELS}
build_info: dict = {}  # kernel -> dict(path, seconds, log)

_fns: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def source_path(name: str) -> str:
    """Repository-relative path of a kernel's source."""
    return os.path.join("desamba_tpu_torch", "csrc", KERNELS[name][0])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> str:
    """The library's path, named by a hash of the source, the headers of
    csrc/ (which any source may include) and the flags."""
    h = hashlib.sha256()
    for name in [src] + sorted(f for f in os.listdir(_CSRC)
                               if f.endswith(".cuh")):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all(extra: tuple = ()) -> dict:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns build_info (per kernel: library path, build seconds, nvcc
    output with the ptxas register report). extra: sources of csrc/ that
    no path calls (measurement-only floors, csrc/measure.cu), built
    alongside and keyed in build_info by their file name."""
    with _lock:
        todo = {}
        srcs = {**{n: s for n, (s, _, _) in KERNELS.items()},
                **{s: s for s in extra}}
        for name, src in srcs.items():
            path = _lib_path(src)
            if os.path.exists(path):
                build_info.setdefault(name, dict(path=path, seconds=0.0,
                                                 log="(cached)"))
            else:
                todo.setdefault(src, (path, []))[1].append(name)
        if not todo:
            return build_info
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        t0 = time.time()
        for src, (path, names) in todo.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
            procs.append((src, path, tmp, names, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, path, tmp, names, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            os.replace(tmp, path)
            for name in names:
                build_info[name] = dict(path=path,
                                        seconds=time.time() - t0, log=log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return build_info


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        build_all()
        _, entry, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(build_info[name]["path"]), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def call(name: str, *args) -> None:
    """Run a kernel's C entry point; raise on a launch error."""
    rc = _fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer; NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch_device(t) -> bool:
    """True if t's device runs the kernel (CUDA), False for the CPU, where
    the plain version runs; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel or plain route for device {t.device}")
    return True


def check(name: str, t, dtype, shape=None, device=None) -> None:
    """Raise unless t is a contiguous tensor of dtype (and shape, and on
    device). Wrappers check every input, on any device, before they pick
    the kernel (CUDA) or the plain version (CPU)."""
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
