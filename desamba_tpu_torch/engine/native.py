"""ctypes binding of the host C++ classify engine (native/classify_host.cpp).

The engine is bit-exact with the reference classifier; the fast path
replays the reads it cannot call unambiguously through it. Counterpart of
desamba_tpu/engine/native.py, fed from the port's `HostIndex`: each hit
comes back as an oracle `Chain` with all twelve columns of the engine's
record, as the sharded engine's merge and the SAM formatter read them.
`native/` is
a C++ library beside both packages; it is built with its Makefile's
`libdesamba_host.so` target when missing or older than its source
(`ensure_built`).
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..constants import DEFAULT_FILTER_MIN_LENGTH, DEFAULT_MIN_SCORE
from ..oracle.classify import Chain, ReadResult

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_HIT_FIELDS = 12  # columns of a hit record (dsb_classify_batch)

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)


class _IndexDesc(ctypes.Structure):
    # field order mirrors struct DsbIndexDesc in native/classify_host.cpp
    _fields_ = [
        ("codes", _u8p), ("cum", _i64p), ("cum_stride", ctypes.c_int64),
        ("L", ctypes.c_int64), ("codes_len", ctypes.c_int64),
        ("rank", _i64p), ("hash13", _i64p), ("sa_uni", _u32p),
        ("sa_off", _u32p), ("dollar_pos", ctypes.c_int64),
        ("uni_len", _i64p), ("reflist", _i64p), ("n_unitig", ctypes.c_int64),
        ("refpos_global", _i64p), ("refpos_refid", _i32p),
        ("n_refpos", ctypes.c_int64), ("ref_offset", _i64p),
        ("ref_len", _i64p), ("ref_bin", _u8p), ("ref_total", ctypes.c_int64),
        ("ek0", _u8p), ("ek1", _u8p), ("ek_mask", ctypes.c_uint64),
        ("ek_len", ctypes.c_int32), ("ek_single_base_max", ctypes.c_int32),
        ("q_mem", _i32p), ("q_lv", _i32p),
        ("filter_min_length", ctypes.c_int32),
        ("filter_min_score", ctypes.c_int32),
        ("filter_min_score_lv3", ctypes.c_int32),
    ]


def ensure_built(native_dir: str = _NATIVE_DIR) -> str:
    """Build native_dir's libdesamba_host.so if it is missing or older
    than its source; its path.

    Safe for concurrent callers (test workers, ranks): the check and the
    build hold an exclusive flock on native_dir/.libdesamba_host.lock;
    make runs in a temporary copy of the Makefile and the source
    (native_dir/.libdesamba_host-build-*, git-ignored), and the built
    library is moved into place with os.replace, so that a process that
    loads the library meanwhile never maps a half-written file."""
    lib = os.path.join(native_dir, "libdesamba_host.so")
    src = os.path.join(native_dir, "classify_host.cpp")

    def fresh() -> bool:
        return (os.path.exists(lib)
                and os.path.getmtime(lib) >= os.path.getmtime(src))

    if fresh():
        return lib
    with open(os.path.join(native_dir, ".libdesamba_host.lock"), "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not fresh():
            tmp = tempfile.mkdtemp(prefix=".libdesamba_host-build-",
                                   dir=native_dir)
            try:
                for name in ("Makefile", "classify_host.cpp"):
                    shutil.copy2(os.path.join(native_dir, name), tmp)
                subprocess.run(["make", "-C", tmp, "libdesamba_host.so"],
                               check=True, capture_output=True)
                os.replace(os.path.join(tmp, "libdesamba_host.so"), lib)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return lib


_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.dsb_engine_create.argtypes = [ctypes.POINTER(_IndexDesc),
                                          ctypes.c_int]
        lib.dsb_engine_create.restype = ctypes.c_void_p
        lib.dsb_engine_destroy.argtypes = [ctypes.c_void_p]
        lib.dsb_classify_batch.argtypes = [
            ctypes.c_void_p, _u8p, _i64p, _i32p, ctypes.c_int64, _i32p,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(_u32p), _i64p]
        lib.dsb_classify_batch.restype = ctypes.c_int
        lib.dsb_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeClassifier:
    """Batch classifier backed by the C++ engine, over `n_threads` striped
    workers (deterministic for a given thread count)."""

    def __init__(self, idx, n_threads: int = 1,
                 filter_min_length: int = DEFAULT_FILTER_MIN_LENGTH,
                 filter_min_score: int = DEFAULT_MIN_SCORE):
        lib = _load_lib()
        c = np.ascontiguousarray
        # the engine reads these in place: keep them for its lifetime
        self._arrs = a = dict(
            codes=c(idx.bwt_pad, dtype=np.uint8),
            cum=c(idx.cum, dtype=np.int64),
            rank=c(idx.rank, dtype=np.int64),
            hash13=c(idx.hash13, dtype=np.int64),
            sa_uni=c(idx.sa_uni, dtype=np.uint32),
            sa_off=c(idx.sa_off, dtype=np.uint32),
            uni_len=c(idx.uni_len, dtype=np.int64),
            reflist=c(idx.uni_reflist, dtype=np.int64),
            refpos_global=c(idx.refpos_global, dtype=np.int64),
            refpos_refid=c(idx.refpos_refid, dtype=np.int32),
            ref_offset=c(idx.ref_offset, dtype=np.int64),
            ref_len=c(idx.ref_len, dtype=np.int64),
            ref_bin=c(idx.ref_bin, dtype=np.uint8),
            ek0=c(idx.ek_words0).view(np.uint8),
            ek1=c(idx.ek_words1).view(np.uint8),
            q_mem=c(idx.q_mem, dtype=np.int32),
            q_lv=c(idx.q_lv, dtype=np.int32))
        i64, u32, u8 = ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint8
        d = _IndexDesc(
            codes=_ptr(a["codes"], u8), cum=_ptr(a["cum"], i64),
            cum_stride=a["cum"].shape[1], L=idx.L,
            codes_len=a["codes"].size, rank=_ptr(a["rank"], i64),
            hash13=_ptr(a["hash13"], i64), sa_uni=_ptr(a["sa_uni"], u32),
            sa_off=_ptr(a["sa_off"], u32), dollar_pos=idx.dollar_pos,
            uni_len=_ptr(a["uni_len"], i64), reflist=_ptr(a["reflist"], i64),
            n_unitig=idx.n_unitig,
            refpos_global=_ptr(a["refpos_global"], i64),
            refpos_refid=_ptr(a["refpos_refid"], ctypes.c_int32),
            n_refpos=a["refpos_global"].size,
            ref_offset=_ptr(a["ref_offset"], i64),
            ref_len=_ptr(a["ref_len"], i64), ref_bin=_ptr(a["ref_bin"], u8),
            ref_total=a["ref_bin"].size * 4, ek0=_ptr(a["ek0"], u8),
            ek1=_ptr(a["ek1"], u8), ek_mask=(1 << idx.ek_mask_bits) - 1,
            ek_len=idx.ek_len, ek_single_base_max=idx.ek_single_base_max,
            q_mem=_ptr(a["q_mem"], ctypes.c_int32),
            q_lv=_ptr(a["q_lv"], ctypes.c_int32),
            filter_min_length=filter_min_length,
            filter_min_score=filter_min_score,
            filter_min_score_lv3=filter_min_score + 10)
        self._lib = lib
        self._handle = lib.dsb_engine_create(ctypes.byref(d), int(n_threads))
        self.n_threads = int(n_threads)

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.dsb_engine_destroy(h)
            self._handle = None

    def classify_batch(self, reads) -> list[ReadResult]:
        """reads: (name, seq, qual) triples. Returns a ReadResult a read,
        its hits as Chains in the engine's order. Reads the engine aborts
        (where the reference binary would crash) come back with no hits
        and .aborted=True."""
        reads = list(reads)
        n = len(reads)
        buf = np.frombuffer(b"".join(r[1] for r in reads), dtype=np.uint8)
        if buf.size == 0:
            buf = np.zeros(1, dtype=np.uint8)
        lens = np.array([len(r[1]) for r in reads], dtype=np.int32)
        offs = np.zeros(n, dtype=np.int64)
        if n > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        nhits = np.zeros(n, dtype=np.int32)
        status = np.zeros(n, dtype=np.int8)
        hits_p = _u32p()
        total = ctypes.c_int64(0)
        rc = self._lib.dsb_classify_batch(
            self._handle, _ptr(buf, ctypes.c_uint8),
            _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int32), n,
            _ptr(nhits, ctypes.c_int32), _ptr(status, ctypes.c_int8),
            ctypes.byref(hits_p), ctypes.byref(total))
        if rc != 0:
            raise RuntimeError(f"dsb_classify_batch returned {rc}")
        t = total.value
        hits = (np.ctypeslib.as_array(hits_p, shape=(t, _HIT_FIELDS)).copy()
                if t else np.zeros((0, _HIT_FIELDS), dtype=np.uint32))
        self._lib.dsb_free(hits_p)
        out = []
        pos = 0
        for i, (name, seq, qual) in enumerate(reads):
            r = ReadResult(name=name, seq=seq, qual=qual or b"")
            r.aborted = bool(status[i])
            # columns as dsb_classify_batch writes them; q_t_dis is signed
            r.hits = [Chain(ref_ID=int(h[0]), direction=int(h[1]),
                            t_st=int(h[2]), t_ed=int(h[3]), q_st=int(h[4]),
                            q_ed=int(h[5]), sum_score=int(h[6]),
                            pri_index=int(h[7]), primary=int(h[8]),
                            anchor_number=int(h[9]), indel=int(h[10]),
                            q_t_dis=int(np.int32(h[11])))
                      for h in hits[pos : pos + int(nhits[i])]]
            pos += int(nhits[i])
            out.append(r)
        return out
