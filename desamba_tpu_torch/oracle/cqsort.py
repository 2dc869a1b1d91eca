"""glibc qsort emulation for exact tie-order parity (a copy of
desamba_tpu/oracle/cqsort.py).

Several reference comparators are not strict weak orders (e.g.
chain_cmp_by_MEM_score returns sum_score%2 on ties, cly.c:62;
Anchor_cmp_by_chr_ID_and_pos returns 0/1 only, cly.c:225-234), so the final
permutation depends on glibc's qsort implementation. We therefore call the
real libc qsort on dummy elements of the *same byte size* as the C structs
(the algorithm's comparison sequence depends on element size), with a
comparator that consults Python data through the embedded original index.
"""
from __future__ import annotations

import ctypes

_libc = ctypes.CDLL("libc.so.6", use_errno=True)
_CMP = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_libc.qsort.argtypes = [
    ctypes.c_void_p,
    ctypes.c_size_t,
    ctypes.c_size_t,
    _CMP,
]
_libc.qsort.restype = None


def qsort_perm(n: int, elem_size: int, cmp) -> list[int]:
    """Return the permutation glibc qsort produces for n elements of
    elem_size bytes under comparator cmp(i, j) (i, j = original indices)."""
    if n <= 1:
        return list(range(n))
    assert elem_size >= 4
    buf = ctypes.create_string_buffer(n * elem_size)
    for i in range(n):
        ctypes.memmove(
            ctypes.addressof(buf) + i * elem_size,
            ctypes.byref(ctypes.c_uint32(i)),
            4,
        )

    def c_cmp(pa, pb):
        ia = ctypes.cast(pa, ctypes.POINTER(ctypes.c_uint32))[0]
        ib = ctypes.cast(pb, ctypes.POINTER(ctypes.c_uint32))[0]
        return cmp(ia, ib)

    cb = _CMP(c_cmp)
    _libc.qsort(ctypes.addressof(buf), n, elem_size, cb)
    out = []
    for i in range(n):
        out.append(
            ctypes.cast(
                ctypes.addressof(buf) + i * elem_size,
                ctypes.POINTER(ctypes.c_uint32),
            )[0]
        )
    return out


def qsort_list(items: list, elem_size: int, cmp) -> list:
    """Sort a Python list with glibc qsort semantics; cmp(a, b) on items."""
    perm = qsort_perm(len(items), elem_size, lambda i, j: cmp(items[i], items[j]))
    return [items[k] for k in perm]
