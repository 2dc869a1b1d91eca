"""FASTA/FASTQ reader (plain or gzip), for the port's entry points.

Counterpart of desamba_tpu/io/fastx.py:read_fastx, the klib kseq parser's
behaviour (lib/utils.c:918-999): the name is the header up to the first
whitespace, the rest is the comment, a sequence may span lines, and FASTQ
qualities are read until they match the sequence's length. Accepts a path,
an open binary file or bytes.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    name: str
    comment: str
    seq: bytes
    qual: bytes | None  # None for FASTA

    def __len__(self) -> int:
        return len(self.seq)


def _open_any(src):
    if isinstance(src, (bytes, bytearray)):
        raw = bytes(src)
        if raw[:2] == b"\x1f\x8b":
            return gzip.open(io.BytesIO(raw), "rb")
        return io.BufferedReader(io.BytesIO(raw))
    if hasattr(src, "read"):
        return src
    f = open(src, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        return gzip.open(src, "rb")
    f.seek(0)
    return f


def read_fastx(src) -> Iterator[SeqRecord]:
    """Yield the records of a FASTA/FASTQ path, file object or bytes."""
    fh = _open_any(src)
    try:
        line = fh.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if not line:
                line = fh.readline()
                continue
            if line[:1] not in (b">", b"@"):
                raise ValueError(f"malformed fastx header: {line[:40]!r}")
            is_fastq = line[:1] == b"@"
            sp = line[1:].split(None, 1)
            name = sp[0].decode() if sp else ""
            comment = sp[1].decode() if len(sp) > 1 else ""
            parts: list[bytes] = []
            line = fh.readline()
            if not is_fastq:
                while line and line[:1] not in (b">", b"@"):
                    parts.append(line.strip())
                    line = fh.readline()
                yield SeqRecord(name, comment, b"".join(parts), None)
                continue
            while line and line[:1] != b"+":
                parts.append(line.strip())
                line = fh.readline()
            seq = b"".join(parts)
            qparts: list[bytes] = []
            qlen = 0
            line = fh.readline()
            while line and qlen < len(seq):
                q = line.strip()
                qparts.append(q)
                qlen += len(q)
                line = fh.readline()
            yield SeqRecord(name, comment, seq, b"".join(qparts))
    finally:
        fh.close()
