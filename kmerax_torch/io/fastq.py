"""Streaming FASTQ(.gz) reader & byte-preserving writer (numpy copy of
kmerax/io/fastq.py, which imports JAX through kmerax/core/codec.py).

The chunked parser runs on the host, behind
kmerax_torch.io.batcher.BackgroundBatcher's thread, while the device runs
asynchronously.

Output format contract (DESIGN.md §11): names and quality lines are carried
through byte-identical; only the sequence line is rewritten.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from kmerax_torch.core.codec import bases_to_seq_bytes

_CHUNK = 8 << 20


def _open_r(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=_CHUNK)


class _DeterministicGzip(gzip.GzipFile):
    """Gzip writer with mtime=0 in the header (DESIGN.md §13: identical
    runs produce identical bytes, .gz headers included) that also closes
    the underlying raw file."""

    def __init__(self, path: str):
        self._raw = open(path, "wb", buffering=_CHUNK)
        super().__init__(filename="", mode="wb", compresslevel=4,
                         fileobj=self._raw, mtime=0)

    def close(self):
        try:
            super().close()
        finally:
            self._raw.close()


def _open_w(path: str):
    if str(path).endswith(".gz"):
        return _DeterministicGzip(path)
    return open(path, "wb", buffering=_CHUNK)


@dataclass
class FastqRecord:
    name: bytes   # without leading '@', without newline
    seq: bytes
    qual: bytes
    plus: bytes = b"+"   # third line verbatim ('+name' round-trips)


class FastqReader:
    """Iterates FastqRecord from a (possibly gzipped) FASTQ file.

    `byte_range=(start, end)`: parse only that record-aligned slice of a
    plain file (io/shard.py::snap_to_record boundaries), the per-host
    byte-range shard."""

    def __init__(self, path: str, byte_range: tuple[int, int] | None = None):
        self.path = path
        self.byte_range = byte_range
        if byte_range is not None and str(path).endswith(".gz"):
            raise ValueError("byte ranges require a plain (non-.gz) FASTQ")

    def __iter__(self):
        tail = b""
        nline = 0
        fields = [b"", b"", b""]  # name, seq, (plus ignored), qual
        remaining = None
        with _open_r(self.path) as f:
            if self.byte_range is not None:
                s, e = self.byte_range
                f.seek(s)
                remaining = e - s
            while True:
                want = _CHUNK if remaining is None else min(_CHUNK,
                                                            remaining)
                chunk = f.read(want) if want else b""
                if remaining is not None:
                    remaining -= len(chunk)
                if not chunk:
                    break
                lines = (tail + chunk).split(b"\n")
                tail = lines.pop()
                for ln in lines:
                    m = nline & 3
                    if m == 0:
                        if not ln.startswith(b"@"):
                            raise ValueError(
                                f"{self.path}: record {nline >> 2}: name line "
                                f"must start with '@', got {ln[:20]!r}")
                        fields[0] = ln[1:]
                    elif m == 1:
                        fields[1] = ln
                    elif m == 2:
                        fields[2] = ln
                    elif m == 3:
                        yield FastqRecord(fields[0], fields[1], ln, fields[2])
                    nline += 1
            if tail:
                if (nline & 3) == 3:
                    yield FastqRecord(fields[0], fields[1], tail, fields[2])
                else:
                    raise ValueError(f"{self.path}: truncated FASTQ record")
            elif (nline & 3) != 0:
                raise ValueError(f"{self.path}: truncated FASTQ record")


class FastqWriter:
    """Writes corrected reads; name/qual byte-identical, LF endings."""

    def __init__(self, path: str):
        self._f = _open_w(path)

    def write(self, name: bytes, seq_bases: np.ndarray, qual: bytes,
              plus: bytes = b"+"):
        seq = bases_to_seq_bytes(np.asarray(seq_bases, dtype=np.uint8))
        self._f.write(b"@" + name + b"\n" + seq.tobytes() + b"\n" + plus
                      + b"\n" + qual + b"\n")

    def write_record(self, rec: FastqRecord, seq_bases: np.ndarray):
        self.write(rec.name, seq_bases, rec.qual, rec.plus)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
