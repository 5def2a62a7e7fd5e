"""Fixed-shape read batching + background host-parse thread (numpy copy of
kmerax/io/batcher.py).

A producer thread parses + packs FASTQ into padded numpy batches while the
main thread keeps the device busy.

Batches are always (batch_size, max_len): the final partial batch is padded
with empty reads (length 0), so every device step sees one shape.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from kmerax_torch.core.codec import seq_bytes_to_bases
from kmerax_torch.io.fastq import FastqReader, FastqRecord
from kmerax_torch.utils import tracing


@dataclass
class ReadBatch:
    bases: np.ndarray           # (B, L) int32, padded with 4
    lengths: np.ndarray         # (B,) int32; 0 for padding rows
    n: int                      # number of real reads in this batch
    records: list               # n FastqRecords (name/qual passthrough)


def _pack(records: list[FastqRecord], batch_size: int,
          max_len: int) -> ReadBatch:
    bases = np.full((batch_size, max_len), 4, dtype=np.int32)
    lengths = np.zeros(batch_size, dtype=np.int32)
    for i, rec in enumerate(records):
        b = seq_bytes_to_bases(np.frombuffer(rec.seq, dtype=np.uint8))
        L = min(len(b), max_len)
        if len(b) > max_len:
            raise ValueError(
                f"read {rec.name!r} length {len(b)} > max_read_len {max_len}")
        bases[i, :L] = b[:L]
        lengths[i] = L
    return ReadBatch(bases, lengths, len(records), records)


def batch_reads(paths, batch_size: int, max_len: int,
                use_native: bool | None = None):
    """Synchronous batch iterator over one or more FASTQ files.

    Dispatches to the C++ chunk parser (kmerax/io/_fastq_ext.cc) when it
    builds (`use_native=None`); the pure-Python parser gives identical
    batches, except that native FastqRecords carry an empty `seq` (bases
    are authoritative).
    """
    if isinstance(paths, (str, tuple)):
        paths = [paths]
    if use_native is None:
        from kmerax_torch.io.native import get_lib
        use_native = get_lib() is not None
    if use_native:
        yield from _batch_reads_native(paths, batch_size, max_len)
        return
    buf: list[FastqRecord] = []
    for p in paths:
        rng = None
        if isinstance(p, tuple):            # (path, start, end) byte range
            p, start, end = p
            rng = (start, end)
        for rec in FastqReader(p, byte_range=rng):
            buf.append(rec)
            if len(buf) == batch_size:
                yield _pack(buf, batch_size, max_len)
                buf = []
    if buf:
        yield _pack(buf, batch_size, max_len)


_NATIVE_CHUNK = 8 << 20


def _batch_reads_native(paths, batch_size: int, max_len: int):
    """C++ fast path: chunked parse -> accumulated arrays -> fixed batches."""
    from kmerax_torch.io.fastq import _open_r
    from kmerax_torch.io.native import parse_chunk

    pend_bases, pend_lens, pend_recs, npend = [], [], [], 0

    def emit(final: bool):
        nonlocal pend_bases, pend_lens, pend_recs, npend
        while npend >= batch_size or (final and npend > 0):
            take = min(npend, batch_size)
            allb = np.concatenate(pend_bases) if len(pend_bases) > 1 \
                else pend_bases[0]
            alll = np.concatenate(pend_lens) if len(pend_lens) > 1 \
                else pend_lens[0]
            bases = np.full((batch_size, max_len), 4, dtype=np.int32)
            bases[:take] = allb[:take]
            lengths = np.zeros(batch_size, dtype=np.int32)
            lengths[:take] = alll[:take]
            yield ReadBatch(bases, lengths, take, pend_recs[:take])
            pend_bases = [allb[take:]] if take < len(allb) else []
            pend_lens = [alll[take:]] if take < len(alll) else []
            pend_recs = pend_recs[take:]
            npend -= take

    for p in paths:
        left = None
        if isinstance(p, tuple):            # (path, start, end) byte range
            p, start, end = p
            left = end - start
        with _open_r(p) as f:
            if left is not None:
                f.seek(start)
            tail = b""
            eof = False
            while not eof:
                want = _NATIVE_CHUNK if left is None \
                    else min(_NATIVE_CHUNK, left)
                chunk = f.read(want) if want else b""
                if left is not None:
                    left -= len(chunk)
                if not chunk:
                    eof = True
                    if not tail:
                        break
                    if not tail.endswith(b"\n"):
                        tail += b"\n"
                buf = tail + chunk
                cap = buf.count(b"\n") // 4 + 1
                bases, lengths, names, quals, pluses, consumed = parse_chunk(
                    buf, cap, max_len)
                tail = buf[consumed:]
                if eof and tail:
                    raise ValueError(f"{p}: truncated FASTQ record")
                if len(bases):
                    pend_bases.append(bases.astype(np.int32))
                    pend_lens.append(lengths)
                    pend_recs.extend(
                        FastqRecord(n, b"", q, pl)
                        for n, q, pl in zip(names, quals, pluses))
                    npend += len(bases)
                    yield from emit(final=False)
    yield from emit(final=True)


class BackgroundBatcher:
    """Double-buffered producer thread wrapping batch_reads."""

    _SENTINEL = object()

    def __init__(self, paths, batch_size: int, max_len: int, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(
            target=self._produce, args=(paths, batch_size, max_len),
            daemon=True)
        self._thread.start()

    def _produce(self, paths, batch_size, max_len):
        try:
            for b in batch_reads(paths, batch_size, max_len):
                self._q.put(b)
        except BaseException as e:   # surface parse errors to the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        while True:
            with tracing.span("io.parse_wait"):
                item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item
