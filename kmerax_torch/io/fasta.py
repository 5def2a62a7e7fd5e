"""FASTA contig writer (copy of kmerax/io/fasta.py's writer; format
DESIGN.md §11)."""

from __future__ import annotations

import gzip


def _open_w(path: str):
    return gzip.open(path, "wb", compresslevel=4) if str(path).endswith(".gz") \
        else open(path, "wb")


def write_fasta(path: str, seqs: list[str]) -> None:
    """`>unitig_{i} len={L}` records, sequence on one line (DESIGN.md §9)."""
    with _open_w(path) as f:
        for i, s in enumerate(seqs):
            f.write(f">unitig_{i} len={len(s)}\n{s}\n".encode("ascii"))
