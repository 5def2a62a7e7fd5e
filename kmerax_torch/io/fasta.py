"""FASTA contig writer and reader (copy of kmerax/io/fasta.py; format
DESIGN.md §11)."""

from __future__ import annotations

import gzip


def _open_w(path: str):
    return gzip.open(path, "wb", compresslevel=4) if str(path).endswith(".gz") \
        else open(path, "wb")


def _open_r(path: str):
    return gzip.open(path, "rb") if str(path).endswith(".gz") else open(path, "rb")


def write_fasta(path: str, seqs: list[str]) -> None:
    """`>unitig_{i} len={L}` records, sequence on one line (DESIGN.md §9)."""
    with _open_w(path) as f:
        for i, s in enumerate(seqs):
            f.write(f">unitig_{i} len={len(s)}\n{s}\n".encode("ascii"))


def read_fasta(path: str) -> list[tuple[str, str]]:
    """[(header-without->, seq)] — multi-line sequences joined."""
    out = []
    name, parts = None, []
    with _open_r(path) as f:
        for ln in f.read().split(b"\n"):
            if ln.startswith(b">"):
                if name is not None:
                    out.append((name, "".join(parts)))
                name, parts = ln[1:].decode(), []
            elif ln:
                parts.append(ln.decode())
    if name is not None:
        out.append((name, "".join(parts)))
    return out
