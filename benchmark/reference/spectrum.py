"""The count, worked out again: the counting Bloom's counters (every valid
canonical k-mer adds 1 to each of its lanes), the exact spectrum (sorted
distinct canonical k-mers and their counts), its histogram and the solid
threshold (DESIGN.md §§5-7; oracle/count.py). A k-mer is one int64 at
k <= 31 (kmers.py) and a row of W int64 words above (words.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kmers, words
from .kmers import check_k, windows

ROWS_A_CHUNK = 1 << 15


@dataclass
class Spectrum:
    k: int
    uniq: torch.Tensor          # (M,) int64 or (M, W) words, ascending
    counts: torch.Tensor        # (M,) int64
    table: torch.Tensor | None  # (2^log2_width,) int64 counters
    n_kmers: int
    hist: list                  # 256 bins, counts clipped to [1, 255]
    threshold: int


def histogram(counts: torch.Tensor) -> list:
    return torch.bincount(counts.clamp(1, 255), minlength=256).tolist()


def first_valley(hist) -> int:
    """Smallest c in [2, 128) with h[c] <= h[c + 1]; else 2."""
    for c in range(2, min(128, len(hist) - 1)):
        if hist[c] <= hist[c + 1]:
            return c
    return 2


def probes(canon: torch.Tensor, k: int, log2_width: int,
           hashes: int) -> torch.Tensor:
    """(..., hashes) counter indices of canonical k-mers of either form."""
    if k > 31:
        return words.probes(canon, log2_width, hashes)
    return kmers.probes(canon, k, log2_width, hashes)


def count(reads: list, k: int, log2_width: int | None, hashes: int,
          device) -> Spectrum:
    """The spectrum of every read in `reads` ((n, L) uint8 arrays or
    tensors), and the Bloom counters unless log2_width is None."""
    wide = k > 31
    (words.check_k if wide else check_k)(k)
    table = None if log2_width is None else torch.zeros(
        1 << log2_width, dtype=torch.int64, device=device)
    canon_parts = []
    n_kmers = 0
    for r in reads:
        r = torch.as_tensor(r)
        for s in range(0, r.shape[0], ROWS_A_CHUNK):
            b = r[s:s + ROWS_A_CHUNK].to(device)
            if wide:
                fwd, rc, valid = words.windows(b, k)
                canon = words.canonical(fwd, rc)[valid]
            else:
                fwd, rc, valid = windows(b, k)
                canon = torch.minimum(fwd, rc)[valid]
            n_kmers += canon.shape[0]
            if table is not None:
                table += torch.bincount(
                    probes(canon, k, log2_width, hashes).reshape(-1),
                    minlength=table.numel())
            canon_parts.append(canon)
    canon = torch.cat(canon_parts) if canon_parts else torch.zeros(
        (0, words.n_words(k)) if wide else 0, dtype=torch.int64,
        device=device)
    del canon_parts
    if wide:
        uniq, counts = words.unique_counts(canon)
    else:
        uniq, counts = torch.unique(canon, sorted=True, return_counts=True)
    del canon
    hist = histogram(counts)
    return Spectrum(k, uniq, counts, table, n_kmers, hist,
                    first_valley(hist))


def solid_query(table: torch.Tensor, k: int, log2_width: int, hashes: int,
                t: int):
    """solid(canon) -> bool: the least of the k-mer's counters >= t."""
    def solid(canon: torch.Tensor) -> torch.Tensor:
        idx = probes(canon, k, log2_width, hashes)
        return table[idx].amin(dim=-1) >= t
    return solid
