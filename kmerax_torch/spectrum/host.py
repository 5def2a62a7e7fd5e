"""Host-resident exact k-mer spectrum (numpy copy of the parts of
kmerax/spectrum/host.py that the main path uses; that module cannot be
imported without JAX). The port keeps the spectrum on the host: one sorted
(N, W) uint32 array + int64 counts, accumulated by the count stage's
pending-buffer flushes (pipeline/count.py), with the histogram for the
solid threshold and the solid rows for assembly. Packed keys and their
search serve the assembly joins (graph/partitioned.py).

Order contract: rows are in DESIGN.md §6 global order (little-endian words
compared most-significant-word first), the order np_merge_counted gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def pack_rows(rows: np.ndarray) -> np.ndarray:
    """(N, W) uint32 rows -> comparable packed keys.

    W<=2 packs to one uint64 (order-isomorphic to the word compare);
    W<=4 packs to (N, 2) uint64 [hi, lo]. Used for O(log N) lookups.
    """
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    n, w = rows.shape
    if w == 1:
        return rows[:, 0].astype(np.uint64)
    if w == 2:
        return (rows[:, 1].astype(np.uint64) << np.uint64(32)) \
            | rows[:, 0].astype(np.uint64)
    if w <= 4:
        pad = np.zeros((n, 4 - w), dtype=np.uint32)
        r = np.concatenate([rows, pad], axis=1)
        lo = (r[:, 1].astype(np.uint64) << np.uint64(32)) \
            | r[:, 0].astype(np.uint64)
        hi = (r[:, 3].astype(np.uint64) << np.uint64(32)) \
            | r[:, 2].astype(np.uint64)
        return np.stack([hi, lo], axis=1)
    raise ValueError(f"unsupported word count {w}")


def searchsorted_packed(keys, queries):
    """Lower-bound indices of `queries` in sorted `keys` (pack_rows forms)."""
    if keys.ndim == 1:
        return np.searchsorted(keys, queries)
    # two-level search for (N, 2) [hi, lo] keys
    hi_k, lo_k = keys[:, 0], keys[:, 1]
    hi_q, lo_q = queries[:, 0], queries[:, 1]
    left = np.searchsorted(hi_k, hi_q, side="left")
    right = np.searchsorted(hi_k, hi_q, side="right")
    # within the equal-hi run, lower-bound on lo
    idx = left.copy()
    run = right > left
    if run.any():
        # vectorized binary search restricted to [left, right)
        lo = left[run]
        hi = right[run]
        q = lo_q[run]
        while True:
            active = lo < hi
            if not active.any():
                break
            mid = (lo + hi) // 2
            less = np.where(active, lo_k[np.minimum(mid, len(lo_k) - 1)] < q,
                            False)
            lo = np.where(active & less, mid + 1, lo)
            hi = np.where(active & ~less, mid, hi)
        idx[run] = lo
    return idx


@dataclass
class HostSpectrum:
    """Sorted exact spectrum on the host. uniq (N, W) uint32, counts (N,)
    int64, k static."""

    uniq: np.ndarray
    counts: np.ndarray
    k: int

    def __post_init__(self):
        assert self.uniq.ndim == 2 and self.uniq.dtype == np.uint32

    @property
    def n_unique(self) -> int:
        return len(self.uniq)

    def histogram(self, max_count: int = 1024) -> np.ndarray:
        c = np.clip(self.counts, 0, max_count)
        return np.bincount(c.astype(np.int64), minlength=max_count + 1)

    def solid_indices(self, t: int) -> np.ndarray:
        return np.nonzero(self.counts >= t)[0]
