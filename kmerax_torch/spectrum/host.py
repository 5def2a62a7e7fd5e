"""Host-resident exact k-mer spectrum (numpy copy of the parts of
kmerax/spectrum/host.py that the main path uses; that module cannot be
imported without JAX). After the count the port keeps the spectrum on the
host: one sorted (N, W) uint32 array + int64 counts. A one-device count
merges its pending rows on the device through the pass and copies the
spectrum here once, at the stage's end (spectrum/exact.py::merge_pending);
a mesh count's flushes merge on the host (np_merge_counted). With it go
the histogram for the solid threshold and the solid rows for assembly. Packed keys and their
search serve the join across hosts (graph/sharded.py; the one-host join runs
on the device, graph/join_kernels.py) and the key ranges of a sharded host
spectrum (spectrum/host_sharded.py). `padded` and
`to_device` give the sentinel-padded form the JAX package keeps on its
device (`CountState.exact` there): the checkpoint saves it and `correct
--use-exact` searches it.

Order contract: rows are in DESIGN.md §6 global order (little-endian words
compared most-significant-word first), the order np_merge_counted gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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

    def padded(self, capacity: int):
        """(uniq (capacity, W) uint32 padded with SENTINEL_WORD rows, counts
        (capacity,) int32 clipped to 2^31-1 and padded with 0, n int32
        scalar) as numpy: the JAX package's HostSpectrum.to_device arrays."""
        from kmerax_torch.spectrum.exact import SENTINEL_WORD

        n, w = self.uniq.shape
        if n > capacity:
            raise ValueError(f"{n} distinct k-mers exceed capacity {capacity}")
        uniq = np.concatenate(
            [self.uniq, np.full((capacity - n, w), SENTINEL_WORD, np.uint32)])
        counts = np.concatenate(
            [np.clip(self.counts, 0, 2 ** 31 - 1).astype(np.int32),
             np.zeros(capacity - n, np.int32)])
        return uniq, counts, np.asarray(n, np.int32)

    def to_device(self, capacity: int, device):
        """The padded form on `device`: (uniq (capacity, W) int64 words in
        [0, 2^32), counts (capacity,) int32, n). The words cross as their
        32 bits and widen on the device."""
        uniq, counts, n = self.padded(capacity)
        words = torch.from_numpy(uniq.view(np.int32)).to(device)
        return (words.to(torch.int64) & 0xFFFFFFFF,
                torch.from_numpy(counts).to(device), int(n))
