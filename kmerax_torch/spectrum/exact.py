"""Exact k-mer spectrum helpers (port of kmerax/spectrum/exact.py).

Raw canonical k-mer rows collect in a device pending buffer; the host merges
them into the sorted spectrum (`np_merge_counted`, a numpy copy of the JAX
package's function: it cannot be imported from there without JAX).

Invalid/padding rows use an all-ones SENTINEL row, which is not a valid
canonical k-mer (bits above 2k would be set) and sorts after every real one.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL_WORD = 0xFFFFFFFF


def sentinel_rows(n: int, w: int, device) -> torch.Tensor:
    """(n, w) int32 rows of the sentinel's bit pattern (pending buffers keep
    32-bit words as int32 bits: half the device bytes of int64)."""
    return torch.full((n, w), -1, dtype=torch.int32, device=device)


def mask_invalid(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace invalid rows of int64 words with the sentinel."""
    return torch.where(valid[..., None], words,
                       torch.full_like(words, SENTINEL_WORD))


def np_merge_counted(rows, weights):
    """Host-side sort+dedup of (N, W) uint32 k-mer rows with int64 weights.

    Returns (uniq (M, W) uint32 in DESIGN.md §6 global order, counts (M,)
    int64). Sentinel rows must be filtered by the caller. k <= 31 rows
    (W=2) take a packed-uint64 sort fast path.
    """
    rows = np.ascontiguousarray(rows)
    weights = np.asarray(weights, dtype=np.int64)
    n, w = rows.shape
    if n == 0:
        return rows.reshape(0, w), weights[:0]
    if w == 2:
        packed = (rows[:, 1].astype(np.uint64) << np.uint64(32)) \
            | rows[:, 0].astype(np.uint64)
        order = np.argsort(packed, kind="stable")
        sp = packed[order]
        is_start = np.concatenate([[True], sp[1:] != sp[:-1]])
        srows = rows[order]
    else:
        order = np.lexsort(tuple(rows[:, i] for i in range(w)))
        srows = rows[order]
        is_start = np.concatenate(
            [[True], np.any(srows[1:] != srows[:-1], axis=1)])
    sw = weights[order]
    out = np.add.reduceat(sw, np.nonzero(is_start)[0])
    return srows[is_start], out
