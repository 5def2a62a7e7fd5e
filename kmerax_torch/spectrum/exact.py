"""Exact k-mer spectrum helpers (port of kmerax/spectrum/exact.py).

Raw canonical k-mer rows collect in a device pending buffer. A one-device
count merges them into the sorted spectrum on that device (`merge_pending`:
the JAX package's `merge_sorted` role; its host merge answered a TPU's padded
1-D sorts, which an H100's radix sort does not have) and copies the spectrum
to the host once, at the stage's end (`spectrum_to_host`). The mesh count merges
on the host (`np_merge_counted`, a numpy copy of the JAX package's function:
it cannot be imported from there without JAX), which the tests also hold
`merge_pending` to.
`searchsorted_words` and `lookup_sorted` search the sentinel-padded sorted
form (`HostSpectrum.to_device`) word by word, as the JAX package does, for
`correct --use-exact`.

Invalid/padding rows use an all-ones SENTINEL row, which is not a valid
canonical k-mer (bits above 2k would be set) and sorts after every real one.
"""

from __future__ import annotations

import numpy as np
import torch

from kmerax_torch.core.codec import words_less

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


def rows_to_keys(rows: torch.Tensor) -> torch.Tensor:
    """(n, W) int32 rows -> (n, ceil(W/2)) int64 keys: each pair of 32-bit
    words, lo word first, read as one little-endian int64 (an odd W gets a
    zero top word). Column 0 holds the least significant words."""
    if rows.shape[1] % 2:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], 1))], dim=1)
    return rows.contiguous().view(torch.int64)


def spectrum_to_host(keys: torch.Tensor, counts: torch.Tensor, w: int):
    """merge_pending's spectrum -> (uniq (M, w) uint32 rows, counts (M,)
    int64) on the host: np_merge_counted's form."""
    rows = keys.cpu().numpy().view(np.uint32)[:, :w]
    return np.ascontiguousarray(rows), counts.cpu().numpy()


_SIGN = -(1 << 63)      # int64's sign bit


def _sort_order(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts (n, K) int64 keys into DESIGN.md §6 order:
    unsigned, most significant column first. An LSD pass a column, stable,
    each column's sign bit flipped so that signed order is unsigned order
    (a lo column spans all 64 bits)."""
    order = None
    for c in range(keys.shape[1]):
        col = keys[:, c] if order is None else keys[order, c]
        o = torch.sort(col ^ _SIGN, stable=True).indices
        order = o if order is None else order[o]
    return order


def merge_pending(keys: torch.Tensor, counts: torch.Tensor,
                  pending: torch.Tensor):
    """Merge raw pending rows into a resident sorted spectrum, on their
    device.

    keys: (M, K) int64 (rows_to_keys form, sorted, distinct), counts: (M,)
    int64; pending: (n, W) int32 rows as K1 wrote them, sentinel rows among
    them. Returns (keys, counts, rows): the merged spectrum in the same form
    and the rows merged (resident + valid new). Equal to np_merge_counted
    on the host rows with weight 1 a new row. Two syncs: the sentinel
    filter's and the compaction's, which sizes the output.
    """
    # a row is the sentinel only if every word is (as np_merge_counted's
    # callers filter); no canonical k-mer's top word is all ones
    new = rows_to_keys(pending[(pending != -1).any(dim=1)])
    keys = torch.cat([keys, new])
    wts = torch.cat([counts, counts.new_ones(new.shape[0])])
    # each temporary goes as soon as it is used: the peak is a few copies
    # of the rows
    del new
    order = _sort_order(keys)
    keys, wts = keys[order], wts[order]
    del order
    start = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    start[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    run = torch.cumsum(start, 0) - 1
    n_rows = keys.shape[0]
    keys = keys[start]
    del start
    return keys, wts.new_zeros(keys.shape[0]).index_add_(0, run, wts), n_rows


def searchsorted_words(uniq_words: torch.Tensor, query_words: torch.Tensor):
    """Vectorized binary search: (..., W) queries -> (idx, found).

    idx is the row of the match (clipped lower-bound otherwise). Sentinel
    padding rows compare greater than every real k-mer, so padding is inert.
    Words are int64 in [0, 2^32) (core/codec.py): torch has no unsigned
    64-bit order on the CPU, so rows compare word by word (words_less).
    """
    m = uniq_words.shape[0]
    steps = max(1, (m - 1).bit_length())
    shape = query_words.shape[:-1]
    lo = torch.zeros(shape, dtype=torch.int64, device=query_words.device)
    hi = torch.full(shape, m, dtype=torch.int64, device=query_words.device)
    for _ in range(steps):
        mid = (lo + hi) // 2
        less = words_less(uniq_words[torch.clamp(mid, 0, m - 1)], query_words)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    idx = torch.clamp(lo, 0, m - 1)
    found = torch.all(uniq_words[idx] == query_words, dim=-1)
    return idx, found


def lookup_sorted(uniq_words: torch.Tensor, counts: torch.Tensor,
                  query_words: torch.Tensor):
    """Counts for queries against a deduped sorted spectrum: (counts,
    found)."""
    idx, found = searchsorted_words(uniq_words, query_words)
    return torch.where(found, counts[idx], 0), found
