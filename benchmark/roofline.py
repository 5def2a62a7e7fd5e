"""Peaks of one NVIDIA H100 SXM and the work of kernel K1 (Bloom insert),
frozen copies of chip_smoke.py's arithmetic (`HBM_BYTES_PER_S`,
`INT32_OPS_PER_S`, `_kmer_ops`, and phase 2's K1 byte count).

The int32 rate is derived, not published: 132 SMs x 64 INT32 lanes x an
assumed 1.98 GHz boost clock. The HBM rate is NVIDIA's data sheet's
3.35 TB/s, at the 700 W power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
I32_COUNTER_BYTES = 4


def kmer_ops(W: int, n_windows: int, n_kmers: int, lanes: int) -> int:
    """int32 operations to address k-mers from packed words (hash scheme):
    per window the W word extraction and the validity test (4W + 4); per
    valid k-mer the canonical form (25W) and two murmur3 hashes
    (2 x (9W + 8)); per counter lane its address (3) and its atomic add
    (1)."""
    return n_windows * (4 * W + 4) + n_kmers * (43 * W + 16) + 4 * lanes


def k1_work(batches: int, batch_reads: int, max_read_len: int, k: int,
            n_kmers: int, hashes: int) -> tuple[int, int]:
    """(bytes, int32 ops) of K1 over `batches` count batches holding
    `n_kmers` valid k-mers: each batch reads its (B, L) int8 bases, writes
    its B * (L - k + 1) pending rows of W words and an 8-byte valid count;
    each of the `hashes` lanes of a valid k-mer is read and written once."""
    W = (k + 15) // 16
    windows = batches * batch_reads * (max_read_len - k + 1)
    lanes = hashes * n_kmers
    nbytes = (batches * (batch_reads * max_read_len + 8) + 4 * W * windows
              + 2 * I32_COUNTER_BYTES * lanes)
    return nbytes, kmer_ops(W, windows, n_kmers, lanes)


def least_seconds(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the int32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
