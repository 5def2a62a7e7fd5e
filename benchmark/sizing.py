"""The acceptance matrix's sizing rule (kmerax_torch/bench/acceptance.py
`sized_config`), frozen: table sizes from the dataset, so that a cut
dataset keeps a full one's ratio of state to data (and its number of
exact-spectrum flushes a job)."""

from __future__ import annotations

import math


def distinct_kmers(genome_len: int, n_reads: int, read_len: int,
                   error_rate: float, k: int) -> float:
    """Genome k-mers plus up to k novel k-mers per substitution."""
    return genome_len + n_reads * read_len * error_rate * k


def sized(genome_len: int, n_reads: int, read_len: int, error_rate: float,
          k: int) -> dict:
    """{exact_capacity, bloom_log2_width, batch_reads, max_read_len}."""
    distinct = distinct_kmers(genome_len, n_reads, read_len, error_rate, k)
    return {
        "exact_capacity": 1 << max(13, math.ceil(math.log2(distinct
                                                           * 1.75))),
        "bloom_log2_width": max(18, min(30, math.ceil(math.log2(distinct
                                                                * 6)))),
        "batch_reads": 4096 if n_reads >= 64 * 1024 else 1024,
        "max_read_len": read_len + 10,
    }


def n_reads(genome_len: int, coverage: int, read_len: int) -> int:
    """Reads of a paired dataset (whole pairs)."""
    return (genome_len * coverage // read_len) // 2 * 2
