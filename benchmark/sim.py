"""Paired-end read simulator: the pair model of the acceptance matrix
(kmerax_torch/bench/acceptance.py, drawn vectorised as chip_smoke.py's
`simulate_pairs`), frozen here so that later changes to the program cannot
change the benchmark's inputs.

A random genome of `genome_len` bases; (genome_len * coverage // read_len)
// 2 pairs; insert ~ N(insert_mean, insert_sd) clipped to [2 * read_len,
genome_len]; R1 forward from the fragment start, R2 the reverse complement
from its end; uniform substitutions at `error_rate`; qualities 30..39.
Every seed gives the same sizes: only the draws change.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Dataset:
    genome: np.ndarray          # (G,) uint8 bases 0..3
    bases: list                 # [R1, R2]: (n_pairs, read_len) uint8 0..3
    quals: list                 # [R1, R2]: (n_pairs, read_len) uint8 ASCII
    names: list                 # [R1, R2]: (n_pairs, name_len) uint8 ASCII

    @property
    def n_reads(self) -> int:
        return sum(len(b) for b in self.bases)


def simulate(seed: int, genome_len: int, coverage: int, read_len: int,
             error_rate: float, insert_mean: int,
             insert_sd: int) -> Dataset:
    """The dataset of `seed` (any non-negative integer)."""
    R, G = read_len, genome_len
    rng = np.random.default_rng([seed, 0])
    genome = rng.integers(0, 4, size=G, dtype=np.int64).astype(np.uint8)
    n_pairs = (G * coverage // R) // 2
    rng = np.random.default_rng([seed, 1])
    ins = np.clip(rng.normal(insert_mean, insert_sd, n_pairs), 2 * R,
                  G).astype(np.int64)
    pos = rng.integers(0, G - ins + 1)
    ar = np.arange(R)
    t1 = genome[pos[:, None] + ar]
    t2 = 3 - genome[(pos + ins - R)[:, None] + ar][:, ::-1]
    bases, quals, names = [], [], []
    for mate, true in ((1, t1), (2, t2)):
        errs = rng.random(true.shape) < error_rate
        shifts = rng.integers(1, 4, true.shape).astype(np.uint8)
        bases.append(np.where(errs, (true + shifts) % 4, true)
                     .astype(np.uint8))
        quals.append((rng.integers(30, 40, true.shape) + 33)
                     .astype(np.uint8))
        names.append(np.frombuffer(b"".join(
            b"SIML1C001R%09d/%d" % (i, mate) for i in range(n_pairs)),
            np.uint8).reshape(n_pairs, -1))
    return Dataset(genome, bases, quals, names)


def fastq_bytes(names: np.ndarray, bases: np.ndarray,
                quals: np.ndarray) -> bytes:
    """Fixed-width FASTQ records (`@name`, sequence, `+`, qualities)."""
    n, R = bases.shape
    nl = names.shape[1]
    rec = np.empty((n, nl + 2 * R + 6), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1:1 + nl] = names
    o = 1 + nl
    rec[:, o] = 10
    rec[:, o + 1:o + 1 + R] = _ACGT[bases]
    o += 1 + R
    rec[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, o + 3:o + 3 + R] = quals
    rec[:, -1] = 10
    return rec.tobytes()


def write_fastq_gz(path: str, names, bases, quals, level: int = 1) -> None:
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(fastq_bytes(names, bases, quals))
