"""Shared inputs for the port's parity tests: seeded numpy data handed to
both packages."""

import numpy as np
import torch


def reads_with_ns(seed: int, B: int, L: int, k: int, n_rate=0.004,
                  err_rate=0.03, with_errors=False):
    """(B, L) int32 bases from a shared 2 kb genome (k-mers repeat) with
    substitutions, Ns, and ragged lengths >= k padded with 4; with_errors
    also returns the (B, L) mask of substituted bases."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000).astype(np.int32)
    starts = rng.integers(0, 2000 - L, B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]]
    errs = rng.random(reads.shape) < err_rate
    reads = np.where(errs, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.int32)
    reads[rng.random(reads.shape) < n_rate] = 4
    lengths = np.full(B, L, np.int32)
    lengths[: B // 8] = rng.integers(k, L + 1, B // 8)
    for i in range(B):
        reads[i, lengths[i]:] = 4
    if with_errors:
        return reads, lengths, errs & (np.arange(L)[None, :] < lengths[:, None])
    return reads, lengths


def t(x) -> torch.Tensor:
    """numpy (or JAX array via numpy) -> CPU tensor; uint32 becomes int64
    words in [0, 2^32), the port's representation."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
