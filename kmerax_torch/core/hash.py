"""K-mer hashing for Bloom probes (port of kmerax/core/hash.py).

murmur3 fmix32 over 32-bit words held in int64 (see core/codec.py);
semantics frozen in DESIGN.md §3. This is the port's one hash source: the
CUDA kernels (csrc/kmerax.cuh) implement the same function in uint32 and the
tests hold them against it.
"""

from __future__ import annotations

import torch

from kmerax_torch.core.codec import M32

HASH_SEED_1 = 0x9E3779B1
HASH_SEED_2 = 0x85EBCA77


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) without int64 overflow: split x
    into 16-bit halves so every partial product stays below 2^49."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer; wrapping 32-bit arithmetic."""
    x = x.to(torch.int64) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def kmer_hash(words: torch.Tensor, seed: int) -> torch.Tensor:
    """h = mix32(seed); for w in words: h = mix32(h ^ w). words: (..., W)."""
    h = mix32(torch.full(words.shape[:-1], seed, dtype=torch.int64,
                         device=words.device))
    for i in range(words.shape[-1]):
        h = mix32(h ^ words[..., i])
    return h


def bloom_blocks_lanes(words: torch.Tensor, log2_width: int, d: int):
    """Register-blocked Bloom addressing, hash bucket scheme (DESIGN.md
    §§5, 5a): the block is the low (log2_width - 7) bits of h1 and the d
    probes are 7-bit lanes of h2 inside that 128-counter block.

    Returns (block (...) int32 global block index, lanes (..., d) int32).
    """
    assert d <= 4
    h1 = kmer_hash(words, HASH_SEED_1)
    h2 = kmer_hash(words, HASH_SEED_2)
    block = h1 & ((1 << (log2_width - 7)) - 1)
    lanes = torch.stack([(h2 >> (7 * i)) & 127 for i in range(d)], dim=-1)
    return block.to(torch.int32), lanes.to(torch.int32)
