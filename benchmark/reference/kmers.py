"""k-mers as integers, murmur3 fmix32 hashing and the counting Bloom's
probe lanes (DESIGN.md §§1-5, as oracle/codec.py and oracle/count.py
define them), in plain torch over whole arrays.

A k-mer (odd k <= 31) is the integer of its 2-bit bases, first base most
significant, held in int64; its words are the little-endian uint32 halves.
uint32 arithmetic is done in int64 and masked: no product exceeds 2^48.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
HASH_SEED_1 = 0x9E3779B1
HASH_SEED_2 = 0x85EBCA77


def check_k(k: int) -> None:
    if k % 2 == 0 or not 0 < k <= 31:
        raise ValueError(f"the reference takes odd k <= 31, got {k}")


def windows(bases: torch.Tensor, k: int):
    """(fwd, rc, valid) of every k-window of (N, L) bases 0..4 (4 = N):
    (N, L - k + 1) int64 forward and reverse-complement integers, and
    whether the window holds no N."""
    b = bases.to(torch.int64)
    nk = b.shape[1] - k + 1
    fwd = torch.zeros((b.shape[0], nk), dtype=torch.int64, device=b.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros_like(fwd, dtype=torch.bool)
    for i in range(k):
        x = b[:, i:i + nk]
        bad |= x >= 4
        fwd = (fwd << 2) | (x & 3)
    for i in range(k - 1, -1, -1):
        rc = (rc << 2) | (3 - (b[:, i:i + nk] & 3))
    return fwd, rc, ~bad


def revcomp(v: torch.Tensor, k: int) -> torch.Tensor:
    r = torch.zeros_like(v)
    x = v
    for _ in range(k):
        r = (r << 2) | (3 - (x & 3))
        x = x >> 2
    return r


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x):
    """murmur3 fmix32 of uint32 values held in int64 (or a Python int)."""
    if isinstance(x, int):
        x &= M32
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & M32
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & M32
        return x ^ (x >> 16)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def kmer_hash(v: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """h = mix32(seed); for each little-endian word w: h = mix32(h ^ w)."""
    h = mix32(seed)
    for i in range((k + 15) // 16):
        h = mix32(((v >> (32 * i)) & M32) ^ h)
    return h


def probes(canon: torch.Tensor, k: int, log2_width: int,
           hashes: int) -> torch.Tensor:
    """(..., hashes) counter indices of canonical k-mers under the hash
    bucket scheme: block = the low log2_width - 7 bits of h1, lane i =
    bits 7i..7i+6 of h2."""
    if hashes > 4:
        raise ValueError("at most 4 hashes")
    h1 = kmer_hash(canon, k, HASH_SEED_1)
    h2 = kmer_hash(canon, k, HASH_SEED_2)
    block = h1 & ((1 << (log2_width - 7)) - 1)
    lanes = torch.stack([(h2 >> (7 * i)) & 127 for i in range(hashes)],
                        dim=-1)
    return (block << 7)[..., None] | lanes
