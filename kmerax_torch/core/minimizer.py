"""Minimizer computation & bucket assignment (port of
kmerax/core/minimizer.py; DESIGN.md §4).

minimizer = min over m-mer offsets of mix32(m-mer value), computed on the
canonical-orientation words. Words are int64 holding values in [0, 2^32)
(core/codec.py), so every shift that can leave that range is masked with
`& M32`, and `min` over non-negative int64 is the unsigned min of DESIGN.md
§4. The CUDA kernels compute the same in uint32 (csrc/kmerax.cuh,
kmerax_block).
"""

from __future__ import annotations

import torch

from kmerax_torch.core.codec import M32, num_words
from kmerax_torch.core.hash import mix32


def _extract_bits(words: torch.Tensor, p: int, nbits: int,
                  w: int) -> torch.Tensor:
    """bits [p, p+nbits) of the little-endian multi-word value (static p)."""
    wi, sb = p // 32, p % 32
    mask = (1 << nbits) - 1
    lo = words[..., wi]
    if sb == 0:
        return lo & mask
    val = lo >> sb
    if sb + nbits > 32 and wi + 1 < w:
        val = val | ((words[..., wi + 1] << (32 - sb)) & M32)
    return val & mask


def minimizers(canon_words: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Minimizer of each canonical k-mer; canon_words (..., W) -> (...)
    int64 in [0, 2^32)."""
    assert 0 < m <= 15 and m < k
    w = num_words(k)
    best = torch.full(canon_words.shape[:-1], M32, dtype=torch.int64,
                      device=canon_words.device)
    for j in range(k - m + 1):
        p = 2 * (k - m - j)               # bit offset of m-mer at offset j
        val = _extract_bits(canon_words, p, 2 * m, w)
        best = torch.minimum(best, mix32(val))
    return best


def buckets(canon_words: torch.Tensor, k: int, m: int,
            nbuckets: int) -> torch.Tensor:
    """bucket = minimizer mod nbuckets (DESIGN.md §4), int32."""
    return (minimizers(canon_words, k, m) % nbuckets).to(torch.int32)
