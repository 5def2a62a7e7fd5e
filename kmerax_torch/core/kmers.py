"""Rolling k-mer extraction from base arrays (port of kmerax/core/kmers.py)."""

from __future__ import annotations

import torch

from kmerax_torch.core.codec import num_words


def extract_kmers(bases: torch.Tensor, k: int):
    """All k-mer windows of each read.

    Args:
      bases: (..., L) integer base codes (0..3 valid, >=4 invalid).
      k: odd k, 0 < k <= 63.
    Returns:
      words: (..., L-k+1, W) int64 words in [0, 2^32), little-endian packed
             forward k-mers (garbage where invalid).
      valid: (..., L-k+1) bool — window contains no invalid base.
    """
    L = bases.shape[-1]
    assert L >= k, f"read length {L} < k {k}"
    nk = L - k + 1
    b = (bases.to(torch.int64) & 7) & 3   # mask so invalid bases can't bleed
    win = b.unfold(-1, k, 1)              # (..., nk, k) view, no copy

    # word wi folds window positions [lo, hi) with the leftmost base in the
    # highest bits: sum of b[i] * 4^(hi-1-i) — one reduction per word
    # instead of a shift-or per base (the sum never exceeds 32 bits)
    words = []
    for wi in range(num_words(k)):
        lo = max(k - 16 * (wi + 1), 0)
        hi = k - 16 * wi
        pow4 = 4 ** torch.arange(hi - lo - 1, -1, -1, dtype=torch.int64,
                                 device=bases.device)
        words.append((win[..., lo:hi] * pow4).sum(dim=-1))
    words = torch.stack(words, dim=-1)

    bad = (bases >= 4).to(torch.int32)
    cum = torch.cumsum(bad, dim=-1)
    cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)  # (..., L+1)
    valid = (cum[..., k:] - cum[..., :nk]) == 0
    return words, valid
