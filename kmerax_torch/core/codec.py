"""2-bit DNA codec over W-word k-mers (port of kmerax/core/codec.py).

A k-mer is W = ceil(k/16) little-endian 32-bit words (`words[..., 0]` = the
least-significant 32 bits); k=31 -> 2 words, k=63 -> 4 (DESIGN.md §§1-2).

torch on the CPU has no `>>` or `flip` for uint32, so the port carries each
32-bit word in an int64 holding a value in [0, 2^32). Every shift that can
leave that range is masked with `& M32`, so values stay non-negative and
`<`, `==` and `min` are the unsigned comparisons DESIGN.md §2 defines.
Host helpers are numpy; `to_u32_bits` converts at the host boundary.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_INVALID = 4
M32 = 0xFFFFFFFF

_LUT = np.full(256, BASE_INVALID, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _LUT[ord(_ch)] = _v
_BASE_CHR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def num_words(k: int) -> int:
    return (k + 15) // 16


def seq_bytes_to_bases(buf: np.ndarray) -> np.ndarray:
    """Host-side: ASCII uint8 array -> base codes (vectorized LUT)."""
    return _LUT[buf]


def bases_to_seq_bytes(bases: np.ndarray) -> np.ndarray:
    """Host-side: base codes -> ASCII uint8 ('N' for 4)."""
    return _BASE_CHR[np.minimum(bases, 4)]


def seq_to_bases(seq: str | bytes) -> np.ndarray:
    """Host-side: ASCII sequence -> uint8 base codes (DESIGN.md §1)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def bases_to_seq(bases: np.ndarray) -> str:
    """Host-side: uint8 base codes -> ASCII str (4 -> 'N')."""
    return bases_to_seq_bytes(np.asarray(bases, dtype=np.uint8)) \
        .tobytes().decode("ascii")


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same 32 bits
    (numpy `.view(np.uint32)` on the host recovers the unsigned value)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _reverse_pairs_u32(w: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups within each 32-bit word."""
    w = ((w & 0x33333333) << 2) | ((w >> 2) & 0x33333333)
    w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return ((w << 16) & M32) | (w >> 16)


def revcomp_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-complement of packed k-mers; words shape (..., W)."""
    w = num_words(k)
    assert words.shape[-1] == w
    x = words ^ M32                       # complement: b -> 3-b == b^3
    x = _reverse_pairs_u32(x)             # reverse 2-bit groups within words
    x = torch.flip(x, dims=(-1,))         # reverse word order
    s = 32 * w - 2 * k                    # 0 <= s < 32 by construction
    if s == 0:
        return x
    hi = torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)
    return (x >> s) | ((hi << (32 - s)) & M32)


def words_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned big-integer a < b over the little-endian word axis."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1]):          # low word first; high words dominate
        lt = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & lt)
    return lt


def words_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def words_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return words_less(a, b) | words_equal(a, b)


def canonical_words(words: torch.Tensor, k: int):
    """(canonical words, is_forward) — min(fwd, revcomp) per DESIGN.md §2."""
    rc = revcomp_words(words, k)
    is_fwd = words_le(words, rc)
    canon = torch.where(is_fwd[..., None], words, rc)
    return canon, is_fwd
