"""Device counting-Bloom spectrum (port of kmerax/spectrum/bloom.py;
DESIGN.md §5).

A table of 2^log2_width counters in 128-counter block rows; a k-mer's d
probes all fall in one block row, chosen by the "hash" bucket scheme
(DESIGN.md §5a) or the "minimizer" one (§4). Counters are stored as
`counter`:
- "i32": one int32 a counter, a (width,) int32 table;
- "p16": two saturating 16-bit counters in each int32 word, a (width/2,)
  table in the JAX package's pack16 layout: word row r holds block rows 2r
  (low half) and 2r+1 (high half), lane by lane, so block b lives at word
  row b >> 1, halfword b & 1. A counter stops at SAT16; min(sum, SAT16) is
  the same whatever the order of the adds, and solidity is unchanged for
  any threshold t <= SAT16.
The table is updated in place (a GPU table at real size is gigabytes; JAX's
functional update has no counterpart the port needs). Inserts go through
kernel K1 (`bloom_kernels.bloom_insert`) and the correct round's window
solidity through kernel K2 (`bloom_kernels.bloom_query_solid`), both in
either layout; both take the read batch itself. `query_solid` here is the
plain probe of given k-mers, for the tests and K3's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kmerax_torch.core.codec import to_u32_bits
from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
    query_solid_plain

SAT16 = (1 << 15) - 1               # p16 counter saturation ceiling


@dataclass(frozen=True)
class BloomParams:
    k: int
    log2_width: int                 # table width = 2^log2_width counters
    num_hashes: int = 4
    minimizer_m: int = 11
    log2_buckets: int = 8           # 2^log2_buckets table segments
    bucket_scheme: str = "hash"     # "hash" (DESIGN.md §5a) | "minimizer" (§4)
    counter: str = "i32"            # "i32" | "p16" (module docstring)

    def __post_init__(self):
        assert 7 < self.log2_width <= 31
        assert 1 <= self.num_hashes <= 4
        assert self.bucket_scheme in ("hash", "minimizer")
        # the hash scheme reads no bucket count (its bucket folds into h1)
        assert self.bucket_scheme == "hash" \
            or self.log2_buckets <= self.log2_width - 7
        assert self.counter in ("i32", "p16")
        if self.counter == "p16":
            assert self.log2_width >= 9, "p16 needs >= 2 block rows"

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    @property
    def table_entries(self) -> int:
        """int32 words in the table (width for i32, width/2 for p16)."""
        return self.width if self.counter == "i32" else self.width // 2


def make_table(params: BloomParams, device) -> torch.Tensor:
    return torch.zeros(params.table_entries, dtype=torch.int32,
                       device=device)


def pack16(table_i32: torch.Tensor) -> torch.Tensor:
    """(width,) int32 counters -> (width/2,) p16 words: adjacent 128-lane
    block rows pair into one word row, word[r, l] = cnt[2r, l] |
    cnt[2r+1, l] << 16 (counters must already be <= SAT16)."""
    t = table_i32.reshape(-1, 2, 128).to(torch.int64)
    return to_u32_bits(t[:, 0] | (t[:, 1] << 16)).reshape(-1)


def unpack16(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack16: (width/2,) p16 words -> (width,) int32
    counters."""
    w = packed.reshape(-1, 128).to(torch.int64)
    return torch.stack([w & 0xFFFF, (w >> 16) & 0xFFFF],
                       dim=1).reshape(-1).to(torch.int32)


def query_solid(params: BloomParams, table: torch.Tensor, t: int,
                canon_words: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Solidity (count >= t over every probe; invalid -> False) of
    canonical k-mers (..., W) against the table in the params' layout, on
    any device. Equals the JAX package's `query(...) >= t` and
    `query_solid` on a bitmap built with t."""
    block, lp = blocks_lanepack(params, canon_words)
    solid = query_solid_plain(table, block.reshape(-1), lp.reshape(-1),
                              valid.reshape(-1), params.num_hashes, t,
                              params.counter)
    return solid.view(valid.shape)
