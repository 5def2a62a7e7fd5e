"""Device counting-Bloom spectrum (port of kmerax/spectrum/bloom.py;
DESIGN.md §5).

One int32 counter table of 2^log2_width counters in 128-counter block rows;
a k-mer's d probes all fall in one block row. The port has the "hash"
bucket scheme (DESIGN.md §5a) and i32 counters only. The table is updated
in place (a GPU table at real size is gigabytes; JAX's functional update
has no counterpart the port needs).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kmerax_torch.core.hash import bloom_blocks_lanes
from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
    bloom_query_solid


@dataclass(frozen=True)
class BloomParams:
    k: int
    log2_width: int                 # table width = 2^log2_width counters
    num_hashes: int = 4

    def __post_init__(self):
        assert 7 < self.log2_width <= 31
        assert 1 <= self.num_hashes <= 4

    @property
    def width(self) -> int:
        return 1 << self.log2_width


def make_table(params: BloomParams, device) -> torch.Tensor:
    return torch.zeros(params.width, dtype=torch.int32, device=device)


def blocks_lanepack(params: BloomParams, canon_words: torch.Tensor):
    """(block (...) int32, lanepack (...) int32 with d 7-bit lanes packed) —
    the kernels' addressing form (DESIGN.md §5)."""
    block, lanes = bloom_blocks_lanes(canon_words, params.log2_width,
                                      params.num_hashes)
    lp = lanes[..., 0]
    for j in range(1, params.num_hashes):
        lp = lp | (lanes[..., j] << (7 * j))
    return block, lp


def insert(params: BloomParams, table: torch.Tensor,
           canon_words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Add one batch of canonical k-mers (..., W) to the table in place
    (kernel K1 on the card); returns the table."""
    block, lp = blocks_lanepack(params, canon_words)
    bloom_insert(table, block.reshape(-1), lp.reshape(-1),
                 valid.reshape(-1), params.num_hashes)
    return table


def query_solid(params: BloomParams, table: torch.Tensor, t: int,
                canon_words: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Solidity (count >= t over every probe; invalid -> False) of
    canonical k-mers (..., W) against the int32 table (kernel K2 on the
    card). Equals the JAX package's `query(...) >= t` and `query_solid` on
    a bitmap built with t."""
    block, lp = blocks_lanepack(params, canon_words)
    solid = bloom_query_solid(table, block.reshape(-1), lp.reshape(-1),
                              valid.reshape(-1), params.num_hashes, t)
    return solid.view(valid.shape)
