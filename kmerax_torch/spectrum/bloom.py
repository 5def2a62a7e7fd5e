"""Device counting-Bloom spectrum (port of kmerax/spectrum/bloom.py;
DESIGN.md §5).

One int32 counter table of 2^log2_width counters in 128-counter block rows;
a k-mer's d probes all fall in one block row, chosen by the "hash" bucket
scheme (DESIGN.md §5a) or the "minimizer" one (§4). The port has i32
counters only. The table is updated
in place (a GPU table at real size is gigabytes; JAX's functional update
has no counterpart the port needs). Inserts go through kernel K1
(`bloom_kernels.bloom_insert`) and the correct round's window solidity
through kernel K2 (`bloom_kernels.bloom_query_solid`); both take the read
batch itself. `query_solid` here is the plain probe of given k-mers, for
the tests and K3's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
    query_solid_plain


@dataclass(frozen=True)
class BloomParams:
    k: int
    log2_width: int                 # table width = 2^log2_width counters
    num_hashes: int = 4
    minimizer_m: int = 11
    log2_buckets: int = 8           # 2^log2_buckets table segments
    bucket_scheme: str = "hash"     # "hash" (DESIGN.md §5a) | "minimizer" (§4)

    def __post_init__(self):
        assert 7 < self.log2_width <= 31
        assert 1 <= self.num_hashes <= 4
        assert self.bucket_scheme in ("hash", "minimizer")
        # the hash scheme reads no bucket count (its bucket folds into h1)
        assert self.bucket_scheme == "hash" \
            or self.log2_buckets <= self.log2_width - 7

    @property
    def width(self) -> int:
        return 1 << self.log2_width


def make_table(params: BloomParams, device) -> torch.Tensor:
    return torch.zeros(params.width, dtype=torch.int32, device=device)


def query_solid(params: BloomParams, table: torch.Tensor, t: int,
                canon_words: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Solidity (count >= t over every probe; invalid -> False) of
    canonical k-mers (..., W) against the int32 table, on any device.
    Equals the JAX package's `query(...) >= t` and `query_solid` on a
    bitmap built with t."""
    block, lp = blocks_lanepack(params, canon_words)
    solid = query_solid_plain(table, block.reshape(-1), lp.reshape(-1),
                              valid.reshape(-1), params.num_hashes, t)
    return solid.view(valid.shape)
