"""Counting-Bloom kernels K1 (insert) and K2 (solidity probe): the CUDA
wrappers and their plain PyTorch versions.

K1 replaces kmerax/spectrum/pallas_bloom.py::_insert_kernel and K2 replaces
pallas_bloom.py::_query_kernel (sources: csrc/bloom.cu). Both take the
Pallas kernels' addressing form: per k-mer a block row (int32), a lanepack
of d 7-bit lanes (int32) and a validity flag. The table is the flat
(nrows * 128,) int32 counter array.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from kmerax_torch.utils import cuda

_CHUNK = 1 << 18                    # k-mers per one-hot slab (plain insert)


def _lanes(lanepack: torch.Tensor, d: int) -> torch.Tensor:
    return torch.stack([(lanepack >> (7 * j)) & 127 for j in range(d)],
                       dim=-1)


def insert_plain(table: torch.Tensor, block: torch.Tensor,
                 lanepack: torch.Tensor, valid: torch.Tensor,
                 d: int) -> None:
    """In place: one one-hot row per k-mer (+1 per probed lane, +2 for a
    repeated lane), scatter-added into its block row — the XLA path of
    kmerax/spectrum/bloom.py::insert. Invalid k-mers add a zero row."""
    table2d = table.view(-1, 128)
    pos = torch.arange(128, dtype=torch.int32, device=table.device)[None, :]
    for s in range(0, block.shape[0], _CHUNK):
        lanes = _lanes(lanepack[s:s + _CHUNK], d)
        oh = sum((lanes[:, j:j + 1] == pos).to(torch.int32)
                 for j in range(d))
        oh = oh * valid[s:s + _CHUNK, None].to(torch.int32)
        table2d.index_add_(0, block[s:s + _CHUNK].to(torch.int64), oh)


def query_solid_plain(table: torch.Tensor, block: torch.Tensor,
                      lanepack: torch.Tensor, valid: torch.Tensor,
                      d: int, t: int) -> torch.Tensor:
    """Gather the d probed lanes of each k-mer's block and test all >= t
    (`bloom.query(...) >= t` of the JAX package); invalid -> False."""
    idx = block.to(torch.int64)[:, None] * 128 + _lanes(lanepack, d)
    return torch.all(table[idx] >= t, dim=-1) & valid


def _check(table, block, lanepack, valid, d):
    dev = table.device
    n = block.shape[0]
    cuda.require(table, "table", torch.int32, dev)
    if table.dim() != 1 or table.shape[0] % 128:
        raise ValueError("table must be flat with a multiple of 128 counters")
    cuda.require(block, "block", torch.int32, dev, (n,))
    cuda.require(lanepack, "lanepack", torch.int32, dev, (n,))
    cuda.require(valid, "valid", torch.bool, dev, (n,))
    if not 1 <= d <= 4:
        raise ValueError(f"num_hashes must be in [1, 4], got {d}")


def bloom_insert(table: torch.Tensor, block: torch.Tensor,
                 lanepack: torch.Tensor, valid: torch.Tensor,
                 d: int) -> None:
    """K1: add a batch of k-mers to the counter table, in place."""
    _check(table, block, lanepack, valid, d)
    if table.device.type == "cpu":
        insert_plain(table, block, lanepack, valid, d)
        return
    rc = cuda.lib().kmerax_bloom_insert(
        table.data_ptr(), block.data_ptr(), lanepack.data_ptr(),
        valid.data_ptr(), block.shape[0], d, cuda.stream())
    cuda.LAUNCHES["bloom_insert"] += 1
    cuda.check(rc, "bloom_insert")


def bloom_query_solid(table: torch.Tensor, block: torch.Tensor,
                      lanepack: torch.Tensor, valid: torch.Tensor,
                      d: int, t: int) -> torch.Tensor:
    """K2: (N,) bool, every probed lane >= t and the k-mer valid."""
    _check(table, block, lanepack, valid, d)
    if table.device.type == "cpu":
        return query_solid_plain(table, block, lanepack, valid, d, t)
    out = torch.empty(block.shape[0], dtype=torch.bool, device=table.device)
    rc = cuda.lib().kmerax_bloom_query_solid(
        table.data_ptr(), block.data_ptr(), lanepack.data_ptr(),
        valid.data_ptr(), out.data_ptr(), block.shape[0], d, int(t),
        cuda.stream())
    cuda.LAUNCHES["bloom_query_solid"] += 1
    cuda.check(rc, "bloom_query_solid")
    return out
