"""Counting-Bloom kernels K1 (insert) and K2 (solidity probe): the CUDA
wrappers and their plain PyTorch versions (sources: csrc/bloom.cu).

K1 replaces kmerax/spectrum/pallas_bloom.py::_insert_kernel together with
the count step's addressing: it takes the (B, L) int8 read batch and does
extraction, canonical form, hashing, the insert, the pending rows and the
valid count in one launch. K2 replaces pallas_bloom.py::_query_kernel and
takes the Pallas kernels' addressing form: per k-mer a block row (int32),
a lanepack of d 7-bit lanes (int32) and a validity flag. The table is the
flat (nrows * 128,) int32 counter array.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from kmerax_torch.core.codec import canonical_words, num_words, to_u32_bits
from kmerax_torch.core.hash import bloom_blocks_lanes
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.spectrum.exact import mask_invalid
from kmerax_torch.utils import cuda

if TYPE_CHECKING:
    from kmerax_torch.spectrum.bloom import BloomParams

_CHUNK = 1 << 18                    # k-mers per one-hot slab (plain insert)
_K1_WARPS = 8                       # reads per K1 block (csrc/bloom.cu)
_SMEM_LIMIT = 48 * 1024             # K1's shared memory without opt-in


def blocks_lanepack(params: BloomParams, canon_words: torch.Tensor):
    """(block (...) int32, lanepack (...) int32 with d 7-bit lanes packed) —
    the kernels' addressing form (DESIGN.md §5)."""
    block, lanes = bloom_blocks_lanes(canon_words, params.log2_width,
                                      params.num_hashes)
    lp = lanes[..., 0]
    for j in range(1, params.num_hashes):
        lp = lp | (lanes[..., j] << (7 * j))
    return block, lp


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


def bloom_insert_plain(table: torch.Tensor, bases: torch.Tensor,
                       params: BloomParams,
                       pending: Optional[torch.Tensor] = None,
                       off: int = 0) -> torch.Tensor:
    """Plain version of K1, the JAX package's count step: extract the
    k-mers of the (B, L) batch, canonicalize, address and insert them;
    write their rows (canonical words as uint32 bits, the all-ones sentinel
    for an invalid window) to pending[off:off + B*(L-k+1)] when pending is
    given. Returns the number of valid k-mers (int64 scalar)."""
    k = params.k
    words, valid = extract_kmers(bases, k)
    canon, _ = canonical_words(words, k)
    block, lp = blocks_lanepack(params, canon)
    insert_plain(table, block.reshape(-1), lp.reshape(-1), valid.reshape(-1),
                 params.num_hashes)
    if pending is not None:
        rows = mask_invalid(canon, valid).reshape(-1, num_words(k))
        pending[off:off + rows.shape[0]] = to_u32_bits(rows)
    return valid.sum()


def _check_insert(table, bases, params, pending, off):
    dev = table.device
    cuda.require(table, "table", torch.int32, dev, (params.width,))
    cuda.require(bases, "bases", torch.int8, dev)
    if bases.dim() != 2:
        raise ValueError(f"bases: shape {tuple(bases.shape)}, expected (B, L)")
    B, L = bases.shape
    if L < params.k:
        raise ValueError(f"read length {L} < k {params.k}")
    if _K1_WARPS * (3 * -(-L // 32) + 1) * 4 > _SMEM_LIMIT:
        raise ValueError(f"read length {L} needs more shared memory than "
                         f"K1 takes")
    if pending is not None:
        cuda.require(pending, "pending", torch.int32, dev)
        rows = B * (L - params.k + 1)
        if pending.dim() != 2 or pending.shape[1] != num_words(params.k):
            raise ValueError(f"pending: shape {tuple(pending.shape)}, "
                             f"expected (P, {num_words(params.k)})")
        if not 0 <= off <= pending.shape[0] - rows:
            raise ValueError(f"pending rows [{off}, {off + rows}) outside "
                             f"[0, {pending.shape[0]})")


def bloom_insert(table: torch.Tensor, bases: torch.Tensor,
                 params: BloomParams, pending: Optional[torch.Tensor] = None,
                 off: int = 0) -> torch.Tensor:
    """K1: insert every k-mer of the (B, L) int8 read batch into the
    counter table in place, and write their pending rows from row `off`
    when `pending` ((P, W) int32) is given. Returns the number of valid
    k-mers as a device int64 scalar."""
    _check_insert(table, bases, params, pending, off)
    if table.device.type == "cpu":
        return bloom_insert_plain(table, bases, params, pending, off)
    n_valid = torch.zeros((), dtype=torch.int64, device=table.device)
    B, L = bases.shape
    rc = cuda.lib().kmerax_bloom_insert(
        table.data_ptr(), bases.data_ptr(), B, L, params.k,
        (1 << (params.log2_width - 7)) - 1, params.num_hashes,
        None if pending is None else pending.data_ptr(), off,
        n_valid.data_ptr(), cuda.stream())
    cuda.LAUNCHES["bloom_insert"] += 1
    cuda.check(rc, "bloom_insert")
    return n_valid


def query_solid_plain(table: torch.Tensor, block: torch.Tensor,
                      lanepack: torch.Tensor, valid: torch.Tensor,
                      d: int, t: int) -> torch.Tensor:
    """Gather the d probed lanes of each k-mer's block and test all >= t
    (`bloom.query(...) >= t` of the JAX package); invalid -> False."""
    idx = block.to(torch.int64)[:, None] * 128 + _lanes(lanepack, d)
    return torch.all(table[idx] >= t, dim=-1) & valid


def _check_query(table, block, lanepack, valid, d):
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


def bloom_query_solid(table: torch.Tensor, block: torch.Tensor,
                      lanepack: torch.Tensor, valid: torch.Tensor,
                      d: int, t: int) -> torch.Tensor:
    """K2: (N,) bool, every probed lane >= t and the k-mer valid."""
    _check_query(table, block, lanepack, valid, d)
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
