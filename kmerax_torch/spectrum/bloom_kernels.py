"""Counting-Bloom kernels K1 (insert), K1r (insert of routed rows into a
range shard) and K2 (window solidity): the CUDA wrappers and their plain
PyTorch versions (sources: csrc/bloom.cu).

All three address k-mers under either bucket scheme of BloomParams (the
kernels take `scheme_args`). K1 and K2 also take either counter layout of
BloomParams ("i32", or "p16": two saturating 16-bit counters a word,
spectrum/bloom.py), each a kernel of its own (`p16` template instances,
counted apart in cuda.LAUNCHES as "bloom_insert_p16" and
"bloom_query_solid_p16"); K1r takes i32 only, as a sharded spectrum keeps
i32 counters.

K1 replaces kmerax/spectrum/pallas_bloom.py::_insert_kernel together with
the count step's addressing: it takes the (B, L) int8 read batch and does
extraction, canonical form, hashing, the insert, the pending rows and the
valid count in one launch; its p16 form replaces the kernel's `packed16`
branch (pallas_bloom.py:97-103), a saturating halfword add. K2 replaces
pallas_bloom.py::_query_kernel as the correct round calls it
(kmerax/ops/correct.py::_window_counts): it takes the round's (B, L) int32
read batch and last_j and returns the solidity of every window, addressing
them itself, in one launch; its p16 form reads the halfword
(pallas_bloom.py:232-235). The table is the flat (nrows * 128,) int32
counter array, or the (nrows * 64,) p16 words.

K1r replaces the same Pallas kernel as a mesh count calls it on a range
shard (kmerax/spectrum/sharded.py::sharded_insert_step, insert_pallas with
`local_bits`): it takes the canonical k-mer rows the bucket all-to-all
brought to this rank and adds the valid ones into this rank's
2^local_bits slice, addressed as in the global table and masked to the
slice (DESIGN.md §12); it appends those rows alone, in order, to the
pending buffer and returns their number.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from kmerax_torch.core.codec import M32, canonical_words, num_words, \
    to_u32_bits
from kmerax_torch.core.hash import bloom_block, bloom_blocks_lanes
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.core.minimizer import buckets
from kmerax_torch.spectrum.exact import mask_invalid
from kmerax_torch.utils import cuda

if TYPE_CHECKING:
    from kmerax_torch.spectrum.bloom import BloomParams

_CHUNK = 1 << 18                    # k-mers per one-hot slab (plain insert)
_WARPS = 8                          # reads per K1 and K2 block (csrc/bloom.cu)
_SMEM_LIMIT = 48 * 1024             # their shared memory without opt-in
_SMEM_OPT_IN = 227 * 1024           # a block's most, opted in (H100)
_K1R_THREADS = 256                  # threads per K1r block (bloom.cu)
_K1R_BLOCKS = 1024                  # K1r blocks to aim for: ~8 an SM
_K1R_STATUS: dict = {}              # (device, stream) -> (status, epoch)


def _scheme_buckets(params: BloomParams, canon_words: torch.Tensor):
    """None for the hash scheme (the bucket folds into h1), else each
    k-mer's minimizer bucket."""
    if params.bucket_scheme == "hash":
        return None
    return buckets(canon_words, params.k, params.minimizer_m,
                   1 << params.log2_buckets)


def blocks(params: BloomParams, canon_words: torch.Tensor) -> torch.Tensor:
    """Each k-mer's global block (int64) under the params' bucket
    scheme."""
    return bloom_block(canon_words, params.log2_width,
                       _scheme_buckets(params, canon_words),
                       params.log2_buckets)


def blocks_lanepack(params: BloomParams, canon_words: torch.Tensor):
    """(block (...) int32, lanepack (...) int32 with d 7-bit lanes packed) —
    the kernels' addressing form (DESIGN.md §5), under the params' bucket
    scheme."""
    block, lanes = bloom_blocks_lanes(
        canon_words, params.log2_width, params.num_hashes,
        _scheme_buckets(params, canon_words), params.log2_buckets)
    lp = lanes[..., 0]
    for j in range(1, params.num_hashes):
        lp = lp | (lanes[..., j] << (7 * j))
    return block, lp


def scheme_args(params: BloomParams) -> tuple[int, int]:
    """(minimizer_m, log2_buckets) as the kernels take them; m = 0 selects
    the hash scheme."""
    if params.bucket_scheme == "hash":
        return 0, 0
    return params.minimizer_m, params.log2_buckets


def _lanes(lanepack: torch.Tensor, d: int) -> torch.Tensor:
    return torch.stack([(lanepack >> (7 * j)) & 127 for j in range(d)],
                       dim=-1)


def counter_name(base: str, params: BloomParams) -> str:
    """The launch-count name of a kernel in the params' counter layout."""
    return base if params.counter == "i32" else f"{base}_p16"


def insert_plain(table: torch.Tensor, block: torch.Tensor,
                 lanepack: torch.Tensor, valid: torch.Tensor,
                 d: int, counter: str = "i32") -> None:
    """In place: one one-hot row per k-mer (+1 per probed lane, +2 for a
    repeated lane), scatter-added into its block row — the XLA path of
    kmerax/spectrum/bloom.py::insert. Invalid k-mers add a zero row. A p16
    table is unpacked, added to, saturated at SAT16 and packed back, as
    there (bloom.py:151-156)."""
    if counter == "p16":
        from kmerax_torch.spectrum.bloom import SAT16, pack16, unpack16

        t32 = unpack16(table)
        insert_plain(t32, block, lanepack, valid, d)
        table.copy_(pack16(t32.clamp_(max=SAT16)))
        return
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
                 params.num_hashes, params.counter)
    if pending is not None:
        rows = mask_invalid(canon, valid).reshape(-1, num_words(k))
        pending[off:off + rows.shape[0]] = to_u32_bits(rows)
    return valid.sum()


def _check_batch(table, bases, dtype, params):
    """The table (in the params' counter layout) and the (B, L) read batch
    K1 and K2 take."""
    dev = table.device
    cuda.require(table, "table", torch.int32, dev, (params.table_entries,))
    cuda.require(bases, "bases", dtype, dev)
    if bases.dim() != 2:
        raise ValueError(f"bases: shape {tuple(bases.shape)}, expected (B, L)")
    L = bases.shape[1]
    if L < params.k:
        raise ValueError(f"read length {L} < k {params.k}")
    if _WARPS * (3 * -(-L // 32) + 1) * 4 > _SMEM_LIMIT:
        raise ValueError(f"read length {L} needs more shared memory than "
                         f"the kernels take")


def _staged_smem_bytes(L: int, params: BloomParams) -> int:
    """K1's and K2's dynamic shared memory a block
    (csrc/bloom.cu::staged_smem_bytes): each warp's packed read and, under
    the minimizer scheme, its staged m-mer hashes, F and R for the L-m+1
    positions, each rounded up to 32 words."""
    words = 3 * -(-L // 32) + 1
    if params.bucket_scheme == "minimizer":
        words += 2 * (-(-(L - params.minimizer_m + 1) // 32) * 32)
    return _WARPS * words * 4


def _check_staged(table, bases, params, kernel: str, static_bytes: int):
    """On a card: the block's staging (plus `static_bytes` of the kernel's
    own) within what a block may opt in to."""
    L = bases.shape[1]
    if table.device.type == "cuda" \
            and _staged_smem_bytes(L, params) + static_bytes > _SMEM_OPT_IN:
        raise ValueError(f"read length {L} needs more shared memory than "
                         f"{kernel} stages under the minimizer scheme")


def _check_insert(table, bases, params, pending, off):
    _check_batch(table, bases, torch.int8, params)
    dev = table.device
    B, L = bases.shape
    _check_staged(table, bases, params, "K1", 4)   # + the block's count
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
    counter table (in the params' layout; p16 counters saturate at SAT16)
    in place, and write their pending rows from row `off` when `pending`
    ((P, W) int32) is given. Returns the number of valid k-mers as a device
    int64 scalar."""
    _check_insert(table, bases, params, pending, off)
    if table.device.type == "cpu":
        return bloom_insert_plain(table, bases, params, pending, off)
    n_valid = torch.zeros((), dtype=torch.int64, device=table.device)
    B, L = bases.shape
    rc = cuda.lib().kmerax_bloom_insert(
        table.data_ptr(), bases.data_ptr(), B, L, params.k,
        (1 << (params.log2_width - 7)) - 1, params.num_hashes,
        *scheme_args(params), int(params.counter == "p16"),
        None if pending is None else pending.data_ptr(), off,
        n_valid.data_ptr(), cuda.stream())
    name = counter_name("bloom_insert", params)
    cuda.LAUNCHES[name] += 1
    cuda.check(rc, name)
    return n_valid


def bloom_insert_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                            rvalid: torch.Tensor, params: BloomParams,
                            local_bits: int,
                            pending: Optional[torch.Tensor] = None,
                            off: int = 0) -> torch.Tensor:
    """Plain version of K1r, the JAX package's `insert(..., local_bits=)`:
    address the canonical rows ((N, W) int32 words) in the global table,
    keep the low local_bits - 7 bits of each block and insert the valid
    rows into the (2^local_bits,) slice in place; write the valid rows
    alone, in order (rows[rvalid]), to pending from row `off` when pending
    is given. Returns their number (int64 scalar)."""
    block, lp = blocks_lanepack(params, rows.to(torch.int64) & M32)
    block = block & ((1 << (local_bits - 7)) - 1)
    insert_plain(table, block, lp, rvalid, params.num_hashes)
    if pending is not None:
        kept = rows[rvalid]
        pending[off:off + kept.shape[0]] = kept
    return rvalid.sum()


def _k1r_status(device: torch.device, n_tiles: int):
    """(status, epoch) of K1r's look-back on this device and stream: one
    int64 word per tile, kept between launches; each launch tags its words
    with a new epoch, so the words need clearing only when the buffer
    grows or the epochs run out."""
    key = (device, cuda.stream())
    status, epoch = _K1R_STATUS.get(key, (None, 0))
    if status is None or status.numel() < n_tiles or epoch + 1 >= 1 << 30:
        status = torch.zeros(n_tiles, dtype=torch.int64, device=device)
        epoch = 0
    _K1R_STATUS[key] = (status, epoch + 1)
    return status, epoch + 1


def k1r_slots_per_thread(n: int) -> int:
    """K1r's routed slots a thread for n slots: 4 where that still gives
    _K1R_BLOCKS blocks, else 2: on an H100, the faster of 1, 2 and 4 at
    the slots one shard of S = 1, 2, 4 and 8 takes (chip_smoke.py's
    `_k1r_by_spt`)."""
    return 4 if -(-n // (_K1R_THREADS * 4)) >= _K1R_BLOCKS else 2


def bloom_insert_rows(table: torch.Tensor, rows: torch.Tensor,
                      rvalid: torch.Tensor, params: BloomParams,
                      local_bits: int, pending: Optional[torch.Tensor] = None,
                      off: int = 0) -> torch.Tensor:
    """K1r: insert the valid canonical rows ((N, W) int32 words, (N,) bool
    rvalid) into this rank's (2^local_bits,) int32 slice of the table
    whose parameters are `params`, in place; write the valid rows alone,
    in order (rows[rvalid]), from row `off` of `pending` ((P, W) int32)
    when given, leaving its other rows as they were. `pending` must have
    room for all N rows from `off` (the valid count is known only after the
    launch). Returns the number of valid rows as a device int64 scalar."""
    dev = table.device
    if params.counter != "i32":
        raise ValueError("sharded spectra keep i32 counters (packed-halfword "
                         "psum carries)")
    if not 7 < local_bits <= params.log2_width:
        raise ValueError(f"local_bits {local_bits} outside (7, "
                         f"{params.log2_width}]")
    cuda.require(table, "table", torch.int32, dev, (1 << local_bits,))
    cuda.require(rows, "rows", torch.int32, dev)
    W = num_words(params.k)
    if rows.dim() != 2 or rows.shape[1] != W:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected "
                         f"(N, {W})")
    N = rows.shape[0]
    if N >= 1 << 31:
        raise ValueError(f"{N} rows: K1r takes fewer than 2^31")
    cuda.require(rvalid, "rvalid", torch.bool, dev, (N,))
    if pending is not None:
        cuda.require(pending, "pending", torch.int32, dev)
        if pending.dim() != 2 or pending.shape[1] != W:
            raise ValueError(f"pending: shape {tuple(pending.shape)}, "
                             f"expected (P, {W})")
        if not 0 <= off <= pending.shape[0] - N:
            raise ValueError(f"pending rows [{off}, {off + N}) outside "
                             f"[0, {pending.shape[0]})")
    if dev.type == "cpu":
        return bloom_insert_rows_plain(table, rows, rvalid, params,
                                       local_bits, pending, off)
    if N == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    n_valid = torch.empty((), dtype=torch.int64, device=dev)  # last tile's
    spt = k1r_slots_per_thread(N)
    status, epoch = _k1r_status(dev, -(-N // (_K1R_THREADS * spt)))
    rc = cuda.lib().kmerax_bloom_insert_rows(
        table.data_ptr(), rows.data_ptr(), rvalid.data_ptr(), N, params.k,
        (1 << (params.log2_width - 7)) - 1, (1 << (local_bits - 7)) - 1,
        params.num_hashes, *scheme_args(params),
        None if pending is None else pending.data_ptr(), off,
        status.data_ptr(), epoch, spt, n_valid.data_ptr(), cuda.stream())
    cuda.LAUNCHES["bloom_insert_rows"] += 1
    cuda.check(rc, "bloom_insert_rows")
    return n_valid


def query_solid_plain(table: torch.Tensor, block: torch.Tensor,
                      lanepack: torch.Tensor, valid: torch.Tensor,
                      d: int, t: int, counter: str = "i32") -> torch.Tensor:
    """Gather the d probed lanes of each k-mer's block and test all >= t
    (`bloom.query(...) >= t` of the JAX package); invalid -> False. A p16
    counter is the halfword block & 1 of word row block >> 1
    (bloom.py:274-280)."""
    block = block.to(torch.int64)
    if counter == "p16":
        idx = (block >> 1)[:, None] * 128 + _lanes(lanepack, d)
        shift = (16 * (block & 1))[:, None]
        vals = (table[idx].to(torch.int64) >> shift) & 0xFFFF
    else:
        vals = table[block[:, None] * 128 + _lanes(lanepack, d)]
    return torch.all(vals >= t, dim=-1) & valid


def bloom_query_solid_plain(table: torch.Tensor, bases: torch.Tensor,
                            last_j: torch.Tensor, params: BloomParams,
                            t: int) -> torch.Tensor:
    """Plain version of K2, `_window_counts(...)[0]` of the JAX package
    with the Bloom solidity: extract the k-mers of the (B, L) batch,
    canonicalize and address them, probe, and keep the windows that start
    in [0, last_j]. Returns (B, L-k+1) bool."""
    k = params.k
    words, valid = extract_kmers(bases, k)
    canon, _ = canonical_words(words, k)
    block, lp = blocks_lanepack(params, canon)
    solid = query_solid_plain(table, block.reshape(-1), lp.reshape(-1),
                              valid.reshape(-1), params.num_hashes, t,
                              params.counter)
    j = torch.arange(valid.shape[1], dtype=torch.int32, device=bases.device)
    return solid.view(valid.shape) & (j[None, :] <= last_j[:, None])


def bloom_query_solid(table: torch.Tensor, bases: torch.Tensor,
                      last_j: torch.Tensor, params: BloomParams,
                      t: int) -> torch.Tensor:
    """K2: the round-start solidity of every window of the (B, L) int32
    read batch, (B, L-k+1) bool: window j of read r is solid iff it starts
    in [0, last_j[r]], holds no base >= 4, and every one of the d probed
    lanes of its canonical k-mer is >= t (in the params' counter
    layout)."""
    _check_batch(table, bases, torch.int32, params)
    _check_staged(table, bases, params, "K2", 0)
    cuda.require(last_j, "last_j", torch.int32, table.device,
                 (bases.shape[0],))
    if table.device.type == "cpu":
        return bloom_query_solid_plain(table, bases, last_j, params, t)
    B, L = bases.shape
    out = torch.empty((B, L - params.k + 1), dtype=torch.bool,
                      device=table.device)
    rc = cuda.lib().kmerax_bloom_query_solid(
        table.data_ptr(), bases.data_ptr(), B, L, params.k,
        last_j.data_ptr(), (1 << (params.log2_width - 7)) - 1,
        params.num_hashes, *scheme_args(params),
        int(params.counter == "p16"), int(t), out.data_ptr(), cuda.stream())
    name = counter_name("bloom_query_solid", params)
    cuda.LAUNCHES[name] += 1
    cuda.check(rc, name)
    return out
