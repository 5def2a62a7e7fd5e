"""Bucket-sharded spectrum over the ("data", "bucket") mesh (port of
kmerax/spectrum/sharded.py; DESIGN.md §12), one process per rank.

The count path: each rank extracts the k-mers of its rows of the batch,
canonicalizes them and routes them by all-to-all over its bucket group to
their bucket-owner rank (the route prep is plain torch, as the JAX package's
jnp), which inserts them into its range shard of the GLOBAL segmented Bloom
table with kernel K1r (DESIGN.md §§5,12). At stage end the partial shards
are summed over "data" and, within the replicate budget, all-gathered over
"bucket" into one replicated global table. Because probe indices are global
and adds commute, the merged table is bit-identical for every mesh shape
(DESIGN.md §13).

Routing uses fixed-capacity per-destination slots: capacity = route_safety
x fair share. Overflow is counted, summed over the world before anything is
written, and the driver replays the batch at a doubled capacity; query
routing is lossless (capacity n).

Each rank keeps the valid routed rows it received in a pending buffer
(K1r appends them, compacted) and host-merges them; `allgather_spectrum`
unions every rank's host spectrum, so every rank ends with the identical
global spectrum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from kmerax_torch.core.codec import M32, canonical_words, to_u32_bits
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.spectrum.bloom import BloomParams
from kmerax_torch.spectrum.bloom_kernels import blocks, blocks_lanepack, \
    bloom_insert_rows
from kmerax_torch.spectrum.exact import np_merge_counted

COUNT_SATURATE = 1 << 30


@dataclass(frozen=True)
class ShardedParams:
    bloom: BloomParams              # GLOBAL table params (i32 counters)
    n_shards: int                   # S = mesh "bucket" size (power of 2)
    route_safety: int = 4           # per-destination capacity multiplier

    def __post_init__(self):
        S = self.n_shards
        assert S & (S - 1) == 0, "bucket shards must be a power of two"
        assert S <= (1 << self.bloom.log2_buckets), \
            "more shards than minimizer buckets"

    @property
    def shard_bits(self) -> int:
        return self.n_shards.bit_length() - 1

    @property
    def local_bits(self) -> int:
        """log2 of the per-shard table slice width (DESIGN.md §12)."""
        return self.bloom.log2_width - self.shard_bits


def shard_of(canon_flat: torch.Tensor, sp: ShardedParams) -> torch.Tensor:
    """shard = bucket >> (TB - SB), the owner of the k-mer's contiguous
    segment range: the top shard_bits bits of its global block, under
    either scheme. canon_flat (n, W) int64 words -> (n,) int64."""
    return blocks(sp.bloom, canon_flat) >> (sp.local_bits - 7)


def route_prep(canon_flat: torch.Tensor, valid_flat: torch.Tensor,
               sp: ShardedParams, cap: int | None = None):
    """The local half of the JAX package's `_route`: sort the k-mers by
    destination (stable), give each its slot among its destination's `cap`
    slots, drop what does not fit. Returns (send (S*cap, W+1) int32 — the
    rows' words as uint32 bits, the sentinel row in an empty slot, and a
    last column 1 where the slot is valid —, overflow (int64 scalar: k-mers
    dropped), meta for `route_back`). Default capacity is the route_safety
    fair share; cap = n is lossless."""
    S = sp.n_shards
    n, w = canon_flat.shape
    dev = canon_flat.device
    if cap is None:
        cap = -(-n * sp.route_safety // S)       # ceil, per-destination slots
    dst = torch.where(valid_flat, shard_of(canon_flat, sp), S)
    order = torch.argsort(dst, stable=True)
    dsts = dst[order]
    counts = torch.bincount(dsts, minlength=S + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[dsts]
    ok = (dsts < S) & (pos < cap)
    slot = torch.where(ok, dsts * cap + pos, S * cap)   # S*cap: dropped
    send = torch.full((S * cap + 1, w + 1), -1, dtype=torch.int32,
                      device=dev)
    send[:, w] = 0
    send[slot, :w] = to_u32_bits(canon_flat[order])
    send[slot, w] = ok.to(torch.int32)
    overflow = torch.clamp(counts[:S] - cap, min=0).sum()
    return send[:-1], overflow, (order, slot, ok, cap)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all over `group` of x's equal row blocks, one per rank."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def route(canon_flat, valid_flat, sp: ShardedParams, group,
          cap: int | None = None):
    """`_route`: route_prep, then the all-to-all over the bucket group.
    Returns (recv (S*cap, W) int32 rows, rvalid (S*cap,) bool, overflow,
    meta)."""
    send, overflow, meta = route_prep(canon_flat, valid_flat, sp, cap)
    recv = exchange(send, group)
    w = canon_flat.shape[1]
    return recv[:, :w], recv[:, w] != 0, overflow, meta


def route_back(values: torch.Tensor, meta, group) -> torch.Tensor:
    """Return per-k-mer answers to their senders (inverse of route).
    values: (S*cap,)."""
    order, slot, ok, cap = meta
    back = exchange(values, group)
    got = torch.where(ok, back[torch.clamp(slot, max=back.shape[0] - 1)], 0)
    out = torch.zeros(order.shape[0], dtype=values.dtype,
                      device=values.device)
    out[order] = got
    return out


def recv_rows(sp: ShardedParams, n_flat: int) -> int:
    """Routed rows landing on each rank per batch: S destinations x
    per-destination capacity. The most a batch can append to pending."""
    S = sp.n_shards
    return S * (-(-n_flat * sp.route_safety // S))


def sharded_insert_step(sp: ShardedParams, mesh, k: int):
    """The per-batch mesh count step at this capacity level:

    step(table, pending, bases, off) -> (n_kmers, overflow, n_pending):
    the first two summed over the world, the third this rank's. table: this
    rank's (width/S,) int32 partial slice; pending: None or the (P, W)
    int32 raw-row buffer, with room for recv_rows rows from `off`; bases:
    this rank's (b, L) int8 rows of the batch. K1r inserts the routed rows
    and appends the valid ones alone, in routed order, to pending from row
    `off`; n_pending is their number (one host sync), by which
    run_count_sharded advances `off`. If the world's overflow is above
    zero the whole batch is a no-op on every rank (nothing is routed or
    written, n_pending = 0), so run_count_sharded can double route_safety
    and replay it."""
    def step(table, pending, bases, off):
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        flat = canon.reshape(-1, canon.shape[-1])
        fvalid = valid.reshape(-1)
        send, overflow, _ = route_prep(flat, fvalid, sp)
        tot = torch.stack([fvalid.sum(), overflow])
        dist.all_reduce(tot)
        nk, ovf = (int(x) for x in tot.tolist())
        if ovf:
            return nk, ovf, 0
        recv = exchange(send, mesh.bucket_group)
        w = flat.shape[1]
        n_new = bloom_insert_rows(table, recv[:, :w].contiguous(),
                                  recv[:, w] != 0, sp.bloom, sp.local_bits,
                                  pending, off)
        return nk, 0, int(n_new) if pending is not None else 0

    return step


def flush_pending_local(pending: torch.Tensor, off: int) -> np.ndarray:
    """This rank's pending rows [0, off) as host (rows, W) uint32 for the
    host merge: K1r wrote valid rows only, so every one of them counts."""
    return pending[:off].cpu().numpy().view(np.uint32)


def merge_keep_sharded(table: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's partial (width/S,) slice -> the merged slice (summed over
    "data"), in place: the routed-query correction's spectrum."""
    dist.all_reduce(table, group=mesh.data_group)
    return table


def merge_and_replicate(table: torch.Tensor, mesh) -> torch.Tensor:
    """Partial (width/S,) slice -> replicated GLOBAL (width,) table: the
    sum over "data" (in place: `table` becomes merge_keep_sharded's
    slice), then the all-gather over "bucket"."""
    merge_keep_sharded(table, mesh)
    S = mesh.spec.bucket
    full = torch.empty(S * table.shape[0], dtype=table.dtype,
                       device=table.device)
    dist.all_gather(list(full.chunk(S)), table, group=mesh.bucket_group)
    return full


def query_local(params: BloomParams, table_shard: torch.Tensor,
                rows: torch.Tensor, valid: torch.Tensor,
                local_bits: int) -> torch.Tensor:
    """count = min over the d probes of canonical rows ((N, W) int32 bits)
    in this rank's 2^local_bits slice, saturated; invalid -> 0. The JAX
    package's jnp `query(..., local_bits=)`, a gather and a min."""
    block, lp = blocks_lanepack(params, rows.to(torch.int64) & M32)
    block = block.to(torch.int64) & ((1 << (local_bits - 7)) - 1)
    lanes = torch.stack([(lp >> (7 * j)) & 127
                         for j in range(params.num_hashes)], dim=-1)
    counts = table_shard[block[:, None] * 128 + lanes].min(dim=-1).values
    counts = torch.clamp(counts, max=COUNT_SATURATE)
    return torch.where(valid, counts, 0)


def routed_query_fn(sp: ShardedParams, table_shard: torch.Tensor, mesh):
    """query_fn(canon (..., W) int64, valid (...)) -> counts (...) that
    routes every probe to its bucket-owner rank over the bucket group and
    routes the counts back (for spectra too large to replicate);
    table_shard is this rank's merged (width/S,) slice. Lossless routing
    (cap = n): a dropped probe would read as count 0. Every rank of the
    bucket group must call it with the same number of k-mers."""
    def qf(canon, valid):
        shape = canon.shape[:-1]
        flat = canon.reshape(-1, canon.shape[-1])
        recv, rvalid, _, meta = route(flat, valid.reshape(-1), sp,
                                      mesh.bucket_group, cap=flat.shape[0])
        counts = query_local(sp.bloom, table_shard, recv, rvalid,
                             sp.local_bits)
        return route_back(counts, meta, mesh.bucket_group).reshape(shape)

    return qf


def allgather_spectrum(rows: np.ndarray, counts: np.ndarray, mesh,
                       group=None):
    """Union every rank's host spectrum (rows (N_r, W) uint32, counts (N_r,)
    int64; sizes differ between ranks) into one sorted spectrum on every
    rank of `group` (the world if None): a padded all-gather on the device
    over the group, then one host merge (deterministic, so every rank
    derives the identical spectrum). Each rank holds only the rows routed
    to it, so unlike the JAX package's one-process mesh this always gathers
    when the group is larger than 1 (over a host's local group it is that
    host's spectrum)."""
    if dist.get_world_size(group) == 1:
        return rows, counts
    dev = mesh.device
    w = rows.shape[1]
    n = mesh.all_gather_rows(torch.tensor([len(rows)], dtype=torch.int64,
                                          device=dev), group).tolist()
    maxn = max(n)
    pr = torch.full((maxn, w), -1, dtype=torch.int32, device=dev)
    pr[:len(rows)] = torch.from_numpy(rows.view(np.int32)).to(dev)
    pc = torch.zeros(maxn, dtype=torch.int64, device=dev)
    pc[:len(rows)] = torch.from_numpy(counts).to(dev)
    allr = mesh.all_gather_rows(pr, group).cpu().numpy().view(np.uint32)
    allc = mesh.all_gather_rows(pc, group).cpu().numpy()
    parts_r = [allr[p * maxn:p * maxn + n[p]] for p in range(len(n))]
    parts_c = [allc[p * maxn:p * maxn + n[p]] for p in range(len(n))]
    return np_merge_counted(np.concatenate(parts_r), np.concatenate(parts_c))
