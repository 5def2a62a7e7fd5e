"""Exact cuckoo-hash k-mer index for the align seed search (port of
kmerax/ops/seed_hash.py, full-width probe only).

Every lookup is exactly two independent row gathers:

  slot1 = h1(kmer) in table half A, slot2 = h2(kmer) in half B;
  every key lives in one of its two slots (a build-time guarantee), so
  found = match(slot1) | match(slot2).

Rows are (W key words + 1 payload word); empty slots hold the all-ones
sentinel, which is not a valid canonical k-mer, so misses are exact. The
table lives on the device as int64 words in [0, 2^32) (core/codec.py).

The build is the JAX package's host random walk (same seeded claim order,
same attempts), with the keys hashed by core/hash.kmer_hash, the port's one
hash source, so the table is byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kmerax_torch.core.hash import HASH_SEED_1, HASH_SEED_2, kmer_hash

_GOLD = 0x9E3779B9  # per-attempt seed stride (any odd constant)
# the JAX package's build settings: other values build another table
_MAX_LOAD = 0.4
_MAX_ITERS = 500
_MAX_ATTEMPTS = 8


def _seeds(attempt: int) -> tuple[int, int]:
    return ((HASH_SEED_1 + _GOLD * attempt) & 0xFFFFFFFF,
            (HASH_SEED_2 + _GOLD * attempt) & 0xFFFFFFFF)


class SeedHash(NamedTuple):
    """Built index: `tab` (2S, W+1) int64 rows (key words + payload) on the
    device; `n_slots` = S per half; `attempt` = the hash-seed variant."""

    tab: torch.Tensor
    n_slots: int
    attempt: int


def seed_hash_from_numpy(tab, n_slots: int, attempt: int,
                         device) -> SeedHash:
    """A SeedHash from a table held as (2S, W+1) uint32 numpy rows, e.g. the
    JAX package's, so the probe can be held against it alone."""
    rows = np.asarray(tab, dtype=np.uint32).astype(np.int64)
    return SeedHash(torch.from_numpy(rows).to(device), int(n_slots),
                    int(attempt))


def build_seed_hash(uniq, pay, *, device) -> SeedHash:
    """Host-side cuckoo build over (M, W) uint32 keys + (M,) int32 payloads;
    the keys are hashed on `device`.

    Deterministic: the claim order is a seeded shuffle per attempt, so the
    same inputs always build the same table.
    """
    rows = np.ascontiguousarray(np.asarray(uniq), dtype=np.uint32)
    payload = np.asarray(pay).astype(np.uint32)
    M, W = rows.shape
    # drop sentinel padding rows if the caller passed a padded index
    real = ~np.all(rows == np.uint32(0xFFFFFFFF), axis=1)
    if not real.all():
        rows, payload = rows[real], payload[real]
        M = len(rows)
    S = 1 << max(4, int(np.ceil(M / _MAX_LOAD / 2)).bit_length())
    keys = torch.from_numpy(rows.astype(np.int64)).to(device)

    def slot(seed: int) -> np.ndarray:
        return (kmer_hash(keys, seed) & (S - 1)).cpu().numpy()

    for attempt in range(_MAX_ATTEMPTS):
        s1, s2 = _seeds(attempt)
        h1 = slot(s1)
        h2 = slot(s2) + S
        occupant = np.full(2 * S, -1, np.int64)
        slot_of = np.full(M, -1, np.int64)
        side = np.zeros(M, np.uint8)
        pending = np.arange(M)
        rng = np.random.default_rng(attempt)
        for _ in range(_MAX_ITERS):
            if len(pending) == 0:
                break
            # symmetry-break: claim order is randomized (seeded)
            pending = rng.permutation(pending)
            slots = np.where(side[pending] == 0, h1[pending], h2[pending])
            occupant[slots] = pending           # last writer wins per slot
            won = occupant[slots] == pending
            winners = pending[won]
            slot_of[winners] = slots[won]
            placed = np.nonzero(slot_of >= 0)[0]
            evicted = placed[occupant[slot_of[placed]] != placed]
            slot_of[evicted] = -1
            losers = pending[~won]
            side[evicted] ^= 1
            side[losers] ^= 1
            pending = np.concatenate([losers, evicted])
        if len(pending) == 0:
            tab = np.full((2 * S, W + 1), 0xFFFFFFFF, np.uint32)
            occ = occupant >= 0
            items = occupant[occ]
            tab[occ, :W] = rows[items]
            tab[occ, W] = payload[items]
            return seed_hash_from_numpy(tab, S, attempt, device)
    raise RuntimeError(
        f"cuckoo build failed after {_MAX_ATTEMPTS} seed attempts "
        f"(M={M}, S={S})")


def probe_seed_hash(tab: torch.Tensor, n_slots: int, attempt: int,
                    query_words: torch.Tensor):
    """(payload int32, found bool) for (..., W) int64 queries: exactly two
    independent row gathers; payload -1 where not found."""
    W = query_words.shape[-1]
    s1, s2 = _seeds(attempt)
    i1 = kmer_hash(query_words, s1) & (n_slots - 1)
    i2 = (kmer_hash(query_words, s2) & (n_slots - 1)) + n_slots
    r1 = tab[i1]                                 # (..., W+1)
    r2 = tab[i2]
    m1 = torch.all(r1[..., :W] == query_words, dim=-1)
    m2 = torch.all(r2[..., :W] == query_words, dim=-1)
    # payloads are pos << 1 | fwd < 2^31, so the int32 cast is exact
    payload = torch.where(m1, r1[..., W], r2[..., W]).to(torch.int32)
    found = m1 | m2
    return torch.where(found, payload, -1), found


def _select_first(pay_all: torch.Tensor, fnd: torch.Tensor):
    """(first hit offset, its payload or -1, any hit) per row. argmax takes
    no bool, so the hits go in as int; like jnp.argmax it returns the first
    maximal index (0 when there is no hit)."""
    first = torch.argmax(fnd.to(torch.int32), dim=1)
    any_hit = torch.any(fnd, dim=1)
    payload = torch.where(
        any_hit, pay_all.gather(1, first[:, None])[:, 0], -1)
    return first.to(torch.int32), payload, any_hit


def probe_first_hit_full(tab: torch.Tensor, n_slots: int, attempt: int,
                         read_canon: torch.Tensor, read_valid: torch.Tensor):
    """Exact first-hit seed search probing every position of each read.
    read_canon (B, nk, W), read_valid (B, nk). Returns (first, payload,
    found)."""
    pay_all, fnd = probe_seed_hash(tab, n_slots, attempt, read_canon)
    return _select_first(pay_all, fnd & read_valid)
