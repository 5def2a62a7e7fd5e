"""Seed-extend read validation (port of kmerax/ops/align.py, cuckoo-hash
seed search only; DESIGN.md §10b).

The banded DP is kernel K4 (ops/align_kernels.py, csrc/align.cu), reached
through its wrapper as the JAX package reaches banded_align_scores_auto.
Scores are bit-exact vs oracle.align (match +2 / mismatch -3 / gap -4,
NEG_INF when no in-band path exists).
"""

from __future__ import annotations

import numpy as np
import torch

from kmerax_torch.core.codec import canonical_words, num_words
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.ops.align_kernels import NEG_INF, banded_align_scores
from kmerax_torch.ops.seed_hash import SeedHash, probe_first_hit_full
from kmerax_torch.spectrum.exact import SENTINEL_WORD


def build_contig_index(contig_bases: list, k: int, chunk: int = 1 << 20,
                       *, device):
    """Read-to-contig index (DESIGN.md §10b): k-mers extracted on `device`
    in overlapping chunks, deduped on the host.

    contig_bases: list of uint8 arrays. Returns numpy (cat (N,) uint8, the
    contigs joined by k-1 N bases; uniq (M, W) uint32 canonical rows sorted;
    payload (M,) int32 = pos << 1 | fwd, the smallest pos per k-mer).
    """
    w = num_words(k)
    sep = np.full(k - 1, 4, np.uint8)
    parts = []
    for i, c in enumerate(contig_bases):
        if i:
            parts.append(sep)
        parts.append(np.asarray(c, dtype=np.uint8))
    cat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    N = len(cat)
    assert N < (1 << 30), "contig index positions must fit int32 payloads"
    empty = (cat, np.full((1, w), SENTINEL_WORD, np.uint32),
             np.zeros(1, np.int32))
    if N < k:
        return empty

    rows_l, pay_l = [], []
    for s0 in range(0, N - k + 1, chunk):
        # the chunk's nw windows and nothing past them: no padding needed
        nw = min(chunk, (N - k + 1) - s0)
        piece = torch.from_numpy(cat[s0:s0 + nw + k - 1]).to(device)
        words, valid = extract_kmers(piece, k)
        canon, fwd = canonical_words(words, k)
        canon = canon.cpu().numpy().astype(np.uint32)
        fwd = fwd.cpu().numpy().astype(np.int64)
        valid = valid.cpu().numpy()
        pos = np.arange(s0, s0 + nw, dtype=np.int64)
        rows_l.append(canon[valid])
        pay_l.append((pos[valid] << 1) | fwd[valid])
    rows = np.concatenate(rows_l, axis=0)
    pay = np.concatenate(pay_l, axis=0)
    if len(rows) == 0:
        return empty
    # sort by (kmer, payload); first occurrence per kmer = smallest pos
    order = np.lexsort((pay,) + tuple(rows[:, i] for i in range(w)))
    rows, pay = rows[order], pay[order]
    first = np.concatenate([[True], np.any(rows[1:] != rows[:-1], axis=1)])
    return cat, rows[first], pay[first].astype(np.int32)


def _extend_and_score(cat_dev, bases, lengths, is_fwd, off, payload, found,
                      k: int, band: int):
    """Seed -> oriented target window -> banded DP (kernel K4). Returns
    (found, strand, pos, score) (B,) each; score NEG_INF when unaligned."""
    B, Lmax = bases.shape
    dev = bases.device
    rfwd = is_fwd.gather(1, off.to(torch.int64)[:, None])[:, 0]
    cfwd = (payload & 1) == 1
    pos = payload >> 1
    strand = (found & (rfwd != cfwd)).to(torch.int32)

    ar = torch.arange(Lmax, dtype=torch.int32, device=dev)[None, :]
    irev = lengths[:, None] - 1 - ar
    rcb = bases.gather(1, torch.clamp(irev, 0, Lmax - 1).to(torch.int64))
    rcb = torch.where((irev >= 0) & (rcb < 4), 3 - rcb, 4)
    Q = torch.where((strand == 1)[:, None], rcb, bases).contiguous()
    jq = torch.where(strand == 1, lengths - k - off, off)
    start = pos - jq

    M = cat_dev.shape[0]
    tidx = start[:, None] + ar
    oob = (tidx < 0) | (tidx >= M) | ~found[:, None]
    T = torch.where(oob, 4, cat_dev[torch.clamp(tidx, 0, M - 1).to(
        torch.int64)].to(torch.int32)).contiguous()
    score = banded_align_scores(Q, T, lengths, lengths, band)
    found = found & (lengths >= k)
    score = torch.where(found, score, NEG_INF)
    return found, torch.where(found, strand, 0), \
        torch.where(found, pos, -1), score


def validate_batch(cat_dev: torch.Tensor, index: SeedHash, bases, lengths,
                   k: int, band: int):
    """Batched seed-extend read validation (DESIGN.md §10b), bit-exact vs
    oracle.validate_read: first k-mer of each read found in the cuckoo index,
    then the banded DP of the oriented read against its contig window.

    cat_dev (N,) int8 joined contigs on the device; bases (B, L) int8 or
    int32, lengths (B,) int32. Returns (found, strand, pos, score), (B,)
    each, score NEG_INF when unaligned."""
    bases = bases.to(torch.int32)
    lengths = lengths.to(torch.int32)
    words, valid = extract_kmers(bases, k)
    canon, is_fwd = canonical_words(words, k)
    off, payload, found = probe_first_hit_full(
        index.tab, index.n_slots, index.attempt, canon, valid)
    return _extend_and_score(cat_dev, bases, lengths, is_fwd, off, payload,
                             found, k, band)
