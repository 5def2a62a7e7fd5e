"""Seed-extend validation of reads against contigs, worked out again
(DESIGN.md §10b; oracle/align.py), with the validate stage's statistics
as the pipeline reports them.

Index: the contigs joined by k - 1 N's; for each canonical k-mer the
smallest position holding it and whether it reads forward there. A read
takes its first k-mer (in read order) found in the index; if the strands
differ the read is reverse-complemented. The target is the read's length
of the joined contigs from where the seed puts the read's start (N past
either end). Score: banded global alignment (match +2, mismatch -3, gap
-4, |i - j| <= band), over whole arrays: row by row along the band, the
gap run inside a row as a running maximum.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import check_k, windows

MATCH, MISMATCH, GAP = 2, -3, -4
NEG_INF = -(1 << 30)
ROWS_A_CHUNK = 1 << 16


def _index(contigs: list[np.ndarray], k: int, device):
    sep = np.full(k - 1, 4, np.uint8)
    parts = []
    for i, c in enumerate(contigs):
        if i:
            parts.append(sep)
        parts.append(c)
    cat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    cat_t = torch.as_tensor(cat, device=device)
    if len(cat) < k:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return cat_t, empty, empty, empty.bool()
    fwd, rc, valid = windows(cat_t[None, :], k)
    fwd, rc, valid = fwd[0], rc[0], valid[0]
    pos = torch.nonzero(valid, as_tuple=True)[0]
    canon = torch.minimum(fwd, rc)[pos]
    isf = (fwd <= rc)[pos]
    order = torch.sort(canon, stable=True).indices
    canon, pos, isf = canon[order], pos[order], isf[order]
    first = torch.ones_like(canon, dtype=torch.bool)
    first[1:] = canon[1:] != canon[:-1]
    return cat_t, canon[first], pos[first], isf[first]


def _banded_score(Q: torch.Tensor, T: torch.Tensor, band: int):
    """(n,) banded global scores of (n, L) queries against (n, L)
    targets."""
    n, L = Q.shape
    dev = Q.device
    d = torch.arange(-band, band + 1, device=dev)
    neg = torch.full((n, d.numel()), NEG_INF, dtype=torch.int64, device=dev)
    A = torch.where((d >= 0) & (d <= min(L, band)), GAP * d, NEG_INF)
    A = A.expand(n, -1).clone()
    Tp = torch.cat([torch.full((n, band + 1), 4, dtype=T.dtype, device=dev),
                    T, torch.full((n, band + 1), 4, dtype=T.dtype,
                                  device=dev)], 1)
    for i in range(1, L + 1):
        j = i + d                                      # cells of row i
        r = Tp[:, (j - 1).clamp(-1, L) + band + 1]     # target base j - 1
        q = Q[:, i - 1:i]
        sub = torch.where((q == r) & (q < 4), MATCH, MISMATCH)
        up = torch.cat([A[:, 1:], neg[:, :1]], 1)
        X = torch.maximum(A + sub, up + GAP)
        X = torch.where(((j >= 1) & (j <= L))[None, :], X, NEG_INF)
        X = torch.where((j == 0)[None, :], GAP * i if i <= band else NEG_INF,
                        X)
        A = torch.cummax(X - GAP * d, 1).values + GAP * d
        A = torch.where(((j >= 0) & (j <= L))[None, :], A, NEG_INF)
    return A[:, band]


def validate(reads: list, contigs: list[bytes], k: int, band: int,
             batch_reads: int, device) -> dict:
    """{reads, aligned, aligned_frac, mean_identity} of reads ((n, L)
    uint8 arrays, in the order the pipeline reads them) against the contig
    sequences, summed batch by batch as the validate stage sums them."""
    check_k(k)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    cat, keys, kpos, kfwd = _index(
        [lut[np.frombuffer(c, np.uint8)] for c in contigs], k, device)
    R = torch.as_tensor(np.concatenate(reads)).to(device)
    N, L = R.shape
    found_all, score_all = [], []
    last = max(keys.numel() - 1, 0)
    for s in range(0, N if keys.numel() else 0, ROWS_A_CHUNK):
        b = R[s:s + ROWS_A_CHUNK].to(torch.int64)
        fwd, rc, valid = windows(b, k)
        canon = torch.minimum(fwd, rc)
        at = torch.searchsorted(keys, canon).clamp(max=last)
        hit = valid & (keys[at] == canon)
        found = hit.any(1)
        j = torch.argmax(hit.to(torch.int8), 1)
        rows = torch.arange(b.shape[0], device=device)
        h = at[rows, j]
        flip = found & ((fwd[rows, j] <= rc[rows, j]) != kfwd[h])
        rev = b.flip(1)
        Q = torch.where(flip[:, None], torch.where(rev < 4, 3 - rev, 4), b)
        start = kpos[h] - torch.where(flip, L - k - j, j)
        p = start[:, None] + torch.arange(L, device=device)
        inside = (p >= 0) & (p < cat.numel())
        T = torch.where(inside, cat.to(torch.int64)[p.clamp(0, cat.numel()
                                                             - 1)], 4)
        found_all.append(found)
        score_all.append(torch.where(found, _banded_score(Q, T, band),
                                     NEG_INF))
    if not found_all:
        found_all = [torch.zeros(N, dtype=torch.bool, device=device)]
        score_all = [torch.full((N,), NEG_INF, device=device)]
    found = torch.cat(found_all).cpu().numpy()
    score = torch.cat(score_all).cpu().numpy()
    lens = np.full(N, L)
    n_aligned, sum_ident = 0, 0.0
    for s in range(0, N, batch_reads):
        f = found[s:s + batch_reads]
        ln = lens[s:s + batch_reads]
        ident = np.where(f & (ln > 0), score[s:s + batch_reads]
                         / (2.0 * np.maximum(ln, 1)), 0.0)
        n_aligned += int(f.sum())
        sum_ident += float(ident[f].sum())
    return {"reads": N, "aligned": n_aligned,
            "aligned_frac": round(n_aligned / max(N, 1), 4),
            "mean_identity": round(sum_ident / max(n_aligned, 1), 4)}
