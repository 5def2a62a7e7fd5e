"""Spectrum-based correction, worked out again (DESIGN.md §8 v2, as
oracle/correct.py defines it for one read), over many reads at once.

Per round: the solidity of every window of the round-start read; a read
whose windows are all solid, or none, is done. Otherwise its maximal weak
runs give candidate positions (the first `max_runs` runs, deduplicated
keeping the first, the first `max_cands` kept); each candidate's four
bases are scored against the round-start read by the number of solid
windows covering it; a candidate is accepted when the best base (the
first of the maxima) differs from the current one, scores more and scores
at least 1, and applied unless an earlier applied candidate of the round
lies within k - 1; a read with none applied is done. A read with more than
`max_edits` edits in all goes back to its input.
"""

from __future__ import annotations

import torch

from .kmers import check_k, windows

ROWS_A_CHUNK = 1 << 16
ENTRIES_A_CHUNK = 1 << 17


def _candidates(solid: torch.Tensor, k: int, max_runs: int,
                max_cands: int) -> torch.Tensor:
    """(n, max_cands) candidate positions of reads whose windows are
    (n, nk) `solid`, in order; -1 where a read has fewer."""
    n, nk = solid.shape
    dev = solid.device
    last_j = nk - 1
    weak = ~solid
    no = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    start = weak & ~torch.cat([no, weak[:, :-1]], 1)
    end = weak & ~torch.cat([weak[:, 1:], no], 1)
    rid = torch.cumsum(start.to(torch.int64), 1) - 1
    j = torch.arange(nk, device=dev).repeat(n, 1)
    j0 = torch.full((n, max_runs + 1), -1, dtype=torch.int64, device=dev)
    j1 = torch.full_like(j0, -1)
    dump = torch.full_like(rid, max_runs)
    j0.scatter_(1, torch.where(start & (rid < max_runs), rid, dump), j)
    j1.scatter_(1, torch.where(end & (rid < max_runs), rid, dump), j)
    j0, j1 = j0[:, :max_runs], j1[:, :max_runs]
    have = j0 >= 0
    interior = (j0 > 0) & (j1 < last_j)
    right = (j0 > 0) & (j1 == last_j)
    whole = (j0 == 0) & (j1 == last_j)
    a = torch.where(interior | right, j0 + k - 1, j1)
    b = torch.where(interior, j1, torch.where(whole, j0 + k - 1, -1))
    c = torch.stack([torch.where(have, a, -1), torch.where(have, b, -1)],
                    -1).reshape(n, 2 * max_runs)
    C = c.shape[1]
    earlier = torch.ones((C, C), dtype=torch.bool, device=dev).tril(-1)
    dup = ((c[:, :, None] == c[:, None, :]) & earlier
           & (c[:, None, :] >= 0)).any(2)
    c = torch.where(dup, -1, c)
    live = c >= 0
    rank = torch.cumsum(live.to(torch.int64), 1) - 1
    return torch.stack([torch.where(live & (rank == s), c, -1).amax(1)
                        for s in range(max_cands)], 1)


def _scores(R: torch.Tensor, er: torch.Tensor, ei: torch.Tensor, k: int,
            solid_fn) -> torch.Tensor:
    """(E, 4): solid windows of read er covering position ei with the base
    there set to 0..3, against R."""
    L = R.shape[1]
    p = ei[:, None] + torch.arange(-(k - 1), k, device=R.device)
    inside = (p >= 0) & (p < L)
    ctx = torch.where(inside, R[er[:, None], p.clamp(0, L - 1)], 4)
    out = []
    for b in range(4):
        ctx[:, k - 1] = b
        fwd, rc, valid = windows(ctx, k)
        s = solid_fn(torch.minimum(fwd, rc)) & valid
        out.append(s.sum(1))
    return torch.stack(out, 1)


def _round(R: torch.Tensor, solid_fn, k: int, max_runs: int,
           max_cands: int):
    """One round over reads R (n, L): (new R, edits applied (n,),
    done (n,))."""
    fwd, rc, valid = windows(R, k)
    solid = solid_fn(torch.minimum(fwd, rc)) & valid
    done = solid.all(1) | ~solid.any(1)
    cand = _candidates(solid, k, max_runs, max_cands)
    cand[done] = -1
    er, es = torch.nonzero(cand >= 0, as_tuple=True)
    ei = cand[er, es]
    n = R.shape[0]
    best = torch.full((n, max_cands), -1, dtype=torch.int64, device=R.device)
    for s in range(0, er.numel(), ENTRIES_A_CHUNK):
        r, i, sl = (x[s:s + ENTRIES_A_CHUNK] for x in (er, ei, es))
        sc = _scores(R, r, i, k, solid_fn)
        cur = R[r, i]
        cur_s = torch.where(cur < 4, sc.gather(1, cur.clamp(max=3)[:, None])
                            [:, 0], 0)
        best_s = sc.amax(1)
        best_b = torch.where(sc == best_s[:, None],
                             torch.arange(4, device=R.device), 4).amin(1)
        ok = (best_b != cur) & (best_s > cur_s) & (best_s >= 1)
        best[r[ok], sl[ok]] = best_b[ok]
    applied = torch.zeros_like(best, dtype=torch.bool)
    for s in range(max_cands):
        ok = best[:, s] >= 0
        for s2 in range(s):
            ok &= ~(applied[:, s2]
                    & ((cand[:, s] - cand[:, s2]).abs() < k))
        applied[:, s] = ok
    R = R.clone()
    for s in range(max_cands):
        rows = torch.nonzero(applied[:, s], as_tuple=True)[0]
        R[rows, cand[rows, s]] = best[rows, s]
    n_app = applied.sum(1)
    return R, n_app, done | (n_app == 0)


def correct(reads, solid_fn, k: int, *, rounds: int = 2, max_runs: int = 8,
            max_edits: int = 8, max_cands: int = 4, device):
    """Correct (N, L) reads of one length (uint8 bases 0..4). Returns
    (corrected (N, L) uint8 tensor, edits kept (N,) int64)."""
    check_k(k)
    reads = torch.as_tensor(reads)
    outs, edits_out = [], []
    for s in range(0, reads.shape[0], ROWS_A_CHUNK):
        orig = reads[s:s + ROWS_A_CHUNK].to(device).to(torch.int64)
        R = orig.clone()
        edits = torch.zeros(R.shape[0], dtype=torch.int64, device=device)
        active = torch.full_like(edits, R.shape[1] >= k, dtype=torch.bool)
        for _ in range(rounds):
            idx = torch.nonzero(active, as_tuple=True)[0]
            if idx.numel() == 0:
                break
            Ra, n_app, done = _round(R[idx], solid_fn, k, max_runs,
                                     max_cands)
            R[idx] = Ra
            edits[idx] += n_app
            active[idx[done]] = False
        revert = edits > max_edits
        R[revert] = orig[revert]
        outs.append(R.to(torch.uint8))
        edits_out.append(torch.where(revert, 0, edits))
    return torch.cat(outs), torch.cat(edits_out)
