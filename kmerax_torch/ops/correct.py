"""Spectrum-based error correction over a read batch (port of
kmerax/ops/correct.py; DESIGN.md §8 v2).

Every candidate of a round is scored in one pass against the round-start
read, then edits are applied together under the deterministic
conflict-suppression rule. `solid_fn(canon_words, valid) -> bool` is the
spectrum; `window_fn` gives the round-start solidity of every window
(kernel K2 on the card), `_window_counts` is its plain version; `eval_fn`
scores the candidate entries (kernel K3 on the card), `_eval_entries` is
its plain version (ops/correct_kernels.py builds both kernel functions).
"""

from __future__ import annotations

import numpy as np
import torch

from kmerax_torch.core.codec import canonical_words
from kmerax_torch.core.kmers import extract_kmers

_I64 = torch.int64


def _weak_run_candidates(solid, existing, last_j, k, max_runs):
    """Candidate edit positions per read (DESIGN.md §8), -1 = absent.

    Returns (B, 2*max_runs) int64, in run order, deduped keeping first.
    """
    B, nk = solid.shape
    dev = solid.device
    weak = existing & ~solid
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    prev_weak = torch.cat([no, weak[:, :-1]], dim=1)
    next_weak = torch.cat([weak[:, 1:], no], dim=1)
    run_start = weak & ~prev_weak
    run_end = weak & ~next_weak
    run_id = torch.cumsum(run_start.to(torch.int32), dim=1) - 1

    # r-th run's [j0, j1]: argmax returns the FIRST max, so it finds the
    # run's single start/end flag
    j0s, j1s, haves = [], [], []
    for r in range(max_runs):
        ms = run_start & (run_id == r)
        me = run_end & (run_id == r)
        j0s.append(torch.argmax(ms.to(torch.uint8), dim=1))
        j1s.append(torch.argmax(me.to(torch.uint8), dim=1))
        haves.append(torch.any(ms, dim=1))
    have = torch.stack(haves, dim=1)                      # (B, max_runs)
    j0 = torch.where(have, torch.stack(j0s, dim=1), -1)
    j1 = torch.where(have, torch.stack(j1s, dim=1), -1)
    lj = last_j.to(_I64)[:, None]

    interior = (j0 > 0) & (j1 < lj)
    left_e = (j0 == 0) & (j1 < lj)
    right_e = (j0 > 0) & (j1 == lj)
    # whole-read-weak = (j0==0)&(j1==lj): cand_a=j1, cand_b=j0+k-1
    cand_a = torch.where(interior | right_e, j0 + k - 1, j1)
    cand_b = torch.where(interior, j1,
                         torch.where(left_e | right_e, -1, j0 + k - 1))
    cand_a = torch.where(have, cand_a, -1)
    cand_b = torch.where(have, cand_b, -1)
    cands = torch.stack([cand_a, cand_b], dim=-1).reshape(B, 2 * max_runs)

    # dedupe keeping first occurrence (O(C^2), C small)
    C = 2 * max_runs
    cols = [cands[:, c] for c in range(C)]
    for c in range(1, C):
        dup = torch.zeros(B, dtype=torch.bool, device=dev)
        for c2 in range(c):
            dup = dup | ((cols[c] == cols[c2]) & (cols[c2] >= 0))
        cols[c] = torch.where(dup, -1, cols[c])
    return torch.stack(cols, dim=1)


def _window_counts(bases, last_j, k, solid_fn):
    """Round-start solidity over all windows. Returns (solid, existing)."""
    words, valid = extract_kmers(bases, k)
    canon, _ = canonical_words(words, k)
    nk = bases.shape[1] - k + 1
    j = torch.arange(nk, dtype=_I64, device=bases.device)
    existing = j[None, :] <= last_j.to(_I64)[:, None]
    solid = solid_fn(canon, valid) & existing
    return solid, existing


def _center_layout(k: int):
    """Per window j: (word index, bit shift) of the center base, which sits
    at window-relative q = k-1-j (core/kmers.py packing)."""
    W = (k + 15) // 16
    wi_j = np.empty(k, np.int64)
    sh_j = np.empty(k, np.int64)
    for j in range(k):
        q = k - 1 - j
        for wi in range(W):
            lo, hi = max(k - 16 * (wi + 1), 0), k - 16 * wi
            if lo <= q < hi:
                wi_j[j] = wi
                sh_j[j] = 2 * (hi - 1 - q)
    return wi_j, sh_j


def _eval_scores(bases, lengths, last_j, ent_r, ent_i, k, solid_fn):
    """Plain version of kernel K3: scores (Q, 4) int32, the number of solid
    k-mers among the k windows covering each entry's position with center
    base v = 0..3, against the round-start bases (DESIGN.md §8 v2)."""
    B, L = bases.shape
    dev = bases.device
    ent_r = ent_r.to(_I64)
    ic = torch.clamp(ent_i.to(_I64), 0, L - 1)
    lens_e = lengths.to(_I64)[ent_r]
    lj_e = last_j.to(_I64)[ent_r]

    offs = ic[:, None] + torch.arange(-(k - 1), k, dtype=_I64, device=dev)
    oob = (offs < 0) | (offs >= lens_e[:, None])
    wb = bases[ent_r[:, None], torch.clamp(offs, 0, L - 1)]
    wb = torch.where(oob, 4, wb)                                   # (Q, 2k-1)

    # extract window words once, then derive the 4 center variants by
    # XOR-ing the center bits; an N center packs as 0 bits and deltas use
    # old&3, so every variant writes its base; window validity is taken
    # with the center forced valid
    W = (k + 15) // 16
    wi_j, sh_j = _center_layout(k)
    words0, _ = extract_kmers(wb, k)                               # (Q,k,W)
    wb_c = wb.clone()
    wb_c[:, k - 1] = 0
    _, wvalid = extract_kmers(wb_c, k)                             # (Q,k)

    old_c = (wb[:, k - 1] & 3).to(_I64)
    bvals4 = torch.arange(4, dtype=_I64, device=dev)
    delta = ((old_c[:, None] ^ bvals4[None, :])[:, :, None]
             << torch.as_tensor(sh_j, device=dev)[None, None, :])  # (Q,4,k)
    at_word = (torch.arange(W, device=dev)[None, None, None, :]
               == torch.as_tensor(wi_j, device=dev)[None, None, :, None])
    words4 = words0[:, None] ^ torch.where(at_word, delta[..., None], 0)
    canon, _ = canonical_words(words4, k)                          # (Q,4,k,W)

    # solid_fn sees exactly the windows the kernel probes: valid and with
    # a start inside the read (it is False for any other window, so the
    # scores are those of masking after the probe)
    jglob = ic[:, None] - (k - 1) + torch.arange(k, dtype=_I64, device=dev)
    in_range = (jglob >= 0) & (jglob <= lj_e[:, None])
    live = (wvalid & in_range)[:, None, :].expand(words4.shape[:-1])
    return solid_fn(canon, live).sum(dim=-1, dtype=torch.int32)    # (Q,4)


def _accept(scores, bases, ent_r, ent_i):
    """The accept rule (DESIGN.md §8 v2): best base (first max wins) beats
    the current base's score. Returns (best_b (Q,), accept (Q,))."""
    L = bases.shape[1]
    ic = torch.clamp(ent_i.to(_I64), 0, L - 1)
    cur = bases[ent_r.to(_I64), ic]
    cur_score = torch.where(
        cur < 4,
        torch.gather(scores, 1, torch.clamp(cur, 0, 3).to(_I64)[:, None])[:, 0],
        0)
    best_s = torch.max(scores, dim=1).values
    best_b = torch.argmax(scores, dim=1).to(bases.dtype)   # first max wins
    accept = ((ent_i >= 0) & (best_b != cur)
              & (best_s > cur_score) & (best_s >= 1))
    return best_b, accept


def _eval_entries(bases, lengths, last_j, ent_r, ent_i, k, solid_fn):
    """Score all four substitutions per entry and apply the accept rule;
    entries with ent_i < 0 are padding. Returns (best_b (Q,), accept (Q,))."""
    scores = _eval_scores(bases, lengths, last_j, ent_r, ent_i, k, solid_fn)
    return _accept(scores, bases, ent_r, ent_i)


def _apply(bases, edits, done, capped, livef, Q, k, max_cands, eval_fn):
    """Evaluate + apply all live candidates, compacted to width Q >= the
    live count (any such width gives the same result: padding entries
    accept nothing). bases and edits update in place; returns done.

    The flat entry list is read-major/slot-order — the oracle's candidate
    order — so a read's earlier candidates sit at flat offsets 1..cc back.
    """
    B, L = bases.shape
    dev = bases.device
    BM = livef.shape[0]
    rank = torch.cumsum(livef.to(_I64), dim=0) - 1
    destf = torch.where(livef, rank, Q)
    sel = torch.full((Q + 1,), BM, dtype=_I64, device=dev)
    sel.scatter_(0, destf, torch.arange(BM, dtype=_I64, device=dev))
    sel = sel[:Q]
    pad = sel >= BM
    selc = torch.clamp(sel, max=BM - 1)
    ent_r = selc // max_cands
    ent_cc = selc % max_cands                  # within-read candidate index
    ent_i = torch.where(pad, -1, capped.reshape(-1)[selc])

    best_b, accept = eval_fn(bases, ent_r, ent_i)

    applied = accept & (ent_cc == 0)
    for p in range(1, max_cands):
        conf = torch.zeros(Q, dtype=torch.bool, device=dev)
        for o in range(1, p + 1):
            pr_app = torch.cat([torch.zeros(o, dtype=torch.bool, device=dev),
                                applied[:-o]])
            pr_r = torch.cat([torch.full((o,), -1, dtype=_I64, device=dev),
                              ent_r[:-o]])
            pr_i = torch.cat([torch.full((o,), -(k + 1), dtype=_I64,
                                         device=dev), ent_i[:-o]])
            conf = conf | (pr_app & (pr_r == ent_r)
                           & (torch.abs(pr_i - ent_i) <= k - 1))
        applied = applied | (accept & (ent_cc == p) & ~conf)

    ic = torch.clamp(ent_i, 0, L - 1)
    rows = ent_r[applied]          # no (row, position) repeats: candidates
    bases[rows, ic[applied]] = best_b[applied]   # are deduped per read
    edits.index_add_(0, rows, torch.ones_like(rows, dtype=edits.dtype))
    made = torch.zeros(B, dtype=torch.bool, device=dev)
    made[rows] = True
    return done | ~made


def correct_batch(bases, lengths, k: int, t: int, solid_fn,
                  rounds: int = 2, max_runs: int = 8, max_edits: int = 8,
                  max_cands: int = 4, eval_fn=None, window_fn=None,
                  width_fn=None):
    """Correct a padded read batch (DESIGN.md §8 v2), bit-exact vs oracle.

    Args:
      bases: (B, L) integer bases, padded past `lengths` with 4.
      lengths: (B,) int32 true read lengths.
      solid_fn: (canon_words, valid) -> bool solidity (count >= t, invalid
        -> False); unused when both window_fn and eval_fn are given.
      window_fn: optional round-start solidity (bases (B, L) int32,
        last_j (B,) int32) -> (solid, existing) (B, L-k+1) bool, identical
        to `_window_counts` with solid_fn (kernel K2 on the card).
      eval_fn: optional candidate evaluator
        (bases, lengths, last_j, ent_r, ent_i) -> (best_b, accept),
        identical to `_eval_entries` with solid_fn (kernel K3 on the card).
      width_fn: optional map of a round's live entry count to the count the
        round compacts to (>= it): the routed mesh correction takes the
        largest over the bucket group, so every rank of it makes the same
        calls of its collective solid_fn with the same number of k-mers,
        as the JAX package's `uniform_width` does. Any width gives the
        same result: an all-padding apply accepts nothing and marks every
        read done, as the skipped round does.
    Returns (corrected bases (B, L) int32, n_edits (B,) int32 — edits kept;
    0 where the read was reverted for exceeding max_edits).
    """
    B, L = bases.shape
    dev = bases.device
    orig = bases.to(torch.int32)
    bases = orig.clone()
    lengths = lengths.to(torch.int32)
    last_j = lengths - k                       # may be negative (short reads)
    edits = torch.zeros(B, dtype=torch.int32, device=dev)
    done = last_j < 0                          # reads shorter than k

    def ev(bs, ent_r, ent_i):
        if eval_fn is not None:
            return eval_fn(bs, lengths, last_j, ent_r, ent_i)
        return _eval_entries(bs, lengths, last_j, ent_r, ent_i, k, solid_fn)

    for _ in range(rounds):
        if window_fn is not None:
            solid, existing = window_fn(bases, last_j)
        else:
            solid, existing = _window_counts(bases, last_j, k, solid_fn)
        all_solid = torch.all(solid | ~existing, dim=1)
        any_solid = torch.any(solid, dim=1)
        done = done | all_solid | ~any_solid
        active = ~done

        cands = _weak_run_candidates(solid, existing, last_j, k, max_runs)
        cands = torch.where(active[:, None], cands, -1)

        # per-read cap: the first max_cands candidates, compacted
        live_row = cands >= 0
        rr = torch.cumsum(live_row.to(torch.int32), dim=1) - 1
        capped = torch.stack(
            [torch.max(torch.where(live_row & (rr == s), cands, -1),
                       dim=1).values for s in range(max_cands)], dim=1)
        livef = (capped >= 0).reshape(-1)

        # the JAX package's lax.cond width dispatch, in plain Python: read
        # the live count once and compact to the next multiple of 128
        n_ent = int(livef.sum())
        if width_fn is not None:
            n_ent = width_fn(n_ent)
        if n_ent == 0:
            done = torch.ones_like(done)
            continue
        Q = -(-n_ent // 128) * 128
        done = _apply(bases, edits, done, capped, livef, Q, k, max_cands, ev)

    revert = edits > max_edits
    bases = torch.where(revert[:, None], orig, bases)
    n_edits = torch.where(revert, 0, edits)
    return bases, n_edits
