"""The correct round's kernels: K3 (fused candidate scoring), K6 (the weak
runs' candidates) and K7 (the conflict-suppressed apply), each with its
CUDA wrapper and its plain PyTorch version; and the kernel step that
runs ops/correct.py::correct_batch's rounds as K2, K6, K3 and K7 with no
host sync (`make_slot_step`), the correct stage's step on every device.

K3 replaces kmerax/ops/pallas_correct.py::_prep_kernel with the solidity
probe (pallas_bloom.py::_query_kernel) fused in (source: csrc/correct.cu).
It returns the per-entry variant scores (Q, 4), zero for a dead entry
(ent_i < 0). It probes the table in either counter layout of BloomParams;
the p16 form (the halfword probe of pallas_correct.py:266-269) is a kernel
of its own, counted as "correct_eval_scores_p16". K6 and K7 replace the
XLA-fused glue of kmerax/ops/correct.py (`_weak_run_candidates`, the cap,
`_apply`); they read only solidity, slots and scores, so one form serves
every counter layout and bucket scheme.

The slot grid: a round's candidates are K6's (B, SLOTS) slots, live ones
first in each row and -1 past them; K3 scores all B * SLOTS slots (row r
of slot s is r) and K7 applies them. That equals correct_batch's
compacted call at max_cands = SLOTS: a dead slot accepts nothing, as
padding does.

Dispatch: a tensor on the CPU takes the plain version; on a card the
wrapper launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from kmerax_torch.ops.correct import _accept, _eval_scores, \
    _weak_run_candidates
from kmerax_torch.spectrum.bloom import BloomParams, query_solid
from kmerax_torch.spectrum.bloom_kernels import bloom_query_solid, \
    counter_name, scheme_args
from kmerax_torch.utils import cuda, tracing

# a read's candidate slots a round: correct_batch's default max_cands
# (kSlots in csrc/correct.cu)
SLOTS = 4


def eval_scores_plain(params: BloomParams, table, t, bases, lengths, last_j,
                      ent_r, ent_i) -> torch.Tensor:
    """Plain version of K3 on any device: ops/correct.py::_eval_scores
    probing the table through the plain solidity gather, zero for a dead
    entry (ent_i < 0), which it does not score."""
    live = ent_i >= 0
    scores = torch.zeros((ent_i.shape[0], 4), dtype=torch.int32,
                         device=bases.device)
    scores[live] = _eval_scores(
        bases, lengths, last_j, ent_r[live], ent_i[live], params.k,
        lambda cw, v: query_solid(params, table, t, cw, v)).to(torch.int32)
    return scores


def correct_eval_scores(params: BloomParams, table: torch.Tensor, t: int,
                        bases: torch.Tensor, lengths: torch.Tensor,
                        last_j: torch.Tensor, ent_r: torch.Tensor,
                        ent_i: torch.Tensor) -> torch.Tensor:
    """K3: scores (Q, 4) int32 for entries (ent_r, ent_i) of the (B, L)
    int32 read batch against the counter table (in the params' layout) at
    threshold t; zero where ent_i < 0."""
    dev = table.device
    B, L = bases.shape
    Q = ent_r.shape[0]
    cuda.require(table, "table", torch.int32, dev, (params.table_entries,))
    cuda.require(bases, "bases", torch.int32, dev, (B, L))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    cuda.require(last_j, "last_j", torch.int32, dev, (B,))
    cuda.require(ent_r, "ent_r", torch.int32, dev, (Q,))
    cuda.require(ent_i, "ent_i", torch.int32, dev, (Q,))
    if dev.type == "cpu":
        return eval_scores_plain(params, table, t, bases, lengths, last_j,
                                 ent_r, ent_i)
    scores = torch.empty((Q, 4), dtype=torch.int32, device=dev)
    rc = cuda.lib().kmerax_correct_eval_scores(
        bases.data_ptr(), L, lengths.data_ptr(), last_j.data_ptr(),
        ent_r.data_ptr(), ent_i.data_ptr(), Q, table.data_ptr(),
        (1 << (params.log2_width - 7)) - 1, params.num_hashes,
        *scheme_args(params), int(params.counter == "p16"), int(t),
        params.k, scores.data_ptr(), cuda.stream())
    name = counter_name("correct_eval_scores", params)
    cuda.LAUNCHES[name] += 1
    cuda.check(rc, name)
    return scores


def round_candidates_plain(solid, last_j, done, k: int,
                           max_runs: int) -> torch.Tensor:
    """Plain version of K6, from correct_batch's round: done (B,) int32 |=
    every existing window solid or none solid, in place; returns the
    (B, SLOTS) int32 slots, the first SLOTS distinct candidates of the
    first max_runs weak runs (ops/correct.py::_weak_run_candidates) of each
    read not done, -1 past them."""
    j = torch.arange(solid.shape[1], dtype=torch.int64, device=solid.device)
    existing = j[None, :] <= last_j.to(torch.int64)[:, None]
    now_done = (done != 0) | torch.all(solid | ~existing, dim=1) \
        | ~torch.any(solid, dim=1)
    done.copy_(now_done)
    cands = _weak_run_candidates(solid, existing, last_j, k, max_runs)
    cands = torch.where(now_done[:, None], -1, cands)
    live = cands >= 0
    rank = torch.cumsum(live.to(torch.int32), dim=1) - 1
    return torch.stack(
        [torch.max(torch.where(live & (rank == s), cands, -1), dim=1).values
         for s in range(SLOTS)], dim=1).to(torch.int32)


def apply_slots_plain(bases, cands, scores, edits, done, k: int,
                      orig=None, max_edits: int = 0):
    """Plain version of K7, from correct_batch's `_apply` on the slot grid:
    the accept rule (ops/correct.py::_accept) on each slot against the
    round-start (B, L) int32 `bases`, then in slot order the conflict rule
    (an accepted slot within k-1 of an earlier applied slot of its read is
    suppressed); the applied edits are written into `bases`, `edits` +=
    their count and `done` |= none applied, all in place. With `orig` (the
    last round) returns (the output rows in orig's dtype, orig's row where
    edits > max_edits; n_edits (B,) int32, 0 there), else None."""
    B, C = cands.shape
    ent_r = torch.arange(B, device=bases.device).repeat_interleave(C)
    best_b, accept = _accept(scores, bases, ent_r, cands.reshape(-1))
    best_b, accept = best_b.view(B, C), accept.view(B, C)
    ic = cands.to(torch.int64)
    applied = torch.zeros_like(accept)
    for s in range(C):
        conf = torch.zeros_like(accept[:, 0])
        for p in range(s):
            conf |= applied[:, p] & ((ic[:, p] - ic[:, s]).abs() <= k - 1)
        applied[:, s] = accept[:, s] & ~conf
    rows, slots = torch.nonzero(applied, as_tuple=True)
    bases[rows, ic[rows, slots]] = best_b[rows, slots]
    edits += applied.sum(dim=1, dtype=torch.int32)
    done |= ~applied.any(dim=1)
    if orig is None:
        return None
    revert = edits > max_edits
    out = torch.where(revert[:, None], orig.to(torch.int32), bases)
    return out.to(orig.dtype), torch.where(revert, 0, edits)


def correct_candidates(solid: torch.Tensor, last_j: torch.Tensor,
                       done: torch.Tensor, k: int,
                       max_runs: int) -> torch.Tensor:
    """K6: one correct round's candidate slots (B, SLOTS) int32 from
    the (B, nk) round-start solidity (K2's, False past last_j), with the
    round's done update on the (B,) int32 `done` in place."""
    dev = solid.device
    B, nk = solid.shape
    cuda.require(solid, "solid", torch.bool, dev, (B, nk))
    cuda.require(last_j, "last_j", torch.int32, dev, (B,))
    cuda.require(done, "done", torch.int32, dev, (B,))
    if dev.type == "cpu":
        return round_candidates_plain(solid, last_j, done, k, max_runs)
    cands = torch.empty((B, SLOTS), dtype=torch.int32, device=dev)
    rc = cuda.lib().kmerax_correct_candidates(
        solid.data_ptr(), B, nk, last_j.data_ptr(), done.data_ptr(), k,
        max_runs, cands.data_ptr(), cuda.stream())
    cuda.LAUNCHES["correct_candidates"] += 1
    cuda.check(rc, "correct_candidates")
    return cands


def correct_apply(bases: torch.Tensor, cands: torch.Tensor,
                  scores: torch.Tensor, edits: torch.Tensor,
                  done: torch.Tensor, k: int, orig=None,
                  max_edits: int = 0):
    """K7: one correct round's accept, conflict suppression and edits on
    the (B, L) int32 round's `bases`, `edits` and `done` ((B,) int32), in
    place, from K6's (B, SLOTS) slots and K3's (B * SLOTS, 4) scores of
    them. With
    `orig` (the batch as it came in, int8 or int32: the last round) it
    returns (the corrected rows in orig's dtype, n_edits (B,) int32) after
    the max_edits revert, else None."""
    dev = bases.device
    B, L = bases.shape
    cuda.require(bases, "bases", torch.int32, dev, (B, L))
    cuda.require(cands, "cands", torch.int32, dev, (B, SLOTS))
    cuda.require(scores, "scores", torch.int32, dev, (B * SLOTS, 4))
    cuda.require(edits, "edits", torch.int32, dev, (B,))
    cuda.require(done, "done", torch.int32, dev, (B,))
    if orig is not None:
        if orig.dtype not in (torch.int8, torch.int32):
            raise TypeError(f"orig: dtype {orig.dtype}, expected int8 or "
                            f"int32")
        cuda.require(orig, "orig", orig.dtype, dev, (B, L))
    if dev.type == "cpu":
        return apply_slots_plain(bases, cands, scores, edits, done, k, orig,
                                 max_edits)
    res = out = n_edits = None
    if orig is not None:
        out = torch.empty_like(orig)
        n_edits = torch.empty(B, dtype=torch.int32, device=dev)
        res = out, n_edits
    rc = cuda.lib().kmerax_correct_apply(
        bases.data_ptr(), B, L, cands.data_ptr(), scores.data_ptr(),
        edits.data_ptr(), done.data_ptr(), k,
        None if orig is None else orig.data_ptr(),
        None if out is None else out.data_ptr(),
        0 if orig is None else orig.element_size(),
        None if n_edits is None else n_edits.data_ptr(), max_edits,
        cuda.stream())
    cuda.LAUNCHES["correct_apply"] += 1
    cuda.check(rc, "correct_apply")
    return res


def make_slot_step(params: BloomParams, table: torch.Tensor, t: int, *,
                   rounds: int, max_runs: int, max_edits: int):
    """step(bases, lengths) -> (corrected (B, L) in bases' dtype, n_edits
    (B,) int32), equal to ops/correct.py::correct_batch (at its default
    max_cands, SLOTS) on the table's solidity at threshold t: each round K2
    (window solidity), K6 (slots), K3 (the whole slot grid) and K7 (apply;
    the revert and the output in the last round), a handful of set-up
    launches a batch, no host sync; on the CPU each kernel's plain version.
    On a card it adds `rounds` to the stage's `correct.rounds_on_card`."""
    k = params.k
    grid_rows = {}                  # (B, device) -> each slot's row

    def step(bases, lengths):
        B = bases.shape[0]
        dev = bases.device
        if rounds == 0:
            return bases.clone(), torch.zeros(B, dtype=torch.int32,
                                              device=dev)
        lengths = lengths.to(torch.int32)
        last_j = lengths - k            # may be negative (short reads)
        cur = bases.to(torch.int32, copy=True)
        edits, done = torch.zeros((2, B), dtype=torch.int32, device=dev)
        ent_r = grid_rows.get((B, dev))
        if ent_r is None:
            ent_r = grid_rows[(B, dev)] = torch.arange(
                B * SLOTS, dtype=torch.int32, device=dev) // SLOTS
        for r in range(rounds):
            solid = bloom_query_solid(table, cur, last_j, params, t)
            cands = correct_candidates(solid, last_j, done, k, max_runs)
            scores = correct_eval_scores(params, table, t, cur, lengths,
                                         last_j, ent_r, cands.view(-1))
            res = correct_apply(cur, cands, scores, edits, done, k,
                                bases if r == rounds - 1 else None,
                                max_edits)
        if dev.type == "cuda":
            tracing.count("correct.rounds_on_card", rounds)
        return res

    return step
