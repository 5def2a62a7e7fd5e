"""Correction kernel K3 (fused candidate scoring): the CUDA wrapper and its
plain PyTorch version; and the correct round's two kernel entry points for
ops/correct.py::correct_batch (K2's window solidity, K3's scoring).

K3 replaces kmerax/ops/pallas_correct.py::_prep_kernel with the solidity
probe (pallas_bloom.py::_query_kernel) fused in (source: csrc/correct.cu).
It returns the per-entry variant scores (Q, 4); the accept rule stays in
torch (ops/correct.py::_accept), as in the JAX package. It probes the table
in either counter layout of BloomParams; the p16 form (the halfword probe
of pallas_correct.py:266-269) is a kernel of its own, counted as
"correct_eval_scores_p16".

Dispatch: a CPU table takes the plain version; a CUDA table launches the
kernel or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from kmerax_torch.ops.correct import _accept, _eval_scores
from kmerax_torch.spectrum.bloom import BloomParams, query_solid
from kmerax_torch.spectrum.bloom_kernels import bloom_query_solid, \
    counter_name, scheme_args
from kmerax_torch.utils import cuda


def eval_scores_plain(params: BloomParams, table, t, bases, lengths, last_j,
                      ent_r, ent_i) -> torch.Tensor:
    """Plain version of K3 on any device: ops/correct.py::_eval_scores
    probing the table through the plain solidity gather."""
    return _eval_scores(bases, lengths, last_j, ent_r, ent_i, params.k,
                        lambda cw, v: query_solid(params, table, t, cw, v))


def correct_eval_scores(params: BloomParams, table: torch.Tensor, t: int,
                        bases: torch.Tensor, lengths: torch.Tensor,
                        last_j: torch.Tensor, ent_r: torch.Tensor,
                        ent_i: torch.Tensor) -> torch.Tensor:
    """K3: scores (Q, 4) int32 for entries (ent_r, ent_i) of the (B, L)
    int32 read batch against the counter table (in the params' layout) at
    threshold t."""
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


def make_eval_fn(params: BloomParams, table: torch.Tensor, t: int):
    """eval_fn(bases, lengths, last_j, ent_r, ent_i) -> (best_b, accept) for
    ops/correct.py::correct_batch, scoring through K3."""
    def eval_fn(bases, lengths, last_j, ent_r, ent_i):
        scores = correct_eval_scores(
            params, table, t, bases, lengths, last_j,
            ent_r.to(torch.int32), ent_i.to(torch.int32))
        return _accept(scores, bases, ent_r, ent_i)

    return eval_fn


def make_window_fn(params: BloomParams, table: torch.Tensor, t: int):
    """window_fn(bases, last_j) -> (solid, existing) for
    ops/correct.py::correct_batch: the round-start solidity of every window
    of the (B, L) int32 batch in one K2 launch, and the windows that start
    in [0, last_j]."""
    def window_fn(bases, last_j):
        solid = bloom_query_solid(table, bases, last_j, params, t)
        j = torch.arange(solid.shape[1], dtype=torch.int32,
                         device=bases.device)
        return solid, j[None, :] <= last_j[:, None]

    return window_fn
