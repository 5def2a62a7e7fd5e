"""Correction kernel K3 (fused candidate scoring): the CUDA wrapper and its
plain PyTorch version.

K3 replaces kmerax/ops/pallas_correct.py::_prep_kernel with the solidity
probe (pallas_bloom.py::_query_kernel) fused in (source: csrc/correct.cu).
It returns the per-entry variant scores (Q, 4); the accept rule stays in
torch (ops/correct.py::_accept), as in the JAX package.

Dispatch: a CPU table takes the plain version; a CUDA table launches the
kernel or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from kmerax_torch.ops.correct import _accept, _eval_scores
from kmerax_torch.spectrum.bloom import BloomParams, blocks_lanepack
from kmerax_torch.spectrum.bloom_kernels import query_solid_plain
from kmerax_torch.utils import cuda


def eval_scores_plain(params: BloomParams, table, t, bases, lengths, last_j,
                      ent_r, ent_i) -> torch.Tensor:
    """Plain version of K3 on any device: ops/correct.py::_eval_scores
    probing the table through the plain solidity gather."""
    d = params.num_hashes

    def solid_fn(cw, v):
        block, lp = blocks_lanepack(params, cw)
        s = query_solid_plain(table, block.reshape(-1), lp.reshape(-1),
                              v.reshape(-1), d, t)
        return s.view(v.shape)

    return _eval_scores(bases, lengths, last_j, ent_r, ent_i, params.k,
                        solid_fn)


def correct_eval_scores(params: BloomParams, table: torch.Tensor, t: int,
                        bases: torch.Tensor, lengths: torch.Tensor,
                        last_j: torch.Tensor, ent_r: torch.Tensor,
                        ent_i: torch.Tensor) -> torch.Tensor:
    """K3: scores (Q, 4) int32 for entries (ent_r, ent_i) of the (B, L)
    int32 read batch against the int32 counter table at threshold t."""
    dev = table.device
    B, L = bases.shape
    Q = ent_r.shape[0]
    cuda.require(table, "table", torch.int32, dev, (params.width,))
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
        (1 << (params.log2_width - 7)) - 1, params.num_hashes, int(t),
        params.k, scores.data_ptr(), cuda.stream())
    cuda.LAUNCHES["correct_eval_scores"] += 1
    cuda.check(rc, "correct_eval_scores")
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
