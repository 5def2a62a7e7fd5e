"""Correct stage (port of kmerax/pipeline/run.py::make_correct_step and
run_correct, single process).

Each batch runs ops/correct.py::correct_batch against the count table: the
round-start solidity through kernel K2 and the candidate scoring through
kernel K3 on the card (their plain versions on the CPU). With
`cfg.wire_pack`, an N-free batch crosses on the 2-bit wire both ways
(io/wire.py): unpacked on the device before the step, its corrected rows
packed there and unpacked on the host. Corrected reads are written with
names and qualities byte-identical (DESIGN.md §11).

`use_exact` corrects against the exact spectrum instead (`correct
--use-exact`; kmerax/pipeline/run.py::run_correct): solidity is a binary
search of the sentinel-padded sorted spectrum (spectrum/exact.py::
lookup_sorted) in torch ops. That is not a plain version standing in for a
kernel: the JAX package runs no Pallas kernel on this path either (B2 and
B3 probe the Bloom table, not the sorted spectrum).
"""

from __future__ import annotations

from typing import Optional

import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.io import wire
from kmerax_torch.io.batcher import BackgroundBatcher
from kmerax_torch.io.fastq import FastqWriter
from kmerax_torch.ops.correct import correct_batch
from kmerax_torch.ops.correct_kernels import make_eval_fn, make_window_fn
from kmerax_torch.pipeline.count import CountState, bloom_params, \
    to_device_batch
from kmerax_torch.spectrum.exact import lookup_sorted
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.pipeline")


def make_correct_step(params, table, t, *, rounds, max_runs, max_edits):
    """step(bases, lengths) -> (corrected int8 (B, L), n_edits (B,)) on the
    table's device."""
    window_fn = make_window_fn(params, table, t)
    eval_fn = make_eval_fn(params, table, t)

    def step(bases, lengths):
        fixed, ne = correct_batch(bases, lengths, params.k, t, None,
                                  rounds=rounds, max_runs=max_runs,
                                  max_edits=max_edits, eval_fn=eval_fn,
                                  window_fn=window_fn)
        return fixed.to(bases.dtype), ne

    return step


def make_exact_step(uniq, counts, k, t, *, rounds, max_runs, max_edits):
    """step(bases, lengths) -> (corrected int8 (B, L), n_edits (B,)) with
    solidity from the padded exact spectrum (uniq, counts) on its device."""
    def solid_fn(cw, v):
        return (torch.where(v, lookup_sorted(uniq, counts, cw)[0], 0)
                >= t) & v

    def step(bases, lengths):
        fixed, ne = correct_batch(bases, lengths, k, t, solid_fn,
                                  rounds=rounds, max_runs=max_runs,
                                  max_edits=max_edits)
        return fixed.to(bases.dtype), ne

    return step


def run_correct(cfg: KmeraxConfig, paths, state: CountState, out_path,
                *, device, metrics: Optional[MetricsWriter] = None,
                use_exact: bool = False) -> dict:
    """Correct pass: stream -> correct_batch -> FASTQ.

    `out_path` is one path (all inputs into one output) or a list with one
    path per input (paired-end R1/R2 outputs). `use_exact` queries the
    exact spectrum instead of the Bloom table; it raises "exact spectrum
    not built" where the state has no padded exact form."""
    m = metrics or MetricsWriter(None)
    if isinstance(paths, str):
        paths = [paths]
    if isinstance(out_path, (list, tuple)):
        if len(out_path) != len(paths):
            raise ValueError("need one --out per input file")
        units = [([p], o) for p, o in zip(paths, out_path)]
    else:
        units = [(paths, out_path)]

    kw = dict(rounds=cfg.rounds, max_runs=cfg.max_runs,
              max_edits=cfg.max_edits)
    if use_exact:
        uniq, counts, _ = state.exact(device)
        step = make_exact_step(uniq, counts, cfg.k, state.threshold, **kw)
    else:
        step = make_correct_step(bloom_params(cfg, cfg.k),
                                 state.bloom_table.to(device),
                                 state.threshold, **kw)

    n_reads = n_edited = n_edits = 0
    m.stage_start("correct")
    for gpaths, gout in units:
        with FastqWriter(gout) as out:
            def flush(pend):
                """Read back + write one completed batch."""
                nonlocal n_reads, n_edited, n_edits
                batch, fixed, ne, packed = pend
                fixed, ne = fixed.cpu().numpy(), ne.cpu().numpy()
                if packed:
                    fixed = wire.unpack2_host(fixed, cfg.max_read_len)
                for i in range(batch.n):
                    out.write_record(batch.records[i],
                                     fixed[i, :batch.lengths[i]])
                n_reads += batch.n
                n_edited += int((ne[:batch.n] > 0).sum())
                n_edits += int(ne[:batch.n].sum())

            # one-deep software pipeline: batch i's read-back + write
            # follow batch i+1's launch, so the host write overlaps the
            # device's tail of work on the next batch
            pend = None
            for batch in BackgroundBatcher(gpaths, cfg.batch_reads,
                                           cfg.max_read_len):
                bases, lengths, packed = to_device_batch(batch, device,
                                                         cfg.wire_pack)
                fixed, ne = step(bases, lengths)
                if packed:          # the D2H leg on the 2-bit wire too
                    fixed = wire.pack2_dev(fixed)
                if pend is not None:
                    flush(pend)
                pend = (batch, fixed, ne, packed)
            if pend is not None:
                flush(pend)
    stats = {"reads": n_reads, "edited_reads": n_edited, "edits": n_edits}
    m.stage_end("correct", **stats)
    log.info("correct: %s", stats)
    return stats
