"""Correct stage (port of kmerax/pipeline/run.py::make_correct_step and
run_correct, single process).

Each batch runs ops/correct.py::correct_batch against the count table, in
the counter layout it was counted in (`CountState.counter`, i32 or p16):
the round-start solidity through kernel K2 and the candidate scoring
through kernel K3 on the card (their plain versions on the CPU). With
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

On a mesh (`cfg.mesh_data * cfg.mesh_bucket > 1`, port of
kmerax/pipeline/run.py::_correct_step_mesh) every rank corrects its own
rows of each batch, on the same wire as one device, and the corrected rows
and edit counts are gathered to every rank in rank order, the order of the
global batch; rank 0 alone writes. The spectrum path, in the JAX package's
order: "fused", the K2/K3 step against the replicated table, wherever one
exists; else "routed-sharded", the plain correction whose probes go by
all-to-all to their bucket owner's merged slice (spectrum/sharded.py::
routed_query_fn), where the table is past the replicate budget and
mesh_bucket > 1; else the JAX package's error. `use_exact` wins over both.
Across hosts with per-host I/O each host corrects its own input shards on
its local ranks instead (see run_correct).
"""

from __future__ import annotations

import contextlib
import os
import shutil
from typing import Optional

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.dist import mesh as dmesh
from kmerax_torch.io import wire
from kmerax_torch.io.batcher import BackgroundBatcher, ReadBatch
from kmerax_torch.io.fastq import FastqWriter
from kmerax_torch.ops.correct import correct_batch
from kmerax_torch.ops.correct_kernels import make_eval_fn, make_window_fn
from kmerax_torch.pipeline.count import CountState, bloom_params, \
    to_device_batch
from kmerax_torch.spectrum.exact import lookup_sorted
from kmerax_torch.utils import tracing
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.pipeline")

# observability: the spectrum path the last mesh correct step selected
# ("fused" | "routed-sharded"), and the input shards this host corrected
# in the last per-host correct (None: not per host)
LAST_CORRECT_PATH = None
LAST_CORRECT_SHARDS = None


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


def make_routed_step(params, sp, table_shard, t, mesh, *, rounds,
                     max_runs, max_edits):
    """step(bases, lengths) on a mesh rank whose count kept the table
    bucket-sharded: the plain correction with every probe routed to its
    owner's merged slice; each round compacts to the bucket group's
    largest entry count, so every rank makes the same collectives."""
    from kmerax_torch.spectrum.sharded import routed_query_fn

    qf = routed_query_fn(sp, table_shard, mesh)

    def solid_fn(cw, v):
        return (qf(cw, v) >= t) & v

    def width_fn(n):
        return mesh.max_int(n, mesh.bucket_group)

    def step(bases, lengths):
        fixed, ne = correct_batch(bases, lengths, params.k, t, solid_fn,
                                  rounds=rounds, max_runs=max_runs,
                                  max_edits=max_edits, width_fn=width_fn)
        return fixed.to(bases.dtype), ne

    return step


def _mesh_step(cfg: KmeraxConfig, state: CountState, mesh, kw):
    """The mesh correct step's spectrum path (see the module docstring)."""
    global LAST_CORRECT_PATH
    params = bloom_params(cfg, cfg.k, state.counter)
    t = state.threshold
    if state.bloom_table is not None:
        LAST_CORRECT_PATH = "fused"
        step = make_correct_step(params, state.bloom_table.to(mesh.device),
                                 t, **kw)
    elif state.sharded is not None and state.sharded_table is not None \
            and mesh.spec.bucket > 1:
        LAST_CORRECT_PATH = "routed-sharded"
        step = make_routed_step(params, state.sharded, state.sharded_table,
                                t, mesh, **kw)
    else:
        raise ValueError(
            "no replicated table (past replicate budget) and the routed "
            "path is unavailable — count on a bucket-sharded mesh "
            "(mesh_bucket > 1) for tables this large")
    log.info("correct[mesh]: spectrum path = %s", LAST_CORRECT_PATH)
    return step


def run_correct(cfg: KmeraxConfig, paths, state: CountState, out_path,
                *, device, metrics: Optional[MetricsWriter] = None,
                use_exact: bool = False) -> dict:
    """Correct pass: stream -> correct_batch -> FASTQ.

    `out_path` is one path (all inputs into one output) or a list with one
    path per input (paired-end R1/R2 outputs). `use_exact` queries the
    exact spectrum instead of the Bloom table; it raises "exact spectrum
    not built" where the state has no padded exact form.

    Across N > 1 hosts with per-host I/O (kmerax/pipeline/run.py:706-885)
    a single output's units are the global input shards
    (io/shard.py::all_input_shards), each written to `out.partNNNN`; with
    a replicated table and a unit a host at least, host p corrects the
    units `_assign_by_size` gives it: its local ranks run the fused step
    over its local group and its leader writes. The stats are summed over
    the hosts and rank 0 concatenates the parts in shard order (the read
    order, so the bytes are the one-process run's). Past the replicate
    budget the step is the global routed step, as in the reference."""
    from kmerax_torch.dist.mesh import host_allgather, host_barrier
    from kmerax_torch.io.fastq import _open_w
    from kmerax_torch.io.shard import _assign_by_size, all_input_shards, \
        shard_size
    from kmerax_torch.pipeline.count import use_per_host_io

    global LAST_CORRECT_PATH, LAST_CORRECT_SHARDS
    m = metrics or MetricsWriter(None)
    if isinstance(paths, (str, tuple)):
        paths = [paths]
    mesh = dmesh.current(cfg)
    host_io = use_per_host_io(cfg, paths, mesh) and not use_exact
    concat = None
    if isinstance(out_path, (list, tuple)):
        if len(out_path) != len(paths):
            raise ValueError("need one --out per input file")
        units = [([p], o) for p, o in zip(paths, out_path)]
    elif host_io:
        units = [([sh], f"{out_path}.part{i:04d}")
                 for i, sh in enumerate(all_input_shards(paths,
                                                         mesh.n_hosts))]
        concat = out_path
    else:
        units = [(paths, out_path)]
    all_units = units
    per_host = (host_io and len(units) >= mesh.n_hosts
                and state.bloom_table is not None)
    if host_io and state.bloom_table is None:
        log.info("correct: per-host mode disabled (table past the "
                 "replicate budget) — using global-mesh routed correction")

    kw = dict(rounds=cfg.rounds, max_runs=cfg.max_runs,
              max_edits=cfg.max_edits)
    group = None
    writer = dmesh.is_writer()
    LAST_CORRECT_SHARDS = None
    if mesh is not None:
        device = mesh.device
        rows = mesh.row_slice(cfg.batch_reads)
    if use_exact:
        uniq, counts, _ = state.exact(device)
        step = make_exact_step(uniq, counts, cfg.k, state.threshold, **kw)
    elif per_host:
        mine = _assign_by_size([shard_size(u[0][0]) for u in units],
                               mesh.n_hosts)[mesh.host]
        log.info("correct[per-host]: process %d owns %d/%d shards: %s",
                 mesh.host, len(mine), len(units),
                 [units[i][1] for i in mine])
        units = [units[i] for i in mine]
        LAST_CORRECT_SHARDS = list(mine)
        LAST_CORRECT_PATH = "fused"
        rows = mesh.local_row_slice(cfg.batch_reads)
        group = mesh.local_group
        writer = mesh.is_leader
        step = make_correct_step(bloom_params(cfg, cfg.k, state.counter),
                                 state.bloom_table.to(device),
                                 state.threshold, **kw)
    elif mesh is not None:
        step = _mesh_step(cfg, state, mesh, kw)
    else:
        step = make_correct_step(bloom_params(cfg, cfg.k, state.counter),
                                 state.bloom_table.to(device),
                                 state.threshold, **kw)
    # the 2-bit wire where the rows are read back locally: one process,
    # one host, or per host (the reference's `use_pack`)
    use_pack = cfg.wire_pack and (mesh is None or mesh.n_hosts == 1
                                  or per_host)

    n_reads = n_edited = n_edits = 0
    with m.stage("correct", device) as st:
        for gpaths, gout in units:
            with (FastqWriter(gout) if writer
                  else contextlib.nullcontext()) as out:
                def flush(pend):
                    """Read back + write one completed batch."""
                    nonlocal n_reads, n_edited, n_edits
                    batch, fixed, ne, packed = pend
                    with tracing.span("correct.write"):
                        fixed, ne = fixed.cpu().numpy(), ne.cpu().numpy()
                        if packed:
                            fixed = wire.unpack2_host(fixed,
                                                      cfg.max_read_len)
                        if out is not None:
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
                    if mesh is None:
                        bases, lengths, packed = to_device_batch(
                            batch, device, use_pack)
                    else:
                        # this rank's rows, on the wire the whole batch takes
                        pack = use_pack and not wire.batch_has_n(
                            batch.bases, batch.lengths)
                        bases, lengths, packed = to_device_batch(
                            ReadBatch(batch.bases[rows], batch.lengths[rows],
                                      0, []), device, pack)
                    with tracing.span("correct.step"):
                        fixed, ne = step(bases, lengths)
                    if packed:          # the D2H leg on the 2-bit wire too
                        fixed = wire.pack2_dev(fixed)
                    if mesh is not None:
                        fixed = mesh.all_gather_rows(fixed, group)
                        ne = mesh.all_gather_rows(ne, group)
                    if pend is not None:
                        flush(pend)
                    pend = (batch, fixed, ne, packed)
                if pend is not None:
                    flush(pend)
        if mesh is not None and mesh.n_hosts > 1:
            # the next stage reads the corrected FASTQ on every host: wait
            # until every writer is done
            host_barrier("correct_write")
            if per_host:
                tot = host_allgather(np.asarray([n_reads, n_edited, n_edits],
                                                np.int64)).sum(axis=0)
                n_reads, n_edited, n_edits = (int(x) for x in tot)
        elif mesh is not None:
            # the next stage (the assembly's re-count) reads the corrected
            # FASTQ on every rank: wait until rank 0 has written it
            mesh.barrier()
        if concat is not None:
            # rank 0 streams the parts in shard order through one writer (one
            # deterministic gzip stream where the output is .gz)
            if dmesh.is_writer():
                with _open_w(concat) as dst:
                    for _, part in all_units:
                        with open(part, "rb") as src:
                            shutil.copyfileobj(src, dst, 8 << 20)
                for _, part in all_units:
                    os.remove(part)
            host_barrier("correct_concat")
        stats = {"reads": n_reads, "edited_reads": n_edited, "edits": n_edits}
        st.set(**stats)
    log.info("correct: %s", stats)
    return stats
