"""Correct stage (port of kmerax/pipeline/run.py::make_correct_step and
run_correct, single process).

Each batch runs ops/correct.py::correct_batch's rounds against the count
table, in the counter layout it was counted in (`CountState.counter`, i32
or p16), as four kernels a round with no host sync (K2 the round-start
solidity, K6 the candidate slots, K3 their scores, K7 the apply:
ops/correct_kernels.py::make_slot_step; their plain versions on the
CPU). With `cfg.wire_pack`, an N-free batch crosses on the 2-bit wire both
ways (io/wire.py): unpacked on the device before the step, its corrected
rows packed there and unpacked on the host. Corrected reads are written with
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
global batch; rank 0 alone writes. The 2-bit wire is decided for the whole
batch before a rank sends its rows (io/wire.py::to_device_batch).

The spectrum path (`_spectrum_step`, chosen once a stage, on one device as
on a mesh), in the JAX package's order: "exact" where `use_exact` asks;
else "fused", the kernel step against the replicated table, wherever one
exists; else "routed-sharded", the plain correction whose probes go by
all-to-all to their bucket owner's merged slice (spectrum/sharded.py::
routed_query_fn), where the table is past the replicate budget and
mesh_bucket > 1; else the JAX package's error. The exact and routed paths
are one wrapper around correct_batch (`correct_step`) given their
solidity source. Across hosts with per-host I/O each host corrects its
own input shards on its local ranks instead (see run_correct).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.dist import mesh as dmesh
from kmerax_torch.io import wire
from kmerax_torch.io.batcher import BackgroundBatcher
from kmerax_torch.io.fastq import FastqWriter
from kmerax_torch.ops.correct import correct_batch
from kmerax_torch.ops.correct_kernels import make_slot_step
from kmerax_torch.pipeline.count import CountState, bloom_params
from kmerax_torch.spectrum.exact import lookup_sorted
from kmerax_torch.utils import tracing
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.pipeline")

# observability: the spectrum path the last correct stage took ("exact" |
# "fused" | "routed-sharded"), and the input shards this host corrected
# in the last per-host correct (None: not per host)
LAST_CORRECT_PATH = None
LAST_CORRECT_SHARDS = None


def correct_step(k, t, *, rounds, max_runs, max_edits, solid_fn,
                 width_fn=None):
    """step(bases, lengths) -> (corrected int8 (B, L), n_edits (B,)):
    ops/correct.py::correct_batch with the solidity source given (its
    solid_fn and width_fn)."""
    def step(bases, lengths):
        fixed, ne = correct_batch(bases, lengths, k, t, solid_fn,
                                  rounds=rounds, max_runs=max_runs,
                                  max_edits=max_edits, width_fn=width_fn)
        return fixed.to(bases.dtype), ne

    return step


def make_correct_step(params, table, t, **kw):
    """The fused step on the table's device: the kernel step
    (ops/correct_kernels.py::make_slot_step: K2, K6, K3, K7 a round, no
    host sync; their plain versions on the CPU)."""
    return make_slot_step(params, table, t, **kw)


def _spectrum_step(cfg: KmeraxConfig, state: CountState, mesh, device,
                   use_exact: bool):
    """(path, step): the correct step's solidity source, in the JAX
    package's order (see the module docstring)."""
    kw = dict(rounds=cfg.rounds, max_runs=cfg.max_runs,
              max_edits=cfg.max_edits)
    t = state.threshold
    if use_exact:
        uniq, counts, _ = state.exact(device)

        def solid_fn(cw, v):
            return (torch.where(v, lookup_sorted(uniq, counts, cw)[0], 0)
                    >= t) & v
        return "exact", correct_step(cfg.k, t, solid_fn=solid_fn, **kw)
    params = bloom_params(cfg, cfg.k, state.counter)
    if state.bloom_table is not None:
        return "fused", make_correct_step(
            params, state.bloom_table.to(device), t, **kw)
    if mesh is not None and state.sharded is not None \
            and state.sharded_table is not None and mesh.spec.bucket > 1:
        from kmerax_torch.spectrum.sharded import routed_query_fn

        # each round compacts to the bucket group's largest entry count,
        # so every rank makes the same collectives
        qf = routed_query_fn(state.sharded, state.sharded_table, mesh)
        return "routed-sharded", correct_step(
            cfg.k, t, solid_fn=lambda cw, v: (qf(cw, v) >= t) & v,
            width_fn=lambda n: mesh.max_int(n, mesh.bucket_group), **kw)
    raise ValueError(
        "no replicated table (past replicate budget) and the routed "
        "path is unavailable — count on a bucket-sharded mesh "
        "(mesh_bucket > 1) for tables this large")


def _write_batch(out, pend, L: int):
    """Read back one corrected batch and write its records (where `out`
    is open); returns its (reads, edited reads, edits)."""
    batch, fixed, ne, packed = pend
    with tracing.span("correct.write"):
        fixed, ne = fixed.cpu().numpy(), ne.cpu().numpy()
        if packed:
            fixed = wire.unpack2_host(fixed, L)
        if out is not None:
            for i in range(batch.n):
                out.write_record(batch.records[i],
                                 fixed[i, :batch.lengths[i]])
    ne = ne[:batch.n]
    return np.asarray([batch.n, int((ne > 0).sum()), int(ne.sum())],
                      np.int64)


def _correct_stream(cfg, paths, step, out, device, pack, mesh, rows, group):
    """Correct the batches of `paths`, writing them to `out`; returns the
    (reads, edited reads, edits) sums. A mesh rank corrects its `rows` of
    each batch and gathers the batch's over `group`. One-deep software
    pipeline: batch i's read-back and write follow batch i+1's launch, so
    the host write overlaps the device's tail of work on the next batch."""
    tot = np.zeros(3, np.int64)
    pend = None
    for batch in BackgroundBatcher(paths, cfg.batch_reads, cfg.max_read_len):
        bases, lengths, packed = wire.to_device_batch(batch, device, pack,
                                                      rows)
        with tracing.span("correct.step"):
            fixed, ne = step(bases, lengths)
        if packed:              # the D2H leg on the 2-bit wire too
            fixed = wire.pack2_dev(fixed)
        if mesh is not None:
            fixed = mesh.all_gather_rows(fixed, group)
            ne = mesh.all_gather_rows(ne, group)
        if pend is not None:
            tot += _write_batch(out, pend, cfg.max_read_len)
        pend = (batch, fixed, ne, packed)
    if pend is not None:
        tot += _write_batch(out, pend, cfg.max_read_len)
    return tot


def run_correct(cfg: KmeraxConfig, paths, state: CountState, out_path,
                *, device, metrics: Optional[MetricsWriter] = None,
                use_exact: bool = False) -> dict:
    """Correct pass: stream -> correct_batch -> FASTQ.

    `out_path` is one path (all inputs into one output) or a list with one
    path per input (paired-end R1/R2 outputs). `use_exact` queries the
    exact spectrum instead of the Bloom table; it raises "exact spectrum
    not built" where the state has no padded exact form.

    Across N > 1 hosts with per-host I/O (kmerax/pipeline/run.py:706-885)
    a single output's units are the global input shards, each written to
    `out.partNNNN` (io/shard.py::shard_units); with a replicated table and
    a unit a host at least, host p corrects the units it owns (`host_share`,
    by size; one output per input: the files are the units): its local
    ranks run the fused step over its local group and its leader writes.
    The stats are summed over the hosts and rank 0 concatenates the parts
    in shard order (the read order, so the bytes are the one-process
    run's). Past the replicate budget the step is the global routed step,
    as in the reference."""
    from kmerax_torch.io.fastq import _open_w
    from kmerax_torch.io.shard import concat_parts, host_share, \
        shard_units, use_per_host_io

    global LAST_CORRECT_PATH, LAST_CORRECT_SHARDS
    m = metrics or MetricsWriter(None)
    if isinstance(paths, (str, tuple)):
        paths = [paths]
    mesh = dmesh.current(cfg)
    host_io = use_per_host_io(cfg, paths, mesh) and not use_exact
    parts = None                # a single output's parts across hosts
    if isinstance(out_path, (list, tuple)):
        if len(out_path) != len(paths):
            raise ValueError("need one --out per input file")
        units = [([p], o) for p, o in zip(paths, out_path)]
    elif host_io:
        units = shard_units(paths, mesh.n_hosts, out_path)
        parts = [part for _, part in units]
    else:
        units = [(paths, out_path)]
    per_host = (host_io and len(units) >= mesh.n_hosts
                and state.bloom_table is not None)
    if host_io and state.bloom_table is None:
        log.info("correct: per-host mode disabled (table past the "
                 "replicate budget) — using global-mesh routed correction")

    rows = group = None
    writer = dmesh.is_writer()
    if mesh is not None:
        device = mesh.device
        rows = mesh.row_slice(cfg.batch_reads)
    if per_host:
        mine = host_share(units, mesh.n_hosts, mesh.host)
        log.info("correct[per-host]: process %d owns %d/%d shards: %s",
                 mesh.host, len(mine), len(units), [units[i][1] for i in mine])
        units = [units[i] for i in mine]
        rows = mesh.local_row_slice(cfg.batch_reads)
        group = mesh.local_group
        writer = mesh.is_leader
    LAST_CORRECT_PATH, step = _spectrum_step(cfg, state, mesh, device,
                                             use_exact)
    LAST_CORRECT_SHARDS = list(mine) if per_host else None
    if mesh is not None and not per_host:
        log.info("correct[mesh]: spectrum path = %s", LAST_CORRECT_PATH)
    # the 2-bit wire where the rows are read back locally: one process,
    # one host, or per host (the reference's `use_pack`)
    pack = cfg.wire_pack and (mesh is None or mesh.n_hosts == 1 or per_host)

    tot = np.zeros(3, np.int64)
    with m.stage("correct", device) as st:
        for gpaths, gout in units:
            with (FastqWriter(gout) if writer
                  else contextlib.nullcontext()) as out:
                tot += _correct_stream(cfg, gpaths, step, out, device, pack,
                                       mesh, rows, group)
        if mesh is not None and mesh.n_hosts > 1:
            # the next stage reads the corrected FASTQ on every host: wait
            # until every writer is done
            dmesh.host_barrier("correct_write")
            if per_host:
                tot = dmesh.host_allgather(tot).sum(axis=0)
        elif mesh is not None:
            # the next stage (the assembly's re-count) reads the corrected
            # FASTQ on every rank: wait until rank 0 has written it
            mesh.barrier()
        if parts is not None:
            # rank 0 streams the parts in shard order through one writer
            # (one deterministic gzip stream where the output is .gz)
            if dmesh.is_writer():
                with _open_w(out_path) as dst:
                    concat_parts(parts, dst)
            dmesh.host_barrier("correct_concat")
        stats = dict(zip(("reads", "edited_reads", "edits"),
                         (int(x) for x in tot)))
        st.set(**stats)
    log.info("correct: %s", stats)
    return stats
