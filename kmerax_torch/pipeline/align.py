"""Align/validate stage (port of kmerax/pipeline/run.py::run_align; SURVEY.md
§3.3, DESIGN.md §10b), on one device, or per host across hosts.

The contigs' k-mers go into a cuckoo index (ops/seed_hash.py); each read
batch is seeded through it and scored by the banded DP (kernel K4 on the
card). Stats and the per-read TSV are byte-identical to the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from typing import Optional

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.core.codec import seq_bytes_to_bases
from kmerax_torch.io.batcher import BackgroundBatcher
from kmerax_torch.io.fasta import read_fasta
from kmerax_torch.ops.align import build_contig_index, validate_batch
from kmerax_torch.ops.seed_hash import build_seed_hash
from kmerax_torch.pipeline.count import to_device_batch
from kmerax_torch.utils import tracing
from kmerax_torch.utils.cuda import resolve_device
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.pipeline")


def run_align(cfg: KmeraxConfig, paths, contigs_fasta: str,
              out_tsv: Optional[str] = None, *, device,
              metrics: Optional[MetricsWriter] = None) -> dict:
    """Seed-extend banded alignment of reads against assembled contigs;
    returns {reads, aligned, aligned_frac, mean_identity} and optionally
    writes a per-read TSV (name, found, strand, pos, score, identity).

    The metrics record of stage "align" also carries the index build's
    seconds, its k-mer count and the cuckoo table's device bytes.

    Across N > 1 hosts (every rank calls it; kmerax/pipeline/run.py:
    946-1020) each host leader aligns only its own input shards with K4
    (per-host I/O: io/shard.py), writing `out.tsv.partNNNN`; the stats are
    summed over the hosts as int64 (the identities as micro-identity
    integers) and rank 0 concatenates the TSV parts in shard order, the
    read order. Without per-host I/O rank 0 aligns everything and its
    stats reach every rank."""
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.io.shard import _assign_by_size, all_input_shards, \
        shard_size
    from kmerax_torch.pipeline.count import use_per_host_io

    mesh = dmesh.current()
    hosts = mesh is not None and mesh.n_hosts > 1
    device = resolve_device(device if mesh is None else mesh.device)
    m = metrics or MetricsWriter(None)
    k, band = cfg.k, cfg.band
    if isinstance(paths, (str, tuple)):
        paths = [paths]
    per_host = use_per_host_io(cfg, paths, mesh)
    if per_host:
        shards = all_input_shards(paths, mesh.n_hosts)
        mine = _assign_by_size([shard_size(x) for x in shards],
                               mesh.n_hosts)[mesh.host]
        units = [([shards[i]], f"{out_tsv}.part{i:04d}" if out_tsv
                  else None) for i in mine] if mesh.is_leader else []
        log.info("align[per-host]: process %d aligns %d/%d shards",
                 mesh.host, len(mine), len(shards))
    else:
        units = [(paths, out_tsv)] if dmesh.is_writer() else []

    n_reads = n_aligned = 0
    sum_ident = 0.0
    index_kmers = table_bytes = 0
    with m.stage("align", device) as st:
        if units:
            with tracing.span("align.contig_index"):
                contigs = [seq_bytes_to_bases(
                    np.frombuffer(seq.encode("ascii"), dtype=np.uint8))
                    for _, seq in read_fasta(contigs_fasta)]
                cat, uniq, pay = build_contig_index(contigs, k,
                                                    device=device)
                cat_dev = (torch.from_numpy(cat.astype(np.int8)).to(device)
                           if len(cat) else
                           torch.zeros(1, dtype=torch.int8, device=device))
            with tracing.span("align.seed_table"):
                index = build_seed_hash(uniq, pay, device=device)
            index_kmers = int(len(uniq))
            table_bytes = index.tab.numel() * index.tab.element_size()
        for gpaths, tpath in units:
            with (open(tpath, "w") if tpath
                  else contextlib.nullcontext()) as tsv:
                for batch in BackgroundBatcher(gpaths, cfg.batch_reads,
                                               cfg.max_read_len):
                    bases, lengths, _ = to_device_batch(batch, device)
                    found, strand, pos, score = (
                        x[:batch.n].cpu().numpy() for x in
                        validate_batch(cat_dev, index, bases, lengths, k,
                                       band))
                    lens = batch.lengths[:batch.n]
                    ident = np.where(found & (lens > 0),
                                     score / (2.0 * np.maximum(lens, 1)), 0.0)
                    n_reads += batch.n
                    n_aligned += int(found.sum())
                    sum_ident += float(ident[found].sum())
                    if tsv is not None:
                        tsv.write("".join(
                            f"{batch.records[i].name.decode()}\t"
                            f"{int(found[i])}\t{int(strand[i])}\t"
                            f"{int(pos[i])}\t{int(score[i])}\t"
                            f"{ident[i]:.4f}\n" for i in range(batch.n)))
        if per_host:
            dmesh.host_barrier("align_parts")
            # int64 sums; the identities ride as micro-identity integers
            tot = dmesh.host_allgather(np.asarray(
                [n_reads, n_aligned, int(round(sum_ident * 1e6))],
                np.int64)).sum(axis=0)
            n_reads, n_aligned = int(tot[0]), int(tot[1])
            sum_ident = float(tot[2]) / 1e6
            if out_tsv and dmesh.is_writer():
                with open(out_tsv, "wb") as dst:
                    for i in range(len(shards)):
                        part = f"{out_tsv}.part{i:04d}"
                        with open(part, "rb") as src:
                            shutil.copyfileobj(src, dst)
                        os.remove(part)
            dmesh.host_barrier("align_concat")
        elif hosts:
            got = dmesh.host_broadcast(np.asarray(
                [n_reads, n_aligned, sum_ident], np.float64))
            n_reads, n_aligned, sum_ident = int(got[0]), int(got[1]), got[2]
        stats = {"reads": n_reads, "aligned": n_aligned,
                 "aligned_frac": round(n_aligned / max(n_reads, 1), 4),
                 "mean_identity": round(sum_ident / max(n_aligned, 1), 4)}
        st.set(**stats, index_s=round(st.seconds("align.contig_index")
                                    + st.seconds("align.seed_table"), 4),
               index_kmers=index_kmers, table_bytes=table_bytes)
    log.info("align: %s", stats)
    return stats
