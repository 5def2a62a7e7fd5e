"""Align/validate stage (port of kmerax/pipeline/run.py::run_align, single
process; SURVEY.md §3.3, DESIGN.md §10b).

The contigs' k-mers go into a cuckoo index (ops/seed_hash.py); each read
batch is seeded through it and scored by the banded DP (kernel K4 on the
card). Stats and the per-read TSV are byte-identical to the JAX package's.
"""

from __future__ import annotations

import contextlib
import time
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
    seconds, its k-mer count and the cuckoo table's device bytes."""
    device = resolve_device(device)
    m = metrics or MetricsWriter(None)
    k, band = cfg.k, cfg.band
    t0 = time.perf_counter()
    contigs = [seq_bytes_to_bases(
        np.frombuffer(seq.encode("ascii"), dtype=np.uint8))
        for _, seq in read_fasta(contigs_fasta)]
    cat, uniq, pay = build_contig_index(contigs, k, device=device)
    cat_dev = torch.from_numpy(cat.astype(np.int8)).to(device) if len(cat) \
        else torch.zeros(1, dtype=torch.int8, device=device)
    index = build_seed_hash(uniq, pay, device=device)
    index_s = time.perf_counter() - t0
    if isinstance(paths, str):
        paths = [paths]

    n_reads = n_aligned = 0
    sum_ident = 0.0
    m.stage_start("align")
    with open(out_tsv, "w") if out_tsv else contextlib.nullcontext() as tsv:
        for batch in BackgroundBatcher(paths, cfg.batch_reads,
                                       cfg.max_read_len):
            bases, lengths = to_device_batch(batch, device)
            found, strand, pos, score = (
                x[:batch.n].cpu().numpy() for x in
                validate_batch(cat_dev, index, bases, lengths, k, band))
            lens = batch.lengths[:batch.n]
            ident = np.where(found & (lens > 0),
                             score / (2.0 * np.maximum(lens, 1)), 0.0)
            n_reads += batch.n
            n_aligned += int(found.sum())
            sum_ident += float(ident[found].sum())
            if out_tsv:
                tsv.write("".join(
                    f"{batch.records[i].name.decode()}\t"
                    f"{int(found[i])}\t{int(strand[i])}\t"
                    f"{int(pos[i])}\t{int(score[i])}\t"
                    f"{ident[i]:.4f}\n" for i in range(batch.n)))
    stats = {"reads": n_reads, "aligned": n_aligned,
             "aligned_frac": round(n_aligned / max(n_reads, 1), 4),
             "mean_identity": round(sum_ident / max(n_aligned, 1), 4)}
    m.stage_end("align", **stats, index_s=round(index_s, 4),
                index_kmers=int(len(uniq)),
                table_bytes=index.tab.numel() * index.tab.element_size())
    log.info("align: %s", stats)
    return stats

