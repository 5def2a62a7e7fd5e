"""Count stage (port of kmerax/pipeline/run.py::run_count, single device).

Per batch: extract k-mers, canonicalize, hash, insert into the Bloom table
(kernel K1 on the card), and append the raw canonical rows to a device
pending buffer. When the buffer fills, and once at the end, the host merges
it into the sorted exact spectrum (np_merge_counted). Counts are
order-free sums, so any flush schedule gives the same spectrum
(DESIGN.md §13). The stage ends with the histogram and the threshold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.core.codec import canonical_words, num_words, to_u32_bits
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.io.batcher import BackgroundBatcher
from kmerax_torch.spectrum.bloom import BloomParams, insert, make_table
from kmerax_torch.spectrum.exact import (
    SENTINEL_WORD, mask_invalid, np_merge_counted, sentinel_rows,
)
from kmerax_torch.spectrum.histogram import solid_threshold
from kmerax_torch.spectrum.host import HostSpectrum
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.pipeline")


@dataclass
class CountState:
    cfg: KmeraxConfig
    bloom_table: torch.Tensor       # (2^log2_width,) int32 on the device
    hist: Optional[np.ndarray]
    threshold: int
    n_reads: int
    n_kmers: int
    host: Optional[HostSpectrum] = None   # set when exact_spectrum=True


def bloom_params(cfg: KmeraxConfig, k: int) -> BloomParams:
    """The port's Bloom parameters: i32 counters ("auto" resolves to i32,
    as the JAX package does off a TPU) and the hash bucket scheme."""
    cfg.require_ported()
    return BloomParams(k, cfg.bloom_log2_width, cfg.bloom_hashes)


def to_device_batch(batch, device):
    """A host ReadBatch -> (int8 bases (B, L), int32 lengths (B,)) on the
    device; bases cross as int8, 4x fewer bytes than int32."""
    bases = torch.from_numpy(batch.bases.astype(np.int8)).to(device)
    lengths = torch.from_numpy(batch.lengths).to(device)
    return bases, lengths


def _count_steps(cfg: KmeraxConfig, k: int):
    """The per-batch count step and the host flush for this config.

    Returns (params, step, exact_flush, P, pend_rows): step(table, pending,
    off, bases) inserts the batch into `table` in place, writes its masked
    canonical rows to pending[off:off + pend_rows] (when pending is not
    None) and returns the number of valid k-mers as a device scalar.
    """
    params = bloom_params(cfg, k)
    w = num_words(k)
    pend_rows = cfg.batch_reads * (cfg.max_read_len - k + 1)
    # buffer ~cap/2 raw rows per flush: flush count stays O(stream/cap)
    pend_m = max(1, (cfg.exact_capacity // 2) // pend_rows)
    P = pend_m * pend_rows

    def step(table, pending, off, bases):
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        insert(params, table, canon, valid)
        if pending is not None:
            flat = mask_invalid(canon, valid).reshape(-1, w)
            pending[off:off + pend_rows] = to_u32_bits(flat)
        return valid.sum()

    def exact_flush(uniq_np, counts_np, pending, off):
        """One D2H of the raw rows + a host sort/merge."""
        pend = pending[:off].cpu().numpy().view(np.uint32)
        pend = pend[~np.all(pend == np.uint32(SENTINEL_WORD), axis=1)]
        rows = np.concatenate([uniq_np, pend], axis=0)
        wts = np.concatenate(
            [counts_np, np.ones(len(pend), dtype=np.int64)])
        return np_merge_counted(rows, wts)

    return params, step, exact_flush, P, pend_rows


def run_count(cfg: KmeraxConfig, paths, *, device,
              k: Optional[int] = None,
              metrics: Optional[MetricsWriter] = None) -> CountState:
    """Count pass: stream batches -> Bloom table (+ exact spectrum)."""
    k = k or cfg.k
    m = metrics or MetricsWriter(None)
    params, step, exact_flush, P, pend_rows = _count_steps(cfg, k)
    table = make_table(params, device)
    pending = None
    host_ex = None
    off = 0
    if cfg.exact_spectrum:
        w = num_words(k)
        host_ex = (np.zeros((0, w), np.uint32), np.zeros(0, np.int64))
        pending = sentinel_rows(P, w, device)

    n_reads = 0
    n_kmers = torch.zeros((), dtype=torch.int64, device=device)
    m.stage_start("count")
    for batch in BackgroundBatcher(paths, cfg.batch_reads, cfg.max_read_len):
        bases, _ = to_device_batch(batch, device)
        n_kmers += step(table, pending, off, bases)
        if pending is not None:
            off += pend_rows
            if off == P:
                host_ex = exact_flush(*host_ex, pending, off)
                off = 0
        n_reads += batch.n
    if host_ex is not None and off > 0:
        host_ex = exact_flush(*host_ex, pending, off)
    del pending
    n_kmers = int(n_kmers)
    hist = None
    host = None
    if host_ex is not None:
        host = HostSpectrum(*host_ex, k)
        log.info("count: %d reads, %d k-mers, %d distinct",
                 n_reads, n_kmers, host.n_unique)
        hist = host.histogram(255)
    if cfg.threshold is None and hist is None:
        raise ValueError("auto threshold needs exact_spectrum=True")
    t = solid_threshold(hist, cfg.threshold) if hist is not None \
        else cfg.threshold
    m.stage_end("count", reads=n_reads, kmers=n_kmers, threshold=t)
    log.info("count: threshold=%d", t)
    return CountState(cfg, table, hist, t, n_reads, n_kmers, host=host)


def count_state_from_numpy(cfg: KmeraxConfig, table, uniq, counts,
                           threshold: int, device) -> CountState:
    """A CountState from count results held as numpy arrays — the
    (2^log2_width,) int32 Bloom table, the sorted spectrum's uniq (N, W)
    uint32 and counts (N,) int64, and the threshold — e.g. the JAX
    package's, so the correct stage can be held against it alone."""
    host = HostSpectrum(np.ascontiguousarray(uniq, dtype=np.uint32),
                        np.asarray(counts, dtype=np.int64), cfg.k)
    table = torch.tensor(np.asarray(table, dtype=np.int32), device=device)
    if table.shape != (1 << cfg.bloom_log2_width,):
        raise ValueError(f"table shape {tuple(table.shape)} does not match "
                         f"bloom_log2_width={cfg.bloom_log2_width}")
    return CountState(cfg, table, host.histogram(255), int(threshold), 0, 0,
                      host=host)
