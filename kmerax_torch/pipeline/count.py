"""Count stage (port of kmerax/pipeline/run.py::run_count, single device).

Per batch: the read batch crosses to the device (on the 2-bit wire when
`cfg.wire_pack` is set and the batch is N-free, then unpacked there to the
int8 rows; else as int8), then one call of kernel K1 on it, which
extracts the k-mers, canonicalizes and hashes them, inserts
them into the Bloom table and appends their raw canonical rows to a device
pending buffer (on the CPU its plain version runs the same steps in
torch). When the buffer fills, and once at the end, the host merges it into
the sorted exact spectrum (np_merge_counted). Counts are
order-free sums, so any flush schedule gives the same spectrum
(DESIGN.md §13). The stage ends with the histogram and the threshold.
A spectrum with fewer distinct k-mers than `exact_capacity` also has the
JAX package's sentinel-padded device form (`CountState.exact`), built only
when a caller asks for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.core.codec import num_words
from kmerax_torch.io import wire
from kmerax_torch.io.batcher import BackgroundBatcher
from kmerax_torch.spectrum.bloom import BloomParams, make_table
from kmerax_torch.spectrum.bloom_kernels import bloom_insert
from kmerax_torch.spectrum.exact import (
    SENTINEL_WORD, np_merge_counted, sentinel_rows,
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
    # rows of the padded exact form (the JAX package's CountState.exact,
    # kept on its device when n_unique < exact_capacity); None past it
    exact_cap: Optional[int] = None

    def exact(self, device):
        """(uniq (cap, W) int64 words, counts (cap,) int32, n) on `device`,
        padded as the JAX package pads them; raises past capacity."""
        if self.exact_cap is None or self.host is None:
            raise ValueError("exact spectrum not built")
        return self.host.to_device(self.exact_cap, device)


def bloom_params(cfg: KmeraxConfig, k: int) -> BloomParams:
    """The port's Bloom parameters: i32 counters ("auto" resolves to i32,
    as the JAX package does off a TPU) and the config's bucket scheme."""
    cfg.require_ported()
    return BloomParams(k, cfg.bloom_log2_width, cfg.bloom_hashes,
                       cfg.minimizer_m, (cfg.num_buckets - 1).bit_length(),
                       cfg.bucket_scheme)


def send_batch(batch, device, pack: bool = False):
    """The H2D leg of a host ReadBatch -> (rows, int32 lengths (B,),
    packed) on the device. With `pack`, an N-free batch crosses on the 2-bit
    wire (rows (B, ceil(L/4)) uint8, io/wire.py) and `packed` is True;
    otherwise the rows are the (B, L) int8 bases."""
    lengths = torch.from_numpy(batch.lengths).to(device)
    if pack and not wire.batch_has_n(batch.bases, batch.lengths):
        return (torch.from_numpy(wire.pack2_host(batch.bases)).to(device),
                lengths, True)
    return (torch.from_numpy(batch.bases.astype(np.int8)).to(device),
            lengths, False)


def unwire(rows, lengths, packed: bool, L: int):
    """The device leg: send_batch's rows -> (B, L) int8 bases."""
    return wire.unpack2_dev(rows, lengths, L) if packed else rows


def to_device_batch(batch, device, pack: bool = False):
    """A host ReadBatch -> (int8 bases (B, L), int32 lengths (B,), packed)
    on the device: send_batch, then the unpack on the 2-bit wire."""
    rows, lengths, packed = send_batch(batch, device, pack)
    return (unwire(rows, lengths, packed, batch.bases.shape[1]), lengths,
            packed)


def _count_steps(cfg: KmeraxConfig, k: int):
    """The Bloom parameters and the host flush for this config.

    Returns (params, exact_flush, P, pend_rows): a batch's step is
    bloom_insert(table, bases, params, pending, off), which writes its
    pend_rows masked canonical rows from row `off` of the (P, W) pending
    buffer.
    """
    params = bloom_params(cfg, k)
    pend_rows = cfg.batch_reads * (cfg.max_read_len - k + 1)
    # buffer ~cap/2 raw rows per flush: flush count stays O(stream/cap)
    pend_m = max(1, (cfg.exact_capacity // 2) // pend_rows)
    P = pend_m * pend_rows

    def exact_flush(uniq_np, counts_np, pending, off):
        """One D2H of the raw rows + a host sort/merge."""
        pend = pending[:off].cpu().numpy().view(np.uint32)
        pend = pend[~np.all(pend == np.uint32(SENTINEL_WORD), axis=1)]
        rows = np.concatenate([uniq_np, pend], axis=0)
        wts = np.concatenate(
            [counts_np, np.ones(len(pend), dtype=np.int64)])
        return np_merge_counted(rows, wts)

    return params, exact_flush, P, pend_rows


def run_count(cfg: KmeraxConfig, paths, *, device,
              k: Optional[int] = None,
              metrics: Optional[MetricsWriter] = None) -> CountState:
    """Count pass: stream batches -> Bloom table (+ exact spectrum)."""
    k = k or cfg.k
    m = metrics or MetricsWriter(None)
    params, exact_flush, P, pend_rows = _count_steps(cfg, k)
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
        bases, _, _ = to_device_batch(batch, device, cfg.wire_pack)
        n_kmers += bloom_insert(table, bases, params, pending, off)
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
    exact_cap = None
    if host_ex is not None:
        host = HostSpectrum(*host_ex, k)
        log.info("count: %d reads, %d k-mers, %d distinct",
                 n_reads, n_kmers, host.n_unique)
        if host.n_unique < cfg.exact_capacity:
            exact_cap = cfg.exact_capacity
        else:
            log.info("count: %d distinct >= capacity %d — no padded exact "
                     "form", host.n_unique, cfg.exact_capacity)
        hist = host.histogram(255)
    if cfg.threshold is None and hist is None:
        raise ValueError("auto threshold needs exact_spectrum=True")
    t = solid_threshold(hist, cfg.threshold) if hist is not None \
        else cfg.threshold
    m.stage_end("count", reads=n_reads, kmers=n_kmers, threshold=t)
    log.info("count: threshold=%d", t)
    return CountState(cfg, table, hist, t, n_reads, n_kmers, host=host,
                      exact_cap=exact_cap)


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
    cap = cfg.exact_capacity if host.n_unique < cfg.exact_capacity else None
    return CountState(cfg, table, host.histogram(255), int(threshold), 0, 0,
                      host=host, exact_cap=cap)
