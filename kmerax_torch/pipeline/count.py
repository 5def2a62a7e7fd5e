"""Count stage (port of kmerax/pipeline/run.py::run_count and
_run_count_sharded).

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

On a mesh of more than one device (`cfg.mesh_data * cfg.mesh_bucket > 1`)
`run_count` takes `run_count_sharded`: each rank counts its rows of every
batch into its range shard of the table through the bucket all-to-all and
kernel K1r (spectrum/sharded.py). Across N > 1 hosts with per-host I/O
each host parses only its own input shards (io/shard.py), the hosts trade
(has_more, n_local) every batch to stay in lockstep, and by default the
leaders range-shard the exact spectrum over the hosts
(spectrum/host_sharded.py).
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
from kmerax_torch.utils import tracing
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.pipeline")


# replicated merged-table ceiling: past this the mesh count keeps the
# spectrum bucket-sharded only and correction routes probes to owners
REPLICATE_TABLE_BUDGET = 1 << 29        # 512 MB

# observability of the last mesh count: how many route-overflow batch
# replays it performed, and the route_safety level it ENDED at (back at
# baseline in steady state)
LAST_COUNT_RETRIES = 0
LAST_ROUTE_SAFETY = None
# host merges of the pending buffer in the last count, one-device or mesh
# (this rank's)
LAST_COUNT_FLUSHES = 0


@dataclass
class CountState:
    cfg: KmeraxConfig
    # (2^log2_width,) int32 counters, or (2^log2_width / 2,) p16 words
    # (`counter`), on the device; None after a mesh count whose table is
    # past REPLICATE_TABLE_BUDGET
    bloom_table: Optional[torch.Tensor]
    hist: Optional[np.ndarray]
    threshold: int
    n_reads: int
    n_kmers: int
    host: Optional[HostSpectrum] = None   # set when exact_spectrum=True
    # rows of the padded exact form (the JAX package's CountState.exact,
    # kept on its device when n_unique < exact_capacity); None past it
    exact_cap: Optional[int] = None
    sharded: Optional[object] = None      # ShardedParams of a mesh count
    # this rank's merged (width/S,) slice after a mesh count: the routed
    # correction's spectrum for tables too large to replicate
    sharded_table: Optional[torch.Tensor] = None
    # the table's counter layout, "i32" or "p16": the count's own, or the
    # one a checkpoint's table length gives (`table_counter`)
    counter: str = "i32"

    def exact(self, device):
        """(uniq (cap, W) int64 words, counts (cap,) int32, n) on `device`,
        padded as the JAX package pads them; raises past capacity."""
        if self.exact_cap is None or self.host is None:
            raise ValueError("exact spectrum not built")
        return self.host.to_device(self.exact_cap, device)


def bloom_params(cfg: KmeraxConfig, k: int,
                 counter: Optional[str] = None) -> BloomParams:
    """The port's Bloom parameters: the config's bucket scheme and counter
    layout ("auto" resolves to i32, as the JAX package does off a TPU), or
    `counter` where given (a count state's, `CountState.counter`)."""
    if counter is None:
        counter = "i32" if cfg.bloom_counter == "auto" else cfg.bloom_counter
    return BloomParams(k, cfg.bloom_log2_width, cfg.bloom_hashes,
                       cfg.minimizer_m, (cfg.num_buckets - 1).bit_length(),
                       cfg.bucket_scheme, counter)


def table_counter(cfg: KmeraxConfig, n_words: int) -> str:
    """The counter layout of a saved (n_words,) Bloom table counted under
    `cfg`: 2^bloom_log2_width words are i32 counters, half as many are p16
    words, even under "auto" (a TPU run resolves "auto" to p16 at 2^25
    counters and saves the packed table). A length that is neither, or a
    layout the config names explicitly and the table is not, raises."""
    width = 1 << cfg.bloom_log2_width
    layout = {width: "i32", width // 2: "p16"}.get(n_words)
    if layout is None:
        raise ValueError(
            f"bloom_table has {n_words} words: neither {width} (i32) nor "
            f"{width // 2} (p16) for bloom_log2_width="
            f"{cfg.bloom_log2_width}")
    if cfg.bloom_counter not in ("auto", layout):
        raise ValueError(
            f"bloom_table has {n_words} words, the {layout} layout, but "
            f"the config names bloom_counter={cfg.bloom_counter!r}")
    return layout


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
        with tracing.span("count.flush"):
            pend = pending[:off].cpu().numpy().view(np.uint32)
            pend = pend[~np.all(pend == np.uint32(SENTINEL_WORD), axis=1)]
            rows = np.concatenate([uniq_np, pend], axis=0)
            tracing.count("count.merge_rows", len(rows))
            wts = np.concatenate(
                [counts_np, np.ones(len(pend), dtype=np.int64)])
            return np_merge_counted(rows, wts)

    return params, exact_flush, P, pend_rows


def run_count(cfg: KmeraxConfig, paths, *, device,
              k: Optional[int] = None,
              metrics: Optional[MetricsWriter] = None) -> CountState:
    """Count pass: stream batches -> Bloom table (+ exact spectrum)."""
    if cfg.mesh_data * cfg.mesh_bucket > 1:
        return run_count_sharded(cfg, paths, device=device, k=k,
                                 metrics=metrics)
    global LAST_COUNT_FLUSHES
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
    LAST_COUNT_FLUSHES = 0
    with m.stage("count", device) as st:
        for batch in BackgroundBatcher(paths, cfg.batch_reads,
                                       cfg.max_read_len):
            bases, _, _ = to_device_batch(batch, device, cfg.wire_pack)
            n_kmers += bloom_insert(table, bases, params, pending, off)
            if pending is not None:
                off += pend_rows
                if off == P:
                    host_ex = exact_flush(*host_ex, pending, off)
                    LAST_COUNT_FLUSHES += 1
                    off = 0
            n_reads += batch.n
        if host_ex is not None and off > 0:
            host_ex = exact_flush(*host_ex, pending, off)
            LAST_COUNT_FLUSHES += 1
        del pending
        n_kmers = int(n_kmers)
        host, hist, exact_cap, t = _finish_count(cfg, host_ex, k, n_reads,
                                                 n_kmers)
        st.set(reads=n_reads, kmers=n_kmers, threshold=t)
    log.info("count: threshold=%d", t)
    return CountState(cfg, table, hist, t, n_reads, n_kmers, host=host,
                      exact_cap=exact_cap, counter=params.counter)


def _finish_count(cfg, host_ex, k, n_reads, n_kmers, tag="count"):
    """(host spectrum, histogram, exact_cap, threshold) at stage end."""
    hist = host = exact_cap = None
    if host_ex is not None:
        host = HostSpectrum(*host_ex, k)
        log.info("%s: %d reads, %d k-mers, %d distinct",
                 tag, n_reads, n_kmers, host.n_unique)
        if host.n_unique < cfg.exact_capacity:
            exact_cap = cfg.exact_capacity
        else:
            log.info("%s: %d distinct >= capacity %d — no padded exact "
                     "form", tag, host.n_unique, cfg.exact_capacity)
        hist = host.histogram(255)
    if cfg.threshold is None and hist is None:
        raise ValueError("auto threshold needs exact_spectrum=True")
    t = solid_threshold(hist, cfg.threshold) if hist is not None \
        else cfg.threshold
    return host, hist, exact_cap, t


def use_per_host_io(cfg: KmeraxConfig, paths, mesh) -> bool:
    """Per-host input sharding (kmerax/pipeline/run.py::_use_per_host_io):
    across N > 1 hosts with `per_host_io`, given at least one file a host
    or plain (non-.gz) files, which split into record-aligned byte ranges,
    so a single big FASTQ still parses 1/N a host."""
    if mesh is None or mesh.n_hosts <= 1 or not cfg.per_host_io:
        return False
    return (len(paths) >= mesh.n_hosts
            or not any(str(p).endswith(".gz") for p in paths))


def _mesh_batches(cfg: KmeraxConfig, paths, mesh):
    """Yield (this rank's (b, L) int8 rows of a global batch, the real
    reads in that global batch) for the mesh count loop.

    One host: every rank parses every input and takes its rows. Per-host
    I/O (kmerax/pipeline/run.py::_global_batches): the ranks of host p
    parse only local_shards(paths, N, p), in batches of B/N rows, each
    taking its local rank's slice; every batch the hosts trade
    (has_more, n_local) over the hosts group and a host that has run out
    feeds empty rows (base code 4). Counting is order-free, so the spectrum
    is the one-process stream's (DESIGN.md §13)."""
    from kmerax_torch.dist.mesh import host_allgather
    from kmerax_torch.io.shard import local_shards

    B, L = cfg.batch_reads, cfg.max_read_len
    if not use_per_host_io(cfg, paths, mesh):
        rows = mesh.row_slice(B)
        for batch in BackgroundBatcher(paths, B, L):
            yield batch.bases[rows].astype(np.int8), batch.n
        return
    N, p = mesh.n_hosts, mesh.host
    mesh.row_slice(B)                   # B divides by the world
    lp = local_shards(paths, N, p)
    log.info("count[per-host]: process %d parses %d shards of %d files: %s",
             p, len(lp), len(paths), [str(x) for x in lp])
    rows = mesh.local_row_slice(B // N)
    empty = np.full((rows.stop - rows.start, L), 4, np.int8)
    it = iter(BackgroundBatcher(lp, B // N, L)) if lp else iter(())
    while True:
        batch = next(it, None)
        flags = host_allgather(np.asarray(
            [0 if batch is None else 1, 0 if batch is None else batch.n],
            np.int64))
        if flags[:, 0].sum() == 0:
            break
        yield (empty if batch is None
               else batch.bases[rows].astype(np.int8)), int(flags[:, 1].sum())


def run_count_sharded(cfg: KmeraxConfig, paths, *, device,
                      k: Optional[int] = None,
                      metrics: Optional[MetricsWriter] = None,
                      mesh=None) -> CountState:
    """Distributed count pass over the ("data", "bucket") mesh (DESIGN.md
    §12), on every rank of it: `mesh`, else this process's current mesh of
    the config's shape.

    Every rank takes its rows of each global batch (`_mesh_batches`: all
    ranks parse every input on one host, each host its own shards across
    hosts) and counts them (int8 on the device): route to the bucket
    owners, K1r into the owner's
    partial slice, the valid routed rows appended to its pending buffer,
    which the host merges when a batch's worst case (recv_rows) no longer
    fits and at the end. A route overflow anywhere
    makes the batch a no-op everywhere; the capacity then doubles (up to 4S)
    and the batch replays, and after 8 clean batches it halves back toward
    the baseline. At the end the slices merge over "data" (kept as
    `sharded_table`) and, within REPLICATE_TABLE_BUDGET, are gathered over
    "bucket" into the replicated table. The ranks' host spectra become
    the global one: on one host (or with `shard_host_spectrum=False`) it is
    unioned onto every rank; across N > 1 hosts by default each host's
    ranks merge theirs onto the host leader, and the leaders range-shard
    the union over the hosts (`state.host` a ShardedHostSpectrum on the
    leaders, None on the other ranks; the histogram and threshold are
    global everywhere). Counts are order-free sums, so the table and the
    spectrum are those of the one-device count (DESIGN.md §13)."""
    import dataclasses

    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.spectrum.sharded import (
        ShardedParams, allgather_spectrum, flush_pending_local,
        merge_and_replicate, merge_keep_sharded, recv_rows,
        sharded_insert_step,
    )

    global LAST_COUNT_RETRIES, LAST_ROUTE_SAFETY, LAST_COUNT_FLUSHES
    k = k or cfg.k
    m = metrics or MetricsWriter(None)
    # a p16 config raises here, before any rank work
    sp = ShardedParams(bloom_params(cfg, k), n_shards=cfg.mesh_bucket)
    mesh = mesh or dmesh.current(cfg)
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    device = mesh.device
    D, S = mesh.spec.data, mesh.spec.bucket
    if S != sp.n_shards:
        raise ValueError(f"mesh {D}x{S} is not the config's "
                         f"{cfg.mesh_data}x{cfg.mesh_bucket}")
    if isinstance(paths, (str, tuple)):
        paths = [paths]
    w = num_words(k)
    n_flat = (cfg.batch_reads // (D * S)) * (cfg.max_read_len - k + 1)
    pending = None
    pend_rows = step_rows = 0
    if cfg.exact_spectrum:
        step_rows = recv_rows(sp, n_flat)
        # buffer ~cap/2 raw rows globally per flush (flat per-batch cost)
        pend_m = max(1, (cfg.exact_capacity // 2) // (step_rows * D * S))
        pend_rows = pend_m * step_rows
        # K1r appends valid rows only; rows past `off` are never read
        pending = torch.empty((pend_rows, w), dtype=torch.int32,
                              device=device)
    table = torch.zeros(sp.bloom.width // S, dtype=torch.int32,
                        device=device)
    step = sharded_insert_step(sp, mesh, k)
    host_ex = (np.zeros((0, w), np.uint32), np.zeros(0, np.int64))

    def flush(pending, off):
        global LAST_COUNT_FLUSHES
        nonlocal host_ex
        with tracing.span("count.flush"):
            raw = flush_pending_local(pending, off)
            rows = np.concatenate([host_ex[0], raw], axis=0)
            tracing.count("count.merge_rows", len(rows))
            host_ex = np_merge_counted(rows, np.concatenate(
                [host_ex[1], np.ones(len(raw), np.int64)]))
        LAST_COUNT_FLUSHES += 1
        log.info("count[mesh]: flushed %d raw rows (%d distinct resident)",
                 len(raw), len(host_ex[0]))

    n_reads = n_kmers = off = 0
    LAST_COUNT_RETRIES = LAST_COUNT_FLUSHES = 0
    # steps are cached per capacity level, and after DECAY_AFTER
    # overflow-free batches the capacity halves back toward baseline, so
    # one adversarial batch does not inflate the routed buffers for the
    # rest of the stage
    base_safety = sp.route_safety
    steps_by_safety = {base_safety: step}
    clean_streak = 0
    DECAY_AFTER = 8

    def _set_safety(new_safety: int):
        nonlocal sp, step, step_rows, pend_rows, pending, off
        sp = dataclasses.replace(sp, route_safety=new_safety)
        if pending is not None:
            if off > 0:
                flush(pending, off)
            off = 0
            step_rows = recv_rows(sp, n_flat)
            pend_m = max(1, (cfg.exact_capacity // 2)
                         // (step_rows * D * S))
            pend_rows = pend_m * step_rows
            pending = None                  # free before the new buffer
            pending = torch.empty((pend_rows, w), dtype=torch.int32,
                                  device=device)
        if new_safety not in steps_by_safety:
            steps_by_safety[new_safety] = sharded_insert_step(sp, mesh, k)
        step = steps_by_safety[new_safety]

    with m.stage("count", device) as st:
        for rows_np, n_real in _mesh_batches(cfg, paths, mesh):
            bases = torch.from_numpy(rows_np).to(device)
            while True:
                nk, ovf, n_new = step(table, pending, bases, off)
                if ovf == 0:
                    break
                # route overflow: the step was a no-op on every rank —
                # double the per-destination capacity and replay this
                # batch; counts stay exact because nothing was inserted
                LAST_COUNT_RETRIES += 1
                new_safety = sp.route_safety * 2
                if new_safety > 4 * S:
                    raise RuntimeError(
                        f"bucket route overflow persists at route_safety="
                        f"{sp.route_safety} ({ovf} k-mers)")
                log.info("count[mesh]: route overflow (%d k-mers) — "
                         "retrying batch with route_safety=%d", ovf,
                         new_safety)
                _set_safety(new_safety)
                clean_streak = 0
            if pending is not None:
                # the valid rows this batch appended; the next batch may
                # append up to step_rows
                off += n_new
                if off + step_rows > pend_rows:
                    flush(pending, off)
                    off = 0
            n_reads += n_real
            n_kmers += nk
            if sp.route_safety > base_safety:
                clean_streak += 1
                if clean_streak >= DECAY_AFTER:
                    log.info("count[mesh]: %d clean batches — decaying "
                             "route_safety %d -> %d", clean_streak,
                             sp.route_safety, max(base_safety,
                                                  sp.route_safety // 2))
                    _set_safety(max(base_safety, sp.route_safety // 2))
                    clean_streak = 0
        if pending is not None and off > 0:
            flush(pending, off)
        del pending
        LAST_ROUTE_SAFETY = sp.route_safety

        if sp.bloom.width * 4 <= REPLICATE_TABLE_BUDGET:
            merged = merge_and_replicate(table, mesh)   # (width,) replicated
        else:
            # past the replication budget the table stays bucket-sharded
            # only; correction takes the routed-query path
            log.info("count[mesh]: table %d B > replicate budget — keeping "
                     "bucket-sharded only (routed correction)",
                     sp.bloom.width * 4)
            merge_keep_sharded(table, mesh)
            merged = None
        tag = f"count[mesh {D}x{S}]"
        shard = cfg.shard_host_spectrum is not False and mesh.n_hosts > 1
        if cfg.exact_spectrum and shard:
            host, hist, exact_cap, t = _shard_host_spectrum(
                cfg, host_ex, k, mesh, n_reads, n_kmers, tag)
        else:
            if cfg.exact_spectrum:
                host_ex = allgather_spectrum(*host_ex, mesh)
            else:
                host_ex = None
            host, hist, exact_cap, t = _finish_count(
                cfg, host_ex, k, n_reads, n_kmers, tag=tag)
        st.set(reads=n_reads, kmers=n_kmers, threshold=t,
               route_retries=LAST_COUNT_RETRIES,
               route_safety_end=sp.route_safety)
    log.info("count[mesh]: threshold=%d", t)
    return CountState(cfg, merged, hist, t, n_reads, n_kmers, host=host,
                      exact_cap=exact_cap, sharded=sp, sharded_table=table)


def _shard_host_spectrum(cfg, host_ex, k, mesh, n_reads, n_kmers, tag):
    """The end of a multi-host count with the range-sharded spectrum (the
    default, kmerax/pipeline/run.py:546-551): each host's ranks merge their
    spectra onto every local rank (over the local group), the leaders
    range-shard the host spectra over the hosts, and rank 0's global
    histogram reaches every rank over the hosts group. Returns
    _finish_count's (host, hist, exact_cap, threshold): host is this
    leader's ShardedHostSpectrum, None on the other ranks; no padded exact
    form exists."""
    from kmerax_torch.dist.mesh import host_broadcast
    from kmerax_torch.spectrum.host_sharded import shard_spectrum
    from kmerax_torch.spectrum.sharded import allgather_spectrum

    rows, counts = allgather_spectrum(*host_ex, mesh, mesh.local_group)
    host = None
    hist = np.zeros(256, np.int64)
    if mesh.is_leader:
        host = shard_spectrum(rows, counts, k, mesh.host, mesh.n_hosts)
        n_unique = host.n_unique
        hist = host.histogram(255)
        log.info("%s: %d reads, %d k-mers, %d distinct (%d resident on "
                 "host %d)", tag, n_reads, n_kmers, n_unique,
                 host.n_unique_local, mesh.host)
    del rows, counts
    hist = host_broadcast(hist)
    t = solid_threshold(hist, cfg.threshold)
    return host, hist, None, t


def count_state_from_numpy(cfg: KmeraxConfig, table, uniq, counts,
                           threshold: int, device) -> CountState:
    """A CountState from count results held as numpy arrays — the Bloom
    table ((2^log2_width,) int32 counters or half as many p16 words), the
    sorted spectrum's uniq (N, W) uint32 and counts (N,) int64, and the
    threshold — e.g. the JAX package's, so the correct stage can be held
    against it alone."""
    host = HostSpectrum(np.ascontiguousarray(uniq, dtype=np.uint32),
                        np.asarray(counts, dtype=np.int64), cfg.k)
    table = torch.tensor(np.asarray(table, dtype=np.int32), device=device)
    if table.dim() != 1:
        raise ValueError(f"table shape {tuple(table.shape)} is not flat")
    counter = table_counter(cfg, table.shape[0])
    cap = cfg.exact_capacity if host.n_unique < cfg.exact_capacity else None
    return CountState(cfg, table, host.histogram(255), int(threshold), 0, 0,
                      host=host, exact_cap=cap, counter=counter)
