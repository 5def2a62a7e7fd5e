"""Host-resident exact spectrum sharded by key range across hosts (port of
kmerax/spectrum/host_sharded.py).

Each host (its leader rank) keeps only the rows of one contiguous range of
the global sort order (quantile-balanced boundaries, so each range holds
~1/N of the rows); the union of the ranges in host order is the global
sorted spectrum. Global quantities derive by sums over the hosts:

  * histogram / threshold: the sum of per-range histograms (disjoint rows);
  * n_unique: the sum of per-range counts;
  * the assembly runs against the range shards (graph/sharded.py).

`shard_spectrum` sends each row to its range owner with one all-to-all a
chunk (dist/mesh.py::host_exchange), where the reference all-gathers every
chunk to every host and filters it: a host receives only the rows it owns,
at most N x chunk a step, and the full spectrum never materializes on any
host. Every function here runs on the host leaders only (their gloo
leaders group).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kmerax_torch.dist.mesh import host_allgather, host_exchange
from kmerax_torch.spectrum.exact import np_merge_counted
from kmerax_torch.spectrum.host import HostSpectrum, pack_rows
from kmerax_torch.utils.logging import get_logger

log = get_logger("kmerax_torch.spectrum.host_sharded")

EXCHANGE_CHUNK = 1 << 20          # rows a host sends per exchange step
_SAMPLE = 1 << 12                 # per-host boundary sample size

# observability of the last shard_spectrum on this host: the rows it
# received over all steps, the most in one step, the steps, the chunk, and
# the received rows it does not own (0)
LAST_EXCHANGE: dict = {}


def _keys_ge(keys: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """keys >= bound for pack_rows key forms: (N,) uint64 scalar-bound, or
    (N, 2) [hi, lo] with a (2,) bound (128-bit compare, k=63)."""
    if keys.ndim == 1:
        return keys >= bound
    return (keys[:, 0] > bound[0]) | \
        ((keys[:, 0] == bound[0]) & (keys[:, 1] >= bound[1]))


def _local_sample(keys: np.ndarray):
    """(count, padded sample): every stride-th packed key of this host, up
    to _SAMPLE, padded with all-ones keys to the gathered shape."""
    two = keys.ndim == 2
    stride = max(1, len(keys) // _SAMPLE)
    sample = keys[::stride][:_SAMPLE]
    pad = np.full((_SAMPLE, 2) if two else (_SAMPLE,),
                  np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    pad[:len(sample)] = sample
    return len(sample), pad


def _pick_boundaries(counts, samples: np.ndarray, n_procs: int,
                     two: bool) -> np.ndarray:
    """The quantile split keys of the gathered samples (samples[p] holds
    counts[p] real keys): owner p holds [b_{p-1}, b_p). A pure function
    of the gathered sample, so every host derives the same bounds.
    Returns (P-1,) or (P-1, 2) uint64."""
    merged = np.concatenate([samples[p, :int(counts[p])]
                             for p in range(len(counts))])
    if len(merged) == 0:
        return np.zeros((n_procs - 1, 2) if two else (n_procs - 1,),
                        np.uint64)
    if two:
        merged = merged[np.lexsort((merged[:, 1], merged[:, 0]))]
    else:
        merged = np.sort(merged)
    qs = [merged[min(len(merged) - 1, (len(merged) * p) // n_procs)]
          for p in range(1, n_procs)]
    return np.asarray(qs, np.uint64)


def _range_boundaries(keys: np.ndarray, n_procs: int) -> np.ndarray:
    """Deterministic quantile boundaries over every host's packed keys
    (pack_rows form), from a per-host sample gathered over the leaders."""
    n, samp = _local_sample(keys)
    counts = host_allgather(np.asarray([n], np.int64), leaders=True)[:, 0]
    allsamp = host_allgather(samp, leaders=True)
    return _pick_boundaries(counts, allsamp, n_procs, keys.ndim == 2)


def owner_of(keys: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """The range owner of each packed key: the number of split keys at or
    below it (owner p holds [b_{p-1}, b_p), the last host everything from
    b_{P-2} up)."""
    own = np.zeros(len(keys), np.int64)
    for b in bounds:
        own += _keys_ge(keys, b)
    return own


@dataclass
class ShardedHostSpectrum:
    """This host's key-range shard of the global exact spectrum."""

    local: HostSpectrum            # rows in [bounds[pid-1], bounds[pid])
    k: int
    n_procs: int
    pid: int
    bounds: np.ndarray             # (P-1,) or (P-1, 2) uint64 split keys

    @property
    def n_unique_local(self) -> int:
        return self.local.n_unique

    @property
    def n_unique(self) -> int:
        """GLOBAL distinct count (summed over ranges; leaders only)."""
        return int(host_allgather(np.asarray([self.local.n_unique],
                                             np.int64), leaders=True).sum())

    def histogram(self, max_count: int = 1024) -> np.ndarray:
        """GLOBAL histogram: ranges are disjoint, so per-range histograms
        sum exactly (leaders only)."""
        h = self.local.histogram(max_count)
        return host_allgather(h, leaders=True).sum(axis=0)


def shard_spectrum(rows: np.ndarray, counts: np.ndarray, k: int, pid: int,
                   n_procs: int,
                   chunk: int | None = None) -> ShardedHostSpectrum:
    """Exchange the hosts' locally merged spectra into key-range shards
    (leaders only).

    rows (N_p, W) uint32 sorted + counts (N_p,) int64 on host `pid` of
    `n_procs` (the same k-mer may sit on several hosts with partial counts),
    so each row goes to its range owner, which merges by summation; every
    k-mer ends on exactly one host with its exact global count. Each step
    sends at most `chunk` (default EXCHANGE_CHUNK) rows a host, in one
    all-to-all.
    """
    chunk = chunk or EXCHANGE_CHUNK
    w = rows.shape[1]
    assert w <= 4, "range sharding packs keys to <= two uint64 (k <= 63)"
    two = w > 2
    LAST_EXCHANGE.clear()
    if n_procs == 1:
        return ShardedHostSpectrum(HostSpectrum(rows, counts, k), k, 1, 0,
                                   np.zeros((0, 2) if two else 0,
                                            np.uint64))
    keys = pack_rows(rows) if len(rows) \
        else np.zeros((0, 2) if two else (0,), np.uint64)
    bounds = _range_boundaries(keys, n_procs)
    # rows are sorted, so each chunk's owners are ascending runs
    n_steps = int(host_allgather(np.asarray([-(-len(rows) // chunk)],
                                            np.int64), leaders=True).max())
    acc_r = [np.zeros((0, w), np.uint32)]
    acc_c = [np.zeros(0, np.int64)]
    got = most = foreign = 0
    for i in range(n_steps):
        s, e = min(i * chunk, len(rows)), min((i + 1) * chunk, len(rows))
        own = owner_of(keys[s:e], bounds)
        block = np.concatenate([rows[s:e].astype(np.int64),
                                counts[s:e, None]], axis=1)
        cuts = np.searchsorted(own, np.arange(1, n_procs))
        recv = np.concatenate(host_exchange(np.split(block, cuts)))
        acc_r.append(recv[:, :w].astype(np.uint32))
        acc_c.append(recv[:, w])
        if len(recv):
            foreign += int((owner_of(pack_rows(acc_r[-1]), bounds)
                            != pid).sum())
        got += len(recv)
        most = max(most, len(recv))
    uniq, cnts = np_merge_counted(np.concatenate(acc_r, axis=0),
                                  np.concatenate(acc_c))
    LAST_EXCHANGE.update(received_rows=got, max_step_rows=most,
                         steps=n_steps, chunk=chunk, foreign_rows=foreign)
    local = HostSpectrum(uniq, cnts, k)
    log.info("host-spectrum shard %d/%d: %d rows resident (received %d in "
             "%d steps)", pid, n_procs, local.n_unique, got, n_steps)
    return ShardedHostSpectrum(local, k, n_procs, pid, bounds)
