"""Partitioned assembly from a host-resident spectrum (port of
kmerax/graph/partitioned.py and graph/build.py::shift_append_base).

Only the SOLID k-mers are materialized for the graph stage, and edge
discovery streams over contiguous partitions of them:

  per partition of solid nodes:
    device: 8 candidate extensions per node (4 bases x 2 orientations),
            canonicalized (`_extensions`, torch), with the rows' H2D and
            the candidates' copy back (span `assemble.extend`)
    host:   membership joins against the packed solid key array
            (np.searchsorted) and the successor select (span
            `assemble.join`; counter `assemble.join_queries`, 8 a node)

Chain pointer-doubling and emission then run on the host (graph/unitig.py).
The numpy parts are copies of the JAX package's, which cannot be imported
without JAX. Unitig sequences equal the JAX package's byte for byte.

Across hosts (a replicated host spectrum at N > 1, `--no-shard-host-
spectrum`) the edge-discovery partitions split round-robin over the host
leaders (partition pi on host pi % N) and the disjoint per-host edge arrays
merge by an element-wise sum over the hosts; every leader then derives the
same chains.
"""

from __future__ import annotations

import numpy as np
import torch

from kmerax_torch.core.codec import M32, canonical_words, num_words, \
    revcomp_words
from kmerax_torch.graph.unitig import chains_from_edges_np, emit_unitigs
from kmerax_torch.spectrum.host import HostSpectrum, pack_rows, \
    searchsorted_packed
from kmerax_torch.utils import tracing
from kmerax_torch.utils.logging import get_logger

log = get_logger("kmerax_torch.graph.partitioned")


def shift_append_base(words: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """suffix_{k-1}(kmer)·4 + b over little-endian words: (x << 2 | b) mod 4^k."""
    w = num_words(k)
    carry = torch.cat(
        [torch.full_like(words[..., :1], b), words[..., :-1] >> 30], dim=-1)
    x = ((words << 2) & M32) | carry
    top_bits = 2 * k - 32 * (w - 1)          # bits used in the top word
    mask = (1 << top_bits) - 1
    return torch.cat([x[..., :-1], x[..., -1:] & mask], dim=-1)


def _extensions(rows: torch.Tensor, k: int):
    """Candidate extensions of (n, W) forward k-mers (int64 words).

    Returns (cand (n, 2, 4, W) canonical words, is_fwd (n, 2, 4)) for
    orientations o in {0=+,1=-} and appended bases b in 0..3.
    """
    rc = revcomp_words(rows, k)
    cands, fwds = [], []
    for f in (rows, rc):
        cb, fb = [], []
        for b in range(4):
            cw, is_fwd = canonical_words(shift_append_base(f, b, k), k)
            cb.append(cw)
            fb.append(is_fwd)
        cands.append(torch.stack(cb, dim=1))
        fwds.append(torch.stack(fb, dim=1))
    return torch.stack(cands, dim=1), torch.stack(fwds, dim=1)


def solid_edges_host(suniq: np.ndarray, k: int, device,
                     partition_rows: int = 1 << 20, n_procs: int = 1,
                     pid: int = 0) -> dict:
    """Edge arrays of the solid dBG, streamed over partitions.

    suniq: (C, W) uint32 SOLID canonical k-mers in global sorted order.
    Returns succ_v/succ_o/outdeg/internal, each (C, 2), with node ids being
    rows of suniq. With `n_procs` > 1, host `pid` handles the partitions
    pi % n_procs == pid (rows of the others stay zero) and returns the
    partial succ_v/succ_o/outdeg; the caller sums them over the hosts and
    finalizes (assemble_host).
    """
    C, W = suniq.shape
    # the keys' packing is join work; the span's entries count partitions
    with tracing.span("assemble.join", n=0):
        skeys = pack_rows(suniq)
    outdeg = np.zeros((C, 2), np.int32)
    succ_v = np.zeros((C, 2), np.int32)
    succ_o = np.zeros((C, 2), np.int32)

    for pi, s in enumerate(range(0, C, partition_rows)):
        if pi % n_procs != pid:
            continue
        e = min(s + partition_rows, C)
        n = e - s
        with tracing.span("assemble.extend"):
            rows = torch.as_tensor(suniq[s:e].astype(np.int64),
                                   device=device)
            cand, is_fwd = _extensions(rows, k)
            cand = cand.cpu().numpy().astype(np.uint32)   # (n, 2, 4, W)
            is_fwd = is_fwd.cpu().numpy()
        tracing.count("assemble.join_queries", 8 * n)
        with tracing.span("assemble.join"):
            q = pack_rows(cand.reshape(-1, W))
            idx = searchsorted_packed(skeys, q)
            idx = np.minimum(idx, max(C - 1, 0))
            if skeys.ndim == 1:
                found = skeys[idx] == q
            else:
                found = np.all(skeys[idx] == q, axis=1)
            found = found.reshape(n, 2, 4)
            idx = idx.reshape(n, 2, 4).astype(np.int32)
            # successor select: iterate b in 0..3, a later hit overwrites
            for o in range(2):
                ex = found[:, o, :]
                outdeg[s:e, o] = ex.sum(axis=1)
                v = np.zeros(n, np.int32)
                osel = np.zeros(n, np.int32)
                for b in range(4):
                    hit = ex[:, b]
                    v = np.where(hit, idx[:, o, b], v)
                    osel = np.where(hit, np.where(is_fwd[:, o, b], 0, 1),
                                    osel)
                succ_v[s:e, o] = v
                succ_o[s:e, o] = osel

    partial = {"succ_v": succ_v, "succ_o": succ_o, "outdeg": outdeg}
    return partial if n_procs > 1 else finalize_edges(partial)


def finalize_edges(partial: dict) -> dict:
    """internal rule over COMPLETE edge arrays: outdeg(u,o)==1 &
    outdeg(v, 1-o')==1 & v!=u (DESIGN.md §9)."""
    succ_v, succ_o, outdeg = (partial["succ_v"], partial["succ_o"],
                              partial["outdeg"])
    C = succ_v.shape[0]
    rows = np.arange(C, dtype=np.int32)
    tgt_back = outdeg[succ_v, 1 - succ_o]
    internal = ((outdeg == 1) & (tgt_back == 1)
                & (succ_v != rows[:, None]))
    return {**partial, "internal": internal}


def assemble_host(host: HostSpectrum, t: int, k: int, device,
                  partition_rows: int = 1 << 20, n_procs: int = 1,
                  pid: int = 0) -> list[str]:
    """Unitig sequences from a host-resident spectrum. Device memory is
    bounded by one edge-discovery partition; the solid set, the edge tables
    and the chains stay on the host. With `n_procs` > 1 every host leader
    holds the same replicated spectrum and calls this: each discovers the
    edges of its partitions, and an element-wise sum over the hosts
    (unowned partitions contributed zeros) completes the tables."""
    with tracing.span("assemble.edges"):
        sidx = host.solid_indices(t)
        suniq = np.ascontiguousarray(host.uniq[sidx])
        C = len(suniq)
        tracing.count("assemble.solid_nodes", C)
        log.info("assemble[host]: %d solid k-mers", C)
        if C == 0:
            return []
        edges = solid_edges_host(suniq, k, device, partition_rows, n_procs,
                                 pid)
        if n_procs > 1:
            from kmerax_torch.dist.mesh import host_allgather

            edges = finalize_edges({
                key: host_allgather(edges[key], leaders=True).sum(axis=0)
                .astype(edges[key].dtype)
                for key in ("succ_v", "succ_o", "outdeg")})
    with tracing.span("assemble.chains"):
        arrays = chains_from_edges_np(suniq, np.ones(C, dtype=bool), edges,
                                      k)
    with tracing.span("assemble.emit"):
        return emit_unitigs(suniq, arrays, k)
