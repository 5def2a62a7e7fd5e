"""Partitioned assembly from a host-resident spectrum (port of
kmerax/graph/partitioned.py and graph/build.py::shift_append_base).

Only the SOLID k-mers are materialized for the graph stage, and edge
discovery streams over contiguous partitions of them:

  once:  the solid keys to the device as their 32-bit words, and three
         (C, 2) int32 edge arrays there (span `assemble.join`, no entry)
  per partition of solid nodes, on the device:
    8 candidate extensions per node (4 bases x 2 orientations),
    canonicalized (`_extensions`, torch) from the partition's slice of the
    keys, and on a card their sync (span `assemble.extend`); then the
    membership join and the successor select (graph/join_kernels.py:
    kernel K5 on a card, its plain version on the CPU) into the edge
    arrays, and on a card its sync (span `assemble.join`; counter
    `assemble.join_queries`, 8 a node)
  once:  the edge arrays' copy back (span `assemble.join`, no entry)

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
from kmerax_torch.graph.join_kernels import solid_join
from kmerax_torch.graph.unitig import chains_from_edges_np, emit_unitigs
from kmerax_torch.spectrum.host import HostSpectrum
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
    C = len(suniq)
    dev = torch.device(device)
    # the keys' upload is join work; the span's entries count partitions
    with tracing.span("assemble.join", n=0):
        keys = torch.from_numpy(
            np.ascontiguousarray(suniq, np.uint32).view(np.int32)).to(dev)
        edges = {name: torch.zeros((C, 2), dtype=torch.int32, device=dev)
                 for name in ("outdeg", "succ_v", "succ_o")}

    for pi, s in enumerate(range(0, C, partition_rows)):
        if pi % n_procs != pid:
            continue
        e = min(s + partition_rows, C)
        with tracing.span("assemble.extend"):
            cand, is_fwd = _extensions(keys[s:e].to(torch.int64) & M32, k)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        tracing.count("assemble.join_queries", 8 * (e - s))
        with tracing.span("assemble.join"):
            solid_join(keys, cand, is_fwd, edges["outdeg"], edges["succ_v"],
                       edges["succ_o"], s)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        del cand, is_fwd

    with tracing.span("assemble.join", n=0):
        partial = {name: t.cpu().numpy() for name, t in edges.items()}
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
    """Unitig sequences from a host-resident spectrum. Device memory holds
    the solid keys (4 W bytes a node), the edge tables (24 bytes a node)
    and one edge-discovery partition's candidates; the chains run on the
    host over the tables' copy. With `n_procs` > 1 every host leader
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
