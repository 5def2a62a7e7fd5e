"""Unitig chains and emission, host path (port of kmerax/graph/unitig.py;
DESIGN.md §9).

`chains_from_edges_np` and `emit_unitigs` are numpy copies of the JAX
package's host functions (their module imports JAX). The monolithic device
assembly is not carried over: `assemble_to_fasta` takes the host-resident
partitioned path (graph/partitioned.py), split over the hosts of a
multi-host mesh when the spectrum is replicated, or the distributed
assembly (graph/sharded.py) when it is range-sharded over N > 1 hosts, as
kmerax/graph/unitig.py::assemble_to_fasta dispatches.
"""

from __future__ import annotations

import numpy as np


def chains_from_edges_np(uniq_np: np.ndarray, solid_np: np.ndarray,
                         edges: dict, k: int) -> dict:
    """Host-side (numpy) pointer-doubling chain decomposition of the solid
    dBG: phase A finds succ-cycles and their minimal oriented node, phase B
    cuts each cycle before it and doubles end/distance pointers on the
    acyclic chain forest. Returns flat (2C,) arrays indexed by
    enc = 2*node + orientation, plus the edge dict."""
    C = uniq_np.shape[0]
    enc_self = np.arange(2 * C, dtype=np.int64)

    internal = np.asarray(edges["internal"]).reshape(-1)
    succ_enc = (np.asarray(edges["succ_v"]).astype(np.int64) * 2
                + np.asarray(edges["succ_o"])).reshape(-1)
    nxt = np.where(internal, succ_enc, enc_self)
    terminal = ~internal

    R = max(1, int(2 * C - 1).bit_length())

    m = enc_self.copy()
    e = nxt.copy()
    for _ in range(R):
        m = np.minimum(m, m[e])
        e = e[e]
    on_cycle = ~terminal[e]
    cut = on_cycle & (nxt == m)

    internal2 = internal & ~cut
    nxt2 = np.where(cut, enc_self, nxt)
    d = np.where(internal2, 1, 0).astype(np.int64)
    e = nxt2.copy()
    for _ in range(R):
        d = d + d[e]
        e = e[e]
    end, dist = e, d

    has_pred = np.zeros(2 * C + 1, dtype=bool)
    has_pred[np.where(internal2, nxt2, 2 * C)] = True
    has_pred = has_pred[:2 * C]
    active = np.repeat(np.asarray(solid_np), 2)
    is_start = active & ~has_pred

    top_shift = (2 * k - 2) % 32
    w = uniq_np.shape[1]
    first_base = (uniq_np[:, w - 1] >> top_shift) & 3
    lb0 = uniq_np[:, 0] & 3
    lb1 = 3 - first_base
    last_base = np.stack([lb0, lb1], axis=1).reshape(-1).astype(np.int64)

    return {"end": end, "dist": dist, "is_start": is_start,
            "was_cycle": on_cycle, "active": active,
            "last_base": last_base, **edges}


def emit_unitigs(uniq_np: np.ndarray, arrays: dict, k: int) -> list[str]:
    """Host-side sequence emission + canonicalization (DESIGN.md §9).

    Fully numpy-vectorized: all chain bases land in one flat uint8 code
    buffer via fancy indexing (plus its per-chain-reversed complement for
    canonicalization); per-unitig Python work is O(#unitigs) byte-slice
    operations, never per-base loops — chr21-scale chains stay cheap.
    """
    end = np.asarray(arrays["end"])
    dist = np.asarray(arrays["dist"])
    is_start = np.asarray(arrays["is_start"])
    was_cycle = np.asarray(arrays["was_cycle"])
    active = np.asarray(arrays["active"])
    last_base = np.asarray(arrays["last_base"]).astype(np.uint8)

    idx = np.nonzero(active)[0]
    if len(idx) == 0:
        return []
    # group by chain end; order within chain by descending dist (start first)
    order = np.lexsort((-dist[idx], end[idx]))
    idx = idx[order]
    ends = end[idx]
    first = np.concatenate([[True], ends[1:] != ends[:-1]])
    starts_at = np.nonzero(first)[0]
    bounds = np.append(starts_at, len(idx))
    heads = idx[starts_at]

    keep = is_start[heads] & ~(was_cycle[heads] & ((heads & 1) == 1))
    ci = np.nonzero(keep)[0]
    if len(ci) == 0:
        return []
    lo, hi = bounds[ci], bounds[ci + 1]
    nlens = hi - lo                                  # nodes per kept chain
    seq_lens = (k - 1) + nlens                       # k start + (n-1) body
    S = len(ci)
    offs = np.concatenate([[0], np.cumsum(seq_lens)])
    total = int(offs[-1])
    out = np.empty(total, np.uint8)

    # start k-mer decode, vectorized over chains: base i of the forward
    # k-mer lives at a static (word, shift) per i (core.kmers packing)
    hk = heads[ci]
    u, o = hk >> 1, hk & 1
    words = uniq_np[u].astype(np.uint32)             # (S, W)
    sb = np.empty((S, k), np.uint8)
    for i in range(k):
        wi = 0
        while not (max(k - 16 * (wi + 1), 0) <= i < k - 16 * wi):
            wi += 1
        shift = 2 * ((k - 16 * wi) - 1 - i)
        sb[:, i] = (words[:, wi] >> shift) & 3
    sb = np.where((o == 1)[:, None], 3 - sb[:, ::-1], sb)
    head_pos = offs[:-1, None] + np.arange(k)[None, :]
    out[head_pos.reshape(-1)] = sb.reshape(-1)

    # body bases: element e of idx belongs to chain cid[e] at rank r[e];
    # kept chains map to compact slot c; rank r >= 1 appends one base at
    # offs[c] + k - 1 + r
    cid = np.cumsum(first) - 1                       # per element of idx
    rank = np.arange(len(idx)) - starts_at[cid]
    slot = np.full(len(bounds) - 1, -1, np.int64)
    slot[ci] = np.arange(S)
    sl = slot[cid]
    sel = (sl >= 0) & (rank >= 1)
    pos = offs[sl[sel]] + (k - 1) + rank[sel]
    out[pos] = last_base[idx[sel]]

    # canonicalization: rc buffer = complement of per-chain-reversed codes
    e_pos = np.arange(total)
    seg = np.searchsorted(offs, e_pos, side="right") - 1
    rev_idx = offs[seg] + (offs[seg + 1] - 1) - e_pos
    rc = (3 - out)[rev_idx]

    table = np.frombuffer(b"ACGT", dtype=np.uint8)
    fwd_b = table[out].tobytes()
    rc_b = table[rc].tobytes()
    seqs = set()
    for c in range(S):
        a, b = int(offs[c]), int(offs[c + 1])
        seqs.add(min(fwd_b[a:b], rc_b[a:b]))
    return sorted((s.decode("ascii") for s in seqs),
                  key=lambda s: (-len(s), s))


def assemble_to_fasta(cfg, state, out_fasta: str, device=None) -> int:
    """Assemble stage: the state's exact spectrum -> unitig FASTA (on a
    mesh, written by rank 0). Returns the unitig count, the same on every
    rank. The pipeline assembles the corrected reads: it re-counts them
    (pipeline/run.py) and hands that count's state here.

    On one host of a mesh every rank holds the same global spectrum, so
    rank 0 alone derives the unitigs. Across N > 1 hosts the host leaders
    assemble: a range-sharded spectrum (the default) through
    graph/sharded.py::assemble_sharded, a replicated one through the
    partitioned path with its edge discovery split over the hosts; the
    other local ranks wait for the count.
    """
    import numpy as np

    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.graph.partitioned import assemble_host
    from kmerax_torch.graph.sharded import assemble_sharded
    from kmerax_torch.io.fasta import write_fasta
    from kmerax_torch.spectrum.host_sharded import ShardedHostSpectrum
    from kmerax_torch.utils import tracing

    if device is None:
        device = (state.bloom_table if state.bloom_table is not None
                  else state.sharded_table).device
    mesh = dmesh.current()
    hosts = mesh is not None and mesh.n_hosts > 1
    works = mesh.is_leader if hosts else dmesh.is_writer()
    if works and state.host is None:
        raise ValueError("assembly needs exact_spectrum=True")
    if mesh is not None:
        device = mesh.device
    n = 0
    if works:
        host, t = state.host, state.threshold
        if isinstance(host, ShardedHostSpectrum) and host.n_procs > 1:
            n = assemble_sharded(host, t, cfg.k, out_fasta, device=device)
        else:
            if isinstance(host, ShardedHostSpectrum):
                host = host.local
            seqs = assemble_host(
                host, t, cfg.k, device=device,
                **(dict(n_procs=mesh.n_hosts, pid=mesh.host) if hosts
                   else {}))
            if dmesh.is_writer():
                # the FASTA's seconds join the emit span assemble_host
                # counted
                with tracing.span("assemble.emit", n=0):
                    write_fasta(out_fasta, seqs)
            n = len(seqs)
    if mesh is None:
        return n
    if hosts:
        return int(dmesh.host_broadcast(np.asarray([n], np.int64))[0])
    return mesh.broadcast_int(n)

