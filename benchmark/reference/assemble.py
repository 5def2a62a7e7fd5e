"""Unitigs of the solid de Bruijn graph, worked out again (DESIGN.md §9,
as oracle/assemble.py defines them).

Nodes are the solid canonical k-mers in ascending order; oriented node
e = 2u + o reads node u forward (o = 0) or reverse-complemented (o = 1).
Its out-edges append a base b = 0..3 to its last k - 1 bases and keep the
extensions whose canonical form is a node. (u, o) has an internal
successor (v, o') when it has exactly one out-edge, v != u, and (v, 1 - o')
has exactly one out-edge too. Chains start at oriented nodes with no
internal predecessor and follow successors; what is left lies on cycles,
each emitted from its least oriented node when that reads forward.
A chain's sequence is its first k-mer and the last base of every later
one; a unitig is the lesser of a sequence and its reverse complement; the
set is sorted by decreasing length, then by sequence. The edge tables are
whole-array torch; the walks follow the oracle step by step. A k-mer is one
int64 at k <= 31 and a row of W words above (words.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import words
from .kmers import check_k, revcomp

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _succ(nodes: torch.Tensor, k: int) -> np.ndarray:
    """(2C,) int64: the internal successor of each oriented node, or -1."""
    C = nodes.numel()
    dev = nodes.device
    suf = (1 << (2 * (k - 1))) - 1
    oriented = torch.stack([nodes, revcomp(nodes, k)], 1)      # (C, 2)
    w = ((oriented & suf) << 2)[:, :, None] | torch.arange(4, device=dev)
    rw = revcomp(w, k)
    canon = torch.minimum(w, rw)
    at = torch.searchsorted(nodes, canon).clamp(max=max(C - 1, 0))
    found = nodes[at] == canon                                 # (C, 2, 4)
    outdeg = found.sum(2)                                      # (C, 2)
    b = torch.argmax(found.to(torch.int8), 2)                  # the one edge
    v = at.gather(2, b[..., None])[..., 0]
    o2 = (w.gather(2, b[..., None])[..., 0] != canon.gather(
        2, b[..., None])[..., 0]).to(torch.int64)
    back = outdeg[v, 1 - o2]
    u = torch.arange(C, device=dev)[:, None]
    internal = (outdeg == 1) & (v != u) & (back == 1)
    return torch.where(internal, 2 * v + o2, -1).reshape(-1).cpu().numpy()


def _succ_words(nodes: torch.Tensor, k: int) -> np.ndarray:
    """`_succ` over (C, W) word rows."""
    C, W = nodes.shape
    dev = nodes.device
    oriented = torch.stack([nodes, words.revcomp(nodes, k)], 1)  # (C, 2, W)
    w = words.extend(oriented[:, :, None, :].expand(C, 2, 4, W),
                     torch.arange(4, device=dev), k)            # (C, 2, 4, W)
    rw = words.revcomp(w, k)
    fwd = words.less_equal(w, rw)
    canon = torch.where(fwd[..., None], w, rw)
    at, found = words.lookup(nodes, canon)                      # (C, 2, 4)
    outdeg = found.sum(2)
    b = torch.argmax(found.to(torch.int8), 2)
    v = at.gather(2, b[..., None])[..., 0]
    o2 = (~fwd).gather(2, b[..., None])[..., 0].to(torch.int64)
    back = outdeg[v, 1 - o2]
    u = torch.arange(C, device=dev)[:, None]
    internal = (outdeg == 1) & (v != u) & (back == 1)
    return torch.where(internal, 2 * v + o2, -1).reshape(-1).cpu().numpy()


def unitigs(uniq: torch.Tensor, counts: torch.Tensor, t: int,
            k: int) -> list[bytes]:
    """Unitig sequences (ASCII) of the k-mers with count >= t."""
    if k > 31:
        words.check_k(k)
    else:
        check_k(k)
    nodes = uniq[counts >= t]
    C = nodes.shape[0]
    if C == 0:
        return []
    if k > 31:
        succ = _succ_words(nodes, k)
        oriented = torch.stack([nodes, words.revcomp(nodes, k)], 1)
        oriented = oriented.reshape(-1, nodes.shape[1]).cpu().numpy()
        last = (oriented[:, 0] & 3).astype(np.uint8)
        p = np.arange(k - 1, -1, -1)
        return _walk(succ, lambda e: ((oriented[e][p // 16] >> (
            2 * (p % 16))) & 3).astype(np.uint8), last)
    succ = _succ(nodes, k)
    oriented = torch.stack([nodes, revcomp(nodes, k)], 1).reshape(-1)
    oriented = oriented.cpu().numpy()
    last = (oriented & 3).astype(np.uint8)
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
    return _walk(succ, lambda e: ((oriented[e] >> shifts) & 3).astype(
        np.uint8), last)


def _walk(succ: np.ndarray, first, last: np.ndarray) -> list[bytes]:
    """The unitigs of the oriented nodes' internal successors `succ`:
    `first(e)` gives oriented node e's bases, `last[e]` its last base."""
    n = len(succ)
    has_pred = np.zeros(n, bool)
    has_pred[succ[succ >= 0]] = True
    succ_l = succ.tolist()
    visited = bytearray(n)
    seqs = set()

    def emit(chain):
        s = _ACGT[np.concatenate([first(chain[0]),
                                  last[np.asarray(chain[1:], np.int64)]])]
        s = s.tobytes()
        seqs.add(min(s, s.translate(_COMP)[::-1]))

    for e in np.nonzero(~has_pred)[0].tolist():
        chain = [e]
        visited[e] = 1
        cur = e
        while succ_l[cur] >= 0:
            cur = succ_l[cur]
            if visited[cur]:
                break
            chain.append(cur)
            visited[cur] = 1
        emit(chain)
    for e in range(n):
        if visited[e]:
            continue
        cyc = []
        cur = e
        while not visited[cur]:
            visited[cur] = 1
            cyc.append(cur)
            cur = succ_l[cur]
        start = min(range(len(cyc)), key=cyc.__getitem__)
        if cyc[start] & 1:
            continue
        emit(cyc[start:] + cyc[:start])
    return sorted(seqs, key=lambda s: (-len(s), s))


def fasta_text(seqs: list[bytes]) -> bytes:
    """`>unitig_{i} len={L}` records, one sequence line each (DESIGN.md
    §11)."""
    return b"".join(b">unitig_%d len=%d\n%s\n" % (i, len(s), s)
                    for i, s in enumerate(seqs))
