"""Range-sharded distributed assembly (port of kmerax/graph/sharded.py;
DESIGN.md §9): no O(global) state or work on any host.

  * each host (its leader rank) keeps only its key range's solid rows (the
    ranges of spectrum/host_sharded.py::ShardedHostSpectrum: their
    concatenation in host order is the global sorted solid array, so a
    global node id is a local row + a gathered row offset);
  * every cross-range access — the 8-way extension membership join, the
    successor-degree lookup of the unitig-internal rule, each pointer-
    doubling hop, the has-pred scatter and the emission records — is a
    chunked exchange in which each query or record goes by all-to-all to
    the host that owns it (dist/mesh.py::host_exchange), and answers come
    back the same way. The reference broadcasts every chunk to every host
    instead; here a host receives only what it owns, at most P x chunk a
    step (counted in LAST_STATS);
  * pointer doubling runs on the distributed halves in O(log 2C) rounds,
    each one (value, successor) exchange;
  * chains are emitted by the owner of their END node; each host sorts
    its chains by (-len, seq) and drops duplicates into a part file, and
    rank 0 streams a k-way merge of the sorted parts into the FASTA,
    dropping duplicates as it goes, so no host holds the whole output.

The FASTA is byte-identical to graph/unitig.py::emit_unitigs (the
one-process truth): same internal rule, same cycle cut, same head/keep
rule, same canonicalization and ordering. Every function runs on the host
leaders only (their gloo leaders group); the edge extensions run on the
leader's device.
"""

from __future__ import annotations

import heapq
import os

import numpy as np
import torch

from kmerax_torch.dist.mesh import host_allgather, host_barrier, \
    host_exchange
from kmerax_torch.graph.partitioned import _extensions
from kmerax_torch.io.fasta import _open_w
from kmerax_torch.spectrum.host import pack_rows, searchsorted_packed
from kmerax_torch.spectrum.host_sharded import owner_of
from kmerax_torch.utils.logging import get_logger

log = get_logger("kmerax_torch.graph.sharded")

EXCHANGE_CHUNK = 1 << 18        # queries a host sends per exchange step
EXCHANGE_BUDGET = 256 << 20     # bytes allowed for one step's transient
                                # (P, chunk, V) answers on a host

# observability of the last assemble_sharded on this host: resident solid
# and edge rows, the global solid count, the emission records it owns, and
# its exchanges: the steps, the rows received over all steps and in the
# largest step, the largest step's bound P x chunk, and the rows it
# received that it does not own (0)
LAST_STATS: dict = {}


def _eff_chunk(chunk: int, n_out: int, P: int) -> int:
    """Clamp the per-step chunk so one step's (P, chunk, n_out) int64
    answers stay within EXCHANGE_BUDGET. Deterministic in (P, n_out), so
    every host derives the same collective schedule."""
    cap = max(1 << 10, EXCHANGE_BUDGET // max(1, P * n_out * 8))
    return min(chunk, cap)


def _n_steps(n: int, chunk: int) -> int:
    """The world's step count: every host walks the largest host's."""
    return int(host_allgather(np.asarray([-(-n // chunk)], np.int64),
                              leaders=True).max())


def _send(rows: np.ndarray, owner: np.ndarray, P: int, chunk: int,
          me: int, owner_fn):
    """One exchange step: rows (n, V) int64 go to their owners. Returns
    (the order that sorted them by owner, the blocks received, in host
    order). Counts the step in LAST_STATS."""
    order = np.argsort(owner, kind="stable")
    cuts = np.searchsorted(owner[order], np.arange(1, P))
    recv = host_exchange(np.split(rows[order], cuts))
    n = sum(len(r) for r in recv)
    LAST_STATS["exchange_steps"] += 1
    LAST_STATS["exchange_rows"] += n
    if n > LAST_STATS["exchange_max_step_rows"]:
        LAST_STATS["exchange_max_step_rows"] = n
        LAST_STATS["exchange_max_step_bound"] = P * chunk
    LAST_STATS["exchange_foreign_rows"] += sum(
        int((owner_fn(r) != me).sum()) for r in recv)
    return order, recv


def _exchange_serve(queries: np.ndarray, owner_fn, serve, n_out: int,
                    P: int, me: int,
                    chunk: int = EXCHANGE_CHUNK) -> np.ndarray:
    """Answer int64 id `queries` (n,) from their range owners.

    owner_fn(ids) -> the owning host of each id; serve(ids (m,)) ->
    (m, n_out) int64 for ids THIS host owns (an empty range serves zeros).
    Each step sends every query to its owner and the answers back, one
    all-to-all each. Returns (n, n_out) int64."""
    chunk = _eff_chunk(chunk, n_out, P)
    n = len(queries)
    out = np.zeros((n, n_out), np.int64)
    for i in range(_n_steps(n, chunk)):
        s, e = min(i * chunk, n), min((i + 1) * chunk, n)
        q = queries[s:e]
        order, recv = _send(q[:, None], owner_fn(q), P, chunk, me,
                            lambda r: owner_fn(r[:, 0]))
        back = host_exchange([serve(r[:, 0]).reshape(-1, n_out)
                              for r in recv])
        out[s + order] = np.concatenate(back, axis=0)
    return out


def _exchange_member(cand: np.ndarray, skeys, row_lo: int, key_owner,
                     P: int, me: int, chunk: int = EXCHANGE_CHUNK):
    """Distributed membership join: (n, W) uint32 candidate k-mers ->
    (found (n,), global solid row id (n,) int64). Each candidate goes to
    the host whose key range could hold it (`key_owner` of its packed
    key), which searches its own sorted solid keys."""
    n = len(cand)
    nloc = skeys.shape[0]
    qk = pack_rows(cand) if n else skeys[:0]
    chunk = _eff_chunk(chunk, 2, P)
    found = np.zeros(n, bool)
    gid = np.zeros(n, np.int64)
    for i in range(_n_steps(n, chunk)):
        s, e = min(i * chunk, n), min((i + 1) * chunk, n)
        rows = cand[s:e].astype(np.int64)
        order, recv = _send(rows, key_owner(qk[s:e]), P, chunk, me,
                            lambda r: key_owner(pack_rows(
                                r.astype(np.uint32))) if len(r)
                            else np.zeros(0, np.int64))
        answers = []
        for r in recv:
            ans = np.zeros((len(r), 2), np.int64)
            if nloc and len(r):
                k = pack_rows(r.astype(np.uint32))
                idx = np.minimum(searchsorted_packed(skeys, k), nloc - 1)
                hit = skeys[idx] == k if skeys.ndim == 1 \
                    else np.all(skeys[idx] == k, axis=1)
                ans[:, 0] = hit
                ans[:, 1] = np.where(hit, idx + row_lo, 0)
            answers.append(ans)
        got = np.concatenate(host_exchange(answers), axis=0)
        found[s + order] = got[:, 0] > 0
        gid[s + order] = got[:, 1]
    return found, gid


def _exchange_mark(targets: np.ndarray, flag: np.ndarray, enc_lo: int,
                   owner_fn, P: int, me: int,
                   chunk: int = EXCHANGE_CHUNK) -> None:
    """Distributed scatter: set flag[t - enc_lo] = True for every host's
    `targets` (int64 enc ids), each sent to the host that owns it."""
    n = len(targets)
    for i in range(_n_steps(n, chunk)):
        s, e = min(i * chunk, n), min((i + 1) * chunk, n)
        t = targets[s:e]
        _, recv = _send(t[:, None], owner_fn(t), P, chunk, me,
                        lambda r: owner_fn(r[:, 0]))
        for r in recv:
            flag[r[:, 0] - enc_lo] = True


def _route_records(rows: np.ndarray, key_col: int, owner_fn, P: int,
                   me: int, chunk: int = EXCHANGE_CHUNK) -> np.ndarray:
    """Send each (n, V) int64 record to the owner of its key column;
    returns the records this host received."""
    n, v = rows.shape
    kept = [np.zeros((0, v), np.int64)]
    for i in range(_n_steps(n, chunk)):
        s, e = min(i * chunk, n), min((i + 1) * chunk, n)
        blk = rows[s:e]
        _, recv = _send(blk, owner_fn(blk[:, key_col]), P, chunk, me,
                        lambda r: owner_fn(r[:, key_col]))
        kept.extend(recv)
    return np.concatenate(kept, axis=0)


def _solid_edges_local(suniq: np.ndarray, skeys, row_lo: int, k: int,
                       partition_rows: int, key_owner, P: int, me: int,
                       device):
    """Edges of THIS range's solid rows, successors as GLOBAL ids, via the
    distributed membership join. Returns succ_v/succ_o/outdeg (C_p, 2)."""
    C, W = suniq.shape
    outdeg = np.zeros((C, 2), np.int32)
    succ_v = np.zeros((C, 2), np.int64)
    succ_o = np.zeros((C, 2), np.int32)
    # every host walks the same number of partitions (the exchanges must
    # line up): the largest host's count rules
    nparts = int(host_allgather(np.asarray(
        [max(1, -(-C // partition_rows))], np.int64), leaders=True).max())
    for pi in range(nparts):
        s = pi * partition_rows
        e = min(s + partition_rows, C)
        if s >= C:
            cand = np.zeros((0, 2, 4, W), np.uint32)
            is_fwd = np.zeros((0, 2, 4), bool)
            n = 0
        else:
            rows = torch.as_tensor(suniq[s:e].astype(np.int64),
                                   device=device)
            cand_d, fwd_d = _extensions(rows, k)
            cand = cand_d.cpu().numpy().astype(np.uint32)
            is_fwd = fwd_d.cpu().numpy()
            n = e - s
        found, gid = _exchange_member(cand.reshape(-1, W), skeys, row_lo,
                                      key_owner, P, me)
        found = found.reshape(n, 2, 4)
        gid = gid.reshape(n, 2, 4)
        for o in range(2):
            ex = found[:, o, :]
            outdeg[s:e, o] = ex.sum(axis=1)
            v = np.zeros(n, np.int64)
            osel = np.zeros(n, np.int32)
            for b in range(4):      # a later existing base overwrites
                hit = ex[:, b]
                v = np.where(hit, gid[:, o, b], v)
                osel = np.where(hit,
                                np.where(is_fwd[:, o, b], 0, 1), osel)
            succ_v[s:e, o] = v
            succ_o[s:e, o] = osel
    return {"succ_v": succ_v, "succ_o": succ_o, "outdeg": outdeg}


def _key_owner_fn(skeys, C_p: int, two: bool):
    """owner(packed keys) for the membership join: the last host with solid
    rows whose first key is <= the key (hosts' ranges are disjoint and in
    host order); a key below every first key goes to the first such host,
    which answers not-found."""
    first = np.zeros((1, 2) if two else (1,), np.uint64)
    if C_p:
        first[0] = skeys[0]
    has = host_allgather(np.asarray([C_p > 0], np.int64), leaders=True)[:, 0]
    firsts = host_allgather(first, leaders=True)[:, 0]
    live = np.nonzero(has)[0]
    bounds = firsts[live][1:]

    def owner(keys):
        return live[owner_of(keys, bounds)]

    return owner


def assemble_sharded(shost, t: int, k: int, out_fasta: str, *, device,
                     partition_rows: int = 1 << 20,
                     chunk: int = EXCHANGE_CHUNK) -> int:
    """Unitigs from a range-sharded host spectrum, fully distributed (host
    leaders only).

    Each host emits ONLY the chains whose end node its range owns, and
    rank 0 streams the hosts' sorted parts into the FASTA (`_merge_parts`).
    Per-host resident state stays O(C/P + P x chunk) throughout. Returns
    the unitig count (identical on every leader).
    """
    pid, P = shost.pid, shost.n_procs
    sidx = shost.local.solid_indices(t)
    suniq = np.ascontiguousarray(shost.local.uniq[sidx])
    C_p, W = suniq.shape
    counts = host_allgather(np.asarray([C_p], np.int64), leaders=True)[:, 0]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    row_lo = int(offsets[pid])
    C = int(offsets[-1])
    log.info("assemble[sharded]: %d/%d solid k-mers resident (range %d/%d)",
             C_p, C, pid, P)
    LAST_STATS.clear()
    LAST_STATS.update(peak_solid_rows=C_p, peak_edge_rows=C_p,
                      global_solid=C, emission_rows=0, exchange_steps=0,
                      exchange_rows=0, exchange_max_step_rows=0,
                      exchange_max_step_bound=0, exchange_foreign_rows=0)
    if C == 0:
        return _merge_parts([], out_fasta, pid, P)
    two = W > 2
    skeys = pack_rows(suniq) if C_p else \
        np.zeros((0, 2) if two else 0, np.uint64)

    def gid_owner(ids):
        return np.searchsorted(offsets[1:], ids, side="right")

    def enc_owner(enc):
        return gid_owner(enc // 2)

    # ---- edges for my rows (distributed membership join)
    edges = _solid_edges_local(suniq, skeys, row_lo, k, partition_rows,
                               _key_owner_fn(skeys, C_p, two), P, pid,
                               device)
    succ_v, succ_o, outdeg = (edges["succ_v"], edges["succ_o"],
                              edges["outdeg"])

    # ---- internal rule: outdeg(u,o)==1 & outdeg(v,1-o')==1 & v!=u, with
    # the target degree fetched from the successor's owner
    def serve_outdeg(ids):
        if C_p == 0:                   # empty range: nothing to serve
            return np.zeros((len(ids), 2), np.int64)
        ok = (ids >= row_lo) & (ids < row_lo + C_p)
        loc = np.where(ok, ids - row_lo, 0).astype(np.int64)
        vals = outdeg[loc].astype(np.int64)        # (m, 2)
        vals[~ok] = 0
        return vals

    tgt_deg = _exchange_serve(succ_v.reshape(-1), gid_owner, serve_outdeg,
                              2, P, pid, chunk)    # (2C_p, 2)
    tgt_back = tgt_deg[np.arange(2 * C_p),
                       (1 - succ_o.reshape(-1))].reshape(C_p, 2)
    rows_g = row_lo + np.arange(C_p, dtype=np.int64)
    internal = ((outdeg == 1) & (tgt_back == 1)
                & (succ_v != rows_g[:, None]))

    # ---- distributed pointer doubling over enc = 2*gid + o
    enc_lo = 2 * row_lo
    enc_self = enc_lo + np.arange(2 * C_p, dtype=np.int64)
    internal_f = internal.reshape(-1)
    succ_enc = (succ_v * 2 + succ_o).reshape(-1)
    nxt = np.where(internal_f, succ_enc, enc_self)
    terminal = ~internal_f

    R = max(1, int(2 * C - 1).bit_length())

    def serve_local(cols):
        """serve(enc ids) -> the columns `cols` of this range's elements."""
        def serve(ids):
            if C_p == 0:
                return np.zeros((len(ids), len(cols)), np.int64)
            ok = (ids >= enc_lo) & (ids < enc_lo + 2 * C_p)
            loc = np.where(ok, ids - enc_lo, 0).astype(np.int64)
            out = np.stack([c[loc].astype(np.int64) for c in cols], axis=1)
            out[~ok] = 0
            return out
        return serve

    def hop(vals: np.ndarray, e: np.ndarray):
        """One doubling round: fetch (vals[e], ecur[e]) from e's owners."""
        got = _exchange_serve(e, enc_owner, serve_local([vals, ecur]), 2,
                              P, pid, chunk)
        return got[:, 0], got[:, 1]

    # phase A: cycle detection + per-cycle min
    m = enc_self.copy()
    ecur = nxt.copy()
    for _ in range(R):
        m_at_e, e_at_e = hop(m, ecur)
        m = np.minimum(m, m_at_e)
        ecur = e_at_e

    on_cycle = _exchange_serve(ecur, enc_owner, serve_local([terminal]), 1,
                               P, pid, chunk)[:, 0] == 0
    cut = on_cycle & (nxt == m)

    # phase B: acyclic end/dist doubling
    internal2 = internal_f & ~cut
    nxt2 = np.where(cut, enc_self, nxt)
    d = np.where(internal2, 1, 0).astype(np.int64)
    ecur = nxt2.copy()
    for _ in range(R):
        d_at_e, e_at_e = hop(d, ecur)
        d = d + d_at_e
        ecur = e_at_e
    end, dist = ecur, d

    has_pred = np.zeros(2 * C_p, bool)
    _exchange_mark(nxt2[internal2], has_pred, enc_lo, enc_owner, P, pid,
                   chunk)
    is_start = ~has_pred

    # ---- last_base per element (graph/unitig.py::chains_from_edges_np)
    top_shift = (2 * k - 2) % 32
    first_base = (suniq[:, W - 1] >> np.uint32(top_shift)) & 3
    lb0 = suniq[:, 0] & 3
    lb1 = 3 - first_base
    last_base = np.stack([lb0, lb1], axis=1).reshape(-1).astype(np.uint8)

    # ---- route emission records to the owner of each element's END node:
    # [end, dist, last_base, flags(is_start | was_cycle << 1 | orient << 2)];
    # the head k-mer words ride only on is_start records
    flags = (is_start.astype(np.int64)
             | (on_cycle.astype(np.int64) << 1)
             | ((enc_self & 1) << 2))
    rec = np.stack([end, dist, last_base.astype(np.int64), flags], axis=1)
    my_rec = _route_records(rec, 0, enc_owner, P, pid, chunk)
    sidx_h = np.nonzero(is_start)[0]
    head_rows = np.concatenate(
        [end[sidx_h][:, None],                       # route key
         enc_self[sidx_h][:, None],
         suniq[sidx_h // 2].astype(np.int64)], axis=1)
    my_heads = _route_records(head_rows, 0, enc_owner, P, pid, chunk)
    LAST_STATS["emission_rows"] = int(len(my_rec))

    # ---- local emission per end-group (emit_unitigs semantics)
    seqs = _emit_groups(my_rec, my_heads, k, W)
    return _merge_parts(seqs, out_fasta, pid, P)


def _emit_groups(my_rec: np.ndarray, my_heads: np.ndarray, k: int,
                 W: int) -> list[bytes]:
    """Emit this owner's chains, vectorized over chains (the emit_unitigs
    flat-buffer scheme, with in-chain rank = dist_head - dist).

    my_rec rows: [end, dist, last_base, flags(is_start|was_cycle<<1|
    orient<<2)]; my_heads rows: [end, enc, words...].
    """
    if len(my_rec) == 0:
        return []
    end_r = my_rec[:, 0]
    dist_r = my_rec[:, 1]
    lb_r = my_rec[:, 2].astype(np.uint8)
    fl_r = my_rec[:, 3]

    order = np.lexsort((-dist_r, end_r))
    end_s = end_r[order]
    first = np.concatenate([[True], end_s[1:] != end_s[:-1]])
    starts_at = np.nonzero(first)[0]
    bounds = np.append(starts_at, len(order))
    heads = order[starts_at]                      # max-dist element / group

    f = fl_r[heads]
    keep = ((f & 1) == 1) & ~(((f & 2) == 2) & (((f >> 2) & 1) == 1))
    ci = np.nonzero(keep)[0]
    if len(ci) == 0:
        return []
    lo, hi = bounds[ci], bounds[ci + 1]
    nlens = hi - lo
    seq_lens = (k - 1) + nlens
    S = len(ci)
    offs = np.concatenate([[0], np.cumsum(seq_lens)])
    total = int(offs[-1])
    out = np.empty(total, np.uint8)

    # head k-mer words per kept chain: my_heads maps end -> words
    h_end = my_heads[:, 0]
    h_sort = np.argsort(h_end, kind="stable")
    pos_h = np.searchsorted(h_end[h_sort], end_r[heads[ci]])
    hrows = my_heads[h_sort[pos_h]]               # aligned to kept chains
    assert np.array_equal(hrows[:, 0], end_r[heads[ci]]), \
        "chain start element missing from its end-owner"
    words = hrows[:, 2:2 + W].astype(np.uint32)   # (S, W)
    orient = (fl_r[heads[ci]] >> 2) & 1

    sb = np.empty((S, k), np.uint8)
    for i in range(k):
        wi = 0
        while not (max(k - 16 * (wi + 1), 0) <= i < k - 16 * wi):
            wi += 1
        shift = 2 * ((k - 16 * wi) - 1 - i)
        sb[:, i] = (words[:, wi] >> np.uint32(shift)) & 3
    sb = np.where((orient == 1)[:, None], 3 - sb[:, ::-1], sb)
    head_pos = offs[:-1, None] + np.arange(k)[None, :]
    out[head_pos.reshape(-1)] = sb.reshape(-1)

    # body bases: element e of group g sits at rank dist_head - dist
    cid = np.cumsum(first) - 1                    # group per sorted element
    slot = np.full(len(bounds) - 1, -1, np.int64)
    slot[ci] = np.arange(S)
    sl = slot[cid]
    rank = dist_r[heads][cid] - dist_r[order]
    sel = (sl >= 0) & (rank >= 1)
    pos = offs[sl[sel]] + (k - 1) + rank[sel]
    out[pos] = lb_r[order[sel]]

    # canonicalization: per-chain min(fwd, revcomp)
    e_pos = np.arange(total)
    seg = np.searchsorted(offs, e_pos, side="right") - 1
    rev_idx = offs[seg] + (offs[seg + 1] - 1) - e_pos
    rc = (3 - out)[rev_idx]
    table = np.frombuffer(b"ACGT", dtype=np.uint8)
    fwd_b = table[out].tobytes()
    rc_b = table[rc].tobytes()
    seqs = []
    for c in range(S):
        a, b = int(offs[c]), int(offs[c + 1])
        seqs.append(min(fwd_b[a:b], rc_b[a:b]))
    return seqs


def _order_key(s: bytes):
    """emit_unitigs' output order: longest first, then the sequence."""
    return -len(s), s


def _read_part(path: str):
    with open(path, "rb") as fh:
        for line in fh:
            yield line.rstrip(b"\n")


def _merge_parts(seqs: list[bytes], out_fasta: str, pid: int, P: int) -> int:
    """Write this host's chains, sorted by (-len, seq) without duplicates,
    to {out_fasta}.part{pid}; rank 0 streams a k-way merge of every part
    into the FASTA, dropping duplicates as it goes (emit_unitigs' output:
    set-dedupe + (-len, seq) order). Returns the global unitig count on
    every leader."""
    part = f"{out_fasta}.part{pid}"
    with open(part, "wb") as fh:
        for s in sorted(set(seqs), key=_order_key):
            fh.write(s + b"\n")
    host_barrier("assemble_parts", leaders=True)
    n_unitigs = 0
    if pid == 0:
        parts = [f"{out_fasta}.part{p}" for p in range(P)]
        prev = None
        with _open_w(out_fasta) as f:
            for s in heapq.merge(*(_read_part(p) for p in parts),
                                 key=_order_key):
                if s == prev:
                    continue
                f.write(b">unitig_%d len=%d\n%s\n" % (n_unitigs, len(s), s))
                n_unitigs += 1
                prev = s
        for p in parts:
            os.remove(p)
    return int(host_allgather(np.asarray([n_unitigs], np.int64),
                              leaders=True).sum())
