"""k-mers of any odd k <= 63 as DESIGN.md §2's words, in plain torch over
whole arrays: the path the reference takes where a k-mer does not fit one
int64 (k > 31; kmers.py keeps k <= 31).

A k-mer is held as its W = ceil(k / 16) little-endian uint32 words, each
in an int64 column of a (..., W) tensor: column 0 holds bits 0..31, the
last bases of the k-mer. k-mers are ordered as unsigned integers, that is
lexicographically over the words from the last column down (§6). Every
word stays in [0, 2^32), so int64 comparisons of one column are unsigned
ones; hashing is kmers.py's uint32 arithmetic on each word.
"""

from __future__ import annotations

import torch

from .kmers import HASH_SEED_1, HASH_SEED_2, M32, mix32


def check_k(k: int) -> None:
    if k % 2 == 0 or not 0 < k <= 63:
        raise ValueError(f"the reference takes odd k <= 63, got {k}")


def n_words(k: int) -> int:
    return (k + 15) // 16


def windows(bases: torch.Tensor, k: int):
    """(fwd, rc, valid) of every k-window of (N, L) bases 0..4 (4 = N):
    (N, L - k + 1, W) int64 words of the forward and reverse-complement
    k-mers, and whether the window holds no N. Word w of the forward value
    holds the bases j with k - 1 - j in [16w, 16w + 16); word w of the
    reverse complement the complements of bases 16w .. 16w + 15."""
    check_k(k)
    b = bases.to(torch.int64)
    nk = b.shape[1] - k + 1
    bad = torch.zeros((b.shape[0], nk), dtype=torch.bool, device=b.device)
    for j in range(k):
        bad |= b[:, j:j + nk] >= 4
    fwd, rc = [], []
    for w in range(n_words(k)):
        x = torch.zeros((b.shape[0], nk), dtype=torch.int64, device=b.device)
        for j in range(max(0, k - 16 * (w + 1)), k - 16 * w):
            x = (x << 2) | (b[:, j:j + nk] & 3)
        fwd.append(x)
        x = torch.zeros_like(x)
        for j in range(min(16 * w + 16, k) - 1, 16 * w - 1, -1):
            x = (x << 2) | (3 - (b[:, j:j + nk] & 3))
        rc.append(x)
    return torch.stack(fwd, -1), torch.stack(rc, -1), ~bad


def less_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b as unsigned integers, over the last dimension's words."""
    le = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(le)
    for w in range(a.shape[-1] - 1, -1, -1):
        x, y = a[..., w], b[..., w]
        le = torch.where(decided, le, x <= y)
        decided |= x != y
    return le


def canonical(fwd: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    return torch.where(less_equal(fwd, rc)[..., None], fwd, rc)


def _reverse_pairs(x: torch.Tensor) -> torch.Tensor:
    """The sixteen 2-bit groups of each 32-bit word in reverse order."""
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) & 0xFFFF) | ((x & 0xFFFF) << 16)


def revcomp(v: torch.Tensor, k: int) -> torch.Tensor:
    """The reverse complements of (..., W) k-mers: every base complemented,
    the 16W groups reversed (words and groups within them), then shifted
    down by the 16W - k pad groups that came to lie at the bottom."""
    r = _reverse_pairs(v ^ M32).flip(-1)
    s = 2 * (16 * v.shape[-1] - k)
    up = torch.cat([r[..., 1:], torch.zeros_like(r[..., :1])], -1)
    return ((r >> s) | (up << (32 - s))) & M32


def extend(v: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """The k-mers of (..., W) k-mers' last k - 1 bases followed by `base`
    (broadcast against v[..., 0])."""
    down = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)
    out = ((v << 2) & M32) | (down >> 30)
    out[..., 0] |= base
    top = 2 * k - 32 * (v.shape[-1] - 1)
    out[..., -1] &= (1 << top) - 1
    return out


def lex_order(x: torch.Tensor) -> torch.Tensor:
    """The stable ascending order of (N, W) rows: one stable sort a word,
    the least significant first."""
    order = torch.arange(x.shape[0], device=x.device)
    for w in range(x.shape[1]):
        order = order[torch.sort(x[order, w], stable=True).indices]
    return order


def unique_counts(x: torch.Tensor):
    """(uniq, counts): the distinct (N, W) rows, ascending, and how often
    each occurs."""
    xs = x[lex_order(x)]
    new = torch.ones(xs.shape[0], dtype=torch.bool, device=x.device)
    new[1:] = (xs[1:] != xs[:-1]).any(-1)
    starts = torch.nonzero(new, as_tuple=True)[0]
    ends = torch.cat([starts[1:], starts.new_tensor([xs.shape[0]])])
    return xs[starts], ends - starts


def ranks(*parts: torch.Tensor) -> list[torch.Tensor]:
    """Dense ranks of the rows of each (N_i, W) part among the rows of
    all: equal rows get equal ranks, and ranks keep the rows' order."""
    cat = torch.cat(parts)
    order = lex_order(cat)
    xs = cat[order]
    new = torch.zeros(xs.shape[0], dtype=torch.int64, device=cat.device)
    new[1:] = (xs[1:] != xs[:-1]).any(-1).to(torch.int64)
    r = torch.empty_like(new)
    r[order] = torch.cumsum(new, 0)
    return list(torch.split(r, [p.shape[0] for p in parts]))


def lookup(nodes: torch.Tensor, q: torch.Tensor):
    """(at, found) of (..., W) queries in the ascending distinct (C, W)
    rows `nodes`: the index of the equal node (0 where none) and whether
    there is one."""
    C = nodes.shape[0]
    flat = q.reshape(-1, q.shape[-1])
    order = lex_order(torch.cat([nodes, flat]))     # a node before its equals
    last = torch.where(order < C, order, -1).cummax(0).values
    at = torch.empty(flat.shape[0], dtype=torch.int64, device=q.device)
    is_q = order >= C
    at[order[is_q] - C] = last[is_q]
    found = at >= 0
    at = at.clamp(min=0)
    if C:
        found &= (nodes[at] == flat).all(-1)
    return at.reshape(q.shape[:-1]), found.reshape(q.shape[:-1])


def kmer_hash(v: torch.Tensor, seed: int) -> torch.Tensor:
    """h = mix32(seed); for each little-endian word w: h = mix32(h ^ w)."""
    h = mix32(seed)
    for w in range(v.shape[-1]):
        h = mix32(v[..., w] ^ h)
    return h


def probes(canon: torch.Tensor, log2_width: int,
           hashes: int) -> torch.Tensor:
    """(..., hashes) counter indices of (..., W) canonical k-mers under the
    hash bucket scheme, as kmers.probes gives them for one int64."""
    if hashes > 4:
        raise ValueError("at most 4 hashes")
    h1 = kmer_hash(canon, HASH_SEED_1)
    h2 = kmer_hash(canon, HASH_SEED_2)
    block = h1 & ((1 << (log2_width - 7)) - 1)
    lanes = torch.stack([(h2 >> (7 * i)) & 127 for i in range(hashes)],
                        dim=-1)
    return (block << 7)[..., None] | lanes
