"""A numpy emulation of how K1, K2 and K3 take a k-mer's minimizer under
the minimizer scheme from m-mer hashes staged once in shared memory
(csrc/kmerax.cuh: kmerax_mmer, kmerax_mmer_rc, kmerax_canonical_strand,
kmerax_bucket_block; csrc/bloom.cu: stage_mmers, staged_minimizer;
csrc/correct.cu: stage_entry, staged_minimizer), held against the JAX
package's `minimizers`, `buckets` and block addressing on the canonical
words of the same k-mers.

K1: one warp packs a read, computes F[p] = mix32(forward m-mer at p) and
R[p] = mix32(its reverse complement) for its L-m+1 positions, and window
j's minimizer is the least of F[j..j+k-m] if the canonical form kept the
forward strand, else of R[j..j+k-m]. K2 does the same for the positions
its probed windows (j <= last_j) hold only, and none for a read whose
last_j < 0. K3: per entry the 2k-1 span bases
(center as code 0), the left positions' suffix minima and the right
positions' prefix minima by warp shuffle scans, and the 4m m-mers over the
center restaged for each of the 4 center bases. Reads have Ns, ragged
lengths and padding; K3's entries include windows that start before
position 0 and padding entries. Exact: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.core.hash import HASH_SEED_1, bloom_blocks_lanes
from kmerax.core.minimizer import buckets as j_buckets
from kmerax.core.minimizer import minimizers as j_minimizers

from parity import reads_with_ns
from test_torch_packed_windows import M32, funnelshift_l, mix32_u32, \
    pack_chunks, span_clear, window_words

FULL = np.uint64(0xFFFFFFFF)
LW, LB = 22, 8                         # 2^22 counters, 256 buckets
CASES = [(k, m) for k in (15, 25, 31, 33, 47, 63) for m in (5, 11, 15)
         if m < k]


def reverse_pairs(w):
    """kmerax_reverse_pairs: the sixteen 2-bit groups of a word reversed."""
    w = ((w & np.uint64(0x33333333)) << np.uint64(2)) \
        | ((w >> np.uint64(2)) & np.uint64(0x33333333))
    w = ((w & np.uint64(0x0F0F0F0F)) << np.uint64(4)) \
        | ((w >> np.uint64(4)) & np.uint64(0x0F0F0F0F))
    w = ((w & np.uint64(0x00FF00FF)) << np.uint64(8)) \
        | ((w >> np.uint64(8)) & np.uint64(0x00FF00FF))
    return ((w << np.uint64(16)) | (w >> np.uint64(16))) & M32


def canonical_strand(words, k):
    """kmerax_canonical_strand on (R, W) words: (canonical words, fwd),
    fwd where the forward strand is kept (fwd <= rc, compared from the
    most significant word)."""
    W = words.shape[1]
    rx = [reverse_pairs(~words[:, W - 1 - i] & M32) for i in range(W)]
    s = 32 * W - 2 * k
    rc = []
    for i in range(W):
        hi = (rx[i + 1] << np.uint64(32 - s)) & M32 \
            if i + 1 < W and s else np.uint64(0)
        rc.append(((rx[i] >> np.uint64(s)) | hi) if s else rx[i])
    lt = np.zeros(words.shape[0], bool)
    eq = np.ones(words.shape[0], bool)
    for i in range(W - 1, -1, -1):
        lt |= eq & (words[:, i] < rc[i])
        eq &= words[:, i] == rc[i]
    fwd = lt | eq
    return np.where(fwd[:, None], words, np.stack(rc, axis=1)), fwd


def mmer(P, p, m):
    """kmerax_mmer: the 2m-bit m-mer at position p of each packed span."""
    x = funnelshift_l(P[:, (p >> 4) + 1], P[:, p >> 4], 2 * (p & 15))
    return x >> np.uint64(32 - 2 * m)


def mmer_rc(x, m):
    """kmerax_mmer_rc."""
    return reverse_pairs(~x & M32) >> np.uint64(32 - 2 * m)


def kmer_hash(words, seed):
    """kmerax_kmer_hash on (R, W) words."""
    h = mix32_u32(np.full(words.shape[0], seed, np.uint64))
    for i in range(words.shape[1]):
        h = mix32_u32(h ^ words[:, i])
    return h


def bucket_block(minimizer, h1):
    """kmerax_bucket_block at 2^LW counters and 2^LB buckets."""
    block_mask = (1 << (LW - 7)) - 1
    seg_bits = LW - 7 - LB
    bucket = minimizer & np.uint64((1 << LB) - 1)
    return (bucket << np.uint64(seg_bits)) \
        | (h1 & np.uint64(block_mask >> LB))


def shfl_up(a, o):
    """__shfl_up_sync over the lanes (last axis): lane l takes lane l-o's
    value, its own below o."""
    out = a.copy()
    out[..., o:] = a[..., :-o]
    return out


def shfl_down(a, o):
    """__shfl_down_sync: lane l takes lane l+o's value, its own past 31."""
    out = a.copy()
    out[..., :-o] = a[..., o:]
    return out


def pack_reads(bases):
    """K1's packing of a (B, L) batch (positions past L read as 4)."""
    B, L = bases.shape
    nch = -(-L // 32)
    b = np.full((B, 32 * nch), 4, np.int64)
    b[:, :L] = bases
    return pack_chunks(b, b >= 4)


def k1_stage(P, L, m):
    """stage_mmers: F and R (B, L-m+1) of each packed read."""
    nm = L - m + 1
    x = np.stack([mmer(P, p, m) for p in range(nm)], axis=1)
    return mix32_u32(x), mix32_u32(mmer_rc(x, m))


def k1_minimizers(bases, k, m):
    """K1's windows: (canonical words (B, nk, W), valid (B, nk), the
    staged minimizer (B, nk), block (B, nk)) of a (B, L) batch."""
    B, L = bases.shape
    P, N = pack_reads(bases)
    F, R = k1_stage(P, L, m)
    nk, w = L - k + 1, k - m + 1
    W = (k + 15) // 16
    canon = np.empty((B, nk, W), np.uint64)
    valid = np.empty((B, nk), bool)
    best = np.empty((B, nk), np.uint64)
    block = np.empty((B, nk), np.uint64)
    for j in range(nk):
        valid[:, j] = span_clear(N, j, k)
        canon[:, j], fwd = canonical_strand(window_words(P, j, k), k)
        best[:, j] = np.where(fwd, F[:, j:j + w].min(axis=1),
                              R[:, j:j + w].min(axis=1))
        block[:, j] = bucket_block(best[:, j],
                                   kmer_hash(canon[:, j], HASH_SEED_1))
    return canon, valid, best, block


def k2_minimizers(bases, last_j, k, m):
    """K2's windows under the minimizer scheme: (canonical words (B, nk,
    W), probed (B, nk): valid and j <= last_j, the staged minimizer (B,
    nk), block (B, nk)). The warp stages F and R of positions p <
    min(L, last_j + k) - m + 1 only, none where last_j < 0; the positions
    it leaves unstaged hold 0, the least hash, so that a probed window that
    read one would take a minimizer of 0."""
    B, L = bases.shape
    P, N = pack_reads(bases)
    F, R = k1_stage(P, L, m)
    nm = np.where(last_j < 0, 0, np.minimum(L, last_j + k) - m + 1)
    unstaged = np.arange(L - m + 1)[None, :] >= nm[:, None]
    F, R = np.where(unstaged, 0, F), np.where(unstaged, 0, R)
    nk, w = L - k + 1, k - m + 1
    W = (k + 15) // 16
    canon = np.empty((B, nk, W), np.uint64)
    probed = np.empty((B, nk), bool)
    best = np.empty((B, nk), np.uint64)
    block = np.empty((B, nk), np.uint64)
    for j in range(nk):
        probed[:, j] = (j <= last_j) & span_clear(N, j, k)
        canon[:, j], fwd = canonical_strand(window_words(P, j, k), k)
        best[:, j] = np.where(fwd, F[:, j:j + w].min(axis=1),
                              R[:, j:j + w].min(axis=1))
        block[:, j] = bucket_block(best[:, j],
                                   kmer_hash(canon[:, j], HASH_SEED_1))
    return canon, probed, best, block, unstaged


def k3_stage(P, k, m):
    """stage_entry: (sufL (E, 2, k-m), preR (E, 2, k-m), ctr (E, 4, 2,
    m)), the scans as the warps run them: 32 lanes a chunk, Hillis-Steele
    by shuffles (a lane past the edge keeps its own value), the chunk's
    carry from lane 0 (suffix, last chunk first) or lane 31 (prefix)."""
    E, nl = P.shape[0], k - m
    lane = np.arange(32)

    def scan(first, shfl, chunks, carry_lane):
        out = np.empty((E, 2, nl), np.uint64)
        carry = np.full((E, 2, 1), FULL)
        for c0 in chunks:
            i = c0 + lane
            x = np.stack([mmer(P, first + min(ii, nl - 1), m) for ii in i],
                         axis=1)
            v = np.stack([mix32_u32(x), mix32_u32(mmer_rc(x, m))], axis=1)
            v = np.where((i < nl)[None, None, :], v, FULL)
            for o in (1, 2, 4, 8, 16):
                v = np.minimum(v, shfl(v, o))
            v = np.minimum(v, carry)
            carry = v[:, :, carry_lane:carry_lane + 1]
            out[:, :, i[i < nl]] = v[:, :, i < nl]
        return out

    suf = scan(0, shfl_down, range((nl - 1) // 32 * 32, -1, -32), 0)
    pre = scan(k, shfl_up, range(0, nl, 32), 31)
    ctr = np.empty((E, 4, 2, m), np.uint64)
    for v in range(4):
        for i in range(m):
            x = mmer(P, nl + i, m) | np.uint64(v << (2 * i))
            ctr[:, v, 0, i] = mix32_u32(x)
            ctr[:, v, 1, i] = mix32_u32(mmer_rc(x, m))
    return suf, pre, ctr


def k3_staged_minimizer(stage, k, m, j, v, s):
    """staged_minimizer of K3 for window j, variant v, strands s (E,)."""
    suf, pre, ctr = stage
    e = np.arange(s.shape[0])
    best = np.full(s.shape[0], FULL)
    if j < k - m:
        best = suf[e, s, j]
    if j >= m:
        best = np.minimum(best, pre[e, s, j - m])
    for i in range(max(j - (k - m), 0), min(j, m - 1) + 1):
        best = np.minimum(best, ctr[e, v, s, i])
    return best


def k3_entries(seed, k):
    """A (B, L) batch and entries over it: padding (-1), centers before
    position k-1 (windows that start before position 0), the last base,
    random positions."""
    B, L = 24, 110
    reads, lengths = reads_with_ns(seed, B, L, k, n_rate=0.01)
    rng = np.random.default_rng(seed)
    Q = 96
    ent_r = rng.integers(0, B, Q).astype(np.int32)
    ent_i = rng.integers(0, L, Q).astype(np.int32)
    ent_i[:6] = -1
    ent_i[6:30] = rng.integers(0, k - 1, 24)
    ent_i[30:36] = lengths[ent_r[30:36]] - 1
    return reads, lengths, lengths - k, ent_r, ent_i


def j_window(kmer_bases, k):
    """The JAX package's canonical words, validity, minimizer (m given
    later) of rows of exactly k bases."""
    jw, jv = j_extract(jnp.asarray(kmer_bases), k)
    jc, _ = j_canonical(jw, k)
    return jc[:, 0], np.asarray(jv)[:, 0]


def j_min_block(jc, k, m):
    mins = np.asarray(j_minimizers(jc, k, m)).astype(np.uint64)
    block, _ = bloom_blocks_lanes(jc, LW, 4, j_buckets(jc, k, m, 1 << LB),
                                  LB)
    return mins, np.asarray(block).astype(np.uint64)


@pytest.mark.parametrize("k,m", CASES)
def test_k1_staged_minimizer_matches_jax(k, m):
    """K1's staged F/R and the window minimum by kept strand give the JAX
    package's canonical words, minimizers, buckets and blocks at every
    valid window of reads with Ns."""
    reads, _ = reads_with_ns(100 + k + m, 16, 130, k, n_rate=0.01)
    canon, valid, best, block = k1_minimizers(reads, k, m)
    jw, jv = j_extract(jnp.asarray(reads), k)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(valid, jv)
    jc = j_canonical(jw, k)[0][jv]
    np.testing.assert_array_equal(canon[valid], np.asarray(jc))
    mins, blocks = j_min_block(jc, k, m)
    np.testing.assert_array_equal(best[valid], mins)
    np.testing.assert_array_equal(block[valid], blocks)
    np.testing.assert_array_equal(
        best[valid] % np.uint64(1 << LB),
        np.asarray(j_buckets(jc, k, m, 1 << LB)).astype(np.uint64))
    assert 0 < valid.sum() < valid.size          # Ns and padding present
    assert len(np.unique(best[valid])) > 10


@pytest.mark.parametrize("k,m", CASES)
def test_k3_staged_minimizer_matches_jax(k, m):
    """K3's staged span (suffix minima left of the center, prefix minima
    right of it, the center m-mers restaged for each of the 4 center
    bases) and the window minimum by kept strand give, for every probed
    (entry, variant, window), the JAX package's canonical words,
    minimizer and block of the substituted k-mer built from the read."""
    bases, lengths, last_j, ent_r, ent_i = k3_entries(200 + k + m, k)
    B, L = bases.shape
    Q = len(ent_r)
    ic = np.clip(ent_i, 0, L - 1)
    c = ic - (k - 1)
    ln = np.minimum(lengths[ent_r], L)
    span = 2 * k - 1
    i = np.arange(32 * -(-span // 32))
    p = c[:, None] + i[None, :]
    inside = (p >= 0) & (p < ln[:, None])
    b = np.where(inside, bases[ent_r[:, None], np.clip(p, 0, L - 1)], 4)
    bad = (b >= 4) | (i >= span)[None, :]
    b[:, k - 1], bad[:, k - 1] = 0, False
    P, N = pack_chunks(b, bad)
    stage = k3_stage(P, k, m)
    got_ok, got_canon, got_min, got_block, rows = [], [], [], [], []
    for j in range(k):
        jg = c + j
        ok = (jg >= 0) & (jg <= last_j[ent_r]) & span_clear(N, j, k)
        base = window_words(P, j, k)
        for v in range(4):
            wv = base.copy()
            wv[:, j >> 4] |= np.uint64(v << (2 * (j & 15)))
            canon, fwd = canonical_strand(wv, k)
            best = k3_staged_minimizer(stage, k, m, j, v,
                                       np.where(fwd, 0, 1))
            got_ok.append(ok)
            got_canon.append(canon)
            got_min.append(best)
            got_block.append(bucket_block(best,
                                          kmer_hash(canon, HASH_SEED_1)))
            # the substituted k-mer, from the read itself
            q = jg[:, None] + np.arange(k)[None, :]
            kb = np.where((q >= 0) & (q < ln[:, None]),
                          bases[ent_r[:, None], np.clip(q, 0, L - 1)], 4)
            kb[q == ic[:, None]] = v
            rows.append(kb)
    ok = np.concatenate(got_ok)
    jc, jv = j_window(np.concatenate(rows).astype(np.int32), k)
    lj = np.tile(last_j[ent_r], 4 * k)
    jgs = np.concatenate([c + j for j in range(k) for _ in range(4)])
    np.testing.assert_array_equal(ok, jv & (jgs >= 0) & (jgs <= lj))
    jc = jc[ok]
    np.testing.assert_array_equal(np.concatenate(got_canon)[ok],
                                  np.asarray(jc))
    mins, blocks = j_min_block(jc, k, m)
    np.testing.assert_array_equal(np.concatenate(got_min)[ok], mins)
    np.testing.assert_array_equal(np.concatenate(got_block)[ok], blocks)
    # windows before position 0 were there, and some windows are probed
    assert (c < 0).any() and 0 < ok.sum() < ok.size
    assert Q * 4 * k == ok.size


@pytest.mark.parametrize("k,m", CASES)
def test_k2_staged_minimizer_matches_jax(k, m):
    """K2's staging of the m-mers its probed windows hold (j <= last_j;
    reads shorter than k, whose last_j < 0, stage none) and the window
    minimum by kept strand give the JAX package's canonical words,
    minimizers, buckets and blocks at every window K2 probes, on reads with
    Ns, ragged lengths and padding."""
    rng = np.random.default_rng(300 + k + m)
    reads, lengths = reads_with_ns(300 + k + m, 16, 130, k, n_rate=0.01)
    short = np.array([1, 5, 9])
    lengths[short] = rng.integers(0, k, short.size)
    for i in short:
        reads[i, lengths[i]:] = 4
    last_j = lengths - k
    last_j[[2, 6]] = [0, lengths[6] - k - 17]    # a cut before the end
    canon, probed, best, block, unstaged = k2_minimizers(reads, last_j, k,
                                                         m)
    jw, jv = j_extract(jnp.asarray(reads), k)
    jv = np.asarray(jv)
    nk = reads.shape[1] - k + 1
    want = jv & (np.arange(nk)[None, :] <= last_j[:, None])
    np.testing.assert_array_equal(probed, want)
    jc = j_canonical(jw, k)[0][want]
    np.testing.assert_array_equal(canon[probed], np.asarray(jc))
    mins, blocks = j_min_block(jc, k, m)
    np.testing.assert_array_equal(best[probed], mins)
    np.testing.assert_array_equal(block[probed], blocks)
    np.testing.assert_array_equal(
        best[probed] % np.uint64(1 << LB),
        np.asarray(j_buckets(jc, k, m, 1 << LB)).astype(np.uint64))
    # the cut: short reads stage and probe nothing; padded reads and those
    # cut before the end stage less than L - m + 1 positions and leave
    # valid windows unprobed; Ns leave windows before the cut unprobed
    assert unstaged[short].all() and not probed[short].any()
    assert unstaged[lengths < reads.shape[1]].any(axis=1).all()
    assert unstaged[[2, 6]].any(axis=1).all() and (jv & ~want).any()
    assert (~jv & (np.arange(nk)[None, :] <= last_j[:, None])).any()
    assert len(np.unique(best[probed])) > 10
