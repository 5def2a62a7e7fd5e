"""A numpy emulation of how kernels K1, K2 and K3 build k-mers
(csrc/kmerax.cuh: kmerax_pack_chunk, kmerax_window_words,
kmerax_span_clear; K3's center OR in csrc/correct.cu), how they address
them under the minimizer scheme (kmerax_block) and how K2 and K3 probe
them (kmerax_probe_two_rounds), held against the JAX package's
extract_kmers, canonical_words and round-start window solidity
(`_window_counts` with the Pallas probe in interpret mode) and against the
plain K3 scores. The card is the only place the kernels run, so this
checks their word layout, funnel-shift offsets, N masks, the last_j mask
and the probe before a chip call. Exact: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.ops.correct import _eval_entries as j_eval_entries
from kmerax.spectrum import bloom as jbloom
from kmerax_torch.core.codec import canonical_words
from kmerax_torch.ops.correct import _accept, _eval_scores
from kmerax_torch.spectrum import bloom
from kmerax_torch.core.hash import HASH_SEED_1, kmer_hash
from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack

from parity import n, reads_with_ns, t
from test_torch_spectrum import j_window_solid, k2_case

M32 = np.uint64(0xFFFFFFFF)


def pack_chunks(codes, bad):
    """What a warp packs (kmerax_pack_chunk), for R spans at once: codes
    and bad (R, 32 nch), lane = position % 32 -> P (R, 2 nch + 1) 2-bit
    words, leftmost base highest, one zero word past the end; N (R, nch)
    with bit i of word c set where position 32c+i is invalid."""
    R, npos = codes.shape
    nch = npos // 32
    lane = np.arange(npos) % 32
    bits = (codes.astype(np.uint64) & np.uint64(3)) \
        << (30 - 2 * (lane % 16)).astype(np.uint64)
    P = bits.reshape(R, 2 * nch, 16).sum(axis=2)   # disjoint bits: OR
    P = np.concatenate([P, np.zeros((R, 1), np.uint64)], axis=1)
    N = (bad.reshape(R, nch, 32).astype(np.uint64)
         << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return P, N


def funnelshift_l(lo, hi, sh):
    """__funnelshift_l(lo, hi, sh): the high word of (hi:lo) << sh."""
    return ((((hi << np.uint64(32)) | lo) << np.uint64(sh))
            >> np.uint64(32)) & M32


def window_words(P, j, k):
    """kmerax_window_words: word wi folds window positions [lo, hi), read
    as the hi - lo bases from position j + lo."""
    W = (k + 15) // 16
    out = np.empty((P.shape[0], W), np.uint64)
    for wi in range(W):
        lo = max(k - 16 * (wi + 1), 0)
        nb = k - 16 * wi - lo
        s = j + lo
        x = funnelshift_l(P[:, (s >> 4) + 1], P[:, s >> 4], 2 * (s & 15))
        out[:, wi] = x >> np.uint64(32 - 2 * nb)
    return out


def span_clear(N, j, k):
    """kmerax_span_clear: no N bit among positions [j, j + k)."""
    e = j + k
    clear = np.ones(N.shape[0], bool)
    for w in range(j >> 5, ((e - 1) >> 5) + 1):
        lo, hi = max(j - 32 * w, 0), min(e - 32 * w, 32)
        m = 0xFFFFFFFF if hi - lo == 32 else ((1 << (hi - lo)) - 1) << lo
        clear &= (N[:, w] & np.uint64(m)) == 0
    return clear


def k1_windows(bases, k):
    """K1's k-mers of a (B, L) batch: one warp per read packs it (positions
    past L read as 4), lane l takes windows l, l+32, ... Returns (words
    (B, nk, W) uint64, valid (B, nk))."""
    B, L = bases.shape
    nch = -(-L // 32)
    b = np.full((B, 32 * nch), 4, np.int64)
    b[:, :L] = bases
    P, N = pack_chunks(b, b >= 4)
    nk = L - k + 1
    words = np.stack([window_words(P, j, k) for j in range(nk)], axis=1)
    valid = np.stack([span_clear(N, j, k) for j in range(nk)], axis=1)
    return words, valid


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k1_packed_windows_match_extract_and_canonical(k):
    reads, _ = reads_with_ns(11 + k, 48, 130, k, n_rate=0.01)
    words, valid = k1_windows(reads, k)
    jw, jv = j_extract(jnp.asarray(reads), k)
    jw, jv = np.asarray(jw), np.asarray(jv)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(words[valid], jw[jv])
    canon, _ = canonical_words(t(words.astype(np.int64)), k)
    jc, _ = j_canonical(jnp.asarray(jw), k)
    np.testing.assert_array_equal(n(canon)[valid], np.asarray(jc)[jv])
    assert 0 < valid.sum() < valid.size          # Ns and padding present


def mix32_u32(x):
    """kmerax_mix32 in uint64 arrays masked to 32 bits."""
    x = x & M32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & M32
    return x ^ (x >> np.uint64(16))


def minimizer_block(words, k, h1, log2_width, m, log2_buckets):
    """kmerax_block<W, true>: per m-mer j its 2m bits at p = 2(k-m-j), read
    from the words wi = p/32 and wi+1 (0 past W) as (lo >> sb) |
    (hi << (32-sb)) in 32 bits, then the least mix32, the bucket its low
    log2_buckets bits above the low seg_bits of h1."""
    W = words.shape[1]
    best = np.full(words.shape[0], 0xFFFFFFFF, np.uint64)
    for j in range(k - m + 1):
        p = 2 * (k - m - j)
        wi, sb = p >> 5, p & 31
        lo = words[:, wi]
        hi = words[:, wi + 1] if wi + 1 < W else np.zeros_like(lo)
        val = lo if sb == 0 else ((lo >> np.uint64(sb))
                                  | ((hi << np.uint64(32 - sb)) & M32))
        best = np.minimum(best, mix32_u32(val & np.uint64((1 << 2 * m) - 1)))
    block_mask = (1 << (log2_width - 7)) - 1
    seg_bits = bin(block_mask).count("1") - log2_buckets
    bucket = best & np.uint64((1 << log2_buckets) - 1)
    return (bucket << np.uint64(seg_bits)) \
        | (h1 & np.uint64(block_mask >> log2_buckets))


@pytest.mark.parametrize("k", [25, 31, 63])
def test_minimizer_block_of_packed_windows_matches_blocks_lanepack(k):
    """K1's packed windows, canonicalized, addressed by the emulated
    kmerax_block (m = 11 and 15, 256 buckets) equal the plain addressing
    of the JAX package's k-mers."""
    reads, _ = reads_with_ns(21 + k, 32, 130, k, n_rate=0.01)
    words, valid = k1_windows(reads, k)
    canon, _ = canonical_words(t(words.astype(np.int64)), k)
    canon = canon[t(valid)]
    h1 = n(kmer_hash(canon, HASH_SEED_1)).astype(np.uint64)
    jw, jv = j_extract(jnp.asarray(reads), k)
    jc = t(np.asarray(j_canonical(jw, k)[0])[np.asarray(jv)])
    for m in (11, 15):
        p = bloom.BloomParams(k, 22, 4, m, 8, "minimizer")
        got = minimizer_block(n(canon).astype(np.uint64), k, h1, 22, m, 8)
        want, _ = blocks_lanepack(p, jc)
        np.testing.assert_array_equal(got.astype(np.int64),
                                      n(want).astype(np.int64))
        assert len(np.unique(got >> np.uint64(22 - 7 - 8))) > 50


def probe_two_rounds(table, block, lanepack, d, t_solid):
    """kmerax_probe_two_rounds: lane 0 first, the other d-1 lanes only
    where it passed (lanes read past a failed lane 0 would not change the
    answer, so the emulation reads them and masks)."""
    row = block.astype(np.int64) * 128
    lane = lambda i: (lanepack.astype(np.int64) >> (7 * i)) & 127
    solid = table[row + lane(0)] >= t_solid
    rest = np.ones_like(solid)
    for i in range(1, d):
        rest &= table[row + lane(i)] >= t_solid
    return solid & rest


def k2_solid(bases, last_j, table, params, t_solid):
    """K2's (B, L-k+1) solidity: K1's packed windows of the int32 batch,
    counted where the window starts in [0, last_j] and holds no N, then
    canonical form, address and the two-round probe."""
    k = params.k
    words, valid = k1_windows(bases, k)
    nk = words.shape[1]
    live = valid & (np.arange(nk)[None, :] <= last_j[:, None])
    canon, _ = canonical_words(t(words.astype(np.int64)), k)
    block, lp = blocks_lanepack(params, canon)
    solid = probe_two_rounds(table, n(block), n(lp), params.num_hashes,
                             t_solid)
    return live & solid


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k2_warp_matches_jax_window_counts(k):
    jp, table, reads, lengths, last_j = k2_case(k, 90 + k)
    want = j_window_solid(jp, table, reads, last_j, 2)
    got = k2_solid(reads, last_j, np.asarray(table),
                   bloom.BloomParams(k, 15, 4), 2)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < (last_j + 1).clip(0).sum()


def k3_scores(bases, lengths, last_j, ent_r, ent_i, k, solid_fn):
    """K3's scores: per entry its 2k-1 window bases packed once (positions
    outside [0, length) as 4, the center as code 0 and valid), then per
    (v, j) the window's words with v ORed in at word j/16, bits 2(j%16),
    counted where the window starts inside the read and holds no N."""
    B, L = bases.shape
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
    W = (k + 15) // 16
    words = np.empty((len(ent_r), 4, k, W), np.uint64)
    live = np.empty((len(ent_r), 4, k), bool)
    for j in range(k):
        jg = c + j
        ok = (jg >= 0) & (jg <= last_j[ent_r]) & span_clear(N, j, k)
        base = window_words(P, j, k)
        for v in range(4):
            wv = base.copy()
            wv[:, j >> 4] |= np.uint64(v << (2 * (j & 15)))
            words[:, v, j], live[:, v, j] = wv, ok
    canon, _ = canonical_words(t(words.astype(np.int64)), k)
    return solid_fn(canon, t(live)).sum(dim=-1, dtype=torch.int32)


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k3_packed_windows_match_eval_scores(k):
    B, L, LW, thr = 48, 110, 15, 2
    reads, lengths = reads_with_ns(40 + k, B, L, k,
                                   err_rate=0.01 if k == 63 else 0.03)
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4)
    jw, jv = j_extract(jnp.asarray(reads), k)
    table = jbloom.insert(jp, jnp.zeros(jp.width, jnp.int32),
                          j_canonical(jw, k)[0], jv)
    p = bloom.BloomParams(k, LW, 4)
    tt = t(table).to(torch.int32)
    solid_fn = lambda cw, v: bloom.query_solid(p, tt, thr, cw, v)
    rng = np.random.default_rng(k)
    Q = 160
    ent_r = rng.integers(0, B, Q).astype(np.int32)
    ent_i = rng.integers(0, L, Q).astype(np.int32)
    ent_i[:8] = -1                        # padding entries
    ent_i[8:16] = rng.integers(0, k - 1, 8)   # window starts before the read
    ent_i[16:24] = L - 1
    last_j = lengths - k
    got = k3_scores(reads, lengths, last_j, ent_r, ent_i, k, solid_fn)
    args = (t(reads).to(torch.int32), t(lengths), t(last_j), t(ent_r),
            t(ent_i))
    want = _eval_scores(*args, k, solid_fn)
    np.testing.assert_array_equal(n(got), n(want))
    assert int(got.sum()) > 0
    _, accept = _accept(got, *args[:1], args[3], args[4])
    _, j_accept = j_eval_entries(
        jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(last_j),
        jnp.asarray(ent_r), jnp.asarray(ent_i), k,
        lambda cw, v: (jbloom.query(jp, table, cw, v) >= thr) & v)
    np.testing.assert_array_equal(n(accept), np.asarray(j_accept))
