"""kmerax_torch.core == kmerax.core: codec, k-mer extraction and hashing,
exact (tolerance 0: every output is an integer)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.core import codec as jcodec
from kmerax.core import hash as jhash
from kmerax.core.kmers import extract_kmers as j_extract
from kmerax_torch.core import codec, hash as thash
from kmerax_torch.core.kmers import extract_kmers

from parity import n, reads_with_ns, t

EXTREMES = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1,
                     0xC2B2AE35, 0x85EBCA6B], dtype=np.uint32)


def _kmer_words(k, seed=0):
    reads, _ = reads_with_ns(seed, 48, 100, k)
    words, valid = j_extract(jnp.asarray(reads), k)
    return np.asarray(words).reshape(-1, (k + 15) // 16), \
        np.asarray(valid).reshape(-1)


@pytest.mark.parametrize("k", [25, 31, 63])
def test_extract_kmers(k):
    reads, _ = reads_with_ns(1, 32, 110, k)
    jw, jv = j_extract(jnp.asarray(reads), k)
    tw, tv = extract_kmers(torch.from_numpy(reads), k)
    np.testing.assert_array_equal(n(tw), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    assert np.asarray(jv).sum() > 0 and (~np.asarray(jv)).sum() > 0


@pytest.mark.parametrize("k", [25, 31, 63])
def test_revcomp_and_canonical(k):
    words, _ = _kmer_words(k)
    np.testing.assert_array_equal(
        n(codec.revcomp_words(t(words), k)),
        np.asarray(jcodec.revcomp_words(jnp.asarray(words), k)))
    jc, jf = jcodec.canonical_words(jnp.asarray(words), k)
    tc, tf = codec.canonical_words(t(words), k)
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    np.testing.assert_array_equal(n(tf), np.asarray(jf))
    assert 0 < np.asarray(jf).sum() < len(words)


def test_reverse_pairs_extremes():
    x = np.concatenate([EXTREMES, np.random.default_rng(2).integers(
        0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)])
    np.testing.assert_array_equal(
        n(codec._reverse_pairs_u32(t(x))),
        np.asarray(jcodec._reverse_pairs_u32(jnp.asarray(x))))


def test_to_u32_bits():
    bits = codec.to_u32_bits(t(EXTREMES))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), EXTREMES)


def test_mix32_extremes():
    rng = np.random.default_rng(3)
    x = np.concatenate([EXTREMES, rng.integers(0, 2**32, 4096,
                                               dtype=np.uint64)
                        .astype(np.uint32)])
    np.testing.assert_array_equal(n(thash.mix32(t(x))),
                                  np.asarray(jhash.mix32(jnp.asarray(x))))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_kmer_hash_extreme_words(w):
    """Rows built from the extreme words (every combination for w <= 2)."""
    rng = np.random.default_rng(w)
    if w <= 2:
        rows = np.stack(np.meshgrid(*[EXTREMES] * w), -1).reshape(-1, w)
    else:
        rows = rng.choice(EXTREMES, size=(512, w))
    for seed in (jhash.HASH_SEED_1, jhash.HASH_SEED_2):
        np.testing.assert_array_equal(
            n(thash.kmer_hash(t(rows), seed)),
            np.asarray(jhash.kmer_hash(jnp.asarray(rows), seed)))


@pytest.mark.parametrize("k,log2_width", [(25, 18), (31, 16), (31, 29),
                                          (63, 24)])
def test_bloom_blocks_lanes(k, log2_width):
    words, _ = _kmer_words(k, seed=4)
    canon = np.asarray(jcodec.canonical_words(jnp.asarray(words), k)[0])
    canon = np.concatenate([canon, np.tile(EXTREMES[:, None],
                                           (1, canon.shape[1]))])
    jb, jl = jhash.bloom_blocks_lanes(jnp.asarray(canon), log2_width, 4,
                                      None, 8)
    tb, tl = thash.bloom_blocks_lanes(t(canon), log2_width, 4)
    np.testing.assert_array_equal(n(tb), np.asarray(jb))
    np.testing.assert_array_equal(n(tl), np.asarray(jl))
