"""The minimizer bucket scheme (DESIGN.md §4) in kmerax_torch against the
JAX package: minimizers and buckets, the Bloom addressing, K1's, K2's and
K3's plain versions, and the whole pipeline byte for byte. Exact:
tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.core.minimizer import buckets as j_buckets
from kmerax.core.minimizer import minimizers as j_minimizers
from kmerax.ops.correct import _eval_entries as j_eval_entries
from kmerax.ops.correct import _window_counts as j_window_counts
from kmerax.pipeline import run_pipeline as j_run_pipeline
from kmerax.pipeline.run import _count_steps as j_count_steps
from kmerax.spectrum import bloom as jbloom
from kmerax.spectrum.exact import sentinel_rows as j_sentinel_rows
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.core.minimizer import buckets, minimizers
from kmerax_torch.ops.correct import _accept
from kmerax_torch.ops.correct_kernels import correct_eval_scores
from kmerax_torch.pipeline.count import bloom_params
from kmerax_torch.pipeline.run import run_pipeline
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
    bloom_insert, bloom_query_solid, scheme_args
from kmerax_torch.spectrum.exact import sentinel_rows
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, t, with_short_reads

LW = 16


def canon_rows(k, seed, n_rows=400):
    """Random canonical-range rows: (N, W) uint32, bits above 2k clear."""
    w = (k + 15) // 16
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, size=(n_rows, w), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, -1] &= np.uint32((1 << (2 * k - 32 * (w - 1))) - 1)
    return rows


def params(k, m=11):
    """(JAX params, port params) of the minimizer scheme, 256 buckets."""
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4, minimizer_m=m,
                            log2_buckets=8, bucket_scheme="minimizer")
    return jp, bloom.BloomParams(k, LW, 4, m, 8, "minimizer")


@pytest.mark.parametrize("m", [11, 15])
@pytest.mark.parametrize("k", [25, 31, 63])
def test_minimizers_and_buckets_match_jax(k, m):
    rows = canon_rows(k, 10 * k + m)
    got = minimizers(t(rows), k, m)
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    np.testing.assert_array_equal(
        n(got), np.asarray(j_minimizers(jnp.asarray(rows), k, m)))
    got_b = buckets(t(rows), k, m, 256)
    assert got_b.dtype == torch.int32
    np.testing.assert_array_equal(
        n(got_b), np.asarray(j_buckets(jnp.asarray(rows), k, m, 256)))


@pytest.mark.parametrize("k", [25, 31, 63])
def test_blocks_lanepack_matches_jax(k):
    jp, p = params(k)
    rows = canon_rows(k, k)
    jb, jl = jbloom.blocks_lanepack(jp, jnp.asarray(rows))
    tb, tl = blocks_lanepack(p, t(rows))
    np.testing.assert_array_equal(n(tb), np.asarray(jb))
    np.testing.assert_array_equal(n(tl), np.asarray(jl))
    # the bucket is the block's top 8 bits, so blocks leave their segment
    seg = n(tb) >> (LW - 7 - 8)
    np.testing.assert_array_equal(seg, n(buckets(t(rows), k, 11, 256)))
    hb, _ = blocks_lanepack(bloom.BloomParams(k, LW, 4), t(rows))
    assert (n(hb) != n(tb)).any()
    assert scheme_args(p) == (11, 8)
    assert scheme_args(bloom.BloomParams(k, LW, 4)) == (0, 0)


def test_config_selects_the_scheme():
    cfg = KmeraxConfig(bucket_scheme="minimizer", minimizer_m=13,
                       num_buckets=64, bloom_log2_width=20)
    p = bloom_params(cfg, 31)
    assert (p.bucket_scheme, p.minimizer_m, p.log2_buckets, p.counter) == \
        ("minimizer", 13, 6, "i32")


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k1_plain_matches_jax_count_step(k):
    """K1's CPU path under the minimizer scheme against the JAX count step:
    table bytes, pending rows from a nonzero offset, valid count."""
    B, L = 32, 100
    reads, lengths = reads_with_ns(80 + k, B, L, k, n_rate=0.01)
    pend_rows = B * (L - k + 1)
    jparams, bloom_step, pend_append, _, P, _ = j_count_steps(
        JConfig(k=k, bloom_log2_width=LW, batch_reads=B, max_read_len=L,
                exact_capacity=2 * 2 * pend_rows,
                bucket_scheme="minimizer"), k)
    assert jparams.bucket_scheme == "minimizer"
    jtable, jn = bloom_step(jnp.zeros(jparams.width, jnp.int32),
                            jnp.asarray(reads.astype(np.int8)),
                            jnp.asarray(lengths))
    jpend = pend_append(j_sentinel_rows(P, (k + 15) // 16), pend_rows,
                        jnp.asarray(reads.astype(np.int8)),
                        jnp.asarray(lengths))
    _, p = params(k)
    table = bloom.make_table(p, "cpu")
    pending = sentinel_rows(P, (k + 15) // 16, "cpu")
    cuda.reset_launches()
    got = bloom_insert(table, t(reads).to(torch.int8), p, pending, pend_rows)
    assert int(got) == int(jn) and 0 < int(got) < pend_rows
    np.testing.assert_array_equal(n(table), np.asarray(jtable))
    np.testing.assert_array_equal(n(pending).view(np.uint32),
                                  np.asarray(jpend))
    assert all(c == 0 for c in cuda.LAUNCHES.values())


def _table(jp, reads, k, times=2):
    """The JAX table holding the k-mers of `reads` `times` times."""
    words, valid = j_extract(jnp.asarray(reads), k)
    canon = j_canonical(words, k)[0]
    table = jnp.zeros(jp.width, jnp.int32)
    for _ in range(times):
        table = jbloom.insert(jp, table, canon, valid)
    return table


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k2_plain_matches_jax_bitmap_solidity(k):
    """K2's CPU path against `_window_counts` with `query_solid` on the
    JAX package's bitmap, half the reads in the table."""
    B, L, t_solid = 32, 100, 2
    reads, lengths = reads_with_ns(90 + k, B, L, k, n_rate=0.01,
                                   err_rate=0.01)
    reads, lengths = with_short_reads(reads, lengths, k)
    last_j = (lengths - k).astype(np.int32)
    jp, p = params(k)
    table = _table(jp, reads[:B // 2], k)
    bm = jbloom.solidity_bitmap(jp, table, t_solid)
    want, _ = j_window_counts(
        jnp.asarray(reads), jnp.asarray(last_j), k,
        lambda cw, v: jbloom.query_solid(jp, bm, cw, v))
    want = np.asarray(want)
    got = bloom_query_solid(t(table).to(torch.int32), t(reads), t(last_j),
                            p, t_solid)
    np.testing.assert_array_equal(n(got), want)
    assert 0 < want.sum() < (last_j + 1).clip(0).sum()


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k3_plain_matches_jax_eval_entries(k):
    """K3's CPU path (scores, then the accept rule) against the JAX
    package's `_eval_entries` with the XLA probe under the scheme."""
    B, L, t_solid = 48, 100, 2
    reads, lengths = reads_with_ns(40 + k, B, L, k,
                                   err_rate=0.01 if k == 63 else 0.03)
    jp, p = params(k)
    table = _table(jp, reads, k, times=1)
    rng = np.random.default_rng(k)
    Q = 160
    ent_r = rng.integers(0, B, Q).astype(np.int32)
    ent_i = rng.integers(0, L, Q).astype(np.int32)
    ent_i[:8] = -1                              # padding entries
    ent_i[8:16] = rng.integers(0, k - 1, 8)     # window starts before the read
    last_j = (lengths - k).astype(np.int32)
    args = (t(reads).to(torch.int32), t(lengths), t(last_j))
    scores = correct_eval_scores(p, t(table).to(torch.int32), t_solid, *args,
                                 t(ent_r), t(ent_i))
    got_b, got_a = _accept(scores, args[0], t(ent_r).long(),
                           t(ent_i).long())
    ref_b, ref_a = j_eval_entries(
        jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(last_j),
        jnp.asarray(ent_r), jnp.asarray(ent_i), k,
        lambda cw, v: (jbloom.query(jp, table, cw, v) >= t_solid) & v)
    ref_a = np.asarray(ref_a)
    np.testing.assert_array_equal(n(got_a), ref_a)
    np.testing.assert_array_equal(n(got_b)[ref_a], np.asarray(ref_b)[ref_a])
    assert 0 < ref_a.sum() and int(scores.sum()) > 0


def test_run_pipeline_minimizer_matches_jax(tmp_path):
    """tests/golden/test_pipeline.py's dataset under the minimizer scheme:
    FASTQ and FASTA bytes equal to the JAX package's."""
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    fq = tmp_path / "reads.fastq"
    fq.write_bytes(make_fastq(reads))
    kw = dict(k=31, bloom_log2_width=18, bloom_hashes=4, batch_reads=128,
              max_read_len=100, exact_capacity=1 << 17,
              bucket_scheme="minimizer")
    jres = j_run_pipeline(JConfig(**kw), [str(fq)], str(tmp_path / "j.fq"),
                          str(tmp_path / "j.fa"))
    tres = run_pipeline(KmeraxConfig(**kw), [str(fq)], str(tmp_path / "t.fq"),
                        str(tmp_path / "t.fa"), device="cpu")
    assert tres == jres and jres["edited_reads"] > 0
    for ext in ("fq", "fa"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
