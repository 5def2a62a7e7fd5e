"""kmerax_torch.spectrum and the count stage == kmerax's: the plain
versions of kernels K1 (insert) and K2 (solidity probe) against the XLA
path and the Pallas kernels in interpret mode, and run_count's table,
spectrum, histogram and threshold. Exact: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.pipeline import run_count as j_run_count
from kmerax.spectrum import bloom as jbloom
from kmerax.spectrum.pallas_bloom import insert_pallas, query_solid_pallas
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
    bloom_query_solid
from kmerax_torch.spectrum.exact import np_merge_counted
from kmerax_torch.spectrum.histogram import solid_threshold
from kmerax_torch.pipeline.count import run_count
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, t


def _canon(k, seed=0, B=100, L=100):
    reads, _ = reads_with_ns(seed, B, L, k)
    words, valid = j_extract(jnp.asarray(reads), k)
    canon, _ = j_canonical(words, k)
    return np.asarray(canon), np.asarray(valid)


@pytest.mark.parametrize("k", [25, 31, 63])
def test_insert_plain_matches_xla_and_pallas(k):
    canon, valid = _canon(k)
    jp = jbloom.BloomParams(k=k, log2_width=16, num_hashes=4)
    t0 = jnp.zeros(jp.width, jnp.int32)
    want_xla = np.asarray(jbloom.insert(jp, t0, jnp.asarray(canon),
                                        jnp.asarray(valid)))
    want_pal = np.asarray(insert_pallas(jp, t0, jnp.asarray(canon),
                                        jnp.asarray(valid), interpret=True))
    tp = bloom.BloomParams(k, 16, 4)
    table = bloom.make_table(tp, "cpu")
    bloom.insert(tp, table, t(canon), t(valid))
    np.testing.assert_array_equal(n(table), want_xla)
    np.testing.assert_array_equal(n(table), want_pal)
    assert want_xla.sum() == 4 * valid.sum()


@pytest.mark.parametrize("t_solid", [1, 3])
def test_query_solid_plain_matches_xla_and_pallas(t_solid):
    k = 31
    canon, valid = _canon(k, seed=5)
    jp = jbloom.BloomParams(k=k, log2_width=16, num_hashes=4)
    table = jbloom.insert(jp, jnp.zeros(jp.width, jnp.int32),
                          jnp.asarray(canon), jnp.asarray(valid))
    # probe with extra invalid lanes and k-mers that were never inserted
    qcanon, qvalid = _canon(k, seed=6)
    qcanon = np.concatenate([canon, qcanon])
    qvalid = np.concatenate([valid & (np.arange(valid.shape[1]) % 13 != 5),
                             qvalid])
    want = np.asarray((jbloom.query(jp, table, jnp.asarray(qcanon),
                                    jnp.asarray(qvalid)) >= t_solid)
                      & jnp.asarray(qvalid))
    got_pal = np.asarray(query_solid_pallas(jp, table, t_solid,
                                            jnp.asarray(qcanon),
                                            jnp.asarray(qvalid),
                                            interpret=True))
    got = bloom.query_solid(bloom.BloomParams(k, 16, 4), t(table), t_solid,
                            t(qcanon), t(qvalid))
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(got), got_pal)
    assert 0 < want.sum() < qvalid.sum()


def test_cpu_wrappers_take_plain_path_and_count_no_launch():
    cuda.reset_launches()
    canon, valid = _canon(31, seed=7, B=8)
    p = bloom.BloomParams(31, 12, 4)
    table = bloom.make_table(p, "cpu")
    block, lp = bloom.blocks_lanepack(p, t(canon))
    v = t(valid).reshape(-1)
    bloom_insert(table, block.reshape(-1), lp.reshape(-1), v, 4)
    solid = bloom_query_solid(table, block.reshape(-1), lp.reshape(-1), v,
                              4, 1)
    assert bool(solid[v].all()) and not bool(solid[~v].any())
    assert all(c == 0 for c in cuda.LAUNCHES.values())


def test_wrapper_rejects_bad_arguments():
    p = bloom.BloomParams(31, 12, 4)
    table = bloom.make_table(p, "cpu")
    block = torch.zeros(4, dtype=torch.int64)
    lp = torch.zeros(4, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        bloom_insert(table, block, lp, valid, 4)
    with pytest.raises(ValueError):
        bloom_insert(table, block.to(torch.int32), lp[:3], valid, 4)


def test_np_merge_counted_and_threshold():
    rng = np.random.default_rng(8)
    for w in (2, 4):
        rows = rng.integers(0, 5, size=(500, w)).astype(np.uint32)
        wts = rng.integers(1, 4, 500).astype(np.int64)
        from kmerax.spectrum.exact import np_merge_counted as j_merge
        ju, jc = j_merge(rows, wts)
        tu, tc = np_merge_counted(rows, wts)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tc, jc)
    from kmerax.spectrum.histogram import solid_threshold as j_thr
    for h in ([0, 9, 5, 3, 4, 8], [0, 5, 4, 3, 2, 1], [0, 1]):
        assert solid_threshold(h) == j_thr(h)
    assert solid_threshold([0, 5, 4], override=7) == 7


@pytest.fixture(scope="module")
def count_fastq(tmp_path_factory):
    _, reads = ecoli_like(seed=21, genome_len=3000, coverage=30,
                          read_len=100, error_rate=0.01)
    p = tmp_path_factory.mktemp("count") / "reads.fastq"
    p.write_bytes(make_fastq(reads))
    return str(p)


@pytest.mark.parametrize("k,cap", [(31, 1 << 17), (31, 1 << 13),
                                   (63, 1 << 17)])
def test_run_count_matches_jax(count_fastq, k, cap):
    """Table bytes, sorted spectrum, histogram and threshold; cap 2^13
    flushes the pending buffer after every batch."""
    kw = dict(k=k, bloom_log2_width=17, batch_reads=64, max_read_len=100,
              exact_capacity=cap)
    js = j_run_count(JConfig(**kw), [count_fastq])
    ts = run_count(KmeraxConfig(**kw), [count_fastq], device="cpu")
    np.testing.assert_array_equal(n(ts.bloom_table),
                                  np.asarray(js.bloom_table))
    np.testing.assert_array_equal(ts.host.uniq, js.host.uniq)
    np.testing.assert_array_equal(ts.host.counts, js.host.counts)
    np.testing.assert_array_equal(ts.hist, js.hist)
    assert (ts.threshold, ts.n_reads, ts.n_kmers) == \
        (js.threshold, js.n_reads, js.n_kmers)
