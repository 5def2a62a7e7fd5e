"""kmerax_torch.spectrum and the count stage == kmerax's: the plain
insert inside kernel K1, the plain probe and the plain version of K2 (the
correct round's window solidity) against the XLA path and the Pallas
kernels in interpret mode, and run_count's table, spectrum, histogram and
threshold. Exact: tolerance 0."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.ops.correct import _window_counts as j_window_counts
from kmerax.pipeline import run_count as j_run_count
from kmerax.spectrum import bloom as jbloom
from kmerax.spectrum.pallas_bloom import insert_pallas, query_solid_pallas
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
    bloom_insert, bloom_query_solid, bloom_query_solid_plain, insert_plain
from kmerax_torch.spectrum.exact import SENTINEL_WORD, np_merge_counted, \
    spectrum_to_host
from kmerax_torch.spectrum.histogram import solid_threshold
from kmerax_torch.pipeline import count as count_mod
from kmerax_torch.pipeline.count import run_count
from kmerax_torch.utils.metrics import MetricsWriter
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, t, with_short_reads


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
    block, lp = blocks_lanepack(tp, t(canon))
    insert_plain(table, block.reshape(-1), lp.reshape(-1),
                 t(valid).reshape(-1), 4)
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


def k2_case(k, seed, B=32, L=100, LW=15, t_solid=2):
    """A table holding the k-mers of half the reads, and the other half
    fresh; Ns, ragged lengths and two reads shorter than k. Returns
    (JAX params, JAX table, reads, lengths, last_j)."""
    reads, lengths = reads_with_ns(seed, B, L, k, n_rate=0.01,
                                   err_rate=0.01)
    reads, lengths = with_short_reads(reads, lengths, k)
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4)
    words, valid = j_extract(jnp.asarray(reads[:B // 2]), k)
    table = jbloom.insert(jp, jnp.zeros(jp.width, jnp.int32),
                          j_canonical(words, k)[0], valid)
    table = jbloom.insert(jp, table, j_canonical(words, k)[0], valid)
    return jp, table, reads, lengths, (lengths - k).astype(np.int32)


def j_window_solid(jp, table, reads, last_j, t_solid):
    """The JAX package's round-start solidity, `_window_counts(...)[0]`,
    with the Pallas probe in interpret mode."""
    solid, _ = j_window_counts(
        jnp.asarray(reads), jnp.asarray(last_j), jp.k,
        lambda cw, v: query_solid_pallas(jp, table, t_solid, cw, v,
                                         interpret=True))
    return np.asarray(solid)


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k2_plain_matches_jax_window_counts(k):
    jp, table, reads, lengths, last_j = k2_case(k, 70 + k)
    want = j_window_solid(jp, table, reads, last_j, 2)
    p = bloom.BloomParams(k, 15, 4)
    got = bloom_query_solid_plain(t(table), t(reads), t(last_j), p, 2)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(n(got), want)
    assert 0 < want.sum() < (last_j + 1).clip(0).sum()
    assert not want[1:3].any()                   # reads shorter than k


def test_cpu_wrappers_take_plain_path_and_count_no_launch():
    cuda.reset_launches()
    reads, lengths = reads_with_ns(7, 8, 100, 31)
    canon, valid = _canon(31, seed=7, B=8)
    p = bloom.BloomParams(31, 12, 4)
    table = bloom.make_table(p, "cpu")
    n_valid = bloom_insert(table, t(reads).to(torch.int8), p)
    assert int(n_valid) == valid.sum()
    last_j = t(lengths - 31)
    solid = bloom_query_solid(table, t(reads), last_j, p, 1)
    existing = torch.arange(70)[None, :] <= last_j[:, None]
    assert torch.equal(solid, t(valid) & existing)
    assert torch.equal(solid, bloom_query_solid_plain(table, t(reads),
                                                      last_j, p, 1))
    assert all(c == 0 for c in cuda.LAUNCHES.values())


def _k2_args():
    p = bloom.BloomParams(31, 12, 4)
    return dict(table=bloom.make_table(p, "cpu"),
                bases=torch.zeros((4, 40), dtype=torch.int32),
                last_j=torch.full((4,), 9, dtype=torch.int32), params=p,
                t=1)


@pytest.mark.parametrize("bad,err", [
    (dict(table=torch.zeros(1 << 12, dtype=torch.int64)), TypeError),
    (dict(table=torch.zeros(1 << 13, dtype=torch.int32)), ValueError),
    (dict(bases=torch.zeros((4, 40), dtype=torch.int8)), TypeError),
    (dict(bases=torch.zeros(160, dtype=torch.int32)), ValueError),
    (dict(bases=torch.zeros((4, 30), dtype=torch.int32)), ValueError),
    (dict(bases=torch.zeros((40, 4), dtype=torch.int32).t()), ValueError),
    (dict(last_j=torch.zeros(4, dtype=torch.int64)), TypeError),
    (dict(last_j=torch.zeros(3, dtype=torch.int32)), ValueError),
])
def test_wrapper_rejects_bad_arguments(bad, err):
    """K2's wrapper; K1's is test_torch_bloom_insert.py's."""
    args = _k2_args()
    bloom_query_solid(**args)            # the good arguments pass
    args.update(bad)
    with pytest.raises(err):
        bloom_query_solid(**args)


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


@pytest.mark.parametrize("k", [15, 31, 33, 63])
def test_run_count_merges_on_the_device(count_fastq, tmp_path, k):
    """A count of 3000 bp at 30x whose capacity of 2^13 merges the pending
    rows after every 64-read batch: every flush merges on the device
    (`count.resident_flushes` == LAST_COUNT_FLUSHES), each merge equals
    the host merge of the same rows, `count.merge_rows` is the host path's
    sum, and the spectrum, histogram and threshold are the JAX package's."""
    kw = dict(k=k, bloom_log2_width=17, batch_reads=64, max_read_len=100,
              exact_capacity=1 << 13)
    merged = []
    merge = count_mod.merge_pending

    def checked(keys, counts, pending):
        w = pending.shape[1]
        uniq, cnt = spectrum_to_host(keys, counts, w)
        new = pending.numpy().view(np.uint32)
        new = new[~np.all(new == SENTINEL_WORD, axis=1)]
        rows = np.concatenate([uniq, new])
        want = np_merge_counted(rows, np.concatenate(
            [cnt, np.ones(len(new), np.int64)]))
        out = merge(keys, counts, pending)
        for got, exp in zip(spectrum_to_host(*out[:2], w), want):
            np.testing.assert_array_equal(got, exp)
        merged.append(len(rows))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(count_mod, "merge_pending", checked)
        mp.setattr(count_mod, "np_merge_counted", None)  # not on this path
        ts = run_count(KmeraxConfig(**kw), [count_fastq], device="cpu",
                       metrics=MetricsWriter(str(tmp_path / "m.jsonl")))
    js = j_run_count(JConfig(**kw), [count_fastq])
    flushes = count_mod.LAST_COUNT_FLUSHES
    assert flushes == len(merged) >= 3
    (rec,) = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert rec["counters"] == {"count.resident_flushes": flushes,
                               "count.merge_rows": sum(merged)}
    assert rec["spans"]["count.flush"][1] == flushes
    assert ts.host.uniq.dtype == np.uint32
    np.testing.assert_array_equal(ts.host.uniq, js.host.uniq)
    np.testing.assert_array_equal(ts.host.counts, js.host.counts)
    np.testing.assert_array_equal(ts.hist, js.hist)
    assert (ts.threshold, ts.n_reads, ts.n_kmers) == \
        (js.threshold, js.n_reads, js.n_kmers)
