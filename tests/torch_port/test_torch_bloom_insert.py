"""Kernel K1 as the count step calls it: `bloom_insert` on the (B, L) int8
read batch, whose CPU path is the plain version, against the JAX package's
count step (kmerax/pipeline/run.py::_count_steps: bloom_step and
pend_append); the wrapper's argument checks; and run_count's one call per
batch. Exact: tolerance 0 (every output is an integer)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax.pipeline.run import _count_steps as j_count_steps
from kmerax.spectrum.exact import sentinel_rows as j_sentinel_rows
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline import count as count_mod
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import bloom_insert
from kmerax_torch.spectrum.exact import sentinel_rows
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, t


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k1_plain_matches_jax_count_step(k):
    """Two batches with Ns and ragged lengths into one table, their rows
    written from nonzero offsets of one pending buffer."""
    B, L = 32, 100
    reads, lengths = reads_with_ns(60 + k, 2 * B, L, k, n_rate=0.01)
    pend_rows = B * (L - k + 1)
    kw = dict(k=k, bloom_log2_width=16, batch_reads=B, max_read_len=L,
              exact_capacity=2 * 3 * pend_rows)
    jparams, bloom_step, pend_append, _, P, jrows = j_count_steps(
        JConfig(**kw), k)
    assert (P, jrows) == (3 * pend_rows, pend_rows)
    W = (k + 15) // 16
    jtable = jnp.zeros(jparams.width, jnp.int32)
    jpend = j_sentinel_rows(P, W)
    p = bloom.BloomParams(k, 16, 4)
    table = bloom.make_table(p, "cpu")
    pending = sentinel_rows(P, W, "cpu")
    cuda.reset_launches()
    for i, off in enumerate((pend_rows, 2 * pend_rows)):
        rows = reads[i * B:(i + 1) * B].astype(np.int8)
        lens = lengths[i * B:(i + 1) * B]
        jtable, jn = bloom_step(jtable, jnp.asarray(rows), jnp.asarray(lens))
        jpend = pend_append(jpend, off, jnp.asarray(rows), jnp.asarray(lens))
        got_n = bloom_insert(table, t(rows), p, pending, off)
        assert got_n.dtype == torch.int64 and got_n.dim() == 0
        assert int(got_n) == int(jn)
    np.testing.assert_array_equal(n(table), np.asarray(jtable))
    np.testing.assert_array_equal(n(pending).view(np.uint32),
                                  np.asarray(jpend))
    assert (n(pending)[:pend_rows] == -1).all()        # rows before `off`
    assert 0 < int(jn) < pend_rows                     # Ns and padding
    assert all(c == 0 for c in cuda.LAUNCHES.values())


def test_k1_without_pending_counts_the_same():
    k, B, L = 31, 16, 90
    reads, _ = reads_with_ns(5, B, L, k)
    p = bloom.BloomParams(k, 14, 4)
    t1, t2 = bloom.make_table(p, "cpu"), bloom.make_table(p, "cpu")
    pending = sentinel_rows(B * (L - k + 1), 2, "cpu")
    n1 = bloom_insert(t1, t(reads).to(torch.int8), p)
    n2 = bloom_insert(t2, t(reads).to(torch.int8), p, pending, 0)
    assert int(n1) == int(n2) and torch.equal(t1, t2)
    assert int(t1.sum()) == 4 * int(n1)


def _k1_args():
    p = bloom.BloomParams(31, 12, 4)
    return dict(table=bloom.make_table(p, "cpu"),
                bases=torch.zeros((4, 40), dtype=torch.int8), params=p,
                pending=sentinel_rows(4 * 10, 2, "cpu"), off=0)


@pytest.mark.parametrize("bad,err", [
    (dict(table=torch.zeros(1 << 12, dtype=torch.int64)), TypeError),
    (dict(table=torch.zeros(1 << 13, dtype=torch.int32)), ValueError),
    (dict(bases=torch.zeros((4, 40), dtype=torch.int32)), TypeError),
    (dict(bases=torch.zeros(160, dtype=torch.int8)), ValueError),
    (dict(bases=torch.zeros((4, 30), dtype=torch.int8)), ValueError),
    (dict(bases=torch.zeros((40, 4), dtype=torch.int8).t()), ValueError),
    (dict(pending=torch.zeros((40, 2), dtype=torch.int64)), TypeError),
    (dict(pending=torch.zeros((40, 3), dtype=torch.int32)), ValueError),
    (dict(off=1), ValueError),
    (dict(off=-1), ValueError),
])
def test_k1_wrapper_rejects_bad_arguments(bad, err):
    args = _k1_args()
    bloom_insert(**args)                 # the good arguments pass
    args.update(bad)
    with pytest.raises(err):
        bloom_insert(**args)


def test_run_count_calls_k1_once_per_batch(tmp_path, monkeypatch):
    """The count step is one K1 call on the (B, L) int8 batch as it
    crossed to the device, with the pending buffer when the exact spectrum
    is on."""
    _, reads = ecoli_like(seed=23, genome_len=1500, coverage=20,
                          read_len=100, error_rate=0.01)
    fq = tmp_path / "r.fastq"
    fq.write_bytes(make_fastq(reads))
    calls = []

    def spy(table, bases, params, pending=None, off=0):
        calls.append((bases.dtype, tuple(bases.shape), pending is not None,
                      off))
        return bloom_insert(table, bases, params, pending, off)

    monkeypatch.setattr(count_mod, "bloom_insert", spy)
    cfg = KmeraxConfig(k=31, bloom_log2_width=16, batch_reads=64,
                       max_read_len=100, exact_capacity=1 << 15)
    state = count_mod.run_count(cfg, [str(fq)], device="cpu")
    n_batches = -(-len(reads) // 64)
    assert len(calls) == n_batches
    assert {c[:3] for c in calls} == {(torch.int8, (64, 100), True)}
    rows = 64 * 70                       # a flush every 3 batches
    assert [c[3] for c in calls] == [0, rows, 2 * rows, 0, rows]
    assert state.n_kmers == sum(len(r.seq) - 30 for r in reads)
