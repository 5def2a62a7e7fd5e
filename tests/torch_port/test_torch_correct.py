"""kmerax_torch.ops.correct == kmerax's: the plain version of kernel K3
(`_eval_entries`) against the fused Pallas kernel in interpret mode and the
XLA `_eval_entries`; `correct_batch`; and the correct stage fed the JAX
package's count state through count_state_from_numpy. Exact: tolerance 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.ops.correct import _eval_entries as j_eval_entries
from kmerax.ops.correct import correct_batch as j_correct_batch
from kmerax.ops.pallas_correct import eval_entries_fused
from kmerax.pipeline import run_correct as j_run_correct
from kmerax.pipeline import run_count as j_run_count
from kmerax.spectrum import bloom as jbloom
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.ops.correct import _eval_entries, correct_batch
from kmerax_torch.ops.correct_kernels import correct_eval_scores, \
    make_eval_fn
from kmerax_torch.pipeline.correct import run_correct
from kmerax_torch.pipeline.count import count_state_from_numpy
from kmerax_torch.spectrum import bloom
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, t

LW = 15


def _setup(k, B=64, L=100, seed=0):
    """Reads with Ns and short reads, and the JAX-counted table (fewer
    substitutions at k=63, where 3% leaves few error-free windows)."""
    reads, lengths, errs = reads_with_ns(
        seed, B, L, k, err_rate=0.01 if k == 63 else 0.03, with_errors=True)
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4)
    words, valid = j_extract(jnp.asarray(reads), k)
    canon, _ = j_canonical(words, k)
    table = jbloom.insert(jp, jnp.zeros(jp.width, jnp.int32), canon, valid)
    return jp, table, reads, lengths, errs


def _j_solid(jp, table, t_solid):
    return lambda cw, v: (jbloom.query(jp, table, cw, v) >= t_solid) & v


def _t_solid(k, table, t_solid):
    p = bloom.BloomParams(k, LW, 4)
    return lambda cw, v: bloom.query_solid(p, table, t_solid, cw, v)


def _entries(errs, k, Q=200, seed=1):
    """Entries at random positions and at substituted bases (which the
    accept rule should fix), plus padding and boundary cases."""
    B, L = errs.shape
    rng = np.random.default_rng(seed)
    ent_r = rng.integers(0, B, Q).astype(np.int32)
    ent_i = rng.integers(0, L, Q).astype(np.int32)
    er, ei = np.nonzero(errs)
    m = min(len(er), Q // 2)
    ent_r[Q - m:], ent_i[Q - m:] = er[:m], ei[:m]
    ent_i[:10] = -1                    # padding entries
    ent_i[10:15] = 0                   # window start k-1 before the read
    ent_i[15:20] = rng.integers(1, k - 1, 5)
    ent_i[20:25] = L - 1
    return ent_r, ent_i


@pytest.mark.parametrize("k", [25, 31, 63])
def test_eval_entries_matches_fused_pallas_and_xla(k):
    L = 110 if k == 63 else 100
    jp, table, reads, lengths, errs = _setup(k, L=L)
    B = reads.shape[0]
    assert (reads == 4).sum() > (B * L - lengths.sum())    # reads carry Ns
    ent_r, ent_i = _entries(errs, k)
    t_solid = 2
    jargs = (jnp.asarray(reads), jnp.asarray(lengths),
             jnp.asarray(lengths - k), jnp.asarray(ent_r), jnp.asarray(ent_i))
    ref_b, ref_a = j_eval_entries(*jargs, k, _j_solid(jp, table, t_solid))
    fus_b, fus_a = eval_entries_fused(jp, table, t_solid, *jargs,
                                      interpret=True)
    tt = t(table).to(torch.int32)
    got_b, got_a = _eval_entries(
        t(reads).to(torch.int32), t(lengths), t(lengths - k), t(ent_r),
        t(ent_i), k, _t_solid(k, tt, t_solid))
    ref_a = np.asarray(ref_a)
    np.testing.assert_array_equal(n(got_a), ref_a)
    np.testing.assert_array_equal(n(got_a), np.asarray(fus_a))
    # best_b matters only where an edit is accepted
    np.testing.assert_array_equal(n(got_b)[ref_a], np.asarray(ref_b)[ref_a])
    np.testing.assert_array_equal(n(got_b)[ref_a], np.asarray(fus_b)[ref_a])
    assert 0 < ref_a.sum()


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k3_wrapper_cpu_is_plain_scores(k):
    """On CPU tensors the K3 wrapper returns the plain scores and counts no
    launch; its accept decisions equal the XLA path's."""
    L = 100
    jp, table, reads, lengths, errs = _setup(k, L=L, seed=2)
    ent_r, ent_i = _entries(errs, k, seed=3)
    p = bloom.BloomParams(k, LW, 4)
    tt = t(table).to(torch.int32)
    cuda.reset_launches()
    args = (t(reads).to(torch.int32), t(lengths), t(lengths - k))
    scores = correct_eval_scores(p, tt, 2, *args, t(ent_r), t(ent_i))
    assert scores.shape == (len(ent_r), 4) and scores.dtype == torch.int32
    assert int(scores.max()) <= k and int(scores.sum()) > 0
    assert cuda.LAUNCHES["correct_eval_scores"] == 0
    got_b, got_a = make_eval_fn(p, tt, 2)(*args, t(ent_r).long(),
                                          t(ent_i).long())
    ref_b, ref_a = j_eval_entries(
        jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(lengths - k),
        jnp.asarray(ent_r), jnp.asarray(ent_i), k, _j_solid(jp, table, 2))
    np.testing.assert_array_equal(n(got_a), np.asarray(ref_a))


@pytest.mark.parametrize("k", [31, 63])
def test_correct_batch_matches_jax(k):
    jp, table, reads, lengths, _ = _setup(k, seed=4)
    t_solid = 2
    ref, ref_ne = j_correct_batch(jnp.asarray(reads), jnp.asarray(lengths),
                                  k, t_solid,
                                  solid_fn=_j_solid(jp, table, t_solid))
    p = bloom.BloomParams(k, LW, 4)
    tt = t(table).to(torch.int32)
    got, got_ne = correct_batch(t(reads).to(torch.int8), t(lengths), k,
                                t_solid, _t_solid(k, tt, t_solid),
                                eval_fn=make_eval_fn(p, tt, t_solid))
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    np.testing.assert_array_equal(n(got_ne), np.asarray(ref_ne))
    assert np.asarray(ref_ne).sum() > 0
    np.testing.assert_array_equal(reads, n(t(reads)))   # input untouched


@pytest.mark.parametrize("rounds", [1, 2])
def test_correct_batch_error_pairs(rounds):
    """Two substitutions k-2 .. k+1 apart in each read: the conflict rule's
    edge (|i - i'| <= k-1 suppresses), which a single round leaves
    visible in the output."""
    k, L, B = 31, 100, 128
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 3000).astype(np.int32)
    clean = genome[rng.integers(0, 3000 - L, 4 * B)[:, None] + np.arange(L)]
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4)
    words, valid = j_extract(jnp.asarray(clean), k)
    table = jbloom.insert(jp, jnp.zeros(jp.width, jnp.int32),
                          j_canonical(words, k)[0], valid)
    reads = clean[:B].copy()
    for i in range(B):
        d = k - 2 + i % 4
        p = rng.integers(0, L - d)
        reads[i, [p, p + d]] = (reads[i, [p, p + d]]
                                + rng.integers(1, 4, 2)) % 4
    lengths = np.full(B, L, np.int32)
    ref, ref_ne = j_correct_batch(jnp.asarray(reads), jnp.asarray(lengths),
                                  k, 2, solid_fn=_j_solid(jp, table, 2),
                                  rounds=rounds)
    p = bloom.BloomParams(k, LW, 4)
    tt = t(table).to(torch.int32)
    got, got_ne = correct_batch(t(reads), t(lengths), k, 2,
                                _t_solid(k, tt, 2), rounds=rounds,
                                eval_fn=make_eval_fn(p, tt, 2))
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    np.testing.assert_array_equal(n(got_ne), np.asarray(ref_ne))


def test_run_correct_from_jax_count_state(tmp_path):
    """The correct stage alone: fed the JAX-counted table and spectrum, the
    port writes the JAX package's corrected FASTQ bytes."""
    _, reads = ecoli_like(seed=31, genome_len=2000, coverage=30,
                          read_len=100, error_rate=0.01)
    fq = tmp_path / "r.fastq"
    fq.write_bytes(make_fastq(reads))
    kw = dict(k=31, bloom_log2_width=17, batch_reads=64, max_read_len=100,
              exact_capacity=1 << 16)
    js = j_run_count(JConfig(**kw), [str(fq)])
    j_run_correct(JConfig(**kw), [str(fq)], js, str(tmp_path / "j.fastq"))
    state = count_state_from_numpy(
        KmeraxConfig(**kw), np.asarray(js.bloom_table), js.host.uniq,
        js.host.counts, js.threshold, "cpu")
    stats = run_correct(KmeraxConfig(**kw), [str(fq)], state,
                        str(tmp_path / "t.fastq"), device="cpu")
    assert (tmp_path / "t.fastq").read_bytes() == \
        (tmp_path / "j.fastq").read_bytes()
    assert stats["reads"] == len(reads) and stats["edited_reads"] > 0
