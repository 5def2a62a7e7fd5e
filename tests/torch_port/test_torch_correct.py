"""kmerax_torch.ops.correct == kmerax's: the plain version of kernel K3
(`_eval_entries`) against the fused Pallas kernel in interpret mode and the
XLA `_eval_entries`; `correct_batch`, with the plain window solidity and
with kernel K2's window_fn; the correct stage fed the JAX package's count
state through count_state_from_numpy, and its K2 calls. Exact: tolerance 0.
"""

import functools

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
from kmerax_torch.ops.correct import _accept, _eval_entries, correct_batch
from kmerax_torch.ops import correct_kernels
from kmerax_torch.ops.correct_kernels import correct_eval_scores
from kmerax_torch.pipeline.correct import run_correct
from kmerax_torch.pipeline.count import count_state_from_numpy, run_count
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import bloom_query_solid, \
    bloom_query_solid_plain
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, t, with_short_reads

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


def make_eval_fn(params, table, t_solid):
    """correct_batch's eval_fn scoring through the K3 wrapper."""
    def eval_fn(bases, lengths, last_j, ent_r, ent_i):
        scores = correct_eval_scores(
            params, table, t_solid, bases, lengths, last_j,
            ent_r.to(torch.int32), ent_i.to(torch.int32))
        return _accept(scores, bases, ent_r, ent_i)

    return eval_fn


def make_window_fn(params, table, t_solid):
    """correct_batch's window_fn: the round-start solidity through the K2
    wrapper, and the windows that start in [0, last_j]."""
    def window_fn(bases, last_j):
        solid = bloom_query_solid(table, bases, last_j, params, t_solid)
        j = torch.arange(solid.shape[1], dtype=torch.int32,
                         device=bases.device)
        return solid, j[None, :] <= last_j[:, None]

    return window_fn


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


@pytest.mark.parametrize("k", [25, 31, 63])
def test_correct_batch_with_k2_window_fn_matches_jax(k):
    """The card's wiring on the CPU: K2's window_fn and K3's eval_fn, no
    solid_fn; reads shorter than k included."""
    jp, table, reads, lengths, _ = _setup(k, seed=6)
    reads, lengths = with_short_reads(reads, lengths, k)
    ref, ref_ne = j_correct_batch(jnp.asarray(reads), jnp.asarray(lengths),
                                  k, 2, solid_fn=_j_solid(jp, table, 2))
    p = bloom.BloomParams(k, LW, 4)
    tt = t(table).to(torch.int32)
    got, got_ne = correct_batch(t(reads).to(torch.int8), t(lengths), k, 2,
                                None, eval_fn=make_eval_fn(p, tt, 2),
                                window_fn=make_window_fn(p, tt, 2))
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    np.testing.assert_array_equal(n(got_ne), np.asarray(ref_ne))
    assert np.asarray(ref_ne).sum() > 0


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


@pytest.mark.parametrize("rounds", [1, 2])
def test_run_correct_calls_k2_once_per_round(tmp_path, monkeypatch, rounds):
    """The round-start solidity is one K2 call on the (B, L) int32 batch
    per round per batch."""
    _, reads = ecoli_like(seed=33, genome_len=1500, coverage=20,
                          read_len=100, error_rate=0.01)
    fq = tmp_path / "r.fastq"
    fq.write_bytes(make_fastq(reads))
    calls = []

    def spy(table, bases, last_j, params, t_solid):
        calls.append((bases.dtype, tuple(bases.shape), last_j.dtype))
        return bloom_query_solid(table, bases, last_j, params, t_solid)

    monkeypatch.setattr(correct_kernels, "bloom_query_solid", spy)
    kw = dict(k=31, bloom_log2_width=16, batch_reads=64, max_read_len=100,
              exact_capacity=1 << 15, rounds=rounds)
    state = run_count(KmeraxConfig(**kw), [str(fq)], device="cpu")
    stats = run_correct(KmeraxConfig(**kw), [str(fq)], state,
                        str(tmp_path / "t.fastq"), device="cpu")
    n_batches = -(-len(reads) // 64)
    assert len(calls) == rounds * n_batches
    assert set(calls) == {(torch.int32, (64, 100), torch.int32)}
    assert stats["reads"] == len(reads) and stats["edited_reads"] > 0


# ---- the kernel step's slot grid: K2 -> K6 -> K3 over every slot -> K7 ----

SLOT_KW = dict(max_runs=3, max_edits=4)     # small, so the caps are reached


@functools.lru_cache(maxsize=None)
def _slot_batch(k, all_solid=False, seed=7):
    """(reads, lengths, JAX table) at L = 4k + 30 from a 3 kb genome whose
    reads (all inserted) make nearly every window solid at t=2; read i of
    kind i % 8 carries: 0 single errors k+2 apart (more than max_runs
    runs, past max_edits), 1 error pairs k/2 apart (more than max_cands
    candidates), 2 an error in the first three bases (left-edge run), 3 in
    the last three (right-edge run), 4 one error in a read of k+3 bases
    (whole-read-weak), 5 two errors k-2..k+1 apart (the conflict rule's
    edge), 6 an error and Ns, or a read shorter than k, 7 none."""
    rng = np.random.default_rng(seed + k)
    B, L = 48, 4 * k + 30
    genome = rng.integers(0, 4, 3000).astype(np.int32)
    clean = genome[rng.integers(0, 3000 - L, 4 * B)[:, None]
                   + np.arange(L)]
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4)
    words, valid = j_extract(jnp.asarray(clean), k)
    table = jbloom.insert(jp, jnp.zeros(jp.width, jnp.int32),
                          j_canonical(words, k)[0], valid)
    reads, lengths = clean[:B].copy(), np.full(B, L, np.int32)
    if all_solid:
        return reads, lengths, table

    def sub(i, ps):
        ps = np.asarray(ps)
        reads[i, ps] = (reads[i, ps] + rng.integers(1, 4, ps.size)) % 4

    for i in range(B):
        kind = i % 8
        if kind == 0:
            sub(i, np.arange(rng.integers(3, 10), L, k + 2))
        elif kind == 1:
            starts = np.arange(rng.integers(3, 10), L - k // 2, 2 * k)
            sub(i, np.concatenate([starts, starts + k // 2]))
        elif kind == 2:
            sub(i, [rng.integers(0, 3), L // 2])
        elif kind == 3:
            sub(i, [L - 1 - rng.integers(0, 3)])
        elif kind == 4:
            lengths[i] = k + 3
            sub(i, [5])
        elif kind == 5:
            p = rng.integers(0, L - k - 2)
            sub(i, [p, p + k - 2 + (i // 8) % 4])
        elif kind == 6 and i % 16 == 6:
            lengths[i] = rng.integers(1, k)
        elif kind == 6:
            sub(i, [rng.integers(0, L)])
            reads[i, rng.integers(0, L, 2)] = 4
    for i in range(B):
        reads[i, lengths[i]:] = 4
    return reads, lengths, table


@functools.lru_cache(maxsize=None)
def _j_slot_ref(k, rounds, all_solid=False):
    reads, lengths, table = _slot_batch(k, all_solid)
    jp = jbloom.BloomParams(k=k, log2_width=LW, num_hashes=4)
    ref, ref_ne = j_correct_batch(jnp.asarray(reads), jnp.asarray(lengths),
                                  k, 2, solid_fn=_j_solid(jp, table, 2),
                                  rounds=rounds, **SLOT_KW)
    return np.asarray(ref), np.asarray(ref_ne)


def _port_table(table, counter):
    tt = t(table).to(torch.int32)
    return tt if counter == "i32" else bloom.pack16(tt)


def _runs(solid, last_j):
    """Per read: (number of weak runs, has a left-edge run, a right-edge
    one, a whole-read one) of the (nk,) round-start solidity."""
    out = []
    for s, lj in zip(n(solid), n(last_j)):
        weak = np.zeros(len(s) + 2, bool)
        weak[1:max(lj, -1) + 2] = ~s[:max(lj, -1) + 1]
        d = np.diff(weak.astype(np.int8))
        j0, j1 = np.nonzero(d == 1)[0], np.nonzero(d == -1)[0] - 1
        out.append((len(j0), any((j0 == 0) & (j1 < lj)),
                    any((j0 > 0) & (j1 == lj)), any((j0 == 0) & (j1 == lj))))
    return out


@pytest.mark.parametrize("counter", ["i32", "p16"])
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("k", [25, 31, 33, 63])
def test_slot_step_matches_correct_batch_and_jax(k, rounds, counter):
    """The kernel step's composition on the CPU (K2's, K6's, K3's and K7's
    plain versions, K3 over every slot of the grid) == correct_batch ==
    the JAX package's correction, on reads that reach every rule."""
    reads, lengths, table = _slot_batch(k)
    tt = _port_table(table, counter)
    p = bloom.BloomParams(k, LW, 4, counter=counter)
    bases, lens = t(reads).to(torch.int8), t(lengths)
    cuda.reset_launches()
    got, got_ne = correct_kernels.make_slot_step(
        p, tt, 2, rounds=rounds, **SLOT_KW)(bases, lens)
    assert got.dtype == torch.int8 and got_ne.dtype == torch.int32
    assert sum(cuda.LAUNCHES.values()) == 0        # plain versions only
    ref, ref_ne = _j_slot_ref(k, rounds)
    np.testing.assert_array_equal(n(got), ref)
    np.testing.assert_array_equal(n(got_ne), ref_ne)
    plain, plain_ne = correct_batch(bases, lens, k, 2,
                                    _t_solid(k, t(table).to(torch.int32), 2),
                                    rounds=rounds, **SLOT_KW)
    np.testing.assert_array_equal(n(got), n(plain))
    np.testing.assert_array_equal(n(got_ne), n(plain_ne))
    # the fixture reaches every rule
    last_j = lens - k
    solid = bloom_query_solid_plain(tt, t(reads), last_j, p, 2)
    runs = _runs(solid, last_j)
    assert max(r[0] for r in runs) > SLOT_KW["max_runs"]
    assert all(any(r[i] for r in runs) for i in (1, 2, 3))
    assert (lengths < k).any() and (reads[lengths >= k] == 4).any()
    changed = (n(got) != reads).any(axis=1)
    assert changed.sum() > 8 and (ref_ne > 0).sum() == changed.sum()
    if rounds == 2:           # kind 0 passes max_edits and is reverted
        assert ((ref_ne == 0) & ~changed)[::8].any()


@pytest.mark.parametrize("k", [31, 63])
def test_slot_step_all_solid_batch(k):
    """A batch with no weak window: every slot dead in round 1, every read
    done, nothing edited, the rows returned as they came."""
    reads, lengths, table = _slot_batch(k, all_solid=True)
    p = bloom.BloomParams(k, LW, 4)
    tt = t(table).to(torch.int32)
    got, got_ne = correct_kernels.make_slot_step(
        p, tt, 2, rounds=2, **SLOT_KW)(t(reads).to(torch.int8), t(lengths))
    ref, ref_ne = _j_slot_ref(k, 2, all_solid=True)
    np.testing.assert_array_equal(n(got), ref)
    np.testing.assert_array_equal(n(got), reads)
    assert not n(got_ne).any() and not ref_ne.any()


@pytest.mark.parametrize("k", [25, 63])
def test_correct_batch_width_is_free(k):
    """correct_batch compacted to the whole slot grid (B * max_cands
    entries) == its default width: the invariant the slot grid rests on."""
    reads, lengths, table = _slot_batch(k)
    tt = t(table).to(torch.int32)
    args = (t(reads).to(torch.int8), t(lengths), k, 2, _t_solid(k, tt, 2))
    want, want_ne = correct_batch(*args, **SLOT_KW)
    got, got_ne = correct_batch(*args, width_fn=lambda q: 4 * len(reads),
                                **SLOT_KW)
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(got_ne), n(want_ne))
