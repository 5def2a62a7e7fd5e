"""The graph's membership join and successor select (graph/join_kernels.py,
kernel K5 `solid_join` and its plain version): solid_edges_host on the CPU
against the JAX package's numpy join at one to four words, the plain lower
bound against the packed host search (spectrum/host.py::
searchsorted_packed) on constructed keys, and the wrapper's guards. The
kernel itself is held to the plain version on the card by chip_smoke.py
(phase 2). Exact: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerax.graph.partitioned as j_part
from kmerax.core.codec import canonical_words
from kmerax.core.kmers import extract_kmers
from kmerax.spectrum.exact import np_merge_counted
from kmerax_torch.graph import join_kernels as jk
from kmerax_torch.graph import partitioned as t_part
from kmerax_torch.spectrum.host import HostSpectrum, pack_rows, \
    searchsorted_packed
from kmerax_torch.utils import cuda, tracing
from sim import ecoli_like

KS = (15, 31, 47, 63)                   # W = 1, 2, 3, 4


@pytest.fixture(scope="module")
def spectra():
    """{k: (uniq (C, W) uint32, counts)} of a 2 kb genome and 60 reads of
    it at 1 % substitutions: the error k-mers make tips and bubbles, so
    nodes have up to four successors."""
    genome, reads = ecoli_like(seed=21, genome_len=2000, coverage=3,
                               read_len=100, error_rate=0.01)
    out = {}
    for k in KS:
        rows = []
        for seqs in (genome[None], np.stack([r.bases for r in reads])):
            words, valid = extract_kmers(jnp.asarray(seqs.astype(np.int32)),
                                         k)
            canon, _ = canonical_words(words, k)
            rows.append(np.asarray(canon)[np.asarray(valid)])
        rows = np.concatenate(rows)
        out[k] = np_merge_counted(rows, np.ones(len(rows), np.int64))
    return out


@pytest.mark.parametrize("k", KS)
def test_solid_edges_host_matches_jax(spectra, k):
    """solid_edges_host(..., "cpu", partition_rows=257) equals the JAX
    package's numpy join, every edge array, over several partitions."""
    suniq = spectra[k][0]
    assert suniq.shape[1] == (k + 15) // 16 and len(suniq) > 3 * 257
    got = t_part.solid_edges_host(suniq, k, "cpu", partition_rows=257)
    want = j_part.solid_edges_host(suniq, k, partition_rows=257)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    assert (got["outdeg"] >= 2).any()       # the select saw several hits


def _rows(rng, n: int, W: int, lo: int = 0) -> np.ndarray:
    r = rng.integers(lo, 2**32, size=(n, W), dtype=np.uint64)
    return r.astype(np.uint32)


def _sorted_unique(rows: np.ndarray) -> np.ndarray:
    return np_merge_counted(rows, np.ones(len(rows), np.int64))[0]


def _lb_case(case: str, W: int, rng):
    """(keys, queries) as (C, W) / (N, W) uint32 rows, keys sorted; the
    queries start with the least and the greatest row."""
    ends = np.concatenate([np.zeros((1, W), np.uint32),
                           np.full((1, W), 0xFFFFFFFF, np.uint32)])
    if case == "single":                  # C = 1
        keys = _rows(rng, 1, W, lo=1)
        keys[0, -1] = min(int(keys[0, -1]), 0xFFFFFFFE)
        below, above = keys.copy(), keys.copy()
        below[0, -1] -= 1
        above[0, -1] += 1
        return keys, np.concatenate([ends, below, keys, above])
    if case == "hi_runs":                 # W = 4: runs of equal hi words
        hi = _rows(rng, 6, 2)
        keys = np.concatenate([np.concatenate(
            [_rows(rng, 40, 2), np.repeat(h[None], 40, 0)], axis=1)
            for h in hi])
        keys = _sorted_unique(keys)
        lo_q = _rows(rng, 300, 2)
        hi_q = hi[rng.integers(0, len(hi), 300)]
        q = np.concatenate([
            ends, np.concatenate([lo_q, hi_q], axis=1),  # inside a run
            keys[rng.integers(0, len(keys), 100)],       # hits
            np.concatenate([lo_q[:50], _rows(rng, 50, 2)], axis=1)])
        return keys, q
    keys = _sorted_unique(_rows(rng, 200, W, lo=1))      # "ends"
    q = np.concatenate([ends, keys[:1], keys[-1:],
                        keys[rng.integers(0, len(keys), 50)],
                        _rows(rng, 100, W)])
    return keys, q


LB_CASES = [(c, W) for c in ("ends", "single") for W in (1, 2, 3, 4)] \
    + [("hi_runs", 4)]


@pytest.mark.parametrize("case,W", LB_CASES,
                         ids=[f"{c}-W{W}" for c, W in LB_CASES])
def test_lower_bound_plain_matches_searchsorted_packed(case, W):
    """Queries below the first key and above the last, equal to both ends,
    inside runs of equal high words at W = 4, and one key alone."""
    keys, q = _lb_case(case, W, np.random.default_rng([W, len(case)]))
    want = searchsorted_packed(pack_rows(keys), pack_rows(q))
    word = lambda a: torch.from_numpy(a.astype(np.int64))
    got = jk.lower_bound_plain(word(keys), word(q)).numpy()
    assert np.array_equal(got, want)
    assert 0 in want and len(keys) in want     # both ends reached


def test_cpu_assembly_launches_nothing(spectra):
    """A CPU assemble_host joins through the plain version: no K5 launch,
    and no `assemble.join_on_card` counter beside `assemble.join_queries`."""
    uniq, counts = spectra[31]
    cuda.reset_launches()
    with tracing.opened(annotate=False) as st:
        seqs = t_part.assemble_host(HostSpectrum(uniq, counts, 31), 1, 31,
                                    "cpu", partition_rows=257)
    assert seqs
    assert cuda.LAUNCHES["solid_join"] == 0
    assert st.counters["assemble.join_queries"] == 8 * len(uniq)
    assert "assemble.join_on_card" not in st.counters


def _join_args(C=40, W=2, n=8, keys_dtype=torch.int32, cand_w=None,
               out_rows=None):
    keys = torch.zeros((C, W), dtype=keys_dtype)
    cand = torch.zeros((n, 2, 4, cand_w or W), dtype=torch.int64)
    is_fwd = torch.zeros((n, 2, 4), dtype=torch.bool)
    outs = [torch.zeros((out_rows or C, 2), dtype=torch.int32)
            for _ in range(3)]
    return keys, cand, is_fwd, *outs


GUARDS = [("cuda_entry_on_cpu", jk.solid_join_cuda, {}, ValueError),
          ("keys_int64", jk.solid_join, {"keys_dtype": torch.int64},
           TypeError),
          ("cand_words", jk.solid_join, {"cand_w": 3}, ValueError),
          ("out_rows", jk.solid_join, {"out_rows": 39}, ValueError),
          ("five_words", jk.solid_join, {"W": 5}, ValueError)]


@pytest.mark.parametrize("name,fn,kw,exc", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_solid_join_guards(name, fn, kw, exc):
    """The wrapper raises before any launch (and without a card): a CPU
    tensor at the CUDA entry, a wrong dtype or shape, W > 4."""
    cuda.reset_launches()
    with pytest.raises(exc):
        fn(*_join_args(**kw), 0)
    assert cuda.LAUNCHES["solid_join"] == 0


def test_solid_join_rows_outside_the_keys():
    """Rows row0 .. row0 + n past the keys raise."""
    with pytest.raises(ValueError, match="outside"):
        jk.solid_join(*_join_args(C=40, n=8), 33)
