"""The exact spectrum: the count's device merge of pending rows
(`merge_pending`) against the host merge, and correction against the
spectrum (`correct --use-exact`): the port's word-by-word binary search of
the sentinel-padded sorted spectrum and its padded form against the JAX
package's, and the CLI's corrected FASTQ byte for byte. Exact: tolerance
0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmerax.cli import main as j_main
from kmerax.spectrum.exact import lookup_sorted as j_lookup_sorted
from kmerax.spectrum.exact import searchsorted_words as j_searchsorted
from kmerax.spectrum.host import HostSpectrum as JHostSpectrum
from kmerax_torch.cli import main
from kmerax_torch.spectrum.exact import SENTINEL_WORD, lookup_sorted, \
    merge_pending, np_merge_counted, rows_to_keys, searchsorted_words, \
    spectrum_to_host
from kmerax_torch.spectrum.host import HostSpectrum
from sim import ecoli_like, make_fastq

from parity import n, run_clis, t


def _rows(rng, n_rows, k):
    w = (k + 15) // 16
    rows = rng.integers(0, 2**32, size=(n_rows, w), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, -1] &= np.uint32((1 << (2 * k - 32 * (w - 1))) - 1)
    return rows


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("k", [15, 25, 31, 33, 47, 49, 63])
def test_merge_pending_equals_host_merge(k, resident):
    """merge_pending == np_merge_counted to the byte (rows, counts, dtype,
    order) on pending rows with repeats, rows already resident, sentinel
    rows and, at W >= 3, lo words with the top bit set and clear, onto an
    empty or a resident spectrum."""
    rng = np.random.default_rng(k + 100 * resident)
    w = (k + 15) // 16
    base = _rows(rng, 60, k)
    if resident:
        r = np.concatenate([base, _rows(rng, 200, k)])
        uniq, counts = np_merge_counted(r, rng.integers(1, 9, len(r)))
    else:
        uniq, counts = base[:0], np.zeros(0, np.int64)
    pend = np.concatenate([
        base[rng.integers(0, len(base), 400)], _rows(rng, 150, k),
        np.full((50, w), SENTINEL_WORD, np.uint32)])
    if w >= 3:
        pend[:100, 1] |= np.uint32(1 << 31)
        pend[100:200, 1] &= np.uint32((1 << 31) - 1)
    pend = pend[rng.permutation(len(pend))]
    keys = rows_to_keys(torch.from_numpy(uniq.view(np.int32)))
    got_k, got_c, n_rows = merge_pending(
        keys, torch.from_numpy(counts), torch.from_numpy(pend.view(np.int32)))
    new = pend[~np.all(pend == SENTINEL_WORD, axis=1)]
    rows = np.concatenate([uniq, new])
    want_u, want_c = np_merge_counted(
        rows, np.concatenate([counts, np.ones(len(new), np.int64)]))
    got_u, got_c = spectrum_to_host(got_k, got_c, w)
    assert (got_u.dtype, got_c.dtype) == (np.uint32, np.int64)
    assert got_u.flags.c_contiguous and got_u.shape == want_u.shape
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_array_equal(got_c, want_c)
    assert n_rows == len(rows)
    assert want_c.sum() > len(want_c)           # repeats merged


@pytest.mark.parametrize("k", [25, 31, 63])
def test_search_and_lookup_match_jax(k):
    """A sorted spectrum of 300 rows padded to 512 with sentinel rows;
    queries: every row, rows between them, below the first, above the
    last, all-zero, and the sentinel itself."""
    rng = np.random.default_rng(k)
    uniq, counts = np_merge_counted(_rows(rng, 300, k),
                                    rng.integers(1, 50, 300))
    host = HostSpectrum(uniq, counts, k)
    pu, pc, pn = host.padded(512)
    ju, jc, jn = JHostSpectrum(uniq, counts, k).to_device(512)
    np.testing.assert_array_equal(pu, np.asarray(ju))
    np.testing.assert_array_equal(pc, np.asarray(jc))
    assert pc.dtype == np.int32 and int(pn) == int(jn) == len(uniq)
    tu, tc, tn = host.to_device(512, "cpu")
    np.testing.assert_array_equal(n(tu), np.asarray(ju).astype(np.int64))
    assert tn == len(uniq)

    q = np.concatenate([
        uniq, _rows(rng, 200, k), uniq[:40] ^ np.uint32(1),
        np.zeros((1, uniq.shape[1]), np.uint32),
        np.full((2, uniq.shape[1]), SENTINEL_WORD, np.uint32),
        np.repeat(uniq[-1:], 2, axis=0)])
    q[-1, 0] += np.uint32(1)                     # just above the last row
    q = q.reshape(-1, 5, uniq.shape[1])          # batch dims carry through
    jidx, jfound = j_searchsorted(ju, jnp.asarray(q))
    idx, found = searchsorted_words(tu, t(q))
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    np.testing.assert_array_equal(n(found), np.asarray(jfound))
    jcnt, _ = j_lookup_sorted(ju, jc, jnp.asarray(q))
    cnt, _ = lookup_sorted(tu, tc, t(q))
    np.testing.assert_array_equal(n(cnt), np.asarray(jcnt))
    assert 0 < n(found).sum() < found.numel()


@pytest.fixture(scope="module")
def golden_fastq(tmp_path_factory):
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    p = tmp_path_factory.mktemp("exact") / "reads.fastq"
    p.write_bytes(make_fastq(reads))
    return str(p)


# a 2^15-counter Bloom table: its false positives make Bloom correction
# differ from exact correction
COMMON = ["-k", "31", "--bloom-log2-width", "15", "--batch-reads", "128",
          "--max-read-len", "100", "--exact-capacity", str(1 << 17)]


@pytest.mark.parametrize("spectrum", [False, True])
def test_use_exact_matches_jax(golden_fastq, tmp_path, spectrum):
    """`correct --use-exact` counting first, or on a `count` checkpoint:
    FASTQ bytes equal to the JAX package's, and not the Bloom's."""
    src = []
    if spectrum:
        run_clis(["count", "--in", golden_fastq, "--out",
                  str(tmp_path / "{pkg}_spec"), *COMMON])
        src = ["--spectrum", str(tmp_path / "{pkg}_spec")]
    jres, tres = run_clis([
        "correct", "--in", golden_fastq, "--out",
        str(tmp_path / "{pkg}.fastq"), "--use-exact", *src, *COMMON])
    assert tres == jres and jres["edited_reads"] > 0
    got = (tmp_path / "t.fastq").read_bytes()
    assert got == (tmp_path / "j.fastq").read_bytes()
    run_clis(["correct", "--in", golden_fastq, "--out",
              str(tmp_path / "{pkg}_bloom.fastq"), *COMMON])
    assert got != (tmp_path / "t_bloom.fastq").read_bytes()


def test_use_exact_past_capacity_raises_as_jax(golden_fastq, tmp_path):
    argv = ["correct", "--in", golden_fastq, "--out",
            str(tmp_path / "x.fastq"), "--use-exact", *COMMON,
            "--exact-capacity", str(1 << 12)]
    with pytest.raises(ValueError, match="exact spectrum not built"):
        j_main(argv)
    with pytest.raises(ValueError, match="exact spectrum not built"):
        main([*argv, "--device", "cpu"])
