"""Unit parity of the port's multi-host pieces with the JAX package's,
called directly in one process: every io/shard function (snap_to_record on
quality lines that start with '@' included) and the batcher over byte
ranges, _emit_groups on the same chain records, the range boundaries
against kmerax.spectrum.host_sharded._range_boundaries(keys, 2) with the
port's second host holding no rows, the range owner against the
reference's keep rule, and solid_edges_host(..., n_procs=2, pid=p) for
each p; then the emulated hosts' groups (dist/mesh.py) and launch's
checks. Exact: tolerance 0."""

import gzip

import numpy as np
import pytest
import torch

import kmerax.graph.partitioned as j_part
import kmerax.graph.sharded as j_gs
import kmerax.io.batcher as j_batcher
import kmerax.io.shard as j_shard
import kmerax.spectrum.host_sharded as j_hs
import kmerax_torch.graph.partitioned as t_part
import kmerax_torch.graph.sharded as t_gs
import kmerax_torch.io.batcher as t_batcher
import kmerax_torch.io.shard as t_shard
import kmerax_torch.spectrum.host_sharded as t_hs
from kmerax.graph.unitig import chains_from_edges_np
from kmerax.spectrum.exact import np_merge_counted
from kmerax.spectrum.host import pack_rows
from kmerax_torch.dist import mesh as dmesh
from sim import ecoli_like, make_fastq


def _at_quals(n: int, seed: int) -> bytes:
    """A FASTQ of n 60-100 bp records whose quality lines often start with
    '@' (a record-start look-alike)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(60, 101))
        seq = "".join("ACGTN"[j] for j in rng.integers(0, 5, L))
        qual = "@" + "".join(chr(33 + int(j)) for j in rng.integers(0, 40,
                                                                  L - 1))
        out.append(f"@r{i} x\n{seq}\n+\n{qual}\n")
    return "".join(out).encode()


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_units")
    paths = []
    for i, n in enumerate((150, 40, 90)):
        p = d / f"f{i}.fastq"
        p.write_bytes(_at_quals(n, i))
        paths.append(str(p))
    gz = d / "g.fastq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(_at_quals(30, 9))
    return paths, str(gz)


def test_io_shard_functions_match_jax(fastqs):
    """Every io/shard function gives the JAX package's answer: the size
    assignment, the file lists, snap_to_record at every byte of a file
    whose quality lines start with '@', byte_shards, shard_size,
    all_input_shards and local_shards for 1-5 hosts, and .gz inputs kept
    whole."""
    paths, gz = fastqs
    for sizes in ([5, 3, 3, 9, 0, 1], [1], [], [7, 7, 7, 7]):
        for n in (1, 2, 3):
            assert t_shard._assign_by_size(sizes, n) == \
                j_shard._assign_by_size(sizes, n)
    size = len(open(paths[0], "rb").read())
    for off in range(0, size + 2):
        assert t_shard.snap_to_record(paths[0], off, probe=64) == \
            j_shard.snap_to_record(paths[0], off, probe=64), off
    for group in ([paths[0]], paths, paths[:2] + [gz], [gz]):
        for n in range(1, 6):
            assert t_shard.assign_paths(group, n) == \
                j_shard.assign_paths(group, n)
            assert t_shard.all_input_shards(group, n) == \
                j_shard.all_input_shards(group, n)
            for p in range(n):
                assert t_shard.local_paths(group, n, p) == \
                    j_shard.local_paths(group, n, p)
                assert t_shard.local_shards(group, n, p) == \
                    j_shard.local_shards(group, n, p)
    for n in (1, 2, 3, 7):
        shards = t_shard.byte_shards(paths[0], n)
        assert shards == j_shard.byte_shards(paths[0], n)
        assert [t_shard.shard_size(s) for s in shards] == \
            [j_shard.shard_size(s) for s in shards]
    assert t_shard.shard_size(gz) == j_shard.shard_size(gz)


@pytest.mark.parametrize("native", [False, True])
def test_batches_over_byte_ranges_match_jax(fastqs, native):
    """The port's batcher over (path, start, end) byte ranges gives the JAX
    package's batches (bases, lengths, names, qualities), on its Python
    parser and on the native one, and the ranges together give the whole
    file's records."""
    paths, _ = fastqs
    shards = t_shard.byte_shards(paths[0], 3)
    assert len(shards) == 3
    got = list(t_batcher.batch_reads(shards, 32, 100, use_native=native))
    want = list(j_batcher.batch_reads(shards, 32, 100, use_native=native))
    whole = list(t_batcher.batch_reads(paths[0], 32, 100, use_native=native))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert np.array_equal(g.bases, w.bases)
        assert np.array_equal(g.lengths, w.lengths)
        assert [r.name for r in g.records] == [r.name for r in w.records]
        assert [r.qual for r in g.records] == [r.qual for r in w.records]
    names = [r.name for b in got for r in b.records]
    assert names == [r.name for b in whole for r in b.records]


@pytest.fixture(scope="module")
def solid():
    """A 3 kb genome's solid k-mers at k = 31 and 63: {k: (C, W) uint32}."""
    import jax.numpy as jnp
    from kmerax.core.codec import canonical_words
    from kmerax.core.kmers import extract_kmers

    genome, _ = ecoli_like(seed=5, genome_len=3000, coverage=1)
    out = {}
    for k in (31, 63):
        words, valid = extract_kmers(jnp.asarray(genome[None]
                                                 .astype(np.int32)), k)
        canon, _ = canonical_words(words, k)
        rows = np.asarray(canon[0])[np.asarray(valid[0])]
        out[k] = np_merge_counted(rows, np.ones(len(rows), np.int64))[0]
    return out


@pytest.mark.parametrize("k", [31, 63])
def test_range_boundaries_match_jax(solid, k):
    """The quantile pick over the gathered per-host samples is a pure
    function: host 0 holding every key and host 1 none gives
    kmerax.spectrum.host_sharded._range_boundaries(keys, 2) of one JAX
    process; for 2-5 hosts the port's owner of each key is the host whose
    reference keep rule holds it."""
    keys = pack_rows(solid[k])
    n0, s0 = t_hs._local_sample(keys)
    n1, s1 = t_hs._local_sample(keys[:0])
    got = t_hs._pick_boundaries([n0, n1], np.stack([s0, s1]), 2,
                                keys.ndim == 2)
    assert np.array_equal(got, j_hs._range_boundaries(keys, 2))
    assert np.array_equal(t_hs._range_boundaries(keys, 2), got)
    for P in (2, 3, 5):
        bounds = j_hs._range_boundaries(keys, P)
        bounds = np.concatenate([bounds[:1], bounds])   # an empty range
        own = t_hs.owner_of(keys, bounds)
        top = np.uint64(0xFFFFFFFFFFFFFFFF)
        for p in range(P + 1):
            lo = (np.zeros(2, np.uint64) if keys.ndim == 2
                  else np.uint64(0)) if p == 0 else bounds[p - 1]
            hi = (np.full(2, top) if keys.ndim == 2 else top) \
                if p == P else bounds[p]
            keep = j_hs._keys_ge(keys, lo) & (~j_hs._keys_ge(keys, hi)
                                              | (p == P))
            assert np.array_equal(own == p, keep), (P, p)


@pytest.mark.parametrize("k", [31, 63])
def test_solid_edges_host_split_matches_jax(solid, k):
    """solid_edges_host(..., n_procs=2, pid=p) gives the JAX package's
    partial edge arrays for each p (partitions of 500 rows, split
    round-robin), and their sum finalizes to the one-process edges."""
    suniq = solid[k]
    parts = []
    for p in range(2):
        got = t_part.solid_edges_host(suniq, k, "cpu", 500, n_procs=2, pid=p)
        want = j_part.solid_edges_host(suniq, k, 500, n_procs=2, pid=p)
        for key in ("succ_v", "succ_o", "outdeg"):
            assert np.array_equal(got[key], want[key]), (p, key)
        parts.append(got)
    whole = t_part.solid_edges_host(suniq, k, "cpu", 500)
    summed = t_part.finalize_edges({key: parts[0][key] + parts[1][key]
                                    for key in ("succ_v", "succ_o",
                                                "outdeg")})
    for key in whole:
        assert np.array_equal(summed[key], whole[key]), key


@pytest.mark.parametrize("k", [31, 63])
def test_emit_groups_matches_jax(solid, k):
    """_emit_groups on the emission records of one host's chains (the
    records assemble_sharded routes: [end, dist, last_base, flags] and the
    start elements' head words) gives the JAX package's sequences."""
    suniq = solid[k]
    C, W = suniq.shape
    edges = j_part.solid_edges_host(suniq, k)
    a = chains_from_edges_np(suniq, np.ones(C, bool), edges, k)
    enc = np.arange(2 * C, dtype=np.int64)
    flags = (a["is_start"].astype(np.int64)
             | (a["was_cycle"].astype(np.int64) << 1) | ((enc & 1) << 2))
    rec = np.stack([a["end"], a["dist"], a["last_base"].astype(np.int64),
                    flags], axis=1)
    st = np.nonzero(a["is_start"])[0]
    heads = np.concatenate([a["end"][st][:, None], enc[st][:, None],
                            suniq[st // 2].astype(np.int64)], axis=1)
    got = t_gs._emit_groups(rec, heads, k, W)
    assert got == j_gs._emit_groups(rec, heads, k, W)
    assert len(got) >= 1
    assert t_gs._emit_groups(rec[:0], heads[:0], k, W) == []


def test_emulated_hosts_groups():
    """Two hosts of a 2 x 2 mesh emulated in one launch (host=None): ranks
    r = p·G + l with G = 2, every rank in the lockstep gather with each
    leader's entry kept, 64-bit values whole across host_allgather, and
    host_exchange delivering each block to its owner alone."""
    from parity import hosts_probe

    dmesh.LAUNCH_TIMEOUT, old = 300, dmesh.LAUNCH_TIMEOUT
    try:
        got = dmesh.launch(dmesh.MeshSpec(2, 2), "cpu", hosts_probe,
                           (1 << 62) + 7, n_hosts=2, host=None)
    finally:
        dmesh.LAUNCH_TIMEOUT = old
    assert (got["host"], got["local_rank"], got["leader"]) == (0, 0, True)
    assert (got["index"], got["count"]) == (0, 2)
    assert got["flags"] == [[0, 0], [2, 1]]
    assert got["gathered"] == [[(1 << 62) + 7], [(1 << 62) + 8]]
    assert got["received"] == [[[0, 0]], [[1, 0]]]


@pytest.mark.parametrize("kw,match", [
    (dict(spec=(1, 1), n_hosts=2, host=0), "does not divide over 2"),
    (dict(spec=(2, 2), n_hosts=2, host=2), r"process id 2 outside \[0, 2\)"),
    (dict(spec=(2, 2), n_hosts=2, host=0), "need a coordinator"),
    (dict(spec=(2, 2), n_hosts=2, host=0, device="cuda"),
     "over 2 processes needs 2 local devices, have 0")])
def test_launch_checks(kw, match):
    """launch refuses, before it starts a rank: a mesh that does not split
    over the hosts, a process id outside [0, N), several hosts without a
    coordinator, and more local ranks than the host's cards (never a
    shared card or a fall-back)."""
    if kw.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = dmesh.MeshSpec(*kw.pop("spec"))
    with pytest.raises(ValueError, match=match):
        dmesh.launch(spec, kw.pop("device", "cpu"), print, **kw)
