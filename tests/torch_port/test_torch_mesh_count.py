"""The mesh count of kmerax_torch (pipeline/count.py::run_count_sharded on a
gloo mesh of one process per rank) against the JAX package's run_count on
the same mesh shape (its 8 CPU devices) and against the port's 1 x 1 count
(DESIGN.md §13: counts do not depend on the mesh). Exact: tolerance 0."""

import numpy as np
import pytest

import kmerax.pipeline.run as j_run
import kmerax_torch.pipeline.count as t_count
from kmerax.config import KmeraxConfig as JConfig
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline.count import run_count
from sim import SimRead, ecoli_like, make_fastq

from parity import run_mesh

# tests/dist/test_sharded.py's sizes
CFG = dict(k=31, bloom_log2_width=16, batch_reads=128, max_read_len=100,
           exact_capacity=1 << 16)
MESHES = [(1, 2), (2, 1), (2, 2)]
# tests/dist/test_route_overflow.py's config and mesh
SKEW_CFG = dict(CFG, exact_capacity=1 << 14)
SKEW_MESH = (1, 8)
# a capacity at which the pending buffer flushes every ~9 batches on these
# meshes (every 14 in run_count): several flushes in the 30 batches of the
# long input
FLUSH_CFG = dict(CFG, exact_capacity=1 << 18)
FLUSH_MESHES = [(1, 2), (2, 2), (1, 8)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/dist/test_sharded.py's reads, test_route_overflow.py's
    homopolymer reads, those followed by > 8 batches of clean reads, and
    by 28 batches of them."""
    d = tmp_path_factory.mktemp("mesh_count")
    _, reads = ecoli_like(seed=88, genome_len=1200, coverage=25,
                          read_len=100, error_rate=0.01)
    (d / "reads.fastq").write_bytes(make_fastq(reads))
    seq = np.zeros(100, np.uint8)
    skew = make_fastq([SimRead(name=f"r{i}", bases=seq.copy(),
                               qual="I" * 100, true_bases=seq.copy(), pos=0,
                               strand=0) for i in range(256)])
    (d / "skew.fastq").write_bytes(skew)
    _, clean = ecoli_like(seed=9, genome_len=1500, coverage=90,
                          read_len=100, error_rate=0.01)
    (d / "mix.fastq").write_bytes(skew + make_fastq(clean))
    _, more = ecoli_like(seed=5, genome_len=3000, coverage=120,
                         read_len=100, error_rate=0.01)
    (d / "long.fastq").write_bytes(skew + make_fastq(more))
    return d


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """The port's mesh counts, every mesh at once: the reads on 1x2, 2x1
    and 2x2, the skewed and the mixed reads on 1x8, the long reads on
    FLUSH_MESHES."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    jobs = [(mesh, {"out": str(tmp), "steps": [{
        "kind": "count", "name": f"reads_{mesh[0]}x{mesh[1]}", "cfg": CFG,
        "paths": [str(inputs / "reads.fastq")]}]}) for mesh in MESHES]
    jobs.append((SKEW_MESH, {"out": str(tmp), "steps": [
        {"kind": "count", "name": name, "cfg": SKEW_CFG,
         "paths": [str(inputs / f"{name}.fastq")]}
        for name in ("skew", "mix")]}))
    jobs += [(mesh, {"out": str(tmp), "steps": [{
        "kind": "count", "name": f"long_{mesh[0]}x{mesh[1]}",
        "cfg": FLUSH_CFG, "paths": [str(inputs / "long.fastq")]}]})
        for mesh in FLUSH_MESHES]
    run_mesh(jobs, tmp)
    return {p.stem: dict(np.load(p)) for p in tmp.glob("*.npz")}


def _jax_count(cfg: dict, mesh, path):
    state = j_run.run_count(JConfig(mesh_data=mesh[0], mesh_bucket=mesh[1],
                                    **cfg), [path])
    return state, j_run.LAST_COUNT_RETRIES, j_run.LAST_ROUTE_SAFETY


def _same_count(got: dict, state, host=None):
    """The port's saved count == a CountState (the port's, or the JAX
    package's): table, host spectrum, histogram, threshold."""
    host = host if host is not None else state.host
    assert bool(got["has_table"])
    np.testing.assert_array_equal(got["table"],
                                  np.asarray(state.bloom_table).reshape(-1))
    np.testing.assert_array_equal(got["uniq"], host.uniq)
    np.testing.assert_array_equal(got["counts"], host.counts)
    np.testing.assert_array_equal(got["hist"], np.asarray(state.hist))
    assert int(got["threshold"]) == state.threshold
    assert int(got["n_reads"]) == state.n_reads
    assert int(got["n_kmers"]) == state.n_kmers


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_count_matches_jax_and_one_device(inputs, port_runs, mesh):
    """Table, host spectrum, histogram and threshold of the port's mesh
    count == the JAX package's run_count on the same mesh == the port's
    1 x 1 count; no route overflow on these reads."""
    path = str(inputs / "reads.fastq")
    got = port_runs[f"reads_{mesh[0]}x{mesh[1]}"]
    jstate, jretries, jsafety = _jax_count(CFG, mesh, path)
    _same_count(got, jstate)
    assert int(got["retries"]) == jretries == 0
    assert int(got["safety"]) == jsafety == 4
    one = run_count(KmeraxConfig(**CFG), [path], device="cpu")
    _same_count(got, one)


@pytest.mark.parametrize("name", ["skew", "mix"])
def test_route_overflow_replays_as_jax(inputs, port_runs, name):
    """Homopolymer reads route every k-mer to one owner and overflow the
    fair share on 1 x 8: the batch replays at a doubled route_safety as
    often as in the JAX package, the counts are the 1 x 1 counts, and after
    the clean batches of the mixed input route_safety has decayed back to
    its baseline, as the JAX package's has."""
    path = str(inputs / f"{name}.fastq")
    got = port_runs[name]
    _, jretries, jsafety = _jax_count(SKEW_CFG, SKEW_MESH, path)
    assert int(got["retries"]) == jretries >= 1
    assert int(got["safety"]) == jsafety
    if name == "mix":
        assert jsafety == 4
    one = run_count(KmeraxConfig(**SKEW_CFG), [path], device="cpu")
    _same_count(got, one)


@pytest.mark.parametrize("mesh", FLUSH_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_count_flushes_mid_stage(inputs, port_runs, mesh):
    """The pending buffer holds only valid routed rows: with a capacity
    small enough to flush it several times mid-stage, the mesh count still
    equals the JAX package's on the same mesh and the port's 1 x 1 count.
    On 1 x 2 and 2 x 2 no batch can overflow (a destination's capacity,
    route_safety 4 x n/S, is at least the n k-mers a rank sends), and the
    count merges no more often than run_count + 1 on the same reads. On
    1 x 8 the homopolymer batches overflow and replay among the flushes;
    at the doubled route_safety the reference's size rule leaves the
    buffer one worst-case batch deep, so every batch flushes until the
    capacity decays, and the +1 does not hold there."""
    path = str(inputs / "long.fastq")
    got = port_runs[f"long_{mesh[0]}x{mesh[1]}"]
    jstate, jretries, jsafety = _jax_count(FLUSH_CFG, mesh, path)
    _same_count(got, jstate)
    assert int(got["retries"]) == jretries
    assert int(got["safety"]) == jsafety
    assert (jretries >= 1) == (mesh == SKEW_MESH)
    one = run_count(KmeraxConfig(**FLUSH_CFG), [path], device="cpu")
    _same_count(got, one)
    flushes = int(got["flushes"])
    assert flushes >= 3
    if mesh != SKEW_MESH:
        assert flushes <= t_count.LAST_COUNT_FLUSHES + 1, \
            (flushes, t_count.LAST_COUNT_FLUSHES)
