"""The mesh count of kmerax_torch (pipeline/count.py::run_count_sharded on a
gloo mesh of one process per rank) against the JAX package's run_count on
the same mesh shape (its 8 CPU devices) and against the port's 1 x 1 count
(DESIGN.md §13: counts do not depend on the mesh). Exact: tolerance 0."""

import numpy as np
import pytest

import kmerax.pipeline.run as j_run
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


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/dist/test_sharded.py's reads, test_route_overflow.py's
    homopolymer reads, and those followed by > 8 batches of clean reads."""
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
    return d


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """The port's mesh counts, every mesh at once: the reads on 1x2, 2x1
    and 2x2, the skewed and the mixed reads on 1x8."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    jobs = [(mesh, {"out": str(tmp), "steps": [{
        "kind": "count", "name": f"reads_{mesh[0]}x{mesh[1]}", "cfg": CFG,
        "paths": [str(inputs / "reads.fastq")]}]}) for mesh in MESHES]
    jobs.append((SKEW_MESH, {"out": str(tmp), "steps": [
        {"kind": "count", "name": name, "cfg": SKEW_CFG,
         "paths": [str(inputs / f"{name}.fastq")]}
        for name in ("skew", "mix")]}))
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
