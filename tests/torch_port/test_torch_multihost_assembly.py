"""The range-sharded host spectrum and the distributed assembly of the port
on two emulated hosts (gloo ranks of tests/torch_port/_mesh_worker.py),
against the JAX package's single-process count and assembly
(tests/dist/test_shard_host_spectrum.py's cases): FASTA bytes equal at
k = 31 and 63, on a circular genome (the cycle cut) and with one host whose
key range is empty; the sharded checkpoint read across the packages both
ways. Exact: tolerance 0.

The sharding is asserted real, with the reference's band
(tests/dist/_mp_shardspec_worker.py:42-43): each host's resident spectrum
rows, solid rows and edge rows lie in 0.5/N..1.5/N of the global count,
and every exchange step delivers a host only rows it owns, at most
P x chunk."""

import json

import numpy as np
import pytest

import kmerax.spectrum.host_sharded as j_hs
from kmerax.config import KmeraxConfig as JConfig
from kmerax.graph.partitioned import assemble_host
from kmerax.graph.unitig import assemble_to_fasta
from kmerax.pipeline import checkpoint as j_ckpt
from kmerax.pipeline.run import run_count
from kmerax.spectrum.host import HostSpectrum as JHost, pack_rows
from kmerax_torch.pipeline import checkpoint as t_ckpt
from sim import SimRead, ecoli_like, make_fastq

from parity import run_mesh

CFG = dict(bloom_log2_width=16, batch_reads=512, max_read_len=100,
           exact_capacity=1 << 16)
N = 2


def _keep(keys, bounds, p):
    """The reference's rows of host p (kmerax/spectrum/host_sharded.py::
    shard_spectrum's keep rule): lo <= key < hi, the last host unbounded."""
    top = np.uint64(0xFFFFFFFFFFFFFFFF)
    two = keys.ndim == 2
    lo = (np.zeros(2, np.uint64) if two else np.uint64(0)) if p == 0 \
        else bounds[p - 1]
    hi = (np.full(2, top) if two else top) if p == N - 1 else bounds[p]
    return j_hs._keys_ge(keys, lo) & (~j_hs._keys_ge(keys, hi)
                                      | (p == N - 1))


def _jax_assembly(cfg, fq, out):
    state = run_count(cfg, [str(fq)])
    assemble_to_fasta(cfg, state, str(out))
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every two-host job at once, after the JAX references they need."""
    d = tmp_path_factory.mktemp("mh_asm")
    _, rs = ecoli_like(seed=55, genome_len=4000, coverage=30, read_len=100,
                       error_rate=0.01)
    fq = d / "reads.fastq"
    fq.write_bytes(make_fastq(rs))
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    circ = np.concatenate([genome, genome[:100]])
    reads = []
    for i in range(600):
        s = rng.integers(0, 2000)
        reads.append(SimRead(name=f"c{i}", bases=circ[s:s + 100].copy(),
                             qual="I" * 100, true_bases=circ[s:s + 100].copy(),
                             pos=int(s), strand=0))
    cq = d / "circ.fastq"
    cq.write_bytes(make_fastq(reads))

    ref = {}
    for k in (31, 63):
        ref[k] = _jax_assembly(JConfig(k=k, **CFG), fq, d / f"j{k}.fasta")
    _jax_assembly(JConfig(k=31, **CFG), cq, d / "jcirc.fasta")

    # the JAX package's sharded save of its k=31 spectrum, split at its own
    # quantile bounds for two hosts (one process: no collective needed)
    st = ref[31]
    keys = pack_rows(st.host.uniq)
    bounds = j_hs._range_boundaries(keys, N)
    jdir = d / "jax_ckpt"
    for p in range(N):
        own = _keep(keys, bounds, p)
        shard = j_hs.ShardedHostSpectrum(
            JHost(st.host.uniq[own], st.host.counts[own], 31), 31, N, p,
            bounds)
        j_ckpt.save_spectrum(str(jdir), JConfig(k=31, **CFG),
                             bloom_table=st.bloom_table, hist=st.hist,
                             threshold=st.threshold, host=shard)

    def job(mesh, **step):
        return (mesh, {"out": str(d), "hosts": N, "steps": [step]})

    run_mesh([
        job((2, 2), kind="shardspec", name="k31", cfg=dict(CFG, k=31),
            paths=[str(fq)], ckpt=str(d / "t_ckpt"), spectrum_chunk=1024),
        job((2, 1), kind="shardspec", name="k63", cfg=dict(CFG, k=63),
            paths=[str(fq)]),
        job((2, 1), kind="shardspec", name="circ", cfg=dict(CFG, k=31),
            paths=[str(cq)]),
        job((2, 1), kind="emptyrange", name="empty"),
        job((2, 1), kind="assemble_ckpt", name="from_jax", dir=str(jdir),
            out_fasta=str(d / "from_jax.fasta")),
    ], d)
    return d, ref


def _hosts(d, name):
    return [json.loads((d / f"{name}_h{p}.json").read_text())
            for p in range(N)]


@pytest.mark.parametrize("name,k", [("k31", 31), ("k63", 63)])
def test_sharded_spectrum_assembly(runs, name, k):
    """run_count on two hosts (2 x 2 at k = 31, 2 x 1 at k = 63) leaves a
    key-range shard on each leader, 0.25..0.75 of the distinct k-mers each,
    whose global histogram and threshold are the JAX package's; the
    distributed assembly writes its FASTA bytes, with each host's resident
    solid and edge rows in the same band, and every exchange step within
    P x chunk rows received, all owned by the receiver."""
    d, ref = runs
    hosts = _hosts(d, name)
    st = ref[k]
    for h in hosts:
        assert h["distinct"] == st.host.n_unique
        assert h["threshold"] == st.threshold
        assert 0.5 / N <= h["resident"] / h["distinct"] <= 1.5 / N
        s = h["stats"]
        for key in ("peak_solid_rows", "peak_edge_rows"):
            assert 0.5 / N <= s[key] / s["global_solid"] <= 1.5 / N, s
        assert s["exchange_steps"] > 0
        assert s["exchange_max_step_rows"] <= s["exchange_max_step_bound"]
        assert s["exchange_foreign_rows"] == 0
        x = h["exchange"]
        assert x["max_step_rows"] <= N * x["chunk"]
        assert x["foreign_rows"] == 0
    assert sum(h["resident"] for h in hosts) == st.host.n_unique
    assert hosts[0]["unitigs"] == hosts[1]["unitigs"]
    assert (d / f"{name}.fasta").read_bytes() == \
        (d / f"j{k}.fasta").read_bytes()


def test_shard_exchange_iterates_in_chunks(runs):
    """With 1,024 rows a step, shard_spectrum's all-to-all runs several
    steps and no step delivers a host more than N x 1,024 rows."""
    d, _ = runs
    for h in _hosts(d, "k31"):
        x = h["exchange"]
        assert x["chunk"] == 1024 and x["steps"] > 1
        assert 0 < x["max_step_rows"] <= N * 1024


def test_sharded_assembly_cycle(runs):
    """A circular genome makes the solid dBG one cycle: the distributed
    cycle detection and cut write the single-process FASTA bytes."""
    d, _ = runs
    assert (d / "circ.fasta").read_bytes() == (d / "jcirc.fasta").read_bytes()


def test_sharded_assembly_empty_range(runs):
    """Host 1's key range holds no solid row: its exchanges serve zeros and
    the FASTA equals the JAX package's single-process assembly of the same
    solid set (tests/dist/_mp_emptyrange_worker.py's genome)."""
    import jax.numpy as jnp
    from kmerax.core.codec import canonical_words
    from kmerax.core.kmers import extract_kmers
    from kmerax.spectrum.exact import np_merge_counted

    d, _ = runs
    k = 31
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 1500).astype(np.int32)
    words, valid = extract_kmers(jnp.asarray(genome[None]), k)
    canon, _ = canonical_words(words, k)
    rows = np.asarray(canon[0])[np.asarray(valid[0])]
    uniq, counts = np_merge_counted(rows, np.ones(len(rows), np.int64))
    seqs = assemble_host(JHost(uniq, counts, k), 1, k)
    want = "".join(f">unitig_{i} len={len(s)}\n{s}\n"
                   for i, s in enumerate(seqs)).encode()
    assert (d / "empty.fasta").read_bytes() == want
    assert [h["unitigs"] for h in _hosts(d, "empty")] == [len(seqs)] * N


def test_port_loads_jax_sharded_checkpoint(runs):
    """The JAX package's sharded save (spectrum.p{p}.npz, manifest.p{p}.json
    with host_shard [p, 2]) loads in the port at N = 2: each host's state is
    its ShardedHostSpectrum, and assembling from it writes the JAX
    package's FASTA bytes. At another geometry the port raises the
    reference's error."""
    d, _ = runs
    for p, h in enumerate(_hosts(d, "from_jax")):
        assert h["host"] == "ShardedHostSpectrum" and h["shard"] == [p, N]
    assert (d / "from_jax.fasta").read_bytes() == \
        (d / "j31.fasta").read_bytes()
    with pytest.raises(RuntimeError, match="geometry mismatch"):
        t_ckpt.load_spectrum(str(d / "jax_ckpt"), 1, 3)
    with pytest.raises(RuntimeError, match="geometry mismatch"):
        t_ckpt.load_spectrum(str(d / "jax_ckpt"), 0, 1)


def test_jax_loads_port_sharded_checkpoint(runs):
    """The port's sharded save (each host leader's shard) loads with
    kmerax.pipeline.checkpoint.load_spectrum(dir, p, 2): the shards hold
    exactly the JAX spectrum's rows and counts of their key ranges (the
    reference's keep rule at the port's bounds), host 0 also wrote
    manifest.json, and at another geometry the JAX package raises."""
    d, ref = runs
    st = ref[31]
    keys = pack_rows(st.host.uniq)
    for p in range(N):
        manifest, arrays = j_ckpt.load_spectrum(str(d / "t_ckpt"), p, N)
        assert manifest["host_shard"] == [p, N]
        assert manifest["npz"] == f"spectrum.p{p}.npz"
        own = _keep(keys, arrays["host_bounds"], p)
        assert np.array_equal(arrays["host_uniq"], st.host.uniq[own])
        assert np.array_equal(arrays["host_counts"], st.host.counts[own])
        assert np.array_equal(arrays["hist"], st.hist)
        assert np.array_equal(arrays["bloom_table"],
                              np.asarray(st.bloom_table))
    top = json.loads((d / "t_ckpt" / "manifest.json").read_text())
    assert top["host_shard"] == [0, N]
    with pytest.raises(RuntimeError, match="geometry mismatch"):
        j_ckpt.load_spectrum(str(d / "t_ckpt"), 0, 1)
    with pytest.raises(RuntimeError, match="geometry mismatch"):
        t_ckpt.load_spectrum(str(d / "t_ckpt"), 2, 3)
