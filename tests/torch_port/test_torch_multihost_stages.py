"""Per-host correct and align, the replicated (`--no-shard-host-spectrum`)
assembly and the two-pass crash/resume of the port on two emulated hosts
(gloo ranks of tests/torch_port/_mesh_worker.py), against the JAX
package's single-process runs on the same paired-end input
(tests/dist/test_perhost_io.py's reads). Exact: tolerance 0 (byte
equality), and the stats equal."""

import json

import numpy as np
import pytest

from kmerax.config import KmeraxConfig as JConfig
from kmerax.graph.unitig import assemble_to_fasta
from kmerax.pipeline import checkpoint as j_ckpt
from kmerax.pipeline.run import run_align, run_count, run_pipeline
from sim import make_fastq, random_genome, simulate_pairs

from parity import run_mesh

CFG = dict(k=31, bloom_log2_width=16, batch_reads=512, max_read_len=100,
           exact_capacity=1 << 16)
N = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then every two-host job at once."""
    d = tmp_path_factory.mktemp("mh_stages")
    rng = np.random.default_rng(31)
    genome = random_genome(rng, 3000)
    r1, r2 = simulate_pairs(genome, 600, 100, 0.01, seed=32,
                            insert_mean=280, insert_sd=20)
    f1, f2 = d / "r1.fastq", d / "r2.fastq"
    f1.write_bytes(make_fastq(r1))
    f2.write_bytes(make_fastq(r2))
    ins = [str(f1), str(f2)]

    ref = {"pipeline": run_pipeline(JConfig(**CFG), ins,
                                     [str(d / "j1.fastq"),
                                      str(d / "j2.fastq")],
                                     str(d / "j.fasta"))}
    # one output for both inputs: correction is per read, so it is the
    # two paired outputs in input order
    (d / "j.fastq").write_bytes((d / "j1.fastq").read_bytes()
                                + (d / "j2.fastq").read_bytes())
    outs = [str(d / "j1.fastq"), str(d / "j2.fastq")]
    cfg63 = JConfig(**dict(CFG, k=63))
    assemble_to_fasta(cfg63, run_count(cfg63, outs), str(d / "j63.fasta"))
    ref["align"] = run_align(JConfig(**CFG), [str(d / "j.fastq")],
                             str(d / "j.fasta"), out_tsv=str(d / "j.tsv"))

    def job(mesh, *steps, **kw):
        return (mesh, {"out": str(d), "hosts": N, "steps": list(steps),
                       **kw})

    def twopass(tag):
        return {"kind": "twopass", "name": tag, "cfg": dict(CFG, k2=63),
                "paths": ins, "workdir": str(d / "ckpt"),
                "out_fastq": [str(d / "tp1.fastq"), str(d / "tp2.fastq")],
                "out_fasta": str(d / "tp.fasta")}

    run_mesh([
        job((2, 1), {"kind": "correct", "name": "paired", "cfg": CFG,
                     "paths": ins, "out_fastq": [str(d / "p1.fastq"),
                                                 str(d / "p2.fastq")]}),
        job((2, 1), {"kind": "correct", "name": "single", "cfg": CFG,
                     "paths": ins, "out_fastq": str(d / "single.fastq")}),
        job((2, 2), {"kind": "correct", "name": "routed", "cfg": CFG,
                     "paths": ins, "out_fastq": str(d / "routed.fastq")},
            budget=0),
        job((2, 1), {"kind": "count", "name": "noshard",
                     "cfg": dict(CFG, shard_host_spectrum=False),
                     "paths": ins},
            {"kind": "pipeline", "name": "noshard_pipe",
             "cfg": dict(CFG, shard_host_spectrum=False), "paths": ins,
             "out_fastq": [str(d / "n1.fastq"), str(d / "n2.fastq")],
             "out_fasta": str(d / "n.fasta")}),
        job((2, 1), twopass("fresh"),
            {"kind": "remove", "paths": [str(d / "ckpt" / "assemble.done"),
                                         str(d / "tp.fasta")]},
            twopass("resumed")),
        job((2, 1), {"kind": "align", "name": "align", "cfg": CFG,
                     "paths": [str(d / "j.fastq")],
                     "contigs": str(d / "j.fasta"),
                     "out_tsv": str(d / "t.tsv")}),
    ], d)
    return d, ref


def _hosts(d, name):
    return [json.loads((d / f"{name}_h{p}.json").read_text())
            for p in range(N)]


def _same(d, a, b):
    assert (d / a).read_bytes() == (d / b).read_bytes(), (a, b)


def test_per_host_correct_two_files(runs):
    """Two inputs, one output each (paired-end R1/R2): each host corrects
    one file on its own ranks ("fused", the replicated table) and writes
    it; the bytes and the summed stats are the JAX package's."""
    d, ref = runs
    hosts = _hosts(d, "paired")
    assert [h["shards"] for h in hosts] == [[0], [1]]
    want = {k: ref["pipeline"][k] for k in ("reads", "edited_reads",
                                            "edits")}
    for h in hosts:
        assert h["path"] == "fused" and h["stats"] == want
    _same(d, "p1.fastq", "j1.fastq")
    _same(d, "p2.fastq", "j2.fastq")


def test_per_host_correct_one_output(runs):
    """Two inputs into one output: the units are the two files, each host
    writes its part and rank 0 concatenates them in shard order: the JAX
    package's bytes, with no part left behind."""
    d, _ = runs
    assert [h["shards"] for h in _hosts(d, "single")] == [[0], [1]]
    _same(d, "single.fastq", "j.fastq")
    assert not list(d.glob("single.fastq.part*"))


def test_per_host_correct_past_budget(runs):
    """Past the replicate budget (REPLICATE_TABLE_BUDGET = 0) there is no
    replicated table: per-host correction is off and the global routed step
    corrects every batch on the 2 x 2 mesh; the parts and their
    concatenation are still the JAX package's bytes."""
    d, _ = runs
    for h in _hosts(d, "routed"):
        assert h["path"] == "routed-sharded" and h["shards"] is None
    _same(d, "routed.fastq", "j.fastq")


def test_no_shard_host_spectrum(runs):
    """shard_host_spectrum=False at N = 2: every rank holds the replicated
    host spectrum (a HostSpectrum, not a ShardedHostSpectrum) and the
    assembly's edge discovery splits over the hosts; FASTQ and FASTA are
    the JAX package's bytes."""
    d, ref = runs
    hosts = _hosts(d, "noshard")
    assert [h["host"] for h in hosts] == ["HostSpectrum"] * N
    assert hosts[0]["hist"] == hosts[1]["hist"]
    with open(d / "noshard_pipe.json") as f:
        got = json.load(f)
    assert got["result"] == ref["pipeline"]
    _same(d, "n1.fastq", "j1.fastq")
    _same(d, "n2.fastq", "j2.fastq")
    _same(d, "n.fasta", "j.fasta")


def test_two_pass_resume_from_sharded_checkpoint(runs):
    """run_two_pass k=31 -> 63 with a workdir on two hosts: every count
    stage is saved as one shard a host (host_shard manifests, readable by
    the JAX package at the same geometry), rank 0 wrote the markers, and
    the run resumed after the count_k2 checkpoint (the assemble marker and
    FASTA gone) assembles the same FASTA from the shards; both equal the
    JAX package's pass-1 FASTQ and k=63 FASTA."""
    d, _ = runs
    ck = d / "ckpt"
    assert sorted(p.name for p in ck.glob("*.done")) == \
        ["assemble.done", "correct.done", "count_k1.done", "count_k2.done"]
    for stage in ("count_k1", "count_k2"):
        for p in range(N):
            manifest, arrays = j_ckpt.load_spectrum(str(ck / stage), p, N)
            assert manifest["host_shard"] == [p, N]
            assert len(arrays["host_uniq"]) > 0
    with open(d / "resumed.json") as f:
        res = json.load(f)
    with open(d / "fresh.json") as f:
        fresh = json.load(f)
    assert res["unitigs"] == fresh["unitigs"] >= 1
    assert res["resumed"] is True
    # the two-pass job is the fifth: its ranks' logs say what resumed
    for r in range(N):
        log = (d / f"job4_r{r}.log").read_text()
        assert log.count("count_k2: resumed from checkpoint") == 1, log
    _same(d, "tp1.fastq", "j1.fastq")
    _same(d, "tp2.fastq", "j2.fastq")
    _same(d, "tp.fasta", "j63.fasta")


def test_per_host_align(runs):
    """align of one plain FASTQ on two hosts: each host aligns its
    byte-range shard with K4's plain version; the summed stats and the
    concatenated TSV are the JAX package's single-process ones."""
    d, ref = runs
    with open(d / "align.json") as f:
        assert json.load(f) == ref["align"]
    _same(d, "t.tsv", "j.tsv")
    assert not list(d.glob("t.tsv.part*"))
