"""Two-pass k=31 -> k2=63 (`pipeline/twopass.py::run_two_pass`) against the
benchmark's plain reference (`benchmark/reference/`, plain torch after
DESIGN.md, importing nothing of the port), on paired reads of a genome
whose repeats of 40-60 bases make the graph branch at k = 31 and not at
63. Also: each count record carries its pass's k, and the host graph's
extension and join spans lie inside its edge span at two and four words.
Exact: every comparison's limit is 0."""

import json

import numpy as np
import pytest
import torch

from benchmark import sim
from benchmark.harness import jobs, main
from benchmark.reference import compare
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.graph.partitioned import assemble_host
from kmerax_torch.pipeline import twopass
from kmerax_torch.pipeline.run import run_pipeline
from kmerax_torch.spectrum.host import HostSpectrum
from kmerax_torch.utils import tracing

CPU = torch.device("cpu")
REPEATS = (40, 50, 60)          # repeat lengths between k = 31 and k2 = 63
# the benchmark's configuration keys (benchmark/configs/*.json) at a tiny
# size: 4,000 bp at 30x, PE150, 0.5 % substitutions
CFG = dict(k=31, k2=63, bloom_log2_width=18, exact_capacity=1 << 15,
           batch_reads=256, max_read_len=160, bloom_hashes=4, rounds=2,
           max_runs=8, max_edits=8, band=15)
GENOME, COVERAGE, READ_LEN, ERRORS = 4000, 30, 150, 0.005
STAGES = ["count", "correct", "assemble"]


def repeat_dataset(seed: int) -> sim.Dataset:
    """`benchmark/sim.py`'s pair model (insert N(450, 37)) on a random
    genome holding three copies of each of three repeats of 40, 50 and 60
    bases, the third copy reverse-complemented."""
    G, R = GENOME, READ_LEN
    rng = np.random.default_rng([seed, 7])
    genome = rng.integers(0, 4, size=G, dtype=np.int64).astype(np.uint8)
    slot = (G - 400) // (3 * len(REPEATS))
    for u, n in enumerate(REPEATS):
        unit = rng.integers(0, 4, size=n, dtype=np.int64).astype(np.uint8)
        for c in range(3):
            at = 200 + slot * (3 * c + u)
            genome[at:at + n] = unit if c < 2 else 3 - unit[::-1]
    n_pairs = (G * COVERAGE // R) // 2
    rng = np.random.default_rng([seed, 1])
    ins = np.clip(rng.normal(450, 37, n_pairs), 2 * R, G).astype(np.int64)
    pos = rng.integers(0, G - ins + 1)
    ar = np.arange(R)
    t1 = genome[pos[:, None] + ar]
    t2 = 3 - genome[(pos + ins - R)[:, None] + ar][:, ::-1]
    bases, quals, names = [], [], []
    for mate, true in ((1, t1), (2, t2)):
        errs = rng.random(true.shape) < ERRORS
        shifts = rng.integers(1, 4, true.shape).astype(np.uint8)
        bases.append(np.where(errs, (true + shifts) % 4, true)
                     .astype(np.uint8))
        quals.append((rng.integers(30, 40, true.shape) + 33)
                     .astype(np.uint8))
        names.append(np.frombuffer(b"".join(
            b"SIML1C001R%09d/%d" % (i, mate) for i in range(n_pairs)),
            np.uint8).reshape(n_pairs, -1))
    return sim.Dataset(genome, bases, quals, names)


@pytest.fixture(scope="module")
def two_pass(tmp_path_factory):
    """run_two_pass on the paired FASTQ.gz of seed 2**31 + 20 as the
    benchmark captures it, and the reference's outputs for the same
    reads."""
    d = tmp_path_factory.mktemp("twopass_ref")
    ds = repeat_dataset(2**31 + 20)
    inputs = []
    for i in range(2):
        p = str(d / f"reads_{i + 1}.fastq.gz")
        sim.write_fastq_gz(p, ds.names[i], ds.bases[i], ds.quals[i])
        inputs.append(p)
    out_fq = [str(d / f"corrected_{i + 1}.fastq") for i in range(2)]
    rec = jobs.Recorder()
    try:
        result = twopass.run_two_pass(
            KmeraxConfig(**CFG), inputs, out_fq, str(d / "contigs.fasta"),
            str(d / "metrics.jsonl"), device="cpu")
        captured, _ = rec.take()
    finally:
        rec.close()
    with open(d / "metrics.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    prog = compare.Outputs(
        [main._count_out(x) for x in captured],
        [open(p, "rb").read() for p in out_fq],
        (d / "contigs.fasta").read_bytes(), result)
    ref = compare.reference_outputs(ds, CFG, STAGES, CPU)
    return {"dir": d, "inputs": inputs, "records": records,
            "captured": captured, "prog": prog, "ref": ref}


def test_run_two_pass_equals_the_plain_reference(two_pass):
    prog, ref = two_pass["prog"], two_pass["ref"]
    assert [c.uniq.dim() for c in ref.counts] == [1, 2]
    assert ref.counts[1].uniq.shape[1] == 4          # k2 = 63: four words
    assert ref.fasta.count(b">") == 1    # the repeats resolve at k2
    checks = compare.checks(prog, ref)
    assert {"spectrum_diff", "bloom_diff", "spectrum2_diff",
            "threshold2_diff", "fastq_diff", "fasta_diff"} <= set(checks)
    assert all(v == 0 for v in checks.values()), checks
    # pass 2 counted every corrected read
    assert prog.counts[1].n_reads == prog.counts[0].n_reads == \
        2 * ((GENOME * COVERAGE // READ_LEN) // 2)


def test_count_records_carry_their_k(two_pass):
    recs = two_pass["records"]
    assert [r["stage"] for r in recs] == ["count", "correct", "count",
                                          "assemble"]
    assert [r["k"] for r in recs if r["stage"] == "count"] == \
        [CFG["k"], CFG["k2"]]
    assert all("k" not in r for r in recs if r["stage"] != "count")


def test_two_pass_assemble_record_nests_the_join_in_the_edges(two_pass):
    (rec,) = [r for r in two_pass["records"] if r["stage"] == "assemble"]
    sp, ct = rec["spans"], rec["counters"]
    assert sp["assemble.extend"][1] == sp["assemble.join"][1] == 1
    assert sp["assemble.extend"][0] + sp["assemble.join"][0] <= \
        sp["assemble.edges"][0]
    assert ct["assemble.join_queries"] == 8 * ct["assemble.solid_nodes"] > 0


@pytest.mark.parametrize("k", [31, 63])
def test_graph_spans_at_two_and_four_words(two_pass, k):
    """assemble_host over the pass's spectrum in partitions of 257 solid
    k-mers: one extension and one join a partition, both inside the edge
    span, and 8 join queries a solid k-mer."""
    (state,) = [c for c in two_pass["captured"]
                if c.uniq.shape[1] == (k + 15) // 16]
    host = HostSpectrum(state.uniq, state.counts, k)
    with tracing.opened(annotate=False) as st:
        seqs = assemble_host(host, state.threshold, k, "cpu",
                             partition_rows=257)
    assert seqs
    C = st.counters["assemble.solid_nodes"]
    parts = -(-C // 257)
    assert parts > 1
    assert st.counters["assemble.join_queries"] == 8 * C
    assert st.spans["assemble.extend"][1] == st.spans["assemble.join"][1] \
        == parts
    assert st.seconds("assemble.extend") + st.seconds("assemble.join") <= \
        st.seconds("assemble.edges")


def test_one_pass_assemble_record_at_k31(two_pass, tmp_path):
    """The one-pass pipeline's assembly (k = 31, after its re-count) has
    the same spans and counters."""
    d = tmp_path
    run_pipeline(KmeraxConfig(**{**CFG, "k2": 0}), two_pass["inputs"],
                 [str(d / "c1.fastq"), str(d / "c2.fastq")],
                 str(d / "c.fa"), str(d / "m.jsonl"), device="cpu")
    recs = [json.loads(ln) for ln in open(d / "m.jsonl")]
    assert [r["k"] for r in recs if r["stage"] == "count"] == [31, 31]
    assert (d / "c.fa").read_bytes().count(b">") > 1     # they branch
    (rec,) = [r for r in recs if r["stage"] == "assemble"]
    sp, ct = rec["spans"], rec["counters"]
    assert sp["assemble.extend"][0] + sp["assemble.join"][0] <= \
        sp["assemble.edges"][0]
    assert ct["assemble.join_queries"] == 8 * ct["assemble.solid_nodes"] > 0
