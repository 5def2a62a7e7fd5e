"""The whole slice: kmerax_torch's batching, assembly extensions, run_pipeline
and CLI on the CPU against the JAX package's, with byte-identical corrected
FASTQ and contig FASTA (DESIGN.md §13). Exact: tolerance 0."""

import gzip
import io
import json

import numpy as np
import jax.numpy as jnp
import pytest

from kmerax.cli import main as j_main
from kmerax.config import KmeraxConfig as JConfig
from kmerax.graph.partitioned import _extensions as j_extensions
from kmerax.io.batcher import batch_reads as j_batch_reads
from kmerax.pipeline import run_pipeline as j_run_pipeline
from kmerax_torch.cli import main
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.graph.partitioned import _extensions
from kmerax_torch.io.batcher import batch_reads
from kmerax_torch.pipeline.run import run_pipeline
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq, random_genome, simulate_pairs

from parity import n, t

# tests/golden/test_pipeline.py's config and dataset
CFG = dict(k=31, bloom_log2_width=18, bloom_hashes=4, batch_reads=128,
           max_read_len=100, exact_capacity=1 << 17)


@pytest.fixture(scope="module")
def golden_fastq(tmp_path_factory):
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    p = tmp_path_factory.mktemp("pipe") / "reads.fastq"
    p.write_bytes(make_fastq(reads))
    return str(p)


def _rough_fastq(reads, rng) -> bytes:
    """FASTQ of `reads` with what the simulator never writes: Ns, lower
    case, '+name' third lines, and ragged lengths, some shorter than k."""
    buf = io.BytesIO()
    for i, r in enumerate(reads):
        seq = bytearray(r.seq.encode())
        for j in np.nonzero(rng.random(len(seq)) < 0.004)[0]:
            seq[j] = ord("N")
        if i % 7 == 3:
            seq = seq.lower()
        cut = len(seq) if i % 11 else int(rng.integers(20, len(seq)))
        plus = b"+" + r.name.encode() if i % 5 == 0 else b"+"
        buf.write(b"@%s\n%s\n%s\n%s\n" % (r.name.encode(), seq[:cut], plus,
                                           r.qual[:cut].encode()))
    return buf.getvalue()


@pytest.fixture(scope="module")
def paired_fastq(tmp_path_factory):
    rng = np.random.default_rng(404)
    genome = random_genome(rng, 2000)
    r1s, r2s = simulate_pairs(genome, 300, 100, 0.01, seed=405)
    d = tmp_path_factory.mktemp("paired")
    p1, p2 = d / "r1.fastq", d / "r2.fastq.gz"
    p1.write_bytes(_rough_fastq(r1s, rng))
    p2.write_bytes(gzip.compress(_rough_fastq(r2s, rng)))
    return [str(p1), str(p2)]


@pytest.mark.parametrize("k", [25, 31, 63])
def test_extensions_match_jax(k):
    w = (k + 15) // 16
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 2**32, size=(300, w), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, -1] &= np.uint32((1 << (2 * k - 32 * (w - 1))) - 1)
    jc, jf = j_extensions(jnp.asarray(rows), k)
    tc, tf = _extensions(t(rows), k)
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    np.testing.assert_array_equal(n(tf), np.asarray(jf))


def test_batches_match_jax(paired_fastq):
    """Native and pure-Python parsers give the JAX package's batches."""
    want = list(j_batch_reads(paired_fastq, 64, 100))
    for native in (True, False):
        got = list(batch_reads(paired_fastq, 64, 100, use_native=native))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.bases, w.bases)
            np.testing.assert_array_equal(g.lengths, w.lengths)
            assert g.n == w.n
            assert [(r.name, r.qual, r.plus) for r in g.records] == \
                [(r.name, r.qual, r.plus) for r in w.records]


def test_run_pipeline_matches_jax(golden_fastq, tmp_path):
    """Single input, single output: FASTQ and FASTA bytes equal, no kernel
    launched on the CPU."""
    jres = j_run_pipeline(JConfig(**CFG), [golden_fastq],
                          str(tmp_path / "j.fastq"), str(tmp_path / "j.fa"))
    cuda.reset_launches()
    tres = run_pipeline(KmeraxConfig(**CFG), [golden_fastq],
                        str(tmp_path / "t.fastq"), str(tmp_path / "t.fa"),
                        metrics_path=str(tmp_path / "m.jsonl"), device="cpu")
    assert tres == jres
    assert all(c == 0 for c in cuda.LAUNCHES.values())
    for ext in ("fastq", "fa"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    assert jres["edited_reads"] > 0 and jres["unitigs"] > 0
    stages = [json.loads(ln)["stage"]
              for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert stages == ["count", "correct", "count", "assemble"]


def test_cli_paired_matches_jax(paired_fastq, tmp_path, capsys):
    """R1/R2 in, one output per input (the second gzipped), through both
    CLIs: every output byte equal."""
    common = ["-k", "31", "--bloom-log2-width", "17", "--batch-reads", "128",
              "--max-read-len", "100", "--exact-capacity", str(1 << 15)]

    def outs(tag):
        return [str(tmp_path / f"{tag}_1.fastq"),
                str(tmp_path / f"{tag}_2.fastq.gz")]

    assert j_main(["pipeline", "--in", *paired_fastq, "--out-fastq",
                   *outs("j"), "--out-fasta", str(tmp_path / "j.fa"),
                   *common]) == 0
    jres = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(["pipeline", "--in", *paired_fastq, "--out-fastq",
                 *outs("t"), "--out-fasta", str(tmp_path / "t.fa"),
                 "--device", "cpu", "--no-wire-pack", *common]) == 0
    tres = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tres == jres and jres["reads"] == 600
    for a, b in zip(outs("t") + [str(tmp_path / "t.fa")],
                    outs("j") + [str(tmp_path / "j.fa")]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
