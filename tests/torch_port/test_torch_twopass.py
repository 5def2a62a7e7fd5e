"""Two-pass k=31 -> k2=63 (port of tests/golden/test_twopass.py):
`pipeline --k2` and `run_two_pass` of kmerax_torch against the JAX
package's, byte for byte, and crash/resume at two crash points giving the
uninterrupted run's bytes. Exact: tolerance 0."""

import json

import numpy as np
import pytest

from kmerax.config import KmeraxConfig as JConfig
from kmerax.pipeline.checkpoint import load_spectrum as j_load_spectrum
from kmerax.pipeline.twopass import run_two_pass as j_run_two_pass
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline import twopass
from kmerax_torch.pipeline.checkpoint import load_spectrum
from kmerax_torch.pipeline.count import run_count
from sim import ecoli_like, make_fastq

from parity import run_clis

CFG = dict(k=31, k2=63, bloom_log2_width=17, batch_reads=128,
           max_read_len=100, exact_capacity=1 << 17)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/golden/test_twopass.py's reads, and the JAX package's
    run_two_pass of them with a workdir: (FASTQ path, its result, output
    dir)."""
    _, reads = ecoli_like(seed=101, genome_len=1500, coverage=35,
                          read_len=100, error_rate=0.008)
    d = tmp_path_factory.mktemp("tp")
    p = d / "reads.fastq"
    p.write_bytes(make_fastq(reads))
    res = j_run_two_pass(JConfig(**CFG), [str(p)], str(d / "j.fastq"),
                         str(d / "j.fasta"), workdir=str(d / "jwork"))
    return str(p), res, d


def test_pipeline_k2_matches_jax(dataset, tmp_path):
    path, _, _ = dataset
    jres, tres = run_clis([
        "pipeline", "--in", path, "--out-fastq", str(tmp_path / "{pkg}.fq"),
        "--out-fasta", str(tmp_path / "{pkg}.fa"), "--k2", "63", "-k", "31",
        "--bloom-log2-width", "17", "--batch-reads", "128",
        "--max-read-len", "100", "--exact-capacity", str(1 << 17),
        "--validate", "--metrics", str(tmp_path / "{pkg}.jsonl")])
    assert tres == jres
    assert jres["threshold_k1"] >= 2 and jres["threshold_k2"] >= 2
    assert "validate" not in tres          # --validate is not run with --k2
    for ext in ("fq", "fa"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    stages = [json.loads(ln)["stage"]
              for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert stages == ["count", "correct", "count", "assemble"]


def test_run_two_pass_workdir_matches_jax(dataset, tmp_path):
    """Same result and bytes as the JAX package's run, and the same
    checkpoints: manifests and npz arrays of both count stages."""
    path, jres, d = dataset
    wd = tmp_path / "work"
    res = twopass.run_two_pass(KmeraxConfig(**CFG), [path],
                               str(tmp_path / "t.fastq"),
                               str(tmp_path / "t.fasta"), workdir=str(wd),
                               device="cpu")
    assert res == jres
    assert (tmp_path / "t.fastq").read_bytes() == \
        (d / "j.fastq").read_bytes()
    assert (tmp_path / "t.fasta").read_bytes() == \
        (d / "j.fasta").read_bytes()
    for stage in ("count_k1", "count_k2"):
        jm, ja = j_load_spectrum(str(d / "jwork" / stage))
        tm, ta = load_spectrum(str(wd / stage))
        assert tm == jm and sorted(ta) == sorted(ja)
        for name in ja:
            assert ta[name].dtype == ja[name].dtype, name
            np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    assert sorted(p.name for p in wd.glob("*.done")) == sorted(
        p.name for p in (d / "jwork").glob("*.done"))


@pytest.mark.parametrize("crash", ["correct", "assemble"])
def test_crash_resume_bit_identical(dataset, tmp_path, monkeypatch, crash):
    """A crash after the count_k1 checkpoint (in correct) or after the
    count_k2 checkpoint (in assemble); the resume gives the uninterrupted
    run's bytes, and a third run changes nothing."""
    path, _, d = dataset
    cfg = KmeraxConfig(**CFG)
    wd = tmp_path / "work"
    fq, fa = tmp_path / "r.fastq", tmp_path / "r.fasta"
    target = {"correct": "run_correct", "assemble": "assemble_to_fasta"}
    orig = getattr(twopass, target[crash])

    def boom(*a, **kw):
        raise RuntimeError("injected host failure")

    monkeypatch.setattr(twopass, target[crash], boom)
    with pytest.raises(RuntimeError, match="injected"):
        twopass.run_two_pass(cfg, [path], str(fq), str(fa), workdir=str(wd),
                             device="cpu")
    done = {"correct": ["count_k1.done"],
            "assemble": ["correct.done", "count_k1.done", "count_k2.done"]}
    assert sorted(p.name for p in wd.glob("*.done")) == done[crash]
    assert not fa.exists() and fq.exists() == (crash == "assemble")

    monkeypatch.setattr(twopass, target[crash], orig)
    calls = []

    def counted(*a, **kw):
        calls.append(a)
        return run_count(*a, **kw)

    monkeypatch.setattr(twopass, "run_count", counted)
    res = twopass.run_two_pass(cfg, [path], str(fq), str(fa),
                               workdir=str(wd), device="cpu")
    # resumed stages come from their checkpoints: only pass 2 re-counts
    # after a crash in correct, nothing after one in assemble
    assert len(calls) == {"correct": 1, "assemble": 0}[crash]
    assert fq.read_bytes() == (d / "j.fastq").read_bytes()
    assert fa.read_bytes() == (d / "j.fasta").read_bytes()
    assert res["unitigs"] >= 1

    before = (fq.read_bytes(), fa.read_bytes())
    again = twopass.run_two_pass(cfg, [path], str(fq), str(fa),
                                 workdir=str(wd), device="cpu")
    assert (fq.read_bytes(), fa.read_bytes()) == before
    assert again.get("resumed") is True and again["unitigs"] == \
        res["unitigs"]
