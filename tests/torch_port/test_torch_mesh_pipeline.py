"""The pipeline of kmerax_torch on a mesh (count, correct, assemble on every
rank of a gloo mesh, rank 0 writing) against the JAX package's on the same
mesh shape: byte-equal corrected FASTQ and contig FASTA on the "fused"
correction (a replicated table exists) and on the "routed-sharded" one (the
table past the replicate budget), and the two-pass pipeline with its
checkpoints and resume. Exact: tolerance 0."""

import json

import pytest

import kmerax.pipeline.run as j_run
import kmerax_torch.pipeline.correct as t_correct
from kmerax.config import KmeraxConfig as JConfig
from kmerax.pipeline.twopass import run_two_pass
from kmerax_torch.dist import mesh as dmesh
from sim import ecoli_like, make_fastq

from parity import MESH_TIMEOUT, run_clis, run_mesh

# tests/dist/test_sharded.py's sizes
CFG = dict(k=31, bloom_log2_width=16, batch_reads=128, max_read_len=100,
           exact_capacity=1 << 16)
ARGS = ["-k", "31", "--bloom-log2-width", "16", "--batch-reads", "128",
        "--max-read-len", "100", "--exact-capacity", str(1 << 16)]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    _, rs = ecoli_like(seed=88, genome_len=1200, coverage=25, read_len=100,
                       error_rate=0.01)
    p = tmp_path_factory.mktemp("mesh_pipe") / "reads.fastq"
    p.write_bytes(make_fastq(rs))
    return p


@pytest.fixture(autouse=True)
def _launch_timeout(monkeypatch):
    """A hung mesh fails the test instead of the suite."""
    monkeypatch.setattr(dmesh, "LAUNCH_TIMEOUT", MESH_TIMEOUT)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_cli_pipeline_matches_jax(reads, tmp_path, mesh):
    """`pipeline --mesh-data D --mesh-bucket S --device cpu` spawns D·S gloo
    ranks: its result, corrected FASTQ and contig FASTA equal the JAX
    CLI's on the same mesh. The port corrects on its "fused" path (a
    replicated table exists); the JAX package routes on the CPU."""
    out = tmp_path / "{pkg}"
    jres, tres = run_clis(["pipeline", "--in", str(reads), "--out-fastq",
                           f"{out}.fastq", "--out-fasta", f"{out}.fasta",
                           "--mesh-data", str(mesh[0]), "--mesh-bucket",
                           str(mesh[1]), *ARGS])
    assert tres == jres
    assert t_correct.LAST_CORRECT_PATH == "fused"
    assert j_run.LAST_CORRECT_PATH == "routed-sharded"
    for ext in ("fastq", "fasta"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext
    assert jres["edits"] > 0 and jres["unitigs"] >= 1


def test_routed_correction_past_budget(reads, tmp_path, monkeypatch):
    """With the replicate budget below the table (REPLICATE_TABLE_BUDGET
    = 0 in both packages, as tests/dist/test_routed_correct.py sets it) the
    mesh count keeps the table bucket-sharded only and the correction
    routes every probe to its owner: the port's path is "routed-sharded"
    and its FASTQ and FASTA bytes equal the JAX package's on 2 x 2."""
    run_mesh([((2, 2), {"out": str(tmp_path), "budget": 0, "steps": [{
        "kind": "pipeline", "name": "routed", "cfg": CFG,
        "paths": [str(reads)], "out_fastq": str(tmp_path / "t.fastq"),
        "out_fasta": str(tmp_path / "t.fasta")}]})], tmp_path)
    with open(tmp_path / "routed.json") as f:
        got = json.load(f)
    monkeypatch.setattr(j_run, "REPLICATE_TABLE_BUDGET", 0)
    want = j_run.run_pipeline(JConfig(mesh_data=2, mesh_bucket=2, **CFG),
                              [str(reads)], str(tmp_path / "j.fastq"),
                              str(tmp_path / "j.fasta"))
    assert got["path"] == "routed-sharded"
    assert j_run.LAST_CORRECT_PATH == "routed-sharded"
    assert got["result"] == want
    for ext in ("fastq", "fasta"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext


def test_cli_two_pass_on_mesh(reads, tmp_path):
    """`pipeline --k2 63` on a 1 x 2 mesh: the pass-1 FASTQ and the k2
    assembly equal the JAX CLI's on the same mesh."""
    out = tmp_path / "{pkg}"
    jres, tres = run_clis(["pipeline", "--in", str(reads), "--out-fastq",
                           f"{out}.fastq", "--out-fasta", f"{out}.fasta",
                           "--k2", "63", "--mesh-data", "1", "--mesh-bucket",
                           "2", *ARGS])
    assert tres == jres
    for ext in ("fastq", "fasta"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext


def test_two_pass_checkpoints_and_resume_on_mesh(reads, tmp_path):
    """run_two_pass with a workdir on a 1 x 2 mesh: rank 0 writes the
    checkpoints and markers; a run resumed after the count_k2 checkpoint
    (the assemble marker and FASTA removed) writes the same FASTA, and
    both equal the JAX package's two-pass on the same mesh. Counted past
    the replicate budget, the count_k1 checkpoint has no replicated table
    and the resume refuses with the JAX package's message."""
    def run(tag, workdir, **kw):
        return {"kind": "twopass", "name": tag, "cfg": dict(CFG, k2=63),
                "paths": [str(reads)], "workdir": str(workdir),
                "out_fastq": str(tmp_path / f"{tag}.fastq"),
                "out_fasta": str(tmp_path / f"{tag}.fasta"), **kw}
    w, wb = tmp_path / "ckpt", tmp_path / "ckpt_budget"
    run_mesh([
        ((1, 2), {"out": str(tmp_path), "steps": [
            run("fresh", w),
            {"kind": "remove", "paths": [str(w / "assemble.done"),
                                         str(tmp_path / "fresh.fasta")]},
            run("fresh", w)]}),
        ((1, 2), {"out": str(tmp_path), "budget": 0, "steps": [
            run("budget", wb), run("budget_resume", wb, catch=True)]})],
        tmp_path)
    jres = run_two_pass(JConfig(mesh_data=1, mesh_bucket=2, k2=63, **CFG),
                        [str(reads)], str(tmp_path / "j.fastq"),
                        str(tmp_path / "j.fasta"))
    with open(tmp_path / "fresh.json") as f:
        res = json.load(f)
    assert res["unitigs"] == jres["unitigs"] >= 1
    assert res["threshold_k2"] == jres["threshold_k2"]
    assert sorted(p.name for p in w.glob("*.done")) == \
        ["assemble.done", "correct.done", "count_k1.done", "count_k2.done"]
    for tag in ("fresh", "budget"):
        for ext in ("fastq", "fasta"):
            assert (tmp_path / f"{tag}.{ext}").read_bytes() == \
                (tmp_path / f"j.{ext}").read_bytes(), (tag, ext)
    with open(tmp_path / "budget_resume.json") as f:
        err = json.load(f)["error"]
    assert err == ("count_k1: checkpoint has no replicated bloom table "
                   "(counted past the replicate budget) — resume by "
                   "re-counting (delete the stage marker)")
