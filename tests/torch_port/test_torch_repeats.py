"""The assembly on repeats (tests/torch_port/repeats.py: a three-copy
segment, a tandem repeat, an inverted repeat, a palindrome, a homopolymer
at the chromosome's end and a circular molecule) against the JAX package
and the oracle, at k = 15 and 31. Exact: tolerance 0 (byte equality).

The fixture is shown to reach each branch rule of DESIGN.md §9 on the
oracle's graph: a node with two successors or more, the self-edge guard
(v != u) on a self-edge and on a hairpin, and the cycle-break rule (a
cycle emitted from its minimal oriented node, its flipped twin not)."""

import numpy as np
import pytest

import oracle
from kmerax.config import KmeraxConfig as JConfig
from kmerax.graph.partitioned import assemble_host as j_assemble_host
from kmerax.graph.unitig import assemble_to_fasta as j_assemble_to_fasta
from kmerax.pipeline.run import run_count as j_run_count, \
    run_pipeline as j_run_pipeline
from kmerax.spectrum.host import HostSpectrum as JHost
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.graph.partitioned import assemble_host
from kmerax_torch.graph.unitig import assemble_to_fasta
from kmerax_torch.pipeline.count import run_count
from kmerax_torch.pipeline.run import run_pipeline
from oracle.assemble import _DBG, build_graph

from repeats import CIRCLE_LEN, branch_rules, repeat_sample, sample_fastq

SEED = 7
CFG = dict(bloom_log2_width=18, batch_reads=512, max_read_len=100,
           exact_capacity=1 << 17)


@pytest.fixture(scope="module")
def sample():
    return repeat_sample(SEED)


@pytest.fixture(scope="module")
def clean(sample, tmp_path_factory):
    """Error-free reads at 30x: (FASTQ path, reads)."""
    fq, reads = sample_fastq(sample, 30, 100, 0.0, SEED + 1)
    p = tmp_path_factory.mktemp("repeats") / "clean.fastq"
    p.write_bytes(fq)
    return p, reads


def _fasta(seqs) -> bytes:
    return "".join(f">unitig_{i} len={len(s)}\n{s}\n"
                   for i, s in enumerate(seqs)).encode()


@pytest.mark.parametrize("k", [15, 31])
def test_repeat_assembly_matches_jax_and_oracle(clean, tmp_path, k):
    """Error-free reads: count, then assemble_to_fasta in both packages;
    the FASTA bytes == the oracle's assemble_fasta on its own spectrum and
    threshold. The oracle's graph reaches every branch rule, and the
    circle comes out as one unitig of CIRCLE_LEN + k - 1 bases."""
    fq, reads = clean
    sp = oracle.ExactSpectrum(k)
    sp.add_reads([r.bases for r in reads])
    t = oracle.auto_threshold(oracle.histogram_of(sp.sorted_items()[1]))
    rules = branch_rules(_DBG(*build_graph(sp, t), k))
    assert rules["branch"] >= 2
    assert rules["self_edge"] >= 1
    assert rules["hairpin"] >= 1
    assert rules["cycle_emitted"] == [CIRCLE_LEN]
    assert rules["cycle_skipped"] == [CIRCLE_LEN]
    want = oracle.assemble_fasta(sp, t, k).encode()
    assert f"len={CIRCLE_LEN + k - 1}\n".encode() in want

    jcfg = JConfig(k=k, **CFG)
    jstate = j_run_count(jcfg, [str(fq)])
    j_assemble_to_fasta(jcfg, jstate, str(tmp_path / "j.fa"))
    cfg = KmeraxConfig(k=k, **CFG)
    state = run_count(cfg, [str(fq)], device="cpu")
    n = assemble_to_fasta(cfg, state, str(tmp_path / "t.fa"), device="cpu")
    assert state.threshold == jstate.threshold == t
    got = (tmp_path / "t.fa").read_bytes()
    assert got == (tmp_path / "j.fa").read_bytes()
    assert got == want
    assert n == want.count(b">")

    # the partitioned edge discovery across many partitions, both packages
    seqs = assemble_host(state.host, t, k, device="cpu", partition_rows=257)
    jseqs = j_assemble_host(JHost(state.host.uniq, state.host.counts, k), t,
                            k, partition_rows=257)
    assert seqs == jseqs
    assert _fasta(seqs) == want


@pytest.mark.parametrize("k", [15, 31])
def test_repeat_pipeline_matches_jax(sample, tmp_path, k):
    """Reads at 0.5 % error: run_pipeline in both packages writes the same
    corrected FASTQ and contig FASTA bytes, with reads edited."""
    fq_bytes, _ = sample_fastq(sample, 30, 100, 0.005, SEED + 2)
    fq = tmp_path / "noisy.fastq"
    fq.write_bytes(fq_bytes)
    jres = j_run_pipeline(JConfig(k=k, **CFG), [str(fq)],
                          str(tmp_path / "j.fastq"), str(tmp_path / "j.fa"))
    tres = run_pipeline(KmeraxConfig(k=k, **CFG), [str(fq)],
                        str(tmp_path / "t.fastq"), str(tmp_path / "t.fa"),
                        device="cpu")
    assert tres == jres
    assert jres["edited_reads"] > 0 and jres["unitigs"] > 0
    for ext in ("fastq", "fa"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext
    assert np.any(np.frombuffer((tmp_path / "t.fastq").read_bytes(),
                                np.uint8)
                  != np.frombuffer(fq_bytes, np.uint8))
