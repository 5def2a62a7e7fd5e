"""KMERAX_TRACE_DIR (utils/tracing.py::maybe_trace, the port of
kmerax/utils/tracing.py): with the variable set, the count, correct and
align stages of a `pipeline --validate` each write a Chrome trace a run
under $KMERAX_TRACE_DIR/<stage>/; without it, nothing is written."""

import json

import pytest

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline.run import run_pipeline
from sim import ecoli_like, make_fastq


@pytest.mark.parametrize("traced", [True, False])
def test_trace_dir_per_stage(tmp_path, monkeypatch, traced):
    _, reads = ecoli_like(seed=8, genome_len=1200, coverage=20,
                          read_len=100, error_rate=0.01)
    fq = tmp_path / "r.fastq"
    fq.write_bytes(make_fastq(reads))
    trace = tmp_path / "trace"
    if traced:
        monkeypatch.setenv("KMERAX_TRACE_DIR", str(trace))
    else:
        monkeypatch.delenv("KMERAX_TRACE_DIR", raising=False)
    cfg = KmeraxConfig(k=31, bloom_log2_width=15, batch_reads=128,
                       max_read_len=100, exact_capacity=1 << 16)
    res = run_pipeline(cfg, [str(fq)], str(tmp_path / "c.fastq"),
                       str(tmp_path / "c.fa"), validate=True, device="cpu")
    assert res["validate"]["reads"] == len(reads)
    if not traced:
        assert not trace.exists()
        return
    assert sorted(p.name for p in trace.iterdir()) == \
        ["align", "correct", "count"]
    # count runs twice: the count stage and the assembly's re-count of
    # the corrected reads
    for stage, runs in (("count", 2), ("correct", 1), ("align", 1)):
        files = list((trace / stage).glob("*.pt.trace.json"))
        assert len(files) == runs, stage
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        # the stage's host ops are in it
        assert any(ev.get("cat") == "cpu_op" for ev in events), stage
