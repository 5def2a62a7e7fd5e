"""The stages' spans, counters and traces (utils/metrics.py::MetricsWriter.
stage and utils/tracing.py, the port of kmerax/utils/tracing.py).

A `pipeline --validate` with `--metrics` gives each stage record its spans
{name: [seconds, n]} and counters {name: n}. With KMERAX_TRACE_DIR set, the
count, correct and align stages each write a Chrome trace of their whole
body under $KMERAX_TRACE_DIR/<stage>/, the spans in it as user_annotation
events; without it, nothing is written, and every output byte and every
non-timing field is the same."""

import json
import math
import threading

import pytest
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline import count as count_mod, run as run_mod
from kmerax_torch.pipeline.run import run_pipeline
from kmerax_torch.utils import tracing
from sim import ecoli_like, make_fastq

# 600 reads in batches of 128; an exact capacity this small flushes the
# pending rows after every batch, so each count pass flushes 5 times
CFG = KmeraxConfig(k=31, bloom_log2_width=15, batch_reads=128,
                   max_read_len=100, exact_capacity=1 << 15)
N_READS = 600
BATCHES = math.ceil(N_READS / CFG.batch_reads)
# the record's fields that time the work
TIMING = {"wall_s", "ts", "reads_per_s", "kmers_per_s", "index_s"}
# spans inside another span of the same stage (graph/partitioned.py: the
# edge discovery's device extension and host join)
NESTED = {"assemble.extend", "assemble.join"}


def _pipeline(tmp, fq, traced: bool) -> dict:
    """One `pipeline --validate` with --metrics; each count pass's flushes
    (LAST_COUNT_FLUSHES) and the rows merge_pending merged."""
    passes = []
    orig_count, orig_merge = count_mod.run_count, count_mod.merge_pending

    def run_count(*a, **kw):
        passes.append({"flushes": 0, "merge_rows": 0})
        state = orig_count(*a, **kw)
        passes[-1]["flushes"] = count_mod.LAST_COUNT_FLUSHES
        return state

    def merge(keys, counts, pending):
        out = orig_merge(keys, counts, pending)
        passes[-1]["merge_rows"] += out[2]
        return out

    with pytest.MonkeyPatch.context() as mp:
        if traced:
            mp.setenv("KMERAX_TRACE_DIR", str(tmp / "trace"))
        else:
            mp.delenv("KMERAX_TRACE_DIR", raising=False)
        for mod in (count_mod, run_mod):
            mp.setattr(mod, "run_count", run_count)
        mp.setattr(count_mod, "merge_pending", merge)
        res = run_pipeline(CFG, [str(fq)], str(tmp / "c.fastq"),
                           str(tmp / "c.fa"), str(tmp / "m.jsonl"),
                           validate=True, device="cpu")
    with open(tmp / "m.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    return {"dir": tmp, "result": res, "records": records, "passes": passes}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same reads through the pipeline untraced and traced."""
    _, reads = ecoli_like(seed=8, genome_len=3000, coverage=20,
                          read_len=100, error_rate=0.01)
    assert len(reads) == N_READS
    fq = tmp_path_factory.mktemp("reads") / "r.fastq"
    fq.write_bytes(make_fastq(reads))
    return {t: _pipeline(tmp_path_factory.mktemp(f"traced{int(t)}"), fq, t)
            for t in (False, True)}


def _traces(run, stage: str) -> list:
    """The user_annotation names of each `stage` trace, in time order
    (the time is the file name's nanoseconds)."""
    files = sorted((run["dir"] / "trace" / stage).glob("*.pt.trace.json"),
                   key=lambda p: int(p.name.split(".")[-4]))
    out = []
    for p in files:
        with open(p) as f:
            events = json.load(f)["traceEvents"]
        out.append([ev["name"] for ev in events
                    if ev.get("cat") == "user_annotation"])
    return out


@pytest.mark.parametrize("traced", [True, False])
def test_trace_dir_per_stage(runs, traced):
    run = runs[traced]
    trace = run["dir"] / "trace"
    assert run["result"]["validate"]["reads"] == N_READS
    if not traced:
        assert not trace.exists()
        return
    assert sorted(p.name for p in trace.iterdir()) == \
        ["align", "correct", "count"]
    # count runs twice: the count stage and the assembly's re-count of
    # the corrected reads
    for stage, n_runs in (("count", 2), ("correct", 1), ("align", 1)):
        files = list((trace / stage).glob("*.pt.trace.json"))
        assert len(files) == n_runs, stage
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        # the stage's host ops are in it
        assert any(ev.get("cat") == "cpu_op" for ev in events), stage


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("stage", ["count", "correct", "assemble", "align"])
def test_stage_records_carry_their_spans(runs, stage, traced):
    run = runs[traced]
    recs = [r for r in run["records"] if r["stage"] == stage]
    assert len(recs) == (2 if stage == "count" else 1)
    for r in recs:
        # the spans time parts of the stage: those not nested in another
        # sum to no more than its wall (wall_s is rounded to 4 places)
        assert sum(s for name, (s, _) in r["spans"].items()
                   if name not in NESTED) <= r["wall_s"] + 5e-5
    n = {name: [r["spans"][name][1] for r in recs]
         for name in recs[0]["spans"]}
    if stage == "count":
        passes = run["passes"]
        assert [p["flushes"] for p in passes] == [BATCHES, BATCHES]
        assert n["count.flush"] == [p["flushes"] for p in passes]
        assert [r["counters"]["count.merge_rows"] for r in recs] == \
            [p["merge_rows"] for p in passes]
        assert all(x >= BATCHES for x in n["io.parse_wait"])
    elif stage == "correct":
        assert n["correct.step"] == n["correct.write"] == [BATCHES]
        assert recs[0]["counters"] == {}
    elif stage == "assemble":
        assert n == {"assemble.edges": [1], "assemble.extend": [1],
                     "assemble.join": [1], "assemble.chains": [1],
                     "assemble.emit": [1]}
    else:
        assert n["align.contig_index"] == n["align.seed_table"] == [1]
        r = recs[0]
        assert r["index_s"] == round(r["spans"]["align.contig_index"][0]
                                     + r["spans"]["align.seed_table"][0], 4)


def test_outputs_and_records_equal_with_and_without_a_trace(runs):
    plain, traced = runs[False], runs[True]
    for name in ("c.fastq", "c.fa"):
        assert (plain["dir"] / name).read_bytes() == \
            (traced["dir"] / name).read_bytes(), name

    def untimed(rec):
        out = {k: v for k, v in rec.items() if k not in TIMING}
        out["spans"] = {k: n for k, (_, n) in rec["spans"].items()}
        return out

    assert [untimed(r) for r in plain["records"]] == \
        [untimed(r) for r in traced["records"]]
    assert plain["result"] == traced["result"]


@pytest.mark.parametrize("stage,span", [("count", "count.flush"),
                                        ("correct", "correct.step")])
def test_trace_holds_the_spans(runs, stage, span):
    """The count traces hold every flush, the last one included (the
    profiler runs over the whole stage), and the correct trace one step a
    batch."""
    run = runs[True]
    got = [names.count(span) for names in _traces(run, stage)]
    want = ([p["flushes"] for p in run["passes"]] if stage == "count"
            else [BATCHES])
    assert got == want


@pytest.mark.parametrize("where", ["no stage", "another thread",
                                   "no profiler"])
def test_span_and_count_outside_a_stage(monkeypatch, where):
    """Spans and counts land only in a stage open on the calling thread;
    without a profiler a span enters no record_function and never
    synchronizes."""
    def refuse(*a, **kw):
        raise AssertionError("called by a span without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)

    def work():
        with tracing.span("x"):
            tracing.count("c", 3)

    if where == "no stage":
        work()
        with tracing.opened(annotate=False) as st:
            pass
        assert (st.spans, st.counters) == ({}, {})
        return
    with tracing.opened(annotate=False) as st:
        if where == "another thread":
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            assert (st.spans, st.counters) == ({}, {})
            return
        work()
        work()
    assert st.spans["x"][1] == 2 and st.counters == {"c": 6}
    assert 0 < st.seconds("x") < 30


# The records a job's metrics file holds, as the benchmark reads them:
# each stage in order with its field names (in record order), its span
# names and its counter names. A one-pass job re-counts the corrected
# reads in a count record just before its assemble record; a two-pass
# job's second count is pass 2 at k2.
COUNT_REC = ("count", ["stage", "wall_s", "ts", "reads", "kmers",
                       "threshold", "k", "reads_per_s", "kmers_per_s"],
             ["count.flush", "io.parse_wait"],
             ["count.merge_rows", "count.resident_flushes"])
CORRECT_REC = ("correct", ["stage", "wall_s", "ts", "reads", "edited_reads",
                           "edits", "reads_per_s"],
               ["correct.step", "correct.write", "io.parse_wait"], [])
ASSEMBLE_REC = ("assemble", ["stage", "wall_s", "ts", "unitigs"],
                ["assemble.chains", "assemble.edges", "assemble.emit",
                 "assemble.extend", "assemble.join"],
                ["assemble.join_queries", "assemble.solid_nodes"])
ALIGN_REC = ("align", ["stage", "wall_s", "ts", "reads", "aligned",
                       "aligned_frac", "mean_identity", "index_s",
                       "index_kmers", "table_bytes", "reads_per_s"],
             ["align.contig_index", "align.seed_table", "io.parse_wait"], [])
PINNED = {
    "validate": [COUNT_REC, CORRECT_REC, COUNT_REC, ASSEMBLE_REC, ALIGN_REC],
    "k2": [COUNT_REC, CORRECT_REC, COUNT_REC, ASSEMBLE_REC],
}


@pytest.fixture(scope="module")
def k2_records(tmp_path_factory):
    """The records of `pipeline --k2 63 --out-fasta --metrics` through the
    CLI, on the `runs` fixture's reads."""
    from kmerax_torch.cli import main

    _, reads = ecoli_like(seed=8, genome_len=3000, coverage=20,
                          read_len=100, error_rate=0.01)
    d = tmp_path_factory.mktemp("k2")
    (d / "r.fastq").write_bytes(make_fastq(reads))
    main(["pipeline", "--in", str(d / "r.fastq"), "--out-fastq",
          str(d / "c.fastq"), "--out-fasta", str(d / "c.fa"), "--metrics",
          str(d / "m.jsonl"), "--k2", "63", "-k", "31", "--bloom-log2-width",
          "15", "--batch-reads", "128", "--max-read-len", "100",
          "--exact-capacity", str(1 << 15), "--device", "cpu"])
    with open(d / "m.jsonl") as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("job", ["validate", "k2"])
def test_metrics_records_are_pinned(runs, k2_records, job):
    """`pipeline --out-fasta --validate` and `pipeline --k2 63 --out-fasta`
    write these stage records, in this order, with these field, span and
    counter names (the benchmark's readers take them by name); the count
    records carry their pass's k."""
    recs = runs[False]["records"] if job == "validate" else k2_records
    got = [(r["stage"], [k for k in r if k not in ("spans", "counters")],
            sorted(r["spans"]), sorted(r["counters"])) for r in recs]
    assert got == PINNED[job]
    assert [r["k"] for r in recs if r["stage"] == "count"] == \
        ([31, 31] if job == "validate" else [31, 63])
