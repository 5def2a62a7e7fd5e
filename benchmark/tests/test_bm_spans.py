"""The readers of the program's spans and counters: a tiny traced run of
each cell on the CPU reports every span metric of its cell, and the spans
of a stage read no more than the stage's own wall."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from benchmark.harness import cells

_RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import bm_tiny
print(json.dumps(bm_tiny.run({cell!r}, traced=True)))
"""
CELLS = ["ecoli50x.count_correct", "chr21_30x.assemble_validate"]
SPAN_METRICS = {
    "count.parse_wait_s_per_mread", "count.flush_s_per_mread",
    "count.merge_rows_per_kmer", "correct.step_s_per_mread",
    "correct.write_s_per_mread", "assemble.edges_s_per_mread",
    "assemble.chains_s_per_mread", "assemble.emit_s_per_mread",
    "align.contig_index_s_per_mread", "align.seed_table_s_per_mread"}
# a stage metric and the span metrics of parts of that stage
PARTS = [("count.s_per_mread", ["count.parse_wait_s_per_mread",
                                "count.flush_s_per_mread"]),
         ("correct.s_per_mread", ["correct.step_s_per_mread",
                                  "correct.write_s_per_mread"]),
         ("assemble.graph_s_per_mread", ["assemble.edges_s_per_mread",
                                         "assemble.chains_s_per_mread",
                                         "assemble.emit_s_per_mread"]),
         ("align.s_per_mread", ["align.contig_index_s_per_mread",
                                "align.seed_table_s_per_mread"])]


@pytest.fixture(scope="module")
def traced():
    out = {}
    for cell in CELLS:
        p = subprocess.run(
            [sys.executable, "-c", _RUN.format(
                root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"),
                cell=cell)],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert p.returncode == 0, p.stderr[-4000:]
        out[cell] = json.loads(p.stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics_of_its_cell(traced, cell):
    result = traced[cell]
    assert result["correct"] is True
    want = {m["name"] for m in cells.cell(cell).per_layer} & SPAN_METRICS
    assert want == (SPAN_METRICS if cell.startswith("chr21") else
                    {m for m in SPAN_METRICS
                     if m.startswith(("count.", "correct."))})
    got = result["metrics"]
    assert want <= set(got)
    for name in want:
        assert got[name]["value"] > 0, name
    # every count pass merges each of its k-mers' rows at least once
    assert got["count.merge_rows_per_kmer"]["value"] >= 1.0


# the stages each cell runs: the ecoli cell neither assembles nor aligns
STAGE_CASES = [(c, s, parts) for c in CELLS for s, parts in PARTS
               if c.startswith("chr21") or s.startswith(("count.",
                                                         "correct."))]


@pytest.mark.parametrize("cell,stage,parts", STAGE_CASES,
                         ids=[f"{c}-{s}" for c, s, _ in STAGE_CASES])
def test_spans_read_no_more_than_their_stage(traced, cell, stage, parts):
    got = traced[cell]["metrics"]
    assert sum(got[p]["value"] for p in parts) <= got[stage]["value"]
