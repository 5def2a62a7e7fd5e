"""The cell `human_wgs_30x.twopass` (SuperPlus config 5, `pipeline --k2 63
--out-fasta`): it loads as a two-pass job; the readers of pass 2 and of
the graph's extension and join read hand-built records right and return
None on records of a program that names no pass's k and times no
extension or join; a tiny copy of the cell runs `correct` on the CPU,
traced, and its control does not; on a card, the control at the cell's
own size."""

import math
import os

import numpy as np
import pytest
import torch

import bm_tiny
from benchmark import roofline, sim
from benchmark.harness import cells, jobs, main, trace
from benchmark.reference import compare
from test_bm_control import _readings
from test_bm_twopass import repeat_simulate

CELL = "human_wgs_30x.twopass"
CPU = torch.device("cpu")
NEW = ["count.k2_s_per_mread", "count.k2_parse_wait_s_per_mread",
       "count.k2_flush_s_per_mread", "K1.k2_roofline_pct",
       "assemble.k2_s_per_mread", "assemble.extend_s_per_mread",
       "assemble.join_s_per_mread"]
# the readers that read the program's clock, not the device's
HOST = [m for m in NEW if m != "K1.k2_roofline_pct"]


def test_cell_loads_as_a_two_pass_job(tmp_path):
    c = cells.cell(CELL)
    assert (c.chips, c.config["k"], c.config["k2"]) == (1, 31, 63)
    assert c.mix["stages"] == ["count", "correct", "assemble"]
    compare.check_job(c.config, c.mix["stages"])
    assert [m["name"] for m in c.end_to_end] == ["reads_per_s", "setup_s"]
    assert {m["name"] for m in c.per_layer} == set(NEW)
    a = jobs.argv(c.config, c.mix, ["IN1", "IN2"], str(tmp_path), "cuda")
    assert a[a.index("-k"):a.index("-k") + 4] == ["-k", "31", "--k2", "63"]
    assert "--out-fasta" in a and "--validate" not in a
    assert a[a.index("--bloom-log2-width") + 1] == "25"
    assert a[a.index("--exact-capacity") + 1] == str(1 << 23)


def test_only_the_graph_spans_reach_chr21():
    chr21 = {m["name"] for m in cells.cell(
        "chr21_30x.assemble_validate").per_layer}
    assert chr21 & set(NEW) == {"assemble.extend_s_per_mread",
                                "assemble.join_s_per_mread"}


# -- the readers on hand-built records --------------------------------------

READS, KMERS2 = 1000, 50_000
CFG = {"k": 31, "k2": 63, "batch_reads": 256, "max_read_len": 160,
       "bloom_hashes": 4}


def _stages(parent: bool) -> list:
    """A two-pass job's records: count at 31, correct, count at 63,
    assemble; `parent` drops each count's `k` and the extension and join
    spans, as a program without them writes the records."""
    count1 = {"stage": "count", "wall_s": 1.0, "reads": READS,
              "kmers": 120_000, "k": 31,
              "spans": {"io.parse_wait": [0.2, 4], "count.flush": [0.1, 2]}}
    count2 = {"stage": "count", "wall_s": 0.5, "reads": READS,
              "kmers": KMERS2, "k": 63,
              "spans": {"io.parse_wait": [0.1, 4], "count.flush": [0.05, 1]}}
    asm = {"stage": "assemble", "wall_s": 2.0,
           "spans": {"assemble.edges": [1.2, 1], "assemble.extend": [0.3, 1],
                     "assemble.join": [0.8, 1], "assemble.chains": [0.5, 1],
                     "assemble.emit": [0.2, 1]},
           "counters": {"assemble.solid_nodes": 900,
                        "assemble.join_queries": 7200}}
    stages = [count1, {"stage": "correct", "wall_s": 3.0, "reads": READS,
                       "spans": {}}, count2, asm]
    if parent:
        for s in stages:
            s.pop("k", None)
        for span in ("assemble.extend", "assemble.join"):
            asm["spans"].pop(span)
    return stages


def _trace(stage: str, kernel_us: float) -> trace.StageTrace:
    name = "void (anonymous namespace)::bloom_insert_kernel<4, false>"
    return trace.StageTrace(stage, [name, "Memcpy DtoH"],
                            ["kernel", "gpu_memcpy"],
                            np.array([0.0, 500.0]),
                            np.array([kernel_us, 20.0]), [], np.array([]),
                            np.array([]), 600.0)


def _run(parent: bool, cfg: dict = CFG) -> main.Run:
    window = [jobs.JobRecord(6.5, READS, _stages(parent), [2, 1], {})
              for _ in range(2)]
    prof = jobs.JobRecord(7.0, READS, _stages(parent), [2, 1], {})
    prof.trace = [_trace("count", 100.0), _trace("correct", 0.0),
                  _trace("count", 40.0)]
    return main.Run(cfg, {}, [READS // 2] * 2, window, prof)


def test_readers_read_hand_built_two_pass_records():
    r = _run(parent=False)
    got = {m: cells.reader(m)(r) for m in NEW}
    least = roofline.least_seconds(*roofline.k1_work(
        math.ceil(READS / 256), 256, 160, 63, KMERS2, 4))
    want = {"count.k2_s_per_mread": 500.0,
            "count.k2_parse_wait_s_per_mread": 100.0,
            "count.k2_flush_s_per_mread": 50.0,
            "K1.k2_roofline_pct": 100.0 * least / 40e-6,
            "assemble.k2_s_per_mread": 2000.0,
            "assemble.extend_s_per_mread": 300.0,
            "assemble.join_s_per_mread": 800.0}
    for m, v in want.items():
        assert got[m] == pytest.approx(v, rel=1e-12), m


@pytest.mark.parametrize("metric", NEW)
def test_reader_is_none_on_parent_records(metric):
    assert cells.reader(metric)(_run(parent=True)) is None


@pytest.mark.parametrize("metric", NEW[:5])
def test_pass2_readers_are_none_in_a_one_pass_job(metric):
    """Without `k2` in the configuration no record is pass 2's."""
    cfg = {key: v for key, v in CFG.items() if key != "k2"}
    assert cells.reader(metric)(_run(parent=False, cfg=cfg)) is None


def test_roofline_reader_needs_a_trace_a_count_record():
    r = _run(parent=False)
    r.profiled.trace = r.profiled.trace[:2]       # pass 2's trace missing
    assert cells.reader("K1.k2_roofline_pct")(r) is None


# -- a tiny copy of the cell on the CPU -------------------------------------

@pytest.fixture(scope="module")
def tiny_traced():
    return bm_tiny.run(CELL, traced=True)


def test_tiny_cell_is_correct_traced(tiny_traced):
    r = tiny_traced
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert {"spectrum_diff", "bloom_diff", "spectrum2_diff", "kmers2_diff",
            "fastq_diff", "fasta_diff"} <= set(checks)
    assert r["correct"] is True, checks
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for m in HOST:
        assert got[m] > 0, m
    # the CPU runs no K1 kernel: nothing for the roofline to read
    assert "K1.k2_roofline_pct" not in got
    assert got["count.k2_parse_wait_s_per_mread"] + \
        got["count.k2_flush_s_per_mread"] <= got["count.k2_s_per_mread"]
    assert got["assemble.extend_s_per_mread"] + \
        got["assemble.join_s_per_mread"] <= got["assemble.k2_s_per_mread"]


@pytest.mark.parametrize("genome", ["random", "repeats"])
def test_tiny_cell_is_correct_and_its_control_is_not(monkeypatch, genome):
    if genome == "repeats":
        monkeypatch.setattr(sim, "simulate", repeat_simulate)
    r = bm_tiny.run(CELL, seed=2**31 + 41)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["reads_per_s"]["value"] > 0
    c = cells.cell(CELL)
    cfg = {**c.config, **bm_tiny.override(CELL)}
    ds = sim.simulate(2**31 + 41, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"], cfg["insert_mean"],
                      cfg["insert_sd"])
    ref = compare.reference_outputs(ds, cfg, c.mix["stages"], CPU)
    got = compare.checks(compare.control_outputs(ds, cfg, c.mix["stages"],
                                                 CPU), ref)
    assert got["spectrum_diff"] > 0 and got["spectrum2_diff"] > 0


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    seeds = [int(s) for s in os.environ.get(
        "BM_CONTROL_SEEDS", "3100000001 3100000002 3100000003").split()]
    cfg = cells.cell(CELL).config
    for seed in seeds:
        got, ref_s = _readings(CELL, cfg, seed, card)
        print(f"control {CELL} seed {seed}: reference {ref_s:.2f} s; "
              + ", ".join(f"{k}={v}" for k, v in got.items()))
        assert any(v > 0 for v in got.values())
        torch.cuda.empty_cache()
