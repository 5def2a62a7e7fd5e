"""BENCHMARK.json against the contract's form, and the data each cell
needs."""

import json
import math
import re

import pytest

from benchmark import roofline, sizing
from benchmark.harness import cells, jobs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        g = [e["name"] for e in BENCH[group]]
        assert len(g) == len(set(g)), group
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist_and_load(w):
    c = cells.cell(w["name"])
    assert c.config["name"] == w["config"]
    assert c.mix["name"] == w["traffic"]
    D, S = jobs.mesh(c.config)      # a cell takes its mesh's cards, else 1
    assert w["chips"] == D * S


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        c = cells.cell(w["name"])
        e2e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells_
            assert m["moves"] in [x["name"] for x in cells.cell(w).end_to_end]
        assert (cells.ROOT / "benchmark" / "metrics"
                / f"{m['name']}.py").exists()
        assert callable(cells.reader(m["name"]))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_check_budget_fits_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_reduced_and_sized_by_the_rule(conf):
    with open(cells.ROOT / conf["file"]) as f:
        cfg = json.load(f)
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"])
    n = sizing.n_reads(cfg["genome_len"], cfg["coverage"], cfg["read_len"])
    s = sizing.sized(cfg["genome_len"], n, cfg["read_len"],
                     cfg["error_rate"], cfg["k"])
    for key, v in s.items():
        assert cfg[key] == v, key


def test_table_sizes_are_the_acceptance_rule():
    got = {}
    for conf in BENCH["configs"]:
        with open(cells.ROOT / conf["file"]) as f:
            cfg = json.load(f)
        got[conf["name"]] = (cfg["bloom_log2_width"], cfg["exact_capacity"])
    assert got["ecoli_k12_pe150_50x_k31"] == (26, 1 << 24)
    assert got["chr21_pe150_30x_k31"] == (24, 1 << 23)


def test_k1_bound_matches_the_kernel_table():
    """PERF.md's kernel table: K1 on 4,096 x 160 at k=31 with 461,556
    valid k-mers is bound by bytes at 0.0059 ms."""
    nbytes, ops = roofline.k1_work(1, 4096, 160, 31, 461_556, 4)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.INT32_OPS_PER_S
    assert math.isclose(roofline.least_seconds(nbytes, ops) * 1e3, 0.0059,
                        abs_tol=5e-5)
