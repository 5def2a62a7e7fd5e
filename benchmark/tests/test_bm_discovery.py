"""A new configuration, traffic mix and per-layer metric are picked up
from new files and BENCHMARK.json entries alone."""

import json
import shutil

from benchmark.harness import cells
from conftest import ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "ecoli_k12_pe150_50x_k31.json").read_text())
    cfg["name"] = "ecoli_new"
    (tmp_path / "benchmark" / "configs" / "ecoli_new.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark" / "mixes" / "count_only.json").write_text(
        json.dumps({"name": "count_only", "command": "pipeline",
                    "stages": ["count", "correct"], "fasta": False,
                    "flags": []}))
    (tmp_path / "benchmark" / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "ecoli_new", "source": "x",
                             "file": "benchmark/configs/ecoli_new.json",
                             "reduced": ["genome_len"], "why": "x"})
    bench["workloads"].append({"name": "ecoli_new.count_only",
                               "config": "ecoli_new",
                               "traffic": "count_only", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "new.metric", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "count", "moves": "reads_per_s",
                               "workloads": ["ecoli_new.count_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "ecoli_new.count_only" in cells.list_cells(tmp_path)
    c = cells.cell("ecoli_new.count_only", tmp_path)
    assert c.config["name"] == "ecoli_new" and c.mix["name"] == "count_only"
    assert [m["name"] for m in c.per_layer] == ["new.metric"]
    assert cells.reader("new.metric", tmp_path)(None) == 42.0
