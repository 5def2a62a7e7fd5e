"""Cells, configurations, traffic mixes and per-layer metric readers, found
by the names in BENCHMARK.json: a configuration is the JSON file its entry
names, a traffic mix is `benchmark/mixes/<traffic>.json`, a per-layer
metric is `benchmark/metrics/<name>.py` with a `read(run)` function. A
later cell, mix or metric is new files and new entries, never an edit.
A configuration may name a ("data", "bucket") mesh of D x S cards
(`mesh_data`, `mesh_bucket`, both 1 by default); its cells ask for D·S
chips."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from ..reference.compare import check_job
from .jobs import mesh

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list        # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def list_cells(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in load_benchmark(root)["workloads"]]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}"
                       f" (have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    check_job(config, mix["stages"])
    D, S = mesh(config)
    if D * S > 1 and D * S != w["chips"]:
        raise ValueError(f"{name}: configuration {w['config']} names a "
                         f"{D} x {S} mesh, {D * S} cards, but the cell asks "
                         f"for {w['chips']} chips")
    return Cell(name, w["chips"], config, mix,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The `read(run) -> float | None` of a per-layer metric's file."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
