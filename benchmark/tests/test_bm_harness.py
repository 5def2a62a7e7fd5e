"""A tiny run through the harness on the CPU: its last line, its
comparison, and the modules it loads."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

_RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import bm_tiny
r = bm_tiny.run({cell!r}, traced={traced})
print(json.dumps(r))
print(json.dumps(sorted(sys.modules)))
"""
CELLS = ["ecoli50x.count_correct", "chr21_30x.assemble_validate"]


def _run(cell, traced=False):
    p = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=str(ROOT), tests=str(
            ROOT / "benchmark" / "tests"), cell=cell, traced=traced)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_the_contract_line(cell):
    result, modules, err = _run(cell)
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(result["device"])
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(ln.startswith("check ") and ln.endswith(" limit 0")
               for ln in tail)
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {"jax", "jaxlib", "flax", "kmerax", "oracle",
                       "chip_smoke"}
    assert not [m for m in modules if m.startswith("kmerax_torch.bench")]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_the_per_layer_metrics(cell):
    result, _, _ = _run(cell, traced=True)
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU there is no device trace: only the host readings
    want = {"count.s_per_mread", "count.flushes_per_job",
            "correct.s_per_mread"}
    if cell.startswith("chr21"):
        want |= {"assemble.graph_s_per_mread", "align.s_per_mread"}
    assert want <= set(result["metrics"])


def test_run_py_refuses_without_a_card_or_the_program(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
