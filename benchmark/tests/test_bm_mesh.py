"""Mesh jobs on the CPU over gloo: a 2 x 2 cell declared on a root of its
own (ecoli's shapes at bm_tiny's genome) run through the harness, its
ranks' count passes, Bloom table, traces and memory peaks handed back, and
the edges of the layout in the configuration."""

import functools
import json
import shutil
import tempfile
import time

import pytest
import torch

import bm_tiny
from benchmark import sim
from benchmark.harness import cells, jobs, main
from benchmark.reference import compare
from conftest import ROOT

CPU = torch.device("cpu")
ECOLI = "ecoli50x.count_correct"
SEED = 2**31 + 4099


def _root(tmp, data=2, bucket=2, chips=4, traffic="count_correct"):
    """A checkout of the benchmark with one more configuration (ecoli's,
    on a data x bucket mesh) and its cell, as a later PR adds them."""
    if not (tmp / "benchmark").exists():
        shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "ecoli_k12_pe150_50x_k31.json").read_text())
    name = f"ecoli_mesh_{data}x{bucket}"
    cfg.update(name=name, mesh_data=data, mesh_bucket=bucket)
    (tmp / "benchmark" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": name, "source": "x",
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": ["genome_len"], "why": "x"})
    workload = f"{name}.{traffic}"
    bench["workloads"].append({"name": workload, "config": name,
                               "traffic": traffic, "chips": chips,
                               "why": "x"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return workload


@pytest.fixture
def bounded_launch(monkeypatch):
    """A mesh whose ranks hang fails the test instead of the run."""
    from kmerax_torch.dist import mesh as dmesh

    monkeypatch.setattr(dmesh, "LAUNCH_TIMEOUT", 300.0)


@pytest.fixture
def programs_outputs(monkeypatch):
    """The program's outputs of every run in this test, as compared."""
    seen = []
    orig = compare.checks

    def checks(prog, ref):
        seen.append(prog)
        return orig(prog, ref)
    monkeypatch.setattr(compare, "checks", checks)
    return seen


def _tiny(workload, root):
    cfg = {**cells.cell(workload, root).config,
           **bm_tiny.override(workload, root=root)}
    ds = sim.simulate(SEED, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"], cfg["insert_mean"],
                      cfg["insert_sd"])
    return cfg, ds


# -- the layout in the configuration -----------------------------------------

@pytest.mark.parametrize("data,bucket,chips", [(2, 2, 1), (1, 2, 4),
                                               (2, 1, 1), (4, 1, 1)])
def test_a_mesh_other_than_the_cells_chips_is_refused(tmp_path, data,
                                                       bucket, chips):
    w = _root(tmp_path, data, bucket, chips)
    with pytest.raises(ValueError, match="mesh"):
        cells.cell(w, tmp_path)


def test_a_mesh_of_the_cells_chips_loads(tmp_path):
    c = cells.cell(_root(tmp_path), tmp_path)
    assert c.chips == 4 and jobs.mesh(c.config) == (2, 2)
    assert jobs.mesh(cells.cell(ECOLI).config) == (1, 1)


def test_argv_of_a_mesh_job_carries_both_flags(tmp_path):
    c = cells.cell(_root(tmp_path), tmp_path)
    one = cells.cell(ECOLI)
    got = jobs.argv(c.config, c.mix, ["IN1", "IN2"], str(tmp_path / "m"),
                    "cpu")
    want = jobs.argv(one.config, one.mix, ["IN1", "IN2"],
                     str(tmp_path / "m"), "cpu")
    assert got == want + ["--mesh-data", "2", "--mesh-bucket", "2"]
    # a 1 x 1 mesh named in the configuration adds no flag
    assert jobs.argv({**one.config, "mesh_data": 1, "mesh_bucket": 1},
                     one.mix, ["IN1", "IN2"], str(tmp_path / "m"),
                     "cpu") == want


def test_the_control_fails_on_the_mesh_cell(tmp_path):
    w = _root(tmp_path)
    cfg, ds = _tiny(w, tmp_path)
    stages = cells.cell(w, tmp_path).mix["stages"]
    ref = compare.reference_outputs(ds, cfg, stages, CPU)
    got = compare.checks(compare.control_outputs(ds, cfg, stages, CPU), ref)
    assert got["spectrum_diff"] > 0


# -- 2 x 2 jobs through the harness ------------------------------------------

def test_a_2x2_cell_reads_as_the_one_device_job(tmp_path, bounded_launch,
                                                 programs_outputs):
    w = _root(tmp_path)
    r = bm_tiny.run(w, seed=SEED, root=tmp_path)
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert {"spectrum_diff", "hist_diff", "threshold_diff", "bloom_diff",
            "fastq_diff"} <= set(checks)
    assert r["correct"] is True and all(v == 0 for v in checks.values()), \
        checks
    assert r["device"]["count"] == 4
    one = bm_tiny.run(ECOLI, seed=SEED, root=tmp_path)
    assert one["correct"] is True and one["device"]["count"] == 1
    mesh, single = programs_outputs
    assert len(mesh.counts) == len(single.counts) == 1
    m, s = mesh.counts[0], single.counts[0]
    assert torch.equal(m.uniq, s.uniq) and torch.equal(m.counts, s.counts)
    assert m.hist == s.hist and m.threshold == s.threshold
    assert torch.equal(m.table.cpu(), s.table.cpu())
    assert mesh.fastq == single.fastq


def _rank_job_with(fault, handback, fn, *args):
    """jobs.rank_job on a rank whose exchange between cards is left out:
    `no_spectrum_gather`, each rank keeps the k-mers routed to it;
    `no_table_reduce`, the table's slices are not summed over "data"."""
    from kmerax_torch.spectrum import sharded

    if fault == "no_spectrum_gather":
        sharded.allgather_spectrum = lambda rows, counts, *a, **kw: (rows,
                                                                     counts)
    elif fault == "no_table_reduce":
        sharded.merge_keep_sharded = lambda table, mesh: table
    return jobs.rank_job(handback, fn, *args)


@pytest.mark.parametrize("fault,number", [
    ("no_spectrum_gather", "spectrum_diff"), ("no_table_reduce",
                                              "bloom_diff")])
def test_a_2x2_job_without_its_exchange_comes_out_not_correct(
        tmp_path, bounded_launch, monkeypatch, fault, number):
    monkeypatch.setattr(jobs, "rank_job",
                        functools.partial(_rank_job_with, fault))
    r = bm_tiny.run(_root(tmp_path), seed=SEED, root=tmp_path)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0, r["checks"]


def _inputs(workload, root, tmp):
    cfg, ds = _tiny(workload, root)
    return cfg, main._write_inputs(ds, str(tmp), None, "reads"), ds.n_reads


def test_a_2x2_job_hands_back_every_ranks_peak(tmp_path, bounded_launch,
                                               monkeypatch):
    w = _root(tmp_path)
    c = cells.cell(w, tmp_path)
    cfg, inputs, n = _inputs(w, tmp_path, tmp_path)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    rec = jobs.Recorder()
    try:
        out = str(tmp_path / "out")
        job = jobs.run(jobs.argv(cfg, c.mix, inputs, out, "cpu"), out, n,
                       rec, lambda: None)
    finally:
        rec.close()
    hb = job.handback
    # on the CPU a rank has no device memory to report
    assert hb.peaks == [0, 0, 0, 0]
    assert 0 < hb.handover_s < job.wall_s and hb.read_s > 0
    assert job.flushes and len(job.counts) == 1
    # the launch's hand-back directory is gone once read
    assert not [p for p in (tmp_path / "tmp").iterdir()
                if p.name.startswith("kmerax_handback_")]


def _rank_job_importing(handback, fn, *args):
    """jobs.rank_job on a rank that imports a module the run may not
    hold (the repo's JAX-era oracle, which loads no JAX) during its job."""
    def job(*a):
        import oracle  # noqa: F401
        return fn(*a)
    return jobs.rank_job(handback, job, *args)


def test_a_2x2_job_whose_ranks_import_a_forbidden_module_is_refused(
        tmp_path, bounded_launch, monkeypatch, capsys):
    monkeypatch.setattr(jobs, "rank_job", _rank_job_importing)
    with pytest.raises(SystemExit) as e:
        bm_tiny.run(_root(tmp_path), seed=SEED, root=tmp_path)
    assert e.value.code == 3
    # the ranks', read after the warm-up job, not this process's own
    assert "forbidden modules loaded in a mesh job's ranks: ['oracle'" \
        in capsys.readouterr().err


def _count_with_budget(cfg, paths, budget):
    """run_count on this rank with the replicated table's budget set:
    0 keeps the table bucket-sharded."""
    from kmerax_torch.pipeline import count

    count.REPLICATE_TABLE_BUDGET = budget
    count.run_count(cfg, paths, device=CPU)


def test_kept_sharded_slices_join_to_the_replicated_table(tmp_path,
                                                         bounded_launch):
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.pipeline import count

    w = _root(tmp_path)
    cfg, inputs, _ = _inputs(w, tmp_path, tmp_path)
    kcfg = KmeraxConfig(k=cfg["k"], bloom_log2_width=cfg["bloom_log2_width"],
                        exact_capacity=cfg["exact_capacity"],
                        batch_reads=cfg["batch_reads"],
                        max_read_len=cfg["max_read_len"], mesh_data=2,
                        mesh_bucket=2)
    one = count.run_count(kcfg.replace(mesh_data=1, mesh_bucket=1), inputs,
                          device=CPU).bloom_table
    rec = jobs.Recorder()
    try:
        tables = []
        for budget in (count.REPLICATE_TABLE_BUDGET, 0):
            dmesh.launch(dmesh.MeshSpec(2, 2), "cpu", _count_with_budget,
                         kcfg, inputs, budget)
            counts, _ = rec.take()
            assert len(counts) == 1 and rec.handback is not None
            tables.append(counts[0].table)
    finally:
        rec.close()
    assert dmesh.launch is rec._launch
    replicated, joined = tables
    assert torch.equal(replicated, one) and torch.equal(joined, one)


def test_a_traced_2x2_job_reads_one_ranks_traces(tmp_path, bounded_launch):
    w = _root(tmp_path)
    c = cells.cell(w, tmp_path)
    cfg, inputs, n = _inputs(w, tmp_path, tmp_path)
    rec = jobs.Recorder()
    try:
        traces = {}
        for name, conf in (("mesh", cfg), ("one", {**cfg, "mesh_data": 1,
                                                   "mesh_bucket": 1})):
            base = tmp_path / name
            base.mkdir()
            t = time.perf_counter()
            job = main._profiled(conf, c.mix, inputs, str(base), "cpu", rec,
                                 lambda: None, n)
            traces[name] = job.trace
            # every trace read or deleted: none left for a later job
            assert not [f for f in (base / "trace").rglob("*")
                        if f.is_file()]
            print(f"{name}: profiled job {time.perf_counter() - t:.2f} s")
    finally:
        rec.close()
    assert [t.stage for t in traces["mesh"]] == [
        t.stage for t in traces["one"]] == ["count", "correct"]
