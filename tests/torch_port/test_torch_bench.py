"""The `bench` harness of kmerax_torch (bench/sim.py, bench/runners.py,
bench/acceptance.py and the `bench` subcommand) against the JAX package's
kmerax/bench: the same simulated reads, the same state left by each timed
pass, and the same acceptance reports and output bytes. Exact: tolerance 0
(every value compared is an integer, a count or a byte; `gain` and the
assembly's k-mer fraction are the same rounded ratio of equal integers)."""

import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import kmerax.bench.runners as j_runners
import kmerax.pipeline.run as j_run
import kmerax_torch.bench.runners as t_runners
import kmerax_torch.pipeline.correct as t_correct
import sim as j_sim
from kmerax.bench.acceptance import run_config as j_run_config
from kmerax.config import KmeraxConfig as JConfig
from kmerax_torch.bench import sim as t_sim
from kmerax_torch.bench.acceptance import CONFIGS, run_config
from kmerax_torch.cli import main
from kmerax_torch.config import KmeraxConfig

# acceptance scales: a few hundred to ~2,000 reads a config
SCALE = {1: 0.05, 2: 0.03, 3: 0.04, 4: 0.05, 5: 0.03}
# the report fields that must equal the reference's
FIELDS = ("genome_len", "reads", "threshold", "threshold_k1",
          "threshold_k2", "edited_reads", "edits", "unitigs", "validate",
          "accuracy", "assembly")


@pytest.fixture(scope="module")
def jax_reports(tmp_path_factory):
    """The JAX package's run_config of every config, once per module (its
    config 4 runs the 2x2 mesh on the 8 CPU devices)."""
    d = tmp_path_factory.mktemp("acc_jax")
    return {n: j_run_config(n, scale=SCALE[n], workdir=str(d / f"c{n}"))
            for n in sorted(CONFIGS)}


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["pairs", "reads"])
def test_sim_draws_match_tests_sim(kind):
    """bench/sim.py draws what tests/sim.py draws, in the same order, and
    gives the same FASTQ bytes."""
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    gj, gt = j_sim.random_genome(rng_j, 3000), t_sim.random_genome(rng_t,
                                                                  3000)
    np.testing.assert_array_equal(gt, gj)
    if kind == "pairs":
        kw = dict(seed=10, insert_mean=450, insert_sd=37)
        rj = sum(j_sim.simulate_pairs(gj, 150, 150, 0.01, **kw), [])
        rt = sum(t_sim.simulate_pairs(gt, 150, 150, 0.01, **kw), [])
    else:
        kw = dict(seed=11, n_rate=0.01, circular=True)
        rj = j_sim.simulate_reads(gj, 300, 100, 0.02, **kw)
        rt = t_sim.simulate_reads(gt, 300, 100, 0.02, **kw)
    assert len(rt) == len(rj) > 0
    for a, b in zip(rt, rj):
        assert (a.name, a.qual, a.pos, a.strand, a.seq) == \
            (b.name, b.qual, b.pos, b.strand, b.seq)
        np.testing.assert_array_equal(a.bases, b.bases)
        np.testing.assert_array_equal(a.true_bases, b.true_bases)
    assert t_sim.make_fastq(rt) == j_sim.make_fastq(rj)
    np.testing.assert_array_equal(t_sim.revcomp_bases(gt[:50]),
                                  j_sim.revcomp_bases(gj[:50]))


def _passes(monkeypatch):
    """The state each package's _time_fresh_pass leaves, in call order."""
    got = {"j": [], "t": []}
    for pkg, mod in (("j", j_runners), ("t", t_runners)):
        real = mod._time_fresh_pass

        def spy(fn, state, batches, real=real, pkg=pkg):
            dt, state = real(fn, state, batches)
            got[pkg].append(state)
            return dt, state
        monkeypatch.setattr(mod, "_time_fresh_pass", spy)
    return got


def _e2e_outputs(monkeypatch):
    """run_correct's stats and corrected FASTQ bytes of each package's
    bench_e2e."""
    got = {"j": [], "t": []}
    for pkg, mod in (("j", j_run), ("t", t_correct)):
        real = mod.run_correct

        def spy(cfg, paths, state, out, *a, real=real, pkg=pkg, **kw):
            stats = real(cfg, paths, state, out, *a, **kw)
            with open(out, "rb") as f:
                got[pkg].append((stats, state.threshold, f.read()))
            return stats
        monkeypatch.setattr(mod, "run_correct", spy)
    return got


@pytest.mark.parametrize("preset", ["count", "correct", "align", "e2e"])
def test_runner_state_matches_jax(monkeypatch, preset):
    """Each runner at a small size leaves the JAX runner's state: the
    count table's bytes, the total of n_edits, the total of found reads,
    e2e's corrected FASTQ; the metric names are equal."""
    kw = dict(k=31, bloom_log2_width=18)
    if preset == "e2e":
        kw.update(batch_reads=256, exact_capacity=1 << 17)
        got = _e2e_outputs(monkeypatch)
        jres = j_runners.bench_e2e(JConfig(**kw), n_reads=640)
        tres = t_runners.bench_e2e(KmeraxConfig(**kw), n_reads=640,
                                   device="cpu")
        assert tres["metric"] == jres["metric"]
        assert {"count_wall_s", "correct_wall_s"} <= set(tres)
        # (640 reads cover the preset's 1 Mb genome ~0.1x: few edits)
        (js, jt, jb), (ts, tt, tb) = got["j"][0], got["t"][0]
        assert (ts, tt) == (js, jt) and ts["reads"] == 640
        assert tb == jb
        return
    got = _passes(monkeypatch)
    fn = f"bench_{preset}"
    jres = getattr(j_runners, fn)(JConfig(**kw), n_reads=300)
    tres = getattr(t_runners, fn)(KmeraxConfig(**kw), n_reads=300,
                                  device="cpu")
    assert tres["metric"] == jres["metric"]
    assert tres["unit"] == jres["unit"]
    assert tres["device"] == {"name": "cpu", "power_limit": None}
    assert tres["batch_wall_s"] > 0 and tres["value"] > 0
    (js,), (ts,) = got["j"], got["t"]
    if preset == "count":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(ts.sum()) > 0
    elif preset == "correct":
        assert int(ts) == int(js) > 0
    else:
        assert bool(js[1])
        assert int(ts) == int(js[0]) > 0


@pytest.mark.parametrize("preset", ["count", "correct", "align", "e2e",
                                    "all"])
def test_bench_preset_cli_runs(monkeypatch, preset):
    """`bench --preset P --device cpu` prints the preset's metrics (e2e at
    640 reads: its size is fixed, as in the JAX CLI)."""
    monkeypatch.setattr(t_runners.bench_e2e, "__defaults__", (640, 150))
    res = _cli(["bench", "--preset", preset, "--reads", "256",
                "--bloom-log2-width", "18", "--batch-reads", "256",
                "--exact-capacity", str(1 << 17), "--device", "cpu"])
    names = {"count": "kmers_per_s_per_chip_k31",
             "correct": "reads_per_s_per_chip_k31",
             "align": "align_reads_per_s_per_chip_k31",
             "e2e": "e2e_correct_reads_per_s_k31"}
    recs = res if preset == "all" else {preset: res}
    assert sorted(recs) == sorted(names if preset == "all" else [preset])
    for p, r in recs.items():
        assert r["metric"] == names[p] and r["value"] > 0
        assert r["device"]["name"] == "cpu"


@pytest.mark.parametrize("n", sorted(CONFIGS))
def test_acceptance_cli_matches_jax(jax_reports, monkeypatch, tmp_path, n):
    """`bench --acceptance N --scale S --device cpu` reports what the JAX
    package's run_config reports and writes the same FASTQ and FASTA bytes.
    Config 4 runs 1 x 1 here and 2 x 2 in the reference (DESIGN.md §13)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rep = _cli(["bench", "--acceptance", str(n), "--scale", str(SCALE[n]),
                "--device", "cpu"])
    ref = jax_reports[n]
    for key in FIELDS:
        assert rep.get(key) == ref.get(key), key
    assert rep["config"] == n and rep["name"] == ref["name"]
    assert rep["note"] == ref["note"] and rep["scale"] == ref["scale"]
    assert rep["backend"] == "cpu" and rep["mesh"] == [1, 1]
    assert ref["mesh"] == ([2, 2] if n == 4 else [1, 1])
    assert rep["accuracy"]["gain"] > 0.9
    assert rep["accuracy"]["errors_introduced"] == 0
    outs = sorted(f for f in os.listdir(ref["workdir"])
                  if f.startswith("corrected_") or f.endswith(".fasta"))
    assert len(outs) == (3 if CONFIGS[n].assemble else 2)
    for f in outs:
        with open(os.path.join(rep["workdir"], f), "rb") as a, \
                open(os.path.join(ref["workdir"], f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("argv", [["--scaling"], ["--hosts", "1", "2"]])
def test_bench_scaling_not_ported(argv, monkeypatch):
    """`bench --scaling [--hosts ...]` and `bench --acceptance N --hosts M`
    are ported now (bench/scaling.py, bench/acceptance_mp.py; their runs
    are held in test_torch_multihost_bench.py): the CLI hands them the host
    counts and the device. `--hosts` without either is ignored, as in the
    JAX CLI."""
    import kmerax_torch.bench.acceptance_mp as amp
    import kmerax_torch.bench.runners as runners
    import kmerax_torch.bench.scaling as scaling

    calls = []
    monkeypatch.setattr(scaling, "run_scaling",
                        lambda **kw: calls.append(("scaling", kw)) or {})
    monkeypatch.setattr(amp, "run_config_mp",
                        lambda n, **kw: calls.append(("mp", n, kw)) or {})
    monkeypatch.setattr(runners, "run_preset",
                        lambda *a, **kw: calls.append(("preset",)) or {})
    main(["bench", *argv, "--device", "cpu"])
    main(["bench", "--acceptance", "4", *argv, "--device", "cpu"])
    dev = torch.device("cpu")
    if argv == ["--scaling"]:
        want = [("scaling", dict(host_counts=(1, 2, 4), device=dev))] * 2
    else:
        want = [("preset",), ("mp", 4, dict(scale="1.0", n_procs=1,
                                             device=dev))]
    assert calls == want


def test_mesh_override_not_ported(tmp_path, monkeypatch):
    """A mesh override is ported now: config 4 with mesh_data=2 runs its
    stages on a 2 x 1 gloo mesh of spawned ranks, says so in its report,
    and writes the 1 x 1 run's FASTQ bytes; its wall is rank 0's stages,
    the ranks' launch reported apart. p16 counters run too (on one
    device) and write the same bytes."""
    from kmerax_torch.dist import mesh as dmesh

    monkeypatch.setattr(dmesh, "LAUNCH_TIMEOUT", 300)
    one = run_config(4, scale=0.02, workdir=str(tmp_path / "one"),
                     device="cpu")
    two = run_config(4, scale=0.02, workdir=str(tmp_path / "two"),
                     overrides={"mesh_data": 2}, device="cpu")
    assert one["mesh"] == [1, 1] and two["mesh"] == [2, 1]
    assert two["wall_s"] > 0 and two["launch_s"] > 0
    assert two["reads_per_s"] == two["reads"] / two["wall_s"]
    assert two["accuracy"] == one["accuracy"]
    outs = sorted(f for f in os.listdir(tmp_path / "one")
                  if f.startswith("corrected_"))
    assert len(outs) == 2
    for f in outs:
        assert (tmp_path / "two" / f).read_bytes() == \
            (tmp_path / "one" / f).read_bytes(), f
    p16 = run_config(4, scale=0.02, workdir=str(tmp_path / "p16"),
                     overrides={"bloom_counter": "p16"}, device="cpu")
    assert p16["mesh"] == [1, 1] and p16["accuracy"] == one["accuracy"]
    for f in outs:
        assert (tmp_path / "p16" / f).read_bytes() == \
            (tmp_path / "one" / f).read_bytes(), f
