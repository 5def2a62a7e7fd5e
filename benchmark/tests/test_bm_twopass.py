"""Two-pass jobs (`pipeline --k2`): the reference's k-mers as words at
k > 31, tiny two-pass cells run through the harness on a root of their
own, the control and planted faults, and the job form of the cells
BENCHMARK.json holds."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bm_tiny
from benchmark import sim
from benchmark.harness import cells, jobs, main
from benchmark.reference import assemble, compare, kmers, spectrum, words
from conftest import ROOT

CPU = torch.device("cpu")
REPEATS = (40, 50, 60)          # repeat lengths between k = 31 and k2 = 63


def repeat_simulate(seed, genome_len, coverage, read_len, error_rate,
                    insert_mean, insert_sd):
    """`sim.simulate`'s pair model on a random genome holding three copies
    of each of three repeats of 40, 50 and 60 bases (the third copy
    reverse-complemented): the graph branches at k = 31, not at 63."""
    R, G = read_len, genome_len
    rng = np.random.default_rng([seed, 7])
    genome = rng.integers(0, 4, size=G, dtype=np.int64).astype(np.uint8)
    slot = (G - 400) // (3 * len(REPEATS))
    for u, n in enumerate(REPEATS):
        unit = rng.integers(0, 4, size=n, dtype=np.int64).astype(np.uint8)
        for c in range(3):
            at = 200 + slot * (3 * c + u)
            genome[at:at + n] = unit if c < 2 else 3 - unit[::-1]
    n_pairs = (G * coverage // R) // 2
    rng = np.random.default_rng([seed, 1])
    ins = np.clip(rng.normal(insert_mean, insert_sd, n_pairs), 2 * R,
                  G).astype(np.int64)
    pos = rng.integers(0, G - ins + 1)
    ar = np.arange(R)
    t1 = genome[pos[:, None] + ar]
    t2 = 3 - genome[(pos + ins - R)[:, None] + ar][:, ::-1]
    bases, quals, names = [], [], []
    for mate, true in ((1, t1), (2, t2)):
        errs = rng.random(true.shape) < error_rate
        shifts = rng.integers(1, 4, true.shape).astype(np.uint8)
        bases.append(np.where(errs, (true + shifts) % 4, true)
                     .astype(np.uint8))
        quals.append((rng.integers(30, 40, true.shape) + 33)
                     .astype(np.uint8))
        names.append(np.frombuffer(b"".join(
            b"SIML1C001R%09d/%d" % (i, mate) for i in range(n_pairs)),
            np.uint8).reshape(n_pairs, -1))
    return sim.Dataset(genome, bases, quals, names)


def _root(tmp, k2, traffic="twopass", stages=("count", "correct",
                                                "assemble")):
    """A checkout of the benchmark with one more configuration (chr21's,
    with `k2`), mix and workload, as a later PR adds them."""
    if not (tmp / "benchmark").exists():
        shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text()
                       if (tmp / "BENCHMARK.json").exists()
                       else (ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "chr21_pe150_30x_k31.json").read_text())
    name = f"twopass_k31_k{k2}"
    cfg.update(name=name, k2=k2)
    (tmp / "benchmark" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    (tmp / "benchmark" / "mixes" / f"{traffic}.json").write_text(
        json.dumps({"name": traffic, "command": "pipeline",
                    "stages": list(stages), "fasta": "assemble" in stages,
                    "flags": ["--validate"] if "validate" in stages
                    else []}))
    if name not in [c["name"] for c in bench["configs"]]:
        bench["configs"].append({"name": name, "source": "x",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": ["genome_len"], "why": "x"})
    workload = f"{name}.{traffic}"
    bench["workloads"].append({"name": workload, "config": name,
                               "traffic": traffic, "chips": 1, "why": "x"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return workload


@pytest.fixture
def repeats(monkeypatch):
    monkeypatch.setattr(sim, "simulate", repeat_simulate)


# -- the reference's words -------------------------------------------------

def _value(bases, k):
    """The k-mer's integer, in Python."""
    v = 0
    for b in bases[:k]:
        v = 4 * v + int(b)
    return v


def _as_int(row):
    return sum(int(w) << (32 * i) for i, w in enumerate(row))


@pytest.mark.parametrize("k", [31, 33, 47, 63])
def test_words_hold_the_kmer_and_its_reverse_complement(k):
    g = torch.Generator().manual_seed(k)
    b = torch.randint(0, 4, (6, 80), generator=g, dtype=torch.uint8)
    b[0, 3] = 4
    fwd, rc, valid = words.windows(b, k)
    assert not valid[0, :4].any() and valid[0, 4:].all()
    for r in range(1, 6):
        for j in (0, 1, 80 - k):
            x = b[r, j:j + k].tolist()
            assert _as_int(fwd[r, j].tolist()) == _value(x, k)
            assert _as_int(rc[r, j].tolist()) == _value(
                [3 - y for y in x[::-1]], k)
    assert torch.equal(words.revcomp(fwd, k), rc)
    assert torch.equal(words.revcomp(rc, k), fwd)
    ext = words.extend(fwd[:, :-1], b[:, k:].to(torch.int64), k)
    assert torch.equal(ext, fwd[:, 1:])


def test_words_at_k31_agree_with_the_one_int64_path():
    ds = sim.simulate(3, 3000, 20, 150, 0.01, 450, 37)
    reads = ds.bases + [np.zeros((8, 150), np.uint8)]   # poly-A: a self-edge
    a = spectrum.count(reads, 31, 16, 4, CPU)
    fwd, rc, valid = words.windows(torch.as_tensor(np.concatenate(reads)),
                                   31)
    uniq, counts = words.unique_counts(words.canonical(fwd, rc)[valid])
    as_words = torch.stack([a.uniq & kmers.M32, a.uniq >> 32], 1)
    assert torch.equal(uniq, as_words) and torch.equal(counts, a.counts)
    assert torch.equal(words.probes(as_words, 16, 4),
                       kmers.probes(a.uniq, 31, 16, 4))
    nodes = a.uniq[a.counts >= a.threshold]
    assert np.array_equal(assemble._succ_words(as_words[a.counts
                                                        >= a.threshold], 31),
                          assemble._succ(nodes, 31))


def test_spectrum_diff_over_words():
    u = torch.tensor([[5, 1, 0], [2, 3, 0], [0, 0, 1]])
    c = torch.tensor([4, 7, 9])
    ref = compare.CountOut(u, c, None, [], 2, 0, 0)

    def diff(pu, pc):
        return compare._spectrum_diff(
            compare.CountOut(pu, pc, None, [], 2, 0, 0), ref)
    assert diff(u, c) == 0
    assert diff(u, torch.tensor([4, 8, 9])) == 1
    assert diff(u[1:], c[1:]) == 1
    assert diff(torch.tensor([[5, 1, 0], [7, 3, 0], [0, 0, 1]]), c) == 2
    assert diff(torch.tensor([1, 2, 3]), c) == 6


def test_count_out_keeps_words_past_two():
    four = jobs.CountCapture(np.array([[1, 2, 3, 4]], np.uint32),
                             np.array([5]), None, [0], 2, 1, 1)
    two = jobs.CountCapture(np.array([[1, 2]], np.uint32), np.array([5]),
                            None, [0], 2, 1, 1)
    assert main._count_out(four).uniq.tolist() == [[1, 2, 3, 4]]
    assert main._count_out(two).uniq.tolist() == [1 + (2 << 32)]


# -- the job form ----------------------------------------------------------

GOLDEN = {
    "ecoli50x.count_correct": [
        "pipeline", "--config", "{out}/settings.toml", "--in", "IN1", "IN2",
        "--out-fastq", "{out}/corrected_1.fastq", "{out}/corrected_2.fastq",
        "-k", "31", "--bloom-log2-width", "26", "--exact-capacity",
        "16777216", "--batch-reads", "4096", "--max-read-len", "160",
        "--device", "cuda", "--metrics", "{out}/metrics.jsonl"],
    "chr21_30x.assemble_validate": [
        "pipeline", "--config", "{out}/settings.toml", "--in", "IN1", "IN2",
        "--out-fastq", "{out}/corrected_1.fastq", "{out}/corrected_2.fastq",
        "-k", "31", "--bloom-log2-width", "24", "--exact-capacity",
        "8388608", "--batch-reads", "4096", "--max-read-len", "160",
        "--device", "cuda", "--metrics", "{out}/metrics.jsonl",
        "--out-fasta", "{out}/contigs.fasta", "--validate"],
}
SETTINGS = ('bloom_hashes = 4\nbucket_scheme = "hash"\nbloom_counter = "i32"'
            '\nwire_pack = true\nrounds = 2\nmax_runs = 8\nmax_edits = 8\n'
            'band = 15\n')


@pytest.mark.parametrize("cell", sorted(GOLDEN))
def test_argv_of_the_cells_is_unchanged(tmp_path, cell):
    c = cells.cell(cell)
    out = str(tmp_path / "out")
    got = jobs.argv(c.config, c.mix, ["IN1", "IN2"], out, "cuda")
    assert got == [a.replace("{out}", out) for a in GOLDEN[cell]]
    assert (tmp_path / "out" / "settings.toml").read_text() == SETTINGS


def test_argv_of_a_two_pass_job(tmp_path):
    c = cells.cell("chr21_30x.assemble_validate")
    got = jobs.argv({**c.config, "k2": 63}, {**c.mix, "flags": []},
                    ["IN1"], str(tmp_path), "cpu")
    assert got[got.index("-k"):got.index("-k") + 4] == ["-k", "31", "--k2",
                                                        "63"]


def test_a_two_pass_job_that_validates_is_refused(tmp_path):
    w = _root(tmp_path, 63, "twopass_validate",
              ("count", "correct", "assemble", "validate"))
    with pytest.raises(ValueError, match="two-pass"):
        cells.cell(w, tmp_path)


def test_the_graph_is_the_assemble_wall_less_only_a_count_inside_it():
    stages = [{"stage": "count", "wall_s": 2.0},
              {"stage": "correct", "wall_s": 3.0},
              {"stage": "count", "wall_s": 1.0},
              {"stage": "assemble", "wall_s": 1.5}]
    job = jobs.JobRecord(10.0, 0, stages, [], {})
    one = dict(main._untraced(job, recount_in_assemble=True))
    two = dict(main._untraced(job, recount_in_assemble=False))
    graph = "assemble: graph on the host (untraced)"
    between = "between stages (CLI, spectrum hand-over)"
    assert (one[graph], one[between]) == (0.5, 3.5)
    assert (two[graph], two[between]) == (1.5, 2.5)


# -- tiny two-pass cells ---------------------------------------------------

@pytest.mark.parametrize("k2", [33, 63])
def test_two_pass_cell_is_correct(tmp_path, repeats, k2):
    w = _root(tmp_path, k2)
    r = bm_tiny.run(w, root=tmp_path)
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert {"spectrum_diff", "bloom_diff", "spectrum2_diff", "kmers2_diff",
            "fastq_diff", "fasta_diff"} <= set(checks)
    assert r["correct"] is True, checks
    assert all(v == 0 for v in checks.values())


def test_the_control_is_not_correct(tmp_path, repeats):
    w = _root(tmp_path, 63)
    c = cells.cell(w, tmp_path)
    cfg = {**c.config, **bm_tiny.override(w, root=tmp_path)}
    ds = sim.simulate(2**31 + 5, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"], cfg["insert_mean"],
                      cfg["insert_sd"])
    ref = compare.reference_outputs(ds, cfg, c.mix["stages"], CPU)
    assert ref.counts[1].uniq.shape[1] == 4
    got = compare.checks(compare.control_outputs(ds, cfg, c.mix["stages"],
                                                 CPU), ref)
    assert got["spectrum_diff"] > 0 and got["spectrum2_diff"] > 0


def _pass2_at_k(monkeypatch):
    """The two-pass pipeline counts and assembles pass 2 at k."""
    from kmerax_torch.pipeline import twopass as mod

    orig = mod.run_two_pass
    monkeypatch.setattr(mod, "run_two_pass", lambda cfg, *a, **kw: orig(
        cfg.replace(k2=cfg.k), *a, **kw))


def _count_off_by_one(monkeypatch):
    """Pass 2's most frequent k-mer counted once more."""
    from kmerax_torch.pipeline import twopass as mod

    orig = mod.run_count

    def run_count(cfg, *a, **kw):
        st = orig(cfg, *a, **kw)
        if cfg.k == 63:
            st.host.counts[int(np.argmax(st.host.counts))] += 1
        return st
    monkeypatch.setattr(mod, "run_count", run_count)


def _flipped_fasta_base(monkeypatch):
    """One base of the last unitig written flipped."""
    from kmerax_torch.io import fasta as mod

    orig = mod.write_fasta

    def write(path, seqs):
        s = seqs[-1]
        seqs = seqs[:-1] + [s[:5] + ("C" if s[5] != "C" else "G") + s[6:]]
        orig(path, seqs)
    monkeypatch.setattr(mod, "write_fasta", write)


FAULTS = [(_pass2_at_k, {"kmers2_diff", "spectrum2_diff", "fasta_diff"},
           None),
          (_count_off_by_one, {"spectrum2_diff"}, 1),
          (_flipped_fasta_base, {"fasta_diff"}, 1)]


@pytest.mark.parametrize("fault,numbers,exactly", FAULTS,
                         ids=[f.__name__[1:] for f, _, _ in FAULTS])
def test_fault_in_a_two_pass_job_comes_out_not_correct(
        tmp_path, repeats, monkeypatch, fault, numbers, exactly):
    fault(monkeypatch)
    r = bm_tiny.run(_root(tmp_path, 63), root=tmp_path)
    assert r["correct"] is False
    for n in numbers:
        assert r["checks"][n]["value"] > 0, (n, r["checks"])
        if exactly is not None:
            assert r["checks"][n]["value"] == exactly


_REF = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import sim
from benchmark.reference import compare
cfg = {cfg!r}
ds = sim.simulate(5, cfg["genome_len"], cfg["coverage"], cfg["read_len"],
                  cfg["error_rate"], cfg["insert_mean"], cfg["insert_sd"])
out = compare.reference_outputs(ds, cfg, ["count", "correct", "assemble"],
                                torch.device("cpu"))
assert out.counts[1].uniq.shape[1] == 4 and out.fasta
print(json.dumps(sorted(sys.modules)))
"""


def test_two_pass_reference_loads_nothing_of_the_program_or_jax():
    cfg = {**cells.cell("chr21_30x.assemble_validate").config,
           **bm_tiny.override("chr21_30x.assemble_validate"), "k2": 63}
    p = subprocess.run([sys.executable, "-c", _REF.format(
        root=str(ROOT), cfg=cfg)], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(p.stdout.splitlines()[-1])}
    assert not tops & {"kmerax_torch", "kmerax", "jax", "jaxlib", "flax",
                       "oracle", "chip_smoke"}
