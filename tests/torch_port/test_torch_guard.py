"""Guards on the port's boundaries: it imports no JAX and reads no file of
the JAX package, its config is the JAX package's, the card is never
silently replaced by the CPU, and paths that cannot run fail loudly."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax_torch.cli import main
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline.run import run_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _port_modules() -> list[str]:
    """Every module of kmerax_torch, by dotted name (dist/ included)."""
    pkg = Path(ROOT) / "kmerax_torch"
    return sorted(
        ".".join(("kmerax_torch", *p.relative_to(pkg).with_suffix("").parts))
        .removesuffix(".__init__") for p in pkg.rglob("*.py"))


def test_port_imports_no_jax():
    """The GPU machine has no jax: a stray import would only show there.
    Every module of the package is imported."""
    mods = _port_modules()
    assert "kmerax_torch.dist.mesh" in mods
    assert "kmerax_torch.spectrum.sharded" in mods
    # the multi-host modules
    assert {"kmerax_torch.io.shard", "kmerax_torch.spectrum.host_sharded",
            "kmerax_torch.graph.sharded", "kmerax_torch.bench.acceptance_mp",
            "kmerax_torch.bench.scaling",
            "kmerax_torch.bench._scaling_worker"} <= set(mods)
    code = (f"import importlib, sys; [importlib.import_module(m) for m in "
            f"{mods!r}];"
            " bad = [m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'kmerax', 'oracle')];"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_modules_import_nothing_of_jax():
    """No module of kmerax_torch (dist/ included) names jax, jaxlib, the
    JAX package or the oracle in an import statement, at any depth of its
    code, so an import that only runs inside a function fails here too."""
    pkg = Path(ROOT) / "kmerax_torch"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "kmerax",
                                          "oracle"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert (Path(ROOT) / "kmerax_torch" / "dist" / "mesh.py").exists()
    assert (Path(ROOT) / "kmerax_torch" / "graph" / "sharded.py").exists()
    assert not bad, bad


# the layers below the stages, and the modules above them that they must
# not reach: the stages (pipeline/) call down into these, never back
LOWER = ("core", "utils", "io", "spectrum", "ops", "graph")
UPPER = ("kmerax_torch.pipeline", "kmerax_torch.bench", "kmerax_torch.cli")


def _imported(path: Path) -> list[str]:
    """The dotted modules a module's import statements name, at any depth
    of its code (lazy imports inside functions included), relative ones
    resolved and `from pkg import mod` read as pkg.mod."""
    pkg = ["kmerax_torch", *path.relative_to(Path(ROOT) / "kmerax_torch")
           .parent.parts]
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = pkg[:len(pkg) - node.level + 1]
                base = ".".join([*up, base] if base else up)
            out.append(base)
            out.extend(f"{base}.{a.name}" for a in node.names)
    return out


@pytest.mark.parametrize("layer", LOWER)
def test_lower_layers_import_no_stage(layer):
    """No module of core/, utils/, io/, spectrum/, ops/ or graph/ imports
    kmerax_torch.pipeline, .bench or .cli, lazily or not: the graph only
    assembles a spectrum it is given, and the stage layer re-counts."""
    files = sorted((Path(ROOT) / "kmerax_torch" / layer).rglob("*.py"))
    assert files, layer
    bad = [f"{p.relative_to(ROOT)}: {name}" for p in files
           for name in _imported(p)
           if any(name == u or name.startswith(u + ".") for u in UPPER)]
    assert not bad, bad


def test_config_matches_jax():
    fields = {f.name: f.default for f in dataclasses.fields(KmeraxConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert fields == want
    cfg = KmeraxConfig(k=25, threshold=4, bloom_log2_width=20)
    assert JConfig.from_json(cfg.to_json()) == JConfig(
        k=25, threshold=4, bloom_log2_width=20)
    for bad in (dict(k=32), dict(k=65), dict(bloom_log2_width=14),
                dict(num_buckets=3), dict(bloom_counter="u8")):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            KmeraxConfig(**bad)


def test_device_cuda_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    fq = tmp_path / "r.fastq"
    fq.write_bytes(b"@r\n" + b"ACGT" * 10 + b"\n+\n" + b"I" * 40 + b"\n")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["pipeline", "--in", str(fq), "--out-fastq",
              str(tmp_path / "o.fastq")])
    with pytest.raises(RuntimeError, match="cuda"):
        run_pipeline(KmeraxConfig(), [str(fq)], str(tmp_path / "o.fastq"),
                     device="cuda")
    assert not (tmp_path / "o.fastq").exists()


def _code_strings(path: Path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_builds_no_path_into_the_jax_package():
    """No module of kmerax_torch names the JAX package's directory in code
    (a path like `... / "kmerax" / ...` or "kmerax/..."): the GPU machine's
    checkout of the port must stand alone."""
    pkg = Path(ROOT) / "kmerax_torch"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        for s in _code_strings(path):
            parts = s.replace("\\", "/").split("/")
            if "kmerax" in parts or "oracle" in parts:
                bad.append(f"{path.relative_to(ROOT)}: {s!r}")
    assert not bad, bad


def test_native_parser_source_is_the_ports_own():
    """io/native.py compiles kmerax_torch/io/_fastq_ext.cc, the port's copy
    of the JAX package's parser, under the same digest key."""
    from kmerax_torch.io import native

    assert native._SRC == Path(ROOT) / "kmerax_torch" / "io" / "_fastq_ext.cc"
    assert native._SRC.read_bytes() == \
        (Path(ROOT) / "kmerax" / "io" / "_fastq_ext.cc").read_bytes()
    assert native._so_path().parent == Path(ROOT) / "kmerax_torch" / "_build"


@pytest.mark.parametrize("extra", [
    ["--process-id", "2", "--num-procs", "2", "--mesh-data", "2"],
    ["--num-procs", "4", "--process-id", "0", "--mesh-bucket", "2"],
    ["--num-procs", "2", "--process-id", "0"],
    []])
def test_unported_flags_fail(tmp_path, extra, monkeypatch):
    """The multi-host flags are ported now; a geometry that cannot run
    fails loudly before any rank starts: a process id outside [0, N), a
    mesh whose D·S does not divide over the N hosts (the last case reads
    N and the process id from KMERAX_NUM_PROCS / KMERAX_PROCESS_INDEX, as
    the JAX CLI does)."""
    monkeypatch.setenv("KMERAX_NUM_PROCS", "3")
    monkeypatch.setenv("KMERAX_PROCESS_INDEX", "1")
    want = ("process id 2 outside" if extra[:2] == ["--process-id", "2"]
            else "does not divide over")
    with pytest.raises(ValueError, match=want):
        main(["pipeline", "--in", "r.fastq", "--out-fastq",
              str(tmp_path / "o.fastq"), "--device", "cpu",
              "--coordinator", "127.0.0.1:1", *extra])
    assert not (tmp_path / "o.fastq").exists()


@pytest.mark.parametrize("kw", [dict(bloom_counter="p16"),
                                dict(bloom_counter="p16", mesh_data=2,
                                     mesh_bucket=2)])
def test_unported_config_fails(tmp_path, kw):
    """p16 counters are ported: on one device the pipeline runs and writes
    the i32 run's bytes; on a mesh it raises the JAX package's words
    before any rank work (sharded spectra keep i32 counters)."""
    from sim import ecoli_like, make_fastq

    _, reads = ecoli_like(seed=3, genome_len=1200, coverage=20,
                          read_len=100, error_rate=0.01)
    fq = tmp_path / "r.fastq"
    fq.write_bytes(make_fastq(reads))
    base = dict(k=31, bloom_log2_width=15, batch_reads=128,
                max_read_len=100, exact_capacity=1 << 16)
    if kw.get("mesh_data", 1) > 1:
        with pytest.raises(ValueError,
                           match="sharded spectra keep i32 counters"):
            run_pipeline(KmeraxConfig(**base, **kw), [str(fq)],
                         str(tmp_path / "o.fastq"), device="cpu")
        assert not (tmp_path / "o.fastq").exists()
        return
    res = {c: run_pipeline(KmeraxConfig(**base, bloom_counter=c), [str(fq)],
                           str(tmp_path / f"{c}.fastq"), device="cpu")
           for c in ("p16", "i32")}
    assert res["p16"] == res["i32"] and res["p16"]["edited_reads"] > 0
    assert (tmp_path / "p16.fastq").read_bytes() == \
        (tmp_path / "i32.fastq").read_bytes()
