"""Guards on the port's boundaries: it imports no JAX and reads no file of
the JAX package, its config is the JAX package's, the card is never
silently replaced by the CPU, and paths not yet ported fail loudly."""

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


def test_port_imports_no_jax():
    """The GPU machine has no jax: a stray import would only show there."""
    code = ("import kmerax_torch, kmerax_torch.cli, kmerax_torch.pipeline.run,"
            " kmerax_torch.ops.correct_kernels,"
            " kmerax_torch.spectrum.bloom_kernels, kmerax_torch.ops.align,"
            " kmerax_torch.ops.align_kernels, kmerax_torch.ops.seed_hash,"
            " kmerax_torch.pipeline.align, kmerax_torch.pipeline.twopass,"
            " kmerax_torch.pipeline.checkpoint, kmerax_torch.core.minimizer,"
            " kmerax_torch.io.wire, kmerax_torch.bench.runners,"
            " kmerax_torch.bench.acceptance, kmerax_torch.bench.sim;"
            " import sys;"
            " bad = [m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'kmerax', 'oracle')];"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


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


@pytest.mark.parametrize("extra", [["--mesh-data", "2"], ["--mesh-bucket", "2"],
                                   ["--num-procs", "2"],
                                   ["--coordinator", "localhost:1234"]])
def test_unported_flags_fail(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(["pipeline", "--in", "r.fastq", "--out-fastq", "o.fastq",
              "--device", "cpu", *extra])


@pytest.mark.parametrize("kw", [dict(bloom_counter="p16"),
                                dict(mesh_data=2)])
def test_unported_config_fails(tmp_path, kw):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_pipeline(KmeraxConfig(**kw), ["r.fastq"],
                     str(tmp_path / "o.fastq"), device="cpu")
