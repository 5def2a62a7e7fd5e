"""Spectrum checkpoints and the staged CLI (`count`, `correct --spectrum`,
`assemble --spectrum`) of kmerax_torch against the JAX package's: equal
manifests and npz arrays, checkpoints read across the two packages, and
byte-identical FASTQ and FASTA. Exact: tolerance 0."""

import json

import numpy as np
import pytest

from kmerax.pipeline.checkpoint import load_spectrum as j_load_spectrum
from kmerax_torch.cli import main
from kmerax_torch.pipeline.checkpoint import load_spectrum
from sim import ecoli_like, make_fastq

from parity import run_clis

# tests/golden/test_pipeline.py's dataset and config; a capacity below the
# distinct k-mer count gives the host form
COMMON = ["-k", "31", "--bloom-log2-width", "18", "--batch-reads", "128",
          "--max-read-len", "100"]
CAP = {"exact": 1 << 17, "host": 1 << 12}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden FASTQ, both packages' `count` of it in each form (JSON
    results and spectrum dirs), and the JAX package's fresh `correct`."""
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    d = tmp_path_factory.mktemp("ckpt")
    fq = d / "reads.fastq"
    fq.write_bytes(make_fastq(reads))
    out = {"fq": str(fq), "dir": d}
    for form, cap in CAP.items():
        args = [*COMMON, "--exact-capacity", str(cap)]
        out[form] = run_clis(["count", "--in", str(fq), "--out",
                              str(d / f"{{pkg}}_{form}"), *args])
        run_clis(["correct", "--in", str(fq), "--out",
                  str(d / f"{{pkg}}_{form}_fresh.fastq"), *args])
    return out


@pytest.mark.parametrize("form", ["exact", "host"])
def test_count_checkpoint_matches_jax(golden, form):
    """Equal JSON results, manifest fields, and npz arrays (names, dtypes,
    shapes, values); the port's loader reads both."""
    jres, tres = golden[form]
    assert tres == jres
    d = golden["dir"]
    jm, ja = j_load_spectrum(str(d / f"j_{form}"))
    tm, ta = load_spectrum(str(d / f"t_{form}"))
    assert tm == jm
    assert sorted(ta) == sorted(ja)
    want = {"exact": ["bloom_table", "exact_counts", "exact_n", "exact_uniq",
                      "hist"],
            "host": ["bloom_table", "hist", "host_counts", "host_uniq"]}
    assert sorted(ta) == want[form]
    for name in ja:
        assert ta[name].dtype == ja[name].dtype, name
        assert ta[name].shape == ja[name].shape, name
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    assert load_spectrum(str(d / f"j_{form}"))[0] == jm
    with open(d / f"t_{form}" / "manifest.json") as f:
        assert json.load(f)["threshold"] == jres["threshold"]
    if form == "exact":
        assert ta["exact_uniq"].shape[0] == CAP["exact"]
        assert int(ta["exact_n"]) < CAP["exact"]


@pytest.mark.parametrize("flag,field,value", [
    ("--no-wire-pack", "wire_pack", False),
    ("--shard-host-spectrum", "shard_host_spectrum", True),
    ("--no-shard-host-spectrum", "shard_host_spectrum", False)])
def test_count_manifest_flags_match_jax(golden, tmp_path, flag, field, value):
    """`count` with each config flag that only reaches the manifest in one
    process: the port's manifest equals the JAX package's, the field set."""
    run_clis(["count", "--in", golden["fq"], "--out",
              str(tmp_path / "{pkg}"), *COMMON, "--exact-capacity",
              str(CAP["exact"]), flag])
    jm, _ = j_load_spectrum(str(tmp_path / "j"))
    tm, _ = load_spectrum(str(tmp_path / "t"))
    assert tm == jm
    assert tm["config"][field] is value


def test_fresh_correct_matches_jax(golden):
    d = golden["dir"]
    for form in CAP:
        assert (d / f"t_{form}_fresh.fastq").read_bytes() == \
            (d / f"j_{form}_fresh.fastq").read_bytes()


@pytest.mark.parametrize("form", ["exact", "host"])
@pytest.mark.parametrize("writer", ["j", "t"])
def test_correct_reads_either_packages_spectrum(golden, tmp_path, form,
                                                writer):
    """`correct --spectrum` of each package on the spectrum that `writer`
    saved: FASTQ bytes equal to a fresh `correct` of the reads."""
    d = golden["dir"]
    jres, tres = run_clis([
        "correct", "--in", golden["fq"], "--spectrum",
        str(d / f"{writer}_{form}"), "--out", str(tmp_path / "{pkg}.fastq"),
        *COMMON, "--exact-capacity", str(CAP[form])])
    assert tres == jres and jres["edited_reads"] > 0
    fresh = (d / f"j_{form}_fresh.fastq").read_bytes()
    for pkg in "jt":
        assert (tmp_path / f"{pkg}.fastq").read_bytes() == fresh, pkg


@pytest.mark.parametrize("writer", ["j", "t"])
def test_assemble_spectrum_matches_jax(golden, tmp_path, writer):
    """`assemble --spectrum` on an exact-form checkpoint: the port's host
    path gives the bytes of the JAX package's device path."""
    jres, tres = run_clis([
        "assemble", "--spectrum", str(golden["dir"] / f"{writer}_exact"),
        "--out", str(tmp_path / "{pkg}.fa"), *COMMON])
    assert tres == jres and jres["unitigs"] > 0
    assert (tmp_path / "t.fa").read_bytes() == \
        (tmp_path / "j.fa").read_bytes()


def test_assemble_host_form_checkpoint_raises_as_jax(golden, tmp_path):
    """The JAX package's `_load_or_count` reads only `exact_uniq`, so a
    host-form checkpoint has no spectrum for `assemble`: both raise."""
    from kmerax.cli import main as j_main

    spec = str(golden["dir"] / "t_host")
    argv = ["assemble", "--spectrum", spec, "--out",
            str(tmp_path / "x.fa"), *COMMON]
    with pytest.raises(ValueError, match="assembly needs exact_spectrum"):
        j_main(argv)
    with pytest.raises(ValueError, match="assembly needs exact_spectrum"):
        main([*argv, "--device", "cpu"])
    assert not (tmp_path / "x.fa").exists()


def test_missing_spectrum_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        main(["correct", "--in", "r.fastq", "--out", "o.fastq",
              "--spectrum", str(tmp_path / "none"), "--device", "cpu"])
    assert e.value.code == 2
