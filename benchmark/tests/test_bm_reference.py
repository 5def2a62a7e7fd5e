"""The reference: independent of the program, and sharp enough."""

import json
import subprocess
import sys

import numpy as np
import torch

from benchmark import sim
from benchmark.harness import cells
from benchmark.reference import compare
from bm_tiny import override
from conftest import ROOT

_REF = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import sim
from benchmark.reference import compare
cfg = {cfg!r}
ds = sim.simulate(5, cfg["genome_len"], cfg["coverage"], cfg["read_len"],
                  cfg["error_rate"], cfg["insert_mean"], cfg["insert_sd"])
compare.reference_outputs(ds, cfg, {stages!r}, torch.device("cpu"))
print(json.dumps(sorted(sys.modules)))
"""


def _cfg(cell):
    c = cells.cell(cell)
    return {**c.config, **override(cell)}, c.mix["stages"]


def test_reference_loads_nothing_of_the_program_or_jax():
    cfg, stages = _cfg("chr21_30x.assemble_validate")
    p = subprocess.run([sys.executable, "-c", _REF.format(
        root=str(ROOT), cfg=cfg, stages=stages)], capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(p.stdout.splitlines()[-1])}
    assert not tops & {"kmerax_torch", "kmerax", "jax", "jaxlib", "flax",
                       "oracle", "chip_smoke"}


def _flip_one_base(fq: bytes) -> bytes:
    lines = fq.split(b"\n")
    s = bytearray(lines[1])
    s[7] = ord("A") if s[7] != ord("A") else ord("C")
    lines[1] = bytes(s)
    return b"\n".join(lines)


def test_one_flipped_base_in_the_corrected_fastq_fails():
    cfg, stages = _cfg("ecoli50x.count_correct")
    ds = sim.simulate(9, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"], cfg["insert_mean"],
                      cfg["insert_sd"])
    ref = compare.reference_outputs(ds, cfg, stages, torch.device("cpu"))
    same = compare.Outputs(ref.counts, list(ref.fastq), ref.fasta,
                           dict(ref.result))
    assert all(v == 0 for v in compare.checks(same, ref).values())
    bad = compare.Outputs(ref.counts, [_flip_one_base(ref.fastq[0]),
                                       ref.fastq[1]], ref.fasta,
                          dict(ref.result))
    assert compare.checks(bad, ref)["fastq_diff"] == 1


def test_reference_corrects_and_assembles_something():
    cfg, stages = _cfg("chr21_30x.assemble_validate")
    ds = sim.simulate(11, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"], cfg["insert_mean"],
                      cfg["insert_sd"])
    ref = compare.reference_outputs(ds, cfg, stages, torch.device("cpu"))
    assert ref.result["edits"] > 0
    assert ref.fasta.count(b">") >= 1
    assert ref.result["validate"]["aligned"] > 0
    assert np.asarray(ref.counts[0].hist).sum() == ref.counts[0].uniq.numel()
