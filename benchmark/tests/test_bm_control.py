"""The control: the reference with every spectrum count read from the
counting Bloom instead of counted exactly, put in the program's place. It
must come out not correct. On the CPU at a tiny size; on a card at each
cell's own size over the seeds in BM_CONTROL_SEEDS (default three)."""

import os
import time

import pytest
import torch

from benchmark import sim
from benchmark.harness import cells
from benchmark.reference import compare
from bm_tiny import override

CELLS = ["ecoli50x.count_correct", "chr21_30x.assemble_validate"]


def _readings(cell, cfg, seed, device):
    c = cells.cell(cell)
    ds = sim.simulate(seed, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"], cfg["insert_mean"],
                      cfg["insert_sd"])
    t = time.perf_counter()
    ref = compare.reference_outputs(ds, cfg, c.mix["stages"], device)
    ref_s = time.perf_counter() - t
    ctl = compare.control_outputs(ds, cfg, c.mix["stages"], device)
    return compare.checks(ctl, ref), ref_s


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_tiny_size(cell):
    cfg = {**cells.cell(cell).config, **override(cell)}
    got, _ = _readings(cell, cfg, 2**31 + 99, torch.device("cpu"))
    assert got["spectrum_diff"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    seeds = [int(s) for s in os.environ.get(
        "BM_CONTROL_SEEDS", "3100000001 3100000002 3100000003").split()]
    cfg = cells.cell(cell).config
    for seed in seeds:
        got, ref_s = _readings(cell, cfg, seed, card)
        print(f"control {cell} seed {seed}: reference {ref_s:.2f} s; "
              + ", ".join(f"{k}={v}" for k, v in got.items()))
        assert any(v > 0 for v in got.values())
        torch.cuda.empty_cache()
