"""A tiny size of each cell, for runs on the CPU: the cell's shapes
(read length, coverage, error rate, k, batch shape) on a short genome,
with tables sized by the same rule."""

import time

from benchmark import sizing
from benchmark.harness import cells, main

GENOME = 4000


def override(workload: str, genome_len: int = GENOME, root=cells.ROOT):
    cfg = cells.cell(workload, root).config
    n = sizing.n_reads(genome_len, cfg["coverage"], cfg["read_len"])
    s = sizing.sized(genome_len, n, cfg["read_len"], cfg["error_rate"],
                     cfg["k"])
    return {"genome_len": genome_len, **s, "batch_reads": 256}


def run(workload: str, seed: int = 2**31 + 17, traced: bool = False,
        root=cells.ROOT):
    return main.run(workload, seed, 0.5, traced, t_start=time.perf_counter(),
                    device="cpu", root=root,
                    config_override=override(workload, root=root))
