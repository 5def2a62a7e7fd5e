"""The benchmark of kmerax_torch: whole CLI jobs on simulated datasets,
timed on the host clock, traced with torch.profiler, and held to a plain
torch reference (`reference/`). `python3 benchmark/run.py --workload CELL
--seed N --seconds S --trace 0|1` runs one cell of BENCHMARK.json."""
