"""One job: the CLI's `main` in this process, as a user runs it, with the
count passes' results captured for the comparison.

The capture wraps `run_count` where the one-pass pipeline, the assembly's
re-count and the two-pass pipeline (`pipeline --k2`) look it up; it keeps
what a count pass returns (the exact spectrum on the host, the histogram,
the threshold, and the first pass's Bloom table) and reads
`LAST_COUNT_FLUSHES` after each pass. It adds no work to the job. A
one-pass pipeline holds its first table to its end anyway; a two-pass one
frees it before pass 2 counts, but the capture keeps it alive through pass
2, so the memory peak of a two-pass cell includes it."""

from __future__ import annotations

import contextlib
import io
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class CountCapture:
    uniq: object            # (M, W) uint32 numpy
    counts: object          # (M,) int64 numpy
    table: object           # the first pass's device table, else None
    hist: list
    threshold: int
    n_reads: int
    n_kmers: int


@dataclass
class JobRecord:
    wall_s: float
    reads: int
    stages: list                    # metrics.jsonl records, in order
    flushes: list                   # exact-spectrum flushes a count pass
    result: dict                    # the CLI's printed result
    counts: list = field(default_factory=list)      # CountCapture a pass
    trace: list = None              # trace.StageTrace a stage, profiled


class Recorder:
    """Wraps the program's count entry points; `take()` hands over what
    the job since the last `take()` counted."""

    def __init__(self):
        from kmerax_torch.pipeline import count as count_mod
        from kmerax_torch.pipeline import run as run_mod
        from kmerax_torch.pipeline import twopass as twopass_mod

        self._count_mod = count_mod
        self._mods = (count_mod, run_mod, twopass_mod)
        self._origs = [m.run_count for m in self._mods]
        self._counts, self._flushes = [], []
        for m, orig in zip(self._mods, self._origs):
            m.run_count = self._wrap(orig)

    def _wrap(self, orig):
        def run_count(*a, **kw):
            st = orig(*a, **kw)
            self._flushes.append(self._count_mod.LAST_COUNT_FLUSHES)
            host = st.host
            self._counts.append(CountCapture(
                None if host is None else host.uniq,
                None if host is None else host.counts,
                st.bloom_table if not self._counts else None,
                [int(x) for x in st.hist], int(st.threshold),
                int(st.n_reads), int(st.n_kmers)))
            return st
        return run_count

    def take(self):
        out = self._counts, self._flushes
        self._counts, self._flushes = [], []
        return out

    def close(self):
        for m, orig in zip(self._mods, self._origs):
            m.run_count = orig


# the configuration's program settings the CLI takes from a --config TOML
TOML_KEYS = ("bloom_hashes", "bucket_scheme", "bloom_counter", "wire_pack",
             "rounds", "max_runs", "max_edits", "band")


def _toml(cfg: dict, path: str) -> str:
    with open(path, "w") as f:
        for key in TOML_KEYS:
            v = cfg[key]
            f.write(f"{key} = " + (("true" if v else "false")
                                   if isinstance(v, bool) else
                                   f'"{v}"' if isinstance(v, str)
                                   else str(v)) + "\n")
    return path


def argv(cfg: dict, mix: dict, inputs: list, outdir: str,
         device: str) -> list:
    """The job's CLI arguments: the configuration's program settings (with
    `k2`, a two-pass job), the mix's job form, outputs under `outdir`."""
    os.makedirs(outdir, exist_ok=True)
    a = [mix["command"], "--config",
         _toml(cfg, os.path.join(outdir, "settings.toml")),
         "--in", *inputs, "--out-fastq",
         *[os.path.join(outdir, f"corrected_{i + 1}.fastq")
           for i in range(len(inputs))],
         "-k", str(cfg["k"]),
         *(["--k2", str(cfg["k2"])] if cfg.get("k2") else []),
         "--bloom-log2-width", str(cfg["bloom_log2_width"]),
         "--exact-capacity", str(cfg["exact_capacity"]),
         "--batch-reads", str(cfg["batch_reads"]),
         "--max-read-len", str(cfg["max_read_len"]),
         "--device", device,
         "--metrics", os.path.join(outdir, "metrics.jsonl")]
    if mix.get("fasta"):
        a += ["--out-fasta", os.path.join(outdir, "contigs.fasta")]
    return a + list(mix.get("flags", []))


def run(args: list, outdir: str, n_reads: int, recorder: Recorder,
        sync) -> JobRecord:
    """Run one job; its wall ends when the CLI returns and the device is
    idle."""
    from kmerax_torch.cli import main

    os.makedirs(outdir, exist_ok=True)
    mpath = os.path.join(outdir, "metrics.jsonl")
    if os.path.exists(mpath):
        os.remove(mpath)
    recorder.take()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    sync()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    with open(mpath) as f:
        stages = [json.loads(ln) for ln in f if ln.strip()]
    counts, flushes = recorder.take()
    return JobRecord(wall, n_reads, stages, flushes, json.loads(lines[-1]),
                     counts)
