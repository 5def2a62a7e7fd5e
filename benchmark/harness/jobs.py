"""One job: the CLI's `main` in this process, as a user runs it, with the
count passes' results captured for the comparison.

The capture wraps `run_count` where the one-pass pipeline, the assembly's
re-count and the two-pass pipeline (`pipeline --k2`) look it up; it keeps
what a count pass returns (the exact spectrum on the host, the histogram,
the threshold, and the first pass's Bloom table) and reads
`LAST_COUNT_FLUSHES` after each pass. It adds no work to the job. A
one-pass pipeline holds its first table to its end anyway; a two-pass one
frees it before pass 2 counts, but the capture keeps it alive through pass
2, so the memory peak of a two-pass cell includes it.

A configuration that names a ("data", "bucket") mesh (`mesh_data` x
`mesh_bucket` > 1) runs the CLI with `--mesh-data/--mesh-bucket`, and the
CLI runs the job on D·S spawned ranks (`kmerax_torch.dist.mesh.launch`).
The recorder then wraps `launch` too: each rank runs `rank_job`, which
installs the same capture in the rank, points its traces at
`<KMERAX_TRACE_DIR>/rank<r>`, runs the job, and hands back, as raw arrays
in the run's temp dir, rank 0's count passes, the first pass's Bloom table
and every rank's memory peak. The ranks write before they exit, so the
hand-back lies inside the job's wall."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class CountCapture:
    uniq: object            # (M, W) uint32 numpy
    counts: object          # (M,) int64 numpy
    table: object           # the first pass's table, else None
    hist: list
    threshold: int
    n_reads: int
    n_kmers: int
    # `table` is this rank's merged (width/S,) bucket slice: a mesh count
    # past REPLICATE_TABLE_BUDGET keeps no replicated table
    shard: bool = False


@dataclass
class Handback:
    """What a mesh job's ranks handed back besides their count passes:
    each rank's device memory peak, the seconds the slowest rank took to
    hand back (inside the job's wall) and the seconds this process took to
    read it (after the wall, inside the window). `main` takes both out of
    the window's time for `reads_per_s`: they are the harness's work."""
    peaks: list
    handover_s: float
    read_s: float


@dataclass
class JobRecord:
    wall_s: float
    reads: int
    stages: list                    # metrics.jsonl records, in order
    flushes: list                   # exact-spectrum flushes a count pass
    result: dict                    # the CLI's printed result
    counts: list = field(default_factory=list)      # CountCapture a pass
    trace: list = None              # trace.StageTrace a stage, profiled
    handback: Handback = None       # a mesh job's


class Counts:
    """Wraps `run_count` where the pipelines look it up and keeps, a count
    pass, what it returned (`passes`) and `LAST_COUNT_FLUSHES` after it
    (`flushes`), until `close()`."""

    def __init__(self):
        from kmerax_torch.pipeline import count as count_mod
        from kmerax_torch.pipeline import run as run_mod
        from kmerax_torch.pipeline import twopass as twopass_mod

        self._count_mod = count_mod
        self._mods = (count_mod, run_mod, twopass_mod)
        self._origs = [m.run_count for m in self._mods]
        self.passes, self.flushes = [], []
        for m, orig in zip(self._mods, self._origs):
            m.run_count = self._wrap(orig)

    def _wrap(self, orig):
        def run_count(*a, **kw):
            st = orig(*a, **kw)
            self.flushes.append(self._count_mod.LAST_COUNT_FLUSHES)
            host = st.host
            table, shard = None, False
            if not self.passes:
                table = st.bloom_table
                if table is None and st.sharded_table is not None:
                    table, shard = st.sharded_table, True
            self.passes.append(CountCapture(
                None if host is None else host.uniq,
                None if host is None else host.counts, table,
                [int(x) for x in st.hist], int(st.threshold),
                int(st.n_reads), int(st.n_kmers), shard))
            return st
        return run_count

    def close(self):
        for m, orig in zip(self._mods, self._origs):
            m.run_count = orig


class Recorder:
    """Captures the count passes of the jobs this process runs and, where
    the CLI runs a job on a mesh, of its ranks: `launch` is wrapped so
    that every rank runs `rank_job` and hands back into a temp dir of its
    launch's own."""

    def __init__(self):
        from kmerax_torch.dist import mesh as dmesh

        self._counts = Counts()
        self._dmesh, self._launch = dmesh, dmesh.launch
        self._launches = []
        # the hand-back of the mesh jobs taken last, None where none ran
        self.handback = None
        dmesh.launch = self._wrap_launch

    def _wrap_launch(self, spec, device, fn, *args, **kw):
        d = tempfile.mkdtemp(prefix="kmerax_handback_")
        self._launches.append((d, spec))
        return self._launch(spec, device, rank_job, d, fn, *args, **kw)

    def take(self) -> tuple:
        """(counts, flushes): each pass's CountCapture and flushes of the
        jobs since the last `take()`, their ranks' where they ran on a
        mesh, whose other readings it leaves in `handback`. Raises
        SystemExit(3) where a rank held a forbidden module."""
        c = self._counts
        counts, flushes = c.passes, c.flushes
        c.passes, c.flushes = [], []
        self.handback = None
        if self._launches:
            t = time.perf_counter()
            hb = Handback([], 0.0, 0.0)
            for d, spec in self._launches:
                _read_handback(d, spec.ndev, counts, flushes, hb)
                shutil.rmtree(d)
            self._launches = []
            hb.read_s = time.perf_counter() - t
            self.handback = hb
        return counts, flushes

    def close(self):
        self._counts.close()
        self._dmesh.launch = self._launch
        for d, _ in self._launches:     # a failed job's, never taken
            shutil.rmtree(d, ignore_errors=True)


# -- a mesh job's hand-back ------------------------------------------------
# In the launch's directory, from each rank r: rank<r>.npz, its arrays
# (rank 0: uniq<i> and counts<i> of each pass i with a host spectrum, and
# `table`, the first pass's replicated table; a rank of data row 0 whose
# first pass kept the table bucket-sharded: `slice`, its merged slice), and
# rank<r>.json, its numbers ({"peak_bytes", "forbidden", "handover_s"},
# "slice" = its bucket where it wrote one; rank 0: "passes", "flushes").

def rank_job(handback: str, fn, *args):
    """fn(*args) on this rank of a mesh job, as `launch` would run it:
    with the count passes captured and, where KMERAX_TRACE_DIR is set, the
    traces under <KMERAX_TRACE_DIR>/rank<r>; then hands back into
    `handback`. A module-level function, so spawn pickles it by name."""
    import torch
    from kmerax_torch.dist import mesh as dmesh

    m = dmesh.current()
    tdir = os.environ.get("KMERAX_TRACE_DIR")
    if tdir:
        os.environ["KMERAX_TRACE_DIR"] = os.path.join(tdir, f"rank{m.rank}")
    counts = Counts()
    try:
        out = fn(*args)
    finally:
        counts.close()
    meta = {"peak_bytes": int(torch.cuda.max_memory_allocated(m.device)
                              if m.device.type == "cuda" else 0),
            "forbidden": forbidden_modules()}
    t = time.perf_counter()
    passes, arrays = counts.passes, {}
    first = passes[0] if passes else None
    if first is not None and first.shard and m.d == 0:
        arrays["slice"], meta["slice"] = _host(first.table), m.s
    if m.rank == 0:
        for i, p in enumerate(passes):
            if p.uniq is not None:
                arrays[f"uniq{i}"], arrays[f"counts{i}"] = p.uniq, p.counts
        if first is not None and first.table is not None and not first.shard:
            arrays["table"] = _host(first.table)
        meta["passes"] = [[p.hist, p.threshold, p.n_reads, p.n_kmers]
                          for p in passes]
        meta["flushes"] = counts.flushes
    np.savez(os.path.join(handback, f"rank{m.rank}.npz"), **arrays)
    meta["handover_s"] = time.perf_counter() - t
    with open(os.path.join(handback, f"rank{m.rank}.json"), "w") as f:
        json.dump(meta, f)
    return out


def _host(x):
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


def _read_handback(d: str, n_ranks: int, counts: list, flushes: list,
                   hb: Handback) -> None:
    """One launch's hand-back, added to `counts`, `flushes` and `hb`."""
    import torch

    metas = []
    for r in range(n_ranks):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            metas.append(json.load(f))
    bad = sorted({x for m in metas for x in m["forbidden"]})
    if bad:
        print(f"forbidden modules loaded in a mesh job's ranks: {bad}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
    hb.peaks += [m["peak_bytes"] for m in metas]
    hb.handover_s += max(m["handover_s"] for m in metas)
    flushes += metas[0]["flushes"]
    # data row 0's merged slices in bucket order, as `merge_and_replicate`'s
    # all-gather joins them
    slices = sorted((m["slice"], r) for r, m in enumerate(metas)
                    if "slice" in m)
    with np.load(os.path.join(d, "rank0.npz")) as z:
        for i, (hist, threshold, n_reads, n_kmers) in enumerate(
                metas[0]["passes"]):
            table = None
            if i == 0 and "table" in z:
                table = z["table"]
            elif i == 0 and slices:
                parts = []
                for _, r in slices:
                    with np.load(os.path.join(d, f"rank{r}.npz")) as y:
                        parts.append(y["slice"])
                table = np.concatenate(parts)
            counts.append(CountCapture(
                z.get(f"uniq{i}"), z.get(f"counts{i}"),
                None if table is None else torch.from_numpy(table), hist,
                threshold, n_reads, n_kmers))


# top-level module names a run may not hold once its window has closed, in
# its own process or in a mesh job's ranks: the JAX package beside the
# port, JAX itself, and the repo's JAX-era tools; nor the program's own
# bench presets (`kmerax_torch.bench`), which the benchmark does not use
FORBIDDEN = {"jax", "jaxlib", "flax", "kmerax", "oracle", "chip_smoke"}
FORBIDDEN_PREFIXES = ("kmerax_torch.bench",)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN
                  or m.startswith(FORBIDDEN_PREFIXES))


def mesh(cfg: dict) -> tuple:
    """(D, S): the configuration's ("data", "bucket") mesh; 1 x 1 where it
    names none."""
    return int(cfg.get("mesh_data", 1)), int(cfg.get("mesh_bucket", 1))


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
    `k2`, a two-pass job; with a mesh, its flags), the mix's job form,
    outputs under `outdir`."""
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
    a += list(mix.get("flags", []))
    D, S = mesh(cfg)
    if D * S > 1:
        a += ["--mesh-data", str(D), "--mesh-bucket", str(S)]
    return a


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
                     counts, handback=recorder.handback)
