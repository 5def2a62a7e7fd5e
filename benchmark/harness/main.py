"""One run of one cell: set-up, the timed window, the traced job, the
comparison with the reference, and the result line.

The window is a closed loop of one client: whole jobs back to back on the
same inputs, each a fresh CLI call in this process (its own table and
spectrum). A job starts while the window's time so far plus the last
job's wall stays within `--seconds` (the first always starts), so a run
stays within its allowance; the window ends when its last job ends.
With `--trace 1` one more job runs after the window under the program's
profiler (KMERAX_TRACE_DIR); the device numbers come from it, the stage
times from the window's jobs. The outputs of the window's last job are
compared with the reference once the window has closed, the memory peak
has been read and the program's device state has been let go.

A cell whose configuration names a mesh runs each job on D·S spawned ranks,
one card each (jobs.py); this process then keeps off the cards until the
window has closed. The device line counts the cell's chips and takes the
largest peak of any rank's card over the window's jobs, and a traced run
reads rank 0's traces, the writer's, whose stage records metrics.jsonl
holds."""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

from . import cells, jobs, trace


@dataclass
class Run:
    """What a per-layer metric's reader is given."""
    config: dict
    mix: dict
    file_reads: list                    # reads of each input file
    jobs: list                          # jobs.JobRecord of the window
    profiled: object = None             # the traced jobs.JobRecord

    def stage_totals(self, stage: str):
        """(seconds, reads) summed over every `stage` record of the
        window's jobs (metrics.jsonl, host clock); None where none has
        one."""
        recs = [s for j in self.jobs for s in j.stages
                if s["stage"] == stage]
        if not recs:
            return None
        return sum(s["wall_s"] for s in recs), sum(s["reads"] for s in recs)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _write_inputs(ds, workdir: str, pairs: int | None, tag: str) -> list:
    from ..sim import write_fastq_gz

    paths = []
    for i, (n, b, q) in enumerate(zip(ds.names, ds.bases, ds.quals)):
        p = os.path.join(workdir, f"{tag}_{i + 1}.fastq.gz")
        s = slice(None) if pairs is None else slice(0, pairs)
        write_fastq_gz(p, n[s], b[s], q[s])
        paths.append(p)
    return paths


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device: str = "cuda", root: Path = cells.ROOT,
        config_override: dict | None = None) -> dict:
    """The result line of one run. `device` "cpu" (the benchmark's own
    tests) skips the look for a card and runs the kernels' plain
    versions."""
    import torch

    c = cells.cell(workload, root)
    cfg = {**c.config, **(config_override or {})}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: torch.cuda.is_available() "
                             "is False")
        if torch.cuda.device_count() < c.chips:
            raise SystemExit(f"{workload} needs {c.chips} cards, "
                             f"{torch.cuda.device_count()} present")
    dev = torch.device(device)
    D, S = jobs.mesh(cfg)
    on_mesh = D * S > 1
    # a mesh job's ranks have left their cards when the CLI returns
    sync = (lambda: torch.cuda.synchronize(dev)) \
        if dev.type == "cuda" and not on_mesh else (lambda: None)
    parts = {"imports_s": time.perf_counter() - t_start}

    t = time.perf_counter()
    if dev.type == "cuda":
        from kmerax_torch.utils.cuda import build, lib

        _, parts["nvcc_s"] = build()
        if not on_mesh:
            lib()
            torch.zeros(1, device=dev)
            sync()
    from kmerax_torch.io.native import get_lib
    get_lib()
    parts["library_s"] = time.perf_counter() - t

    from ..sim import simulate

    t = time.perf_counter()
    base = tempfile.mkdtemp(prefix=f"bench_{workload}_")
    try:
        ds = simulate(seed, cfg["genome_len"], cfg["coverage"],
                      cfg["read_len"], cfg["error_rate"],
                      cfg["insert_mean"], cfg["insert_sd"])
        inputs = _write_inputs(ds, base, None, "reads")
        warm_inputs = _write_inputs(ds, base, cfg["batch_reads"], "warm")
        parts["dataset_s"] = time.perf_counter() - t
        return _measure(c, cfg, ds, inputs, warm_inputs, base, seconds,
                        traced, dev, sync, parts, t_start, root, on_mesh)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _measure(c, cfg, ds, inputs, warm_inputs, base, seconds, traced, dev,
             sync, parts, t_start, root, on_mesh) -> dict:
    import torch

    from ..reference import compare

    rec = jobs.Recorder()
    try:
        t = time.perf_counter()
        jobs.run(jobs.argv(cfg, c.mix, warm_inputs,
                           os.path.join(base, "warm"), dev.type),
                 os.path.join(base, "warm"), 2 * cfg["batch_reads"], rec,
                 sync)
        parts["warmup_s"] = time.perf_counter() - t
        if dev.type == "cuda" and not on_mesh:
            torch.cuda.reset_peak_memory_stats(dev)
        n_reads = ds.n_reads
        out = os.path.join(base, "out")
        args = jobs.argv(cfg, c.mix, inputs, out, dev.type)
        window = []
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            if window:
                window[-1].counts = []      # let go of its device table
            window.append(jobs.run(args, out, n_reads, rec, sync))
            el = time.perf_counter() - t0
            if el + window[-1].wall_s > seconds:
                break
        window_s = time.perf_counter() - t0
        # a mesh job's hand-back is the harness's work, not the program's
        harness_s = sum(j.handback.handover_s + j.handback.read_s
                        for j in window if j.handback is not None)
        if on_mesh:
            peak = max(p for j in window for p in j.handback.peaks)
        else:
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
        last = window[-1]
        prog_fastq = []
        for i in range(len(inputs)):
            with open(os.path.join(out, f"corrected_{i + 1}.fastq"),
                      "rb") as f:
                prog_fastq.append(f.read())
        fasta = None
        if c.mix.get("fasta"):
            with open(os.path.join(out, "contigs.fasta"), "rb") as f:
                fasta = f.read()

        profiled = None
        if traced:
            profiled = _profiled(cfg, c.mix, inputs, base, dev.type, rec,
                                 sync, n_reads)
    finally:
        rec.close()

    prog = compare.Outputs(
        [_count_out(x) for x in last.counts], prog_fastq, fasta,
        last.result)
    last.counts = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = compare.reference_outputs(ds, cfg, c.mix["stages"], dev)
    checks = compare.checks(prog, ref)
    ref_s = time.perf_counter() - t
    del prog, ref

    for k, v in parts.items():
        say(f"setup part {k} {v:.4f}")
    say(f"setup_s {setup_s:.4f}; window {window_s:.4f} s, {len(window)} "
        f"jobs: " + ", ".join(f"{j.wall_s:.4f}" for j in window))
    for i, j in enumerate(window):
        hb = j.handback
        hand = "" if hb is None else (
            f", handover_s {hb.handover_s:.4f} (read after the wall "
            f"{hb.read_s:.4f} s; both out of reads_per_s's time)")
        say(f"job {i} wall {j.wall_s:.4f} s{hand}: " + ", ".join(
            f"{s['stage']} {s['wall_s']}" for s in j.stages))
    say(f"reference_s {ref_s:.4f}")

    result = {"correct": all(v == 0 for v in checks.values()),
              "attempted": len(window), "failed": 0, "metrics": {},
              "device": _device(dev, peak, c.chips)}
    if traced:
        r = Run(cfg, c.mix, [len(b) for b in ds.bases], window, profiled)
        med = statistics.median(j.wall_s for j in window)
        say(f"profiled job wall {profiled.wall_s:.4f} s against the "
            f"window's median {med:.4f} s (the tracing overhead)")
        for m in c.per_layer:
            v = cells.reader(m["name"], root)(r)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        busy = sum(t.busy_us() for t in profiled.trace) * 1e-6
        result["device"].update(busy_s=busy, window_s=profiled.wall_s)
        result["breakdown"] = {
            "device_ops": trace.device_ops(profiled.trace),
            "idle_gaps": trace.idle_gaps(profiled.trace, _untraced(
                profiled, recount_in_assemble=not cfg.get("k2")))}
    else:
        for m in c.end_to_end:
            v = {"reads_per_s": n_reads * len(window)
                 / (window_s - harness_s),
                 "setup_s": setup_s}.get(m["name"])
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    bad = jobs.forbidden_modules()
    if bad:
        say(f"forbidden modules loaded: {bad}")
        raise SystemExit(3)
    for k, v in checks.items():
        say(f"check {k} {v} limit 0")
    return result


def _profiled(cfg, mix, inputs, base, device: str, rec, sync,
              n_reads) -> jobs.JobRecord:
    """One more job under the program's profiler (KMERAX_TRACE_DIR), with
    its stage traces read: on a mesh, rank 0's, and the other ranks' are
    deleted unread."""
    tdir = os.path.join(base, "trace")
    os.environ["KMERAX_TRACE_DIR"] = tdir
    try:
        prof = os.path.join(base, "prof")
        job = jobs.run(jobs.argv(cfg, mix, inputs, prof, device), prof,
                       n_reads, rec, sync)
    finally:
        del os.environ["KMERAX_TRACE_DIR"]
    job.counts = []
    D, S = jobs.mesh(cfg)
    job.trace = trace.read_rank0(tdir) if D * S > 1 else trace.read_dir(tdir)
    return job


def _count_out(x):
    import numpy as np
    import torch

    from ..reference.compare import CountOut

    u = x.uniq.astype(np.int64)
    if u.shape[1] <= 2:     # k <= 31: one int64, as the reference holds it
        v = np.zeros(len(u), np.int64)
        for i in range(u.shape[1]):
            v |= u[:, i] << (32 * i)
    else:                   # the (M, W) words as they are
        v = u
    table = None if x.table is None else x.table.cpu()
    return CountOut(torch.from_numpy(v), torch.from_numpy(
        x.counts.astype(np.int64)), table, x.hist, x.threshold, x.n_reads,
        x.n_kmers)


def _untraced(job, recount_in_assemble: bool) -> list:
    """[label, seconds] of the profiled job's time that no stage trace
    covers: the assembly's graph, which is never profiled, and what lies
    between stages. Each stage's trace spans the whole stage (the export
    lies after it). In a one-pass job the assembly's re-count runs inside
    the assemble stage and its record comes just before it: the graph is
    the assemble wall less that count's. In a two-pass job the count
    before it is pass 2, a stage of its own."""
    out, prev, covered = [], None, 0.0
    for s in job.stages:
        if s["stage"] == "assemble":
            g = s["wall_s"] - (prev["wall_s"] if recount_in_assemble and prev
                               and prev["stage"] == "count" else 0.0)
            out.append(["assemble: graph on the host (untraced)", g])
            covered += g
        else:
            covered += s["wall_s"]
        prev = s
    out.append(["between stages (CLI, spectrum hand-over)",
                max(job.wall_s - covered, 0.0)])
    return out


def _device(dev, peak: int, count: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak)}
