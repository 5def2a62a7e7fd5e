"""Multi-host acceptance runs (port of kmerax/bench/acceptance_mp.py;
BASELINE.md config 4: "sharded k-mer spectrum across 2 hosts, merged
counts"): N emulated hosts on this machine, each one process of the
production CLI (`python -m kmerax_torch.cli pipeline ... --coordinator
127.0.0.1:P --num-procs N --process-id p`) that spawns its G ranks of an
N x G mesh: per-host input parsing, the all-to-all bucket routing, the
range-sharded host spectrum (the multi-host default), per-host correction
and the distributed assembly. On the CPU the ranks are gloo processes; on
cards each host sees its own G cards (CUDA_VISIBLE_DEVICES), so N x G
cards must exist. The parent simulates the inputs once, starts the hosts,
then scores accuracy (and assembly quality where the config assembles) as
the single-process harness (bench/acceptance.py) does.

    python -m kmerax_torch.cli bench --acceptance 4 --hosts 2 --scale 0.1 \
        --device cpu
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from kmerax_torch.utils.cuda import device_info, resolve_device


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def host_envs(n_procs: int, local_ranks: int, device) -> list:
    """Each emulated host's environment: on the CPU one torch thread a rank
    (the machine's cores split over every host's ranks); on cards host p
    sees cards p·G .. p·G + G - 1, and N x G cards must exist."""
    base = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [base.get("PYTHONPATH")] if p])
    if torch.device(device).type != "cuda":
        threads = max(1, (os.cpu_count() or 1) // (n_procs * local_ranks))
        return [dict(base, OMP_NUM_THREADS=str(threads))
                for _ in range(n_procs)]
    have = torch.cuda.device_count()
    if n_procs * local_ranks > have:
        raise ValueError(f"{n_procs} hosts x {local_ranks} ranks need "
                         f"{n_procs * local_ranks} devices, have {have}")
    return [dict(base, CUDA_VISIBLE_DEVICES=",".join(
        str(p * local_ranks + l) for l in range(local_ranks)))
        for p in range(n_procs)]


def run_hosts(argvs: list, envs: list, logs: list,
              timeout: float | None = None) -> float:
    """Start one process a host (argvs[p] with envs[p], output into
    logs[p]) and wait for all; returns the wall in seconds. A host that
    fails, or all of them past `timeout`, raises with its log's tail; no
    process outlives the call."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=env, stdout=open(log, "wb"),
                              stderr=subprocess.STDOUT)
             for argv, env, log in zip(argvs, envs, logs)]
    try:
        deadline = None if timeout is None else t0 + timeout
        for p in procs:
            p.wait(timeout=None if deadline is None
                   else max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[pid], "rb") as fh:
                out = fh.read().decode(errors="replace")
            raise RuntimeError(f"host {pid} failed:\n{out[-6000:]}")
    return wall


def run_config_mp(n: int, scale="1.0", n_procs: int = 2,
                  workdir: str | None = None, seed: int = 42,
                  scale_note: str = "", *, device,
                  local_ranks: int | None = None,
                  timeout: float | None = None) -> dict:
    """Acceptance config `n` over `n_procs` emulated hosts of an
    n_procs x G mesh (G = `local_ranks`: 4 on the CPU, as the reference's
    4 devices a process; 1 on cards); returns the JAX package's report
    keys plus `device` (name, power limit)."""
    from kmerax_torch.bench.acceptance import (
        CONFIGS, _accuracy, _sim_inputs, assembly_metrics, sized_config,
    )

    device = resolve_device(device)
    G = local_ranks or (4 if device.type == "cpu" else 1)
    spec = CONFIGS[n]
    if scale == "full":
        scale = spec.full_genome_len / spec.genome_len
    scale = float(scale)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix=f"kmerax_acc{n}_mp_")
    os.makedirs(workdir, exist_ok=True)
    envs = host_envs(n_procs, G, device)

    genome, paths, sim_reads = _sim_inputs(spec, scale, workdir, seed)
    n_reads = sum(len(r) for r in sim_reads)
    cfg = sized_config(spec, len(genome), n_reads, (n_procs, G))
    out_fastq = [os.path.join(workdir, f"corrected_{i+1}.fastq")
                 for i in range(len(paths))]
    out_fasta = os.path.join(workdir, "contigs.fasta") if spec.assemble \
        else None
    args = [sys.executable, "-m", "kmerax_torch.cli", "pipeline",
            "-k", str(cfg.k), "--bloom-log2-width", str(cfg.bloom_log2_width),
            "--batch-reads", str(cfg.batch_reads),
            "--max-read-len", str(cfg.max_read_len),
            "--exact-capacity", str(cfg.exact_capacity),
            "--mesh-data", str(n_procs), "--mesh-bucket", str(G),
            "--coordinator", f"127.0.0.1:{free_port()}",
            "--num-procs", str(n_procs), "--device", device.type,
            "--in", *paths, "--out-fastq", *out_fastq]
    if spec.k2:
        args += ["--k2", str(spec.k2)]
    if out_fasta:
        args += ["--out-fasta", out_fasta]
    logs = [os.path.join(workdir, f"worker{p}.log") for p in range(n_procs)]
    wall = run_hosts([args + ["--process-id", str(p)]
                      for p in range(n_procs)], envs, logs, timeout)

    report = {
        "config": n, "name": spec.name, "note": spec.note,
        "scale": scale, "genome_len": len(genome), "reads": n_reads,
        "n_procs": n_procs, "mesh": [n_procs, G], "backend": device.type,
        "device": device_info(device),
        "memory_model": "range-sharded host spectrum (multi-host default)",
        "wall_s": wall,
        "reads_per_s": n_reads / wall,
        "accuracy": _accuracy(sim_reads, out_fastq), "workdir": workdir,
    }
    if out_fasta is not None and os.path.exists(out_fasta):
        report["assembly"] = assembly_metrics(genome, out_fasta,
                                              spec.k2 or spec.k,
                                              device=device)
    if scale_note:
        report["scale_note"] = scale_note
    return report
