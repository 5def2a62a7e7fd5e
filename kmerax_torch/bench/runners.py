"""Benchmark presets (port of kmerax/bench/runners.py): k-mers/s (count),
reads/s (correct, align) on one device, and an end-to-end FASTQ run
(count then correct) on the config's mesh.

Each timed preset runs the port's production step: count one K1
`bloom_insert` a batch (no pending buffer: the preset counts without the
exact spectrum), correct `pipeline/correct.make_correct_step` (K2, K6,
K3, K7), align `ops/align.validate_batch` (K4); e2e runs `run_count` and
`run_correct` on one FASTQ file: here on one device, or, as the JAX
package's e2e counts and corrects on the config's mesh, on the ranks of a
mesh of D·S > 1 or of a multi-host run (`e2e_stages` through
dist/mesh.launch), with the ranks' start-up reported apart as `launch_s`.

Timing (`_time_fresh_pass`): two warm calls on batch 0, then one chained
pass over N_FRESH fresh batches already on the device, with one device
synchronisation at the end and none per batch, which is the shape of the
streaming pipeline. The output keeps the JAX package's metric names and
fields and adds the device's name and power limit.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline.count import bloom_params
from kmerax_torch.spectrum.bloom import make_table
from kmerax_torch.spectrum.bloom_kernels import bloom_insert
from kmerax_torch.utils.cuda import device_info, resolve_device

N_FRESH = 8                     # timed fresh batches per metric


def _draw_reads(rng, genome: np.ndarray, n_reads: int, read_len: int,
                error_rate: float = 0.01) -> np.ndarray:
    """(n_reads, read_len) uint8 reads of `genome` at uniform starts, with
    uniform substitutions (shift 1-3), drawn from `rng` in this order."""
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    errs = rng.random(reads.shape) < error_rate
    shift = rng.integers(1, 4, reads.shape).astype(np.uint8)
    return np.where(errs, (reads + shift) % 4, reads)


def _sim_batch(n_reads: int, read_len: int, seed: int = 0,
               error_rate: float = 0.01, genome_len: int = 1 << 17):
    """(n_reads, read_len) int32 reads of a random genome with uniform
    substitutions. The default genome gives ~19-38x coverage a batch, as
    the acceptance configs, so correction sees realistic solidity."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    return _draw_reads(rng, genome, n_reads, read_len,
                       error_rate).astype(np.int32)


def _on(device, reads: np.ndarray) -> torch.Tensor:
    """Reads as the production wire puts them on the device: int8."""
    return torch.from_numpy(reads.astype(np.int8)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fresh_pass(fn, state, batches):
    """Warm on batches[0] twice, then time ONE chained pass over the fresh
    batches[1:], already on the device, with one sync at the end. Returns
    (seconds per batch, the state the pass left)."""
    device = batches[0].device
    for _ in range(2):
        state = fn(state, batches[0])
    _sync(device)
    fresh = batches[1:]
    t0 = time.perf_counter()
    for b in fresh:
        state = fn(state, b)
    _sync(device)
    return (time.perf_counter() - t0) / len(fresh), state


def _result(metric: str, value: float, unit: str, device, **extra) -> dict:
    return {"metric": metric, "value": value, "unit": unit, **extra,
            "device": device_info(device)}


def count_setup(cfg: KmeraxConfig, n_reads: int, read_len: int, device):
    """(Bloom params, int8 batches on the device) of the count preset."""
    return bloom_params(cfg, cfg.k), [
        _on(device, _sim_batch(n_reads, read_len, seed=s))
        for s in range(N_FRESH + 1)]


def bench_count(cfg: KmeraxConfig, n_reads: int = 16384,
                read_len: int = 150, *, device) -> dict:
    """k-mers/s at k=cfg.k: one K1 launch a batch into a fresh table."""
    device = resolve_device(device)
    params, batches = count_setup(cfg, n_reads, read_len, device)

    def step(table, bases):
        bloom_insert(table, bases, params)
        return table

    dt, _ = _time_fresh_pass(step, make_table(params, device), batches)
    kmers = n_reads * (read_len - cfg.k + 1)
    return _result(f"kmers_per_s_per_chip_k{cfg.k}", kmers / dt,
                   "kmers/s/chip", device, batch_wall_s=dt)


def correct_setup(cfg: KmeraxConfig, n_reads: int, read_len: int, device):
    """(Bloom params, the table of batches 0 and 1, int8 batches, lengths)
    of the correct preset. Its genome is sized so the table sees ~37x,
    inside the acceptance configs' 30-80x: correction work per read is set
    by how much of the spectrum clears the solid threshold."""
    params = bloom_params(cfg, cfg.k)
    batches = [_on(device, _sim_batch(n_reads, read_len, seed=s,
                                      genome_len=1 << 15))
               for s in range(N_FRESH + 1)]
    table = make_table(params, device)
    for b in batches[:2]:
        bloom_insert(table, b, params)
    lengths = torch.full((n_reads,), read_len, dtype=torch.int32,
                         device=device)
    return params, table, batches, lengths


def bench_correct(cfg: KmeraxConfig, n_reads: int = 8192,
                  read_len: int = 150, *, device) -> dict:
    """reads/s of the production correct step (K2, K6, K3, K7) at t = 3."""
    from kmerax_torch.pipeline.correct import make_correct_step

    device = resolve_device(device)
    params, table, batches, lengths = correct_setup(cfg, n_reads, read_len,
                                                    device)
    step0 = make_correct_step(params, table, 3, rounds=cfg.rounds,
                              max_runs=cfg.max_runs, max_edits=cfg.max_edits)

    def step(state, bases):
        _, ne = step0(bases, lengths)
        return state + ne.sum()

    dt, _ = _time_fresh_pass(
        step, torch.zeros((), dtype=torch.int64, device=device), batches)
    return _result(f"reads_per_s_per_chip_k{cfg.k}", n_reads / dt,
                   "reads/s/chip", device, batch_wall_s=dt)


def align_setup(cfg: KmeraxConfig, n_reads: int, read_len: int, device):
    """(joined contigs on the device, cuckoo index, int8 batches, lengths)
    of the align preset: reads drawn from the indexed genome, 1 %
    substitutions."""
    from kmerax_torch.ops.align import build_contig_index
    from kmerax_torch.ops.seed_hash import build_seed_hash

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 1 << 17).astype(np.uint8)
    cat, uniq, pay = build_contig_index([genome], cfg.k, device=device)
    cat_dev = torch.from_numpy(cat.astype(np.int8)).to(device)
    index = build_seed_hash(uniq, pay, device=device)
    batches = [_on(device, _draw_reads(np.random.default_rng(1000 + s),
                                       genome, n_reads, read_len))
               for s in range(N_FRESH + 1)]
    lengths = torch.full((n_reads,), read_len, dtype=torch.int32,
                         device=device)
    return cat_dev, index, batches, lengths


def bench_align(cfg: KmeraxConfig, n_reads: int = 16384,
                read_len: int = 150, *, device) -> dict:
    """reads/s of align-validate: `validate_batch` (cuckoo seed probe, then
    K4) of reads against the contig index of their source genome."""
    from kmerax_torch.ops.align import validate_batch

    device = resolve_device(device)
    cat_dev, index, batches, lengths = align_setup(cfg, n_reads, read_len,
                                                   device)

    def step(state, bases):
        found = validate_batch(cat_dev, index, bases, lengths, cfg.k,
                               cfg.band)[0]
        return state + found.sum()

    dt, _ = _time_fresh_pass(
        step, torch.zeros((), dtype=torch.int64, device=device), batches)
    return _result(f"align_reads_per_s_per_chip_k{cfg.k}", n_reads / dt,
                   "reads/s/chip", device, batch_wall_s=dt)


def write_e2e_fastq(path: str, n_reads: int, read_len: int) -> None:
    """The e2e preset's FASTQ: n_reads reads of a 2^20 bp random genome
    with 1 % substitutions, drawn from seed 0 (the JAX package's draws),
    names r0.., qualities all 'I'."""
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 1 << 20).astype(np.uint8)
    reads = _draw_reads(rng, genome, n_reads, read_len)
    code = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        qual = b"I" * read_len
        for i in range(n_reads):
            f.write(b"@r%d\n" % i)
            f.write(code[reads[i]].tobytes())
            f.write(b"\n+\n")
            f.write(qual)
            f.write(b"\n")


def e2e_stages(cfg: KmeraxConfig, fq: str, out: str, device) -> dict:
    """run_count then run_correct of the FASTQ `fq` into `out`, on `device`
    or on this rank of the current mesh (its rank 0 writes `out`); returns
    this process's stage walls, {"count_wall_s", "correct_wall_s"}.

    Across hosts each host passes its own `fq` (the same bytes) and `out`;
    the corrected parts then go next to rank 0's `out`, which the hosts
    must share, as the per-host correction's concatenation needs."""
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.pipeline.correct import run_correct
    from kmerax_torch.pipeline.count import run_count

    mesh = dmesh.current()
    if mesh is None:
        device = resolve_device(device)
    else:
        device = mesh.device
        if mesh.n_hosts > 1:
            out = _rank0_path(out)
    t0 = time.perf_counter()
    state = run_count(cfg, [fq], device=device)
    t_count = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_correct(cfg, [fq], state, out, device=device)
    return {"count_wall_s": t_count,
            "correct_wall_s": time.perf_counter() - t0}


def _rank0_path(path: str) -> str:
    """Rank 0's `path` on every rank of the current mesh."""
    import torch.distributed as dist

    from kmerax_torch.dist.mesh import current

    got = [path]
    dist.broadcast_object_list(got, src=0, group=current().hosts_group)
    return got[0]


def _on_mesh(cfg: KmeraxConfig, hosts) -> bool:
    """Whether e2e runs on spawned ranks: a mesh of D·S > 1, or hosts."""
    return cfg.mesh_data * cfg.mesh_bucket > 1 or hosts[0] is not None


def bench_e2e(cfg: KmeraxConfig, n_reads: int = 65536,
              read_len: int = 150, *, device,
              hosts=(None, 1, 0)) -> dict:
    """End-to-end reads/s: count then correct one FASTQ file through the
    production run_count / run_correct (parse, H2D, kernels, D2H, FASTQ
    write, overlapped by the background batcher).

    The FASTQ is written here. On a config of one device the stages run
    here. On a mesh of D·S > 1, or across hosts (`hosts` = (coordinator,
    N, p), as the CLI reads them), they run on the ranks this process
    starts (dist/mesh.launch: its D·S / N ranks), each `e2e_stages`; the
    walls are its first rank's, and `launch_s` is the rest of the launch:
    the ranks' start, rendezvous, imports and teardown."""
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.pipeline.run import restore_observed, with_observed

    device = resolve_device(device)
    coordinator, n_hosts, host = hosts
    spec = dmesh.MeshSpec(cfg.mesh_data, cfg.mesh_bucket)
    on_mesh = _on_mesh(cfg, hosts)
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "bench.fastq")
        write_e2e_fastq(fq, n_reads, read_len)
        out = os.path.join(td, "corrected.fastq")
        if not on_mesh:
            walls = e2e_stages(cfg, fq, out, device)
            extra = {}
        else:
            # launch raises where the cards cannot hold the mesh, before
            # it starts a rank
            if device.type == "cuda":
                # rank 0 takes this process's card too
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            walls, obs = dmesh.launch(
                spec, device, with_observed, e2e_stages, cfg, fq, out,
                device.type, coordinator=coordinator, n_hosts=n_hosts,
                host=host)
            extra = {"launch_s": time.perf_counter() - t0
                     - walls["count_wall_s"] - walls["correct_wall_s"]}
            restore_observed(obs)
    return _result(f"e2e_correct_reads_per_s_k{cfg.k}",
                   n_reads / walls["correct_wall_s"], "reads/s/chip",
                   device, **walls, **extra)


def run_preset(preset: str, cfg: KmeraxConfig, n_reads: int = 16384, *,
               device, hosts=(None, 1, 0)) -> dict:
    """The preset's metrics. count, correct and align time one device here
    whatever the config's mesh; e2e runs on the mesh and across `hosts`
    (bench_e2e)."""
    from kmerax_torch.dist import mesh as dmesh

    kw = dict(device=device)
    if preset in ("e2e", "all") and _on_mesh(cfg, hosts):
        # before any preset runs: a mesh the cards cannot hold raises here
        spec = dmesh.MeshSpec(cfg.mesh_data, cfg.mesh_bucket)
        dmesh.check_hosts(spec, hosts[1], hosts[2])
        dmesh.check_devices(spec, device, hosts[1])
    if preset == "count":
        return bench_count(cfg, n_reads=n_reads, **kw)
    if preset == "correct":
        return bench_correct(cfg, n_reads=min(n_reads, 8192), **kw)
    if preset == "align":
        return bench_align(cfg, n_reads=n_reads, **kw)
    if preset == "e2e":
        return bench_e2e(cfg, hosts=hosts, **kw)
    if preset == "all":
        return {"count": bench_count(cfg, n_reads=n_reads, **kw),
                "correct": bench_correct(cfg, n_reads=min(n_reads, 8192),
                                         **kw),
                "align": bench_align(cfg, n_reads=n_reads, **kw),
                "e2e": bench_e2e(cfg, hosts=hosts, **kw)}
    raise ValueError(f"unknown preset {preset}")
