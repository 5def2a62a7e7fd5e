"""Runnable acceptance matrix (port of kmerax/bench/acceptance.py;
BASELINE.md configs 1-5).

Each config simulates a seeded scale-down of its dataset (bench/sim.py,
which draws what tests/sim.py draws, DNBSEQ-like names), writes real
FASTQ.gz inputs, runs the CLI-level pipeline stages on one device, and
reports wall time, reads/s and correction accuracy (the simulator knows the
true bases, so the report counts the injected substitutions the corrector
removed and the errors it introduced).

`scale` multiplies the genome length; coverage, read length and k match the
spec. A spec's mesh runs only where that many devices exist, as in the JAX
package; a mesh larger than 1 x 1 is not ported and raises.
"""

from __future__ import annotations

import gzip
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.utils.cuda import device_info, resolve_device


@dataclass(frozen=True)
class AcceptanceSpec:
    name: str
    genome_len: int           # scale-down base length (scale=1.0)
    full_genome_len: int      # real dataset size (for the record)
    coverage: int
    read_len: int
    k: int
    k2: int = 0               # two-pass second k (config 5)
    paired: bool = True
    error_rate: float = 0.01
    assemble: bool = False
    mesh: tuple = (1, 1)      # (data, bucket) — >1 needs >=4 devices
    note: str = ""


CONFIGS = {
    1: AcceptanceSpec(
        "ecoli_k12_pe150_50x_k31", genome_len=60_000,
        full_genome_len=4_641_652, coverage=50, read_len=150, k=31,
        note="E. coli K-12 MG1655 PE150 ~50x, k=31 count+correct "
             "(BASELINE.json:7; CPU single host)"),
    2: AcceptanceSpec(
        "scerevisiae_pe100_80x_k25", genome_len=60_000,
        full_genome_len=12_157_105, coverage=80, read_len=100, k=25,
        note="S. cerevisiae PE100 ~80x, k=25 count+correct, 1 chip "
             "(BASELINE.json:8)"),
    3: AcceptanceSpec(
        "chr21_pe150_30x_k31_assemble", genome_len=80_000,
        full_genome_len=46_709_983, coverage=30, read_len=150, k=31,
        assemble=True, error_rate=0.005,
        note="Human chr21 PE150 30x DNBSEQ-like, k=31 correct+assemble "
             "(BASELINE.json:9; single host)"),
    4: AcceptanceSpec(
        "celegans_60x_sharded_2host", genome_len=60_000,
        full_genome_len=100_286_401, coverage=60, read_len=100, k=31,
        mesh=(2, 2),
        note="C. elegans 60x, spectrum sharded over a 2x2 mesh standing in "
             "for 2 hosts, merged counts (BASELINE.json:10)"),
    5: AcceptanceSpec(
        "human_wgs_30x_twopass_k31_k63", genome_len=80_000,
        full_genome_len=3_100_000_000, coverage=30, read_len=150,
        k=31, k2=63, assemble=True, error_rate=0.005,
        note="Human WGS 30x PE150, k=31+k=63 two-pass correct+assemble "
             "(BASELINE.json:11; v5e-16 emulated at scale-down)"),
}


def _write_fastq_gz(path: str, reads) -> None:
    from kmerax_torch.bench.sim import make_fastq

    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(make_fastq(reads))


def _sim_inputs(spec: AcceptanceSpec, scale: float, workdir: str, seed: int):
    from kmerax_torch.bench.sim import random_genome, simulate_pairs, \
        simulate_reads

    g_len = max(4 * spec.read_len, int(spec.genome_len * scale))
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, g_len)
    n_reads = g_len * spec.coverage // spec.read_len
    if spec.paired:
        r1, r2 = simulate_pairs(genome, n_reads // 2, spec.read_len,
                                spec.error_rate, seed=seed + 1,
                                insert_mean=min(3 * spec.read_len, g_len),
                                insert_sd=spec.read_len // 4)
        p1 = os.path.join(workdir, "reads_1.fastq.gz")
        p2 = os.path.join(workdir, "reads_2.fastq.gz")
        _write_fastq_gz(p1, r1)
        _write_fastq_gz(p2, r2)
        return genome, [p1, p2], [r1, r2]
    reads = simulate_reads(genome, n_reads, spec.read_len, spec.error_rate,
                           seed=seed + 1)
    p = os.path.join(workdir, "reads.fastq.gz")
    _write_fastq_gz(p, reads)
    return genome, [p], [reads]


def assembly_metrics(genome: np.ndarray, fasta_path: str, k: int, *,
                     device) -> dict:
    """Assembly quality against the known simulated genome: contig count,
    total bases, N50, and the fraction of the genome's distinct canonical
    k-mers that appear in the contigs (a gap-free coverage proxy that
    ignores the orientation and offset of unitigs)."""
    from kmerax_torch.core.codec import seq_to_bases
    from kmerax_torch.io.fasta import read_fasta
    from kmerax_torch.ops.align import build_contig_index
    from kmerax_torch.spectrum.host import pack_rows

    contigs = []
    lens = []
    for _, seq in read_fasta(fasta_path):
        lens.append(len(seq))
        contigs.append(seq_to_bases(seq))
    lens.sort(reverse=True)
    total = int(sum(lens))
    n50 = 0
    acc = 0
    for ln in lens:
        acc += ln
        if acc * 2 >= total:
            n50 = ln
            break
    _, g_uniq, _ = build_contig_index([genome.astype(np.uint8)], k,
                                      device=device)
    g_keys = pack_rows(np.asarray(g_uniq))
    if contigs:
        _, c_uniq, _ = build_contig_index(contigs, k, device=device)
        c_keys = pack_rows(np.asarray(c_uniq))
    else:
        c_keys = np.zeros(0, g_keys.dtype)
    if g_keys.ndim == 2:            # k > 32: (N, 2) uint64 -> void rows
        vt = [("a", np.uint64), ("b", np.uint64)]
        g_keys = np.ascontiguousarray(g_keys).view(vt).reshape(-1)
        c_keys = np.ascontiguousarray(c_keys).view(vt).reshape(-1) \
            if len(c_keys) else np.zeros(0, vt)
    covered = np.isin(g_keys, c_keys).sum()
    return {"contigs": len(lens), "total_bases": total, "n50": n50,
            "genome_kmer_fraction": round(float(covered)
                                          / max(len(g_keys), 1), 4)}


def _accuracy(in_reads, out_paths) -> dict:
    """Error-correction gain: (errors fixed - errors introduced) / errors."""
    from kmerax_torch.core.codec import seq_to_bases
    from kmerax_torch.io.fastq import FastqReader

    before = after = introduced = total = 0
    for reads, path in zip(in_reads, out_paths):
        recs = list(FastqReader(path))
        assert len(recs) == len(reads), (len(recs), len(reads))
        assert all(len(rec.seq) == len(r.bases)
                   for r, rec in zip(reads, recs))
        # all reads of a file at once: the per-read sums, in bulk
        fixed = seq_to_bases(b"".join(rec.seq for rec in recs))
        noisy = np.concatenate([r.bases for r in reads])
        truth = np.concatenate([r.true_bases for r in reads])
        err0 = noisy != truth
        err1 = fixed != truth
        before += int(err0.sum())
        after += int((err0 & err1).sum())
        introduced += int((~err0 & err1).sum())
        total += len(noisy)
    gain = (before - after - introduced) / max(before, 1)
    return {"errors_before": before, "errors_remaining": after,
            "errors_introduced": introduced, "bases": total,
            "gain": round(gain, 4)}


def run_config(n: int, scale="1.0", workdir: str | None = None,
               seed: int = 42, overrides: dict | None = None, *,
               device) -> dict:
    """Run acceptance config `n` end to end on `device`; returns the
    metrics dict.

    scale: genome-length multiplier of the spec's scale-down base, or the
    string "full" for the real dataset size (config 1 = the 4.6 Mb E. coli
    genome, ~1.5 M PE150 reads at 50x).
    overrides: KmeraxConfig field overrides; one that selects a path the
    port does not have (a mesh larger than 1 x 1) raises "not yet ported".
    """
    from kmerax_torch.graph.unitig import assemble_to_fasta
    from kmerax_torch.pipeline.align import run_align
    from kmerax_torch.pipeline.correct import run_correct
    from kmerax_torch.pipeline.count import run_count
    from kmerax_torch.pipeline.twopass import run_two_pass
    from kmerax_torch.utils.metrics import MetricsWriter

    device = resolve_device(device)
    spec = CONFIGS[n]
    if scale == "full":
        scale = spec.full_genome_len / spec.genome_len
    scale = float(scale)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix=f"kmerax_acc{n}_")
    os.makedirs(workdir, exist_ok=True)

    mesh_d, mesh_b = spec.mesh
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if mesh_d * mesh_b > n_dev:          # no slice available: run unsharded
        mesh_d = mesh_b = 1

    genome, paths, sim_reads = _sim_inputs(spec, scale, workdir, seed)
    n_reads = sum(len(r) for r in sim_reads)

    # distinct k-mers ~ genome + error-induced novels (each error spawns up
    # to ~k unseen k-mers, clustered); 1.75x margin, pow2
    distinct = (len(genome)
                + n_reads * spec.read_len * spec.error_rate * spec.k)
    cap = 1 << max(13, int(np.ceil(np.log2(distinct * 1.75))))
    # Bloom load <= ~0.5 probes/counter so solidity stays discriminative
    width = max(18, min(30, int(np.ceil(np.log2(distinct * 6)))))
    batch_reads = 4096 if n_reads >= 64 * 1024 else 1024
    cfg = KmeraxConfig(
        k=spec.k, k2=spec.k2, mesh_data=mesh_d, mesh_bucket=mesh_b,
        exact_capacity=cap, batch_reads=batch_reads,
        max_read_len=spec.read_len + 10, bloom_log2_width=width)
    if overrides:
        cfg = cfg.replace(**overrides)
        mesh_d, mesh_b = cfg.mesh_data, cfg.mesh_bucket
    cfg.require_ported()
    out_fastq = [os.path.join(workdir, f"corrected_{i+1}.fastq")
                 for i in range(len(paths))]
    out_fasta = os.path.join(workdir, "contigs.fasta") if spec.assemble \
        else None
    metrics = os.path.join(workdir, "metrics.jsonl")

    t0 = time.perf_counter()
    if spec.k2:
        result = run_two_pass(cfg, paths, out_fastq[0] if len(paths) == 1
                              else out_fastq, out_fasta,
                              metrics_path=metrics,
                              workdir=os.path.join(workdir, "ckpt"),
                              device=device)
        out_list = out_fastq if len(paths) > 1 else [out_fastq[0]]
    else:
        # per-file outputs (paired-end R1/R2) via run_correct's group mode
        m = MetricsWriter(metrics)
        try:
            state = run_count(cfg, paths, metrics=m, device=device)
            stats = run_correct(cfg, paths, state,
                                out_fastq if len(paths) > 1
                                else out_fastq[0], metrics=m, device=device)
            result = {"threshold": state.threshold, **stats}
            if out_fasta is not None:
                result["unitigs"] = assemble_to_fasta(
                    cfg, state, out_fasta,
                    corrected_fastq=out_fastq if len(out_fastq) > 1
                    else out_fastq[0], device=device)
                # the seed-extend validation stage (DESIGN.md §10b):
                # corrected reads aligned back to the contigs
                result["validate"] = run_align(cfg, out_fastq, out_fasta,
                                               metrics=m, device=device)
        finally:
            m.close()
        out_list = out_fastq
    wall = time.perf_counter() - t0

    acc = _accuracy(sim_reads, out_list)
    asm = None
    if out_fasta is not None and os.path.exists(out_fasta):
        asm = assembly_metrics(genome, out_fasta, spec.k2 or spec.k,
                               device=device)
    report = {
        "config": n, "name": spec.name, "note": spec.note,
        "scale": scale, "genome_len": len(genome), "reads": n_reads,
        "mesh": [mesh_d, mesh_b], "backend": device.type,
        "device": device_info(device),
        "wall_s": wall,
        "reads_per_s": n_reads / wall,
        **{k: v for k, v in result.items() if k != "reads"},
        "accuracy": acc, "workdir": workdir,
    }
    if asm is not None:
        report["assembly"] = asm
    return report


def run_all(scale: float = 1.0, configs=None, *, device) -> list:
    return [run_config(n, scale, device=device)
            for n in (configs or sorted(CONFIGS))]
