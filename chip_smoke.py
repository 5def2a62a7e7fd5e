#!/usr/bin/env python3
"""Smoke test of the kmerax_torch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package (`kmerax/`); the numpy-only
oracle (`oracle/`) and simulator (`tests/sim.py`) are the witnesses.

  1. device and toolchain: card name and power limit, torch/CUDA/nvcc
     versions; builds the CUDA kernels from kmerax_torch/csrc.
  2. each kernel (K1 bloom_insert and K2 bloom_query_solid at k = 15,
     25, 31, 33, 63 on a config-1 read batch, K3 correct_eval_scores at
     the same k, K1-K3 under the hash and again under the minimizer bucket
     scheme (m = 11, 256 buckets), timed at k = 25, 31, 63 (k = 15 and 33
     hold the one- and three-word instantiations), K4 banded_align_scores
     at band 15 and 63 in each of its lanes-per-read layouts, each timed)
     against its plain
     PyTorch version on the card at its path's shapes: exact integer
     equality (tolerance 0, all outputs are integers). Each kernel's
     device time per launch over 50 back-to-back launches, its host time
     per call, one wrapper call's median, the plain version's time, its
     bound (bytes over the HBM rate or int32 operations over the int32
     rate, counted from this run's inputs), the sector floor of its
     counter rows, and one PyTorch call's time where one computes the
     same function (K1: index_add_ at its lanes). K1r bloom_insert_rows,
     the routed-row insert of a mesh count, on the same config-1 batches at
     k = 15, 25, 31, 33, 63 under both schemes: the k-mers routed to S = 1, 2, 4
     and 8 range shards by the port's plain route prep, each shard
     inserted by K1r == its plain version exactly (the slice, the valid
     rows it appends to pending, their count), and the S slices,
     concatenated, == K1's whole table (DESIGN.md §12); at k=31, S=1 also
     on valid masks route_prep does not make; timed at S = 1, one shard of
     each S at each number of routed slots a thread, and at S = 1 on the
     same rows sorted by block and grouped by 512 and 256 MiB region.
     K1, K2 and K3 on p16 counters (2^29 counters in 2^28 words) == their
     plain versions at k = 15, 25, 31, 33, 63 under both schemes, K1's words
     unpacked == min(its i32 table, SAT16) on the same batch, a batch
     whose one read is inserted until its counters pass SAT16, and a batch
     inserted into 2^10 counters until they pass SAT16 inside a launch
     (K1 p16's CASes meet on both halves of a word and retry), each launch
     == plain; each p16 kernel timed as its i32 row at k=31, and K1-K3 on
     i32 and p16 counters at 2^24 and 2^29 counters in turns (whether a
     32 MiB p16 table in the 50 MB L2 beats a 64 MiB i32 one), K1's bound
     and sector floor at both widths. K2's record keeps its times, bound
     and floor at every timed k (`by_k`). The correct round's K6
     correct_candidates and K7 correct_apply (`_check_slots`) at k = 25,
     31, 63 on a config-1 batch whose clean reads fill the table, under
     both schemes on i32 and p16 counters: each == its plain version, K3
     on the whole slot grid == K3 on its live slots alone, the kernel step
     == correct_batch with K2's and K3's plain versions; K6, K7 and K3 on
     the grid and compacted timed at k=31, hash scheme, i32 counters.
  3. small goldens: the port's pipeline on the card, under the hash and
     the minimizer bucket scheme, `correct --use-exact`, and `pipeline --k2
     63` must write corrected FASTQ and unitig FASTA bytes equal to the
     oracle's, and the `align` subcommand a TSV whose every row equals
     oracle.align.validate_read.
  4. BASELINE config 1 at full scale (E. coli K-12 size genome, PE150,
     50x, error rate 0.01, k=31; 2^29-counter Bloom table) through the CLI
     entry point, with launch counts of every kernel, stage rates and
     correction accuracy against the simulated truth; then, outside the
     launch count, the count stage's synchronised device step per batch,
     one profiler window of 20 count and one of 20 correct batches (the
     kernel step, make_correct_step) with the kernels' device share and
     the kernels launched per batch and per correct round, and K2 and K3
     against their plain versions on the main path's own first calls (K3
     on the slot grid and also at its entry count); K2, K6, K3 and K7
     launched once a round each, as many as the record's
     correct.rounds_on_card.
  5. BASELINE config 3 (human chr21 PE150 30x, error rate 0.005, k=31,
     correct + assemble) on a 1.0 Mb genome, through `pipeline --validate`
     and then the `align` subcommand, with stage walls, launch counts,
     correction accuracy and the validate stats held to their bars.
  6. BASELINE config 5 (human WGS 30x PE150, two-pass k=31 -> k2=63,
     correct + assemble, error 0.005) on a 0.5 Mb genome: `pipeline --k2
     63` held to config 3's bars, a crash after the count_k2 checkpoint
     and its resume, byte-equal, then `correct --spectrum` and `assemble
     --spectrum` on the checkpoints, byte-equal, and `correct --use-exact`.
  7. `bench`: `bench --preset all` at run_preset's sizes (every metric
     printed); the presets' first (B, 150) batches through K1, the correct
     step (K2, K6, K3, K7) and K4 against their plain versions, exactly;
     `bench
     --preset e2e` on the int8 and the 2-bit wire (walls), and in a child
     process each wire's copies and the count step's launches per batch
     under the profiler; BASELINE config 2 (S. cerevisiae PE100 80x, k=25)
     through `bench --acceptance 2 --scale 5`, held to its accuracy bars;
     the same reads on p16 counters through `count --config c2_p16.toml`
     (traced with KMERAX_TRACE_DIR: the trace names K1's p16 kernel) and
     `correct --spectrum`, byte-equal to the i32 run, K1-K3 launched in
     their p16 form; then the mesh count's driver
     (pipeline/count.py::run_count_sharded) on the same reads over a
     world-size-1 NCCL group, its table, host
     spectrum, histogram and threshold byte-equal to run_count's, with
     its wall and host merges beside run_count's, retries and K1r
     launches (one a batch). A mesh of more ranks than cards
     on cuda must raise the JAX package's "mesh DxS needs N devices, have
     M"; a multi-rank mesh runs only where there are cards for it (with
     two cards or more, `count --mesh-bucket S` through the CLI, its
     spectrum == run_count's; with one card a line says it did not run),
     and `bench --preset e2e --mesh-bucket 2` on one card raises it before
     any rank or preset runs. The e2e preset's stages
     (bench/runners.e2e_stages) on its 65,536-read FASTQ here and in a
     spawned rank of a one-rank NCCL mesh: K1-K3 launched in the rank, the
     corrected FASTQ byte-equal, the rank's stage walls and `launch_s`
     beside this process's; with two cards or more also `bench --preset
     e2e --mesh-bucket S` on S ranks, byte-equal.

  8. the multi-host path: `pipeline --coordinator 127.0.0.1:P
     --num-procs 1 --process-id 0` (a `tcp://` rendezvous, one NCCL rank)
     on a prefix of phase 7's config-2 reads, FASTQ and FASTA byte-equal to
     the one-device `pipeline` and K1-K3 launched in its rank; `count` to a
     checkpoint and `assemble --spectrum` the same way, byte-equal to one
     device; then phase 7's config-2 exact spectrum split between two host
     processes (gloo, started by dist/mesh.launch): shard_spectrum, the
     global histogram (== phase 7's), assemble_sharded (FASTA == the
     one-device assembly of the same spectrum) and the sharded
     checkpoint's save and load, with each step's wall, each host's
     resident rows and the rows it received. A world of two NCCL ranks
     needs two cards: a line says so. Every log line of the port on the
     stderr of the multi-host `pipeline` reads `... [host0] ...`, and the
     two host processes' lines carry [host0] and [host1].

Phase 4's count profiler window runs in a child process of its own
(`python3 chip_smoke.py --child NAME ARG`, used by the script itself), as
does phase 7's wire profile. `python3 chip_smoke.py --turns TREE...` runs
no phase: it times K1-K3 and K1r in each checkout TREE in turn, each in a
process of its own (`turns`, `_child_kernel_times`: K1, K2, K3 at k = 25,
31, 63, K1 p16 at 2^24 and 2^29 counters, K1r), to compare two versions
on one card. A profiler session that recorded fewer launches of a
kernel than were made is repeated (`_kernel_ms`). Each phase prints its
wall, the script its total. Every failure raises. The last line is
{"ok": true, "device": {...}}. Exits nonzero without printing a result
where CUDA is absent.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# BASELINE config 1 (kmerax/bench/acceptance.py CONFIGS[1], scale "full"):
# 4,641,652 bp, PE150, 50x, error 0.01, k=31. acceptance.py's sizing rule
# for its 1,547,216 reads: distinct = G + n*150*0.01*31 = 76,587,196, so
# exact_capacity = 2^ceil(log2(1.75 * distinct)) = 2^27 and the Bloom
# table 2^ceil(log2(6 * distinct)) = 2^29 counters; batches 4096 x 160.
# Config 1 is the main path and runs uncut: at 20x its correction
# introduced 2 errors, against config 1's bar of none.
C1_GENOME = 4_641_652
C1_COVERAGE = 50
C1_ERROR = 0.01
C1_CFG = dict(k=31, bloom_log2_width=29, exact_capacity=1 << 27,
              batch_reads=4096, max_read_len=160)
# config 1's peak device memory since the count merges its exact spectrum
# on the card (spectrum/exact.py::merge_pending; the last merge sorts ~76 M
# resident and ~62 M new rows beside the 2 GiB table); the 2-bit wire's
# device unpack may add its uint8 temporaries, up to 4 bytes a base of one
# batch
C1_PEAK_BYTES = 9_610_426_368
C1_UNPACK_BYTES = 4 * 4096 * 160
# BASELINE config 3 (acceptance.py CONFIGS[3]) on a 1,000,000 bp genome
# (chr21 is 46,709,983 bp; the CPU record ACCEPTANCE_full_c3.json has
# 6,000,000, at which the six phases took 1,206.4 s on an H100 80GB HBM3
# at 700 W, this phase ~410 s of it; at 3,000,000 bp it took 121.1 s of
# a 1,009.7 s call on the same card, and the script, with phases 5-7 at
# their earlier sizes, ran past 1,200 s on a slower host), PE150, 30x,
# error 0.005, k=31, 200,000 reads. The tables keep the sizes acceptance.py's rule gives at
# 3,000,000 bp: distinct = G + n*150*0.005*31 = 16,950,000, so
# exact_capacity 2^25 and a 2^27-counter Bloom table.
C3_GENOME = 1_000_000
C3_FULL_GENOME = 46_709_983
C3_COVERAGE = 30
C3_ERROR = 0.005
C3_CFG = dict(k=31, bloom_log2_width=27, exact_capacity=1 << 25,
              batch_reads=4096, max_read_len=160)
# BASELINE config 5 (acceptance.py CONFIGS[5]: human WGS 30x PE150, k=31 ->
# k2=63 two-pass correct + assemble, error 0.005) at a quarter of the size
# of ACCEPTANCE_full_c5.json: a 500,000 bp genome (the cut; the human
# genome is 3.1 Gb; at 2,000,000 bp this phase took 230.3 s of the
# 1,009.7 s call above), 30x, 100,000 reads. The tables keep the sizes
# acceptance.py's rule gives at 2,000,000 bp: distinct = G +
# n*150*0.005*31 = 11,300,000, so exact_capacity 2^25 and a 2^27-counter
# Bloom table, for both passes.
C5_GENOME = 500_000
C5_COVERAGE = 30
C5_ERROR = 0.005
C5_CFG = dict(k=31, bloom_log2_width=27, exact_capacity=1 << 25,
              batch_reads=4096, max_read_len=160)


def _cli_args(cfg: dict) -> list:
    return ["-k", str(cfg["k"]), "--bloom-log2-width",
            str(cfg["bloom_log2_width"]), "--exact-capacity",
            str(cfg["exact_capacity"]), "--batch-reads",
            str(cfg["batch_reads"]), "--max-read-len",
            str(cfg["max_read_len"])]


C1_ARGS = _cli_args(C1_CFG)
C3_ARGS = _cli_args(C3_CFG)
C5_ARGS = _cli_args(C5_CFG)
SEED = 42
READ_LEN = 150
# the kernels of count -> correct -> assemble (phase 4); K4 runs only on
# the align-validate path (phase 5)
MAIN_PATH_KERNELS = ("bloom_insert", "bloom_query_solid",
                     "correct_eval_scores")
# every kernel of the one-device paths; K1r runs only in a mesh count
ONE_DEVICE_KERNELS = MAIN_PATH_KERNELS + ("banded_align_scores",)

CARD = ""          # "name, power limit" of the card, set in phase 1
DEVICE = "cuda"    # the card (a CPU rehearsal of this script sets "cpu")


def say(msg: str) -> None:
    print(msg, flush=True)


def num(msg: str) -> None:
    """A line that carries a measured number: the card goes beside it."""
    print(f"{msg}  [{CARD}]", flush=True)


# ---------------------------------------------------------------- phase 1

def phase_toolchain():
    global CARD
    import torch
    from kmerax_torch.utils import cuda

    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(CARD)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    say("nvcc: " + nvcc.strip().splitlines()[-1])
    so, secs = cuda.build()
    num(f"phase1 kernels built in {secs:.2f} s -> {so.name}")
    for ln in so.with_suffix(".log").read_text().splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            say("  ptxas " + ln.strip())
    cuda.lib()


# ---------------------------------------------------------------- phase 2

def _median_ms(fn, runs: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _per_launch_ms(fn, launches: int = 50, warm: int = 3):
    """(device ms per call, host ms per call) over `launches` back-to-back
    calls between two CUDA events: while the host enqueues faster than the
    card runs, the event time is the kernels' own, not the wrapper's."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / launches
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches, host


# The least time the card could take for a kernel's work (the larger of
# bytes over the HBM rate and int32 operations over the int32 issue rate),
# and the sector floor that random 512-byte counter rows allow.
HBM_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
INT32_OPS_PER_S = 132 * 64 * 1.98e9     # 132 SMs x 64 INT32 lanes x 1.98 GHz
SECTOR = 32                             # bytes of one DRAM sector
# bytes of one counter in each layout (a p16 counter is a halfword)
_COUNTER_BYTES = {"i32": 4, "p16": 2}
# phase 2's batch (reads x length) and table (log2 counters): config 1's
K_READS, K_LEN, K_LOG2_WIDTH = 4096, 160, 29
# the k phase 2 holds K1-K3 and K1r to their plain versions at: every word
# count W = ceil(k/16) the kernels instantiate (15: W = 1; 33: W = 3, K3's
# first two-warps-a-variant case), and the k it times them at
K_CHECKED, K_TIMED = (15, 25, 31, 33, 63), (25, 31, 63)
# the minimizer bucket scheme's settings (KmeraxConfig defaults): m = 11,
# 256 buckets
MINIMIZER_M, LOG2_BUCKETS = 11, 8


def _params(k, scheme="hash", log2_width=None, counter="i32"):
    """Phase 2's Bloom parameters: d = 4, 2^K_LOG2_WIDTH counters."""
    from kmerax_torch.spectrum.bloom import BloomParams

    return BloomParams(k, log2_width or K_LOG2_WIDTH, 4, MINIMIZER_M,
                       LOG2_BUCKETS, scheme, counter)


def _covered(kmers, span):
    """(R, nk + span - 1) bool: the m-mers of each row that lie in at least
    one of the k-mers `kmers` marks ((R, nk) bool, a row's k-mers in order,
    `span` = k - m + 1 m-mers a k-mer)."""
    import torch

    nk = kmers.shape[1]
    c = torch.nn.functional.pad(kmers.to(torch.int32).cumsum(1), (1, 0))
    j = torch.arange(nk + span - 1, device=kmers.device)
    return (c[:, (j + 1).clamp(max=nk)]
            - c[:, (j - span + 1).clamp(min=0)]) > 0


def _mmers(p, valid, fwd):
    """(m-mer, strand) pairs whose mix32 the minimizers of the k-mers
    `valid` marks need ((R, nk) bool, `fwd` their canonical strand): each
    m-mer in a k-mer whose canonical form reads it on that strand, counted
    once however many k-mers share it; 0 under the hash scheme."""
    if p.bucket_scheme != "minimizer":
        return 0
    span = p.k - p.minimizer_m + 1
    return sum(int(_covered(valid & s, span).sum()) for s in (fwd, ~fwd))


def _k3_mmers(pk, live, fwd, args):
    """(m-mer, strand) pairs whose mix32 one K3 call needs (0 under the
    hash scheme). `live` and `fwd` are (Q, 4, k): the probed windows of each
    entry's center variants and their canonical strands. The m-mers of the
    round-start reads count once per read position and strand, however many
    entries' windows hold them; the m-mers over an entry's center count
    again for each variant other than the read's base, once per distinct
    (read, position)."""
    import torch

    if pk.bucket_scheme != "minimizer":
        return 0
    bases, _, _, ent_r, ent_i = args
    k, m = pk.k, pk.minimizer_m
    B, L = bases.shape
    Q, dev = live.shape[0], live.device
    keep = ent_i >= 0
    r, ic = ent_r.long(), ent_i.long().clamp(0, L - 1)
    is_cur = (torch.arange(4, device=dev)[None, :]
              == (bases[r, ic].long() & 3)[:, None])[:, :, None]
    center = torch.zeros(2 * k - m, dtype=torch.bool, device=dev)
    center[k - m:k] = True
    flat = (r * L + ic - (k - 1))[:, None] + torch.arange(2 * k - m,
                                                          device=dev)
    idx = torch.nonzero(keep).squeeze(1)
    if idx.numel() == 0:
        return 0
    _, inv = torch.unique(r[idx] * L + ic[idx], return_inverse=True)
    rep = torch.empty(int(inv.max()) + 1, dtype=torch.long,
                      device=dev).scatter_(0, inv, idx)
    total = 0
    for s in (fwd, ~fwd):
        cov = _covered((live & s & keep[:, None, None]).reshape(-1, k),
                       k - m + 1).reshape(Q, 4, -1)
        in_read = torch.where(center, (cov & is_cur).any(1), cov.any(1))
        seen = torch.zeros(B * L, dtype=torch.bool, device=dev)
        seen[flat[in_read]] = True
        sub = (cov & ~is_cur)[:, :, center].sum(dim=(1, 2))
        total += int(seen.sum()) + int(sub[rep].sum())
    return total


def _bound(nbytes, ops):
    """(bound_ms, bound_by) of a function that must move `nbytes` (each
    input read once, each output written once) and do `ops` int32
    operations."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / INT32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _kmer_ops(W, n_windows, n_kmers, lanes, mmers=0):
    """int32 operations to address k-mers from packed words: per window the
    W word extraction and the validity test (4W + 4); per valid k-mer the
    canonical form (25W: reverse-complement 19, alignment 3, compare 2,
    select 1 per word) and two murmur3 hashes (2 x (9W + 8)); per counter
    lane its address (3) and its compare or atomic add (1). Under the
    minimizer scheme, the least the minimizers need: `mmers` (m-mer,
    strand) pairs (`_mmers`, `_k3_mmers`: each m-mer once however many
    k-mers share it), each rolled in from its neighbour (3), mixed by mix32
    (8) and entered into a prefix and a suffix minimum (2), so that a
    k-mer's minimizer is one min of two (van Herk / Gil-Werman); then per
    k-mer that min (1) and the bucket and block (4)."""
    ops = n_windows * (4 * W + 4) + n_kmers * (43 * W + 16) + 4 * lanes
    if mmers:
        ops += 13 * mmers + 5 * n_kmers
    return ops


def _probe_traffic(table, block, lanepack, valid, d, t=None,
                   counter="i32"):
    """(counters read, distinct 32-byte sectors) these k-mers need: all d
    lanes of every valid k-mer (the insert: t=None), or a probe's lanes up
    to and including the first below t. A p16 block's lanes lie in word row
    block >> 1, so its sectors are counted as the i32 row's."""
    import torch

    lanes = torch.stack([(lanepack.long() >> (7 * j)) & 127
                         for j in range(d)], dim=-1)
    need = valid.reshape(-1, 1).expand(-1, d).clone()
    if t is not None:
        blk = block.long()[:, None]
        if counter == "p16":
            vals = (table[(blk >> 1) * 128 + lanes].long()
                    >> (16 * (blk & 1))) & 0xFFFF
        else:
            vals = table[blk * 128 + lanes]
        below = vals < t
        passed = torch.cumprod((~below).to(torch.int32), dim=1).bool()
        need[:, 1:] &= passed[:, :-1]
    sec = lanes >> 3                    # 8 int32 counters per sector
    first = need.clone()
    for j in range(1, d):
        for i in range(j):
            first[:, j] &= ~(need[:, i] & (sec[:, i] == sec[:, j]))
    return int(need.sum()), int(first.sum())


def _reads(rng, B, L, k, n_rate=0.003):
    """(B, L) int32 bases with Ns, ragged lengths >= k and 4-padding, from
    a shared genome so k-mers repeat across reads."""
    import numpy as np

    genome = rng.integers(0, 4, 200_000).astype(np.int32)
    starts = rng.integers(0, len(genome) - L, B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]]
    errs = rng.random(reads.shape) < 0.01
    reads = np.where(errs, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads)
    reads[rng.random(reads.shape) < n_rate] = 4
    lengths = np.full(B, L, np.int32)
    short = rng.random(B) < 0.1
    lengths[short] = rng.integers(k, L + 1, short.sum())
    for i in np.nonzero(short)[0]:
        reads[i, lengths[i]:] = 4
    return reads.astype(np.int32), lengths


# host seconds a profiler session idles before and after its launches when
# it is repeated: the profiler keeps only the device records that fall in
# its window, which it opens and closes on a host clock
_PROFILE_PADS = (0.05, 0.5, 2.0)


def _kernel_ms(fn, kernel: str, launches: int = 50, warm: int = 3):
    """The device time per launch of the CUDA kernel whose name holds
    `kernel`, as torch.profiler records it over `launches` calls of fn:
    the kernel's own time, whatever the host's pace. A session that
    recorded fewer launches than were made is said and repeated, with the
    launches framed by idle host time (`_PROFILE_PADS`); None where no
    session recorded them all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for pad in (0.0, *_PROFILE_PADS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        us = n = 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in e.key):
                us += e.self_device_time_total
                n += e.count
        if n >= launches:
            return us / n * 1e-3
        say(f"profiler: {kernel}: the session (idle {pad} s before and "
            f"after) recorded {n} of its {launches} launches")
    return None


def _timed(fn, plain, kernel: str, plain_calls: int = 10) -> dict:
    """The kernel's device ms per launch over 50 back-to-back calls between
    two events and its host ms per call, its own device time per launch
    from the profiler (kernel_ms: where the host enqueues no faster than
    the card runs, the event time is the host's), one wrapper call's
    median ms, and the plain version's ms per call back to back."""
    ms, host = _per_launch_ms(fn)
    kms = _kernel_ms(fn, kernel)
    wms = _median_ms(fn)
    pms, _ = _per_launch_ms(plain, plain_calls)
    return dict(ms=ms, kernel_ms=kms, host_ms=host, wrapper_ms=wms,
                plain_ms=pms)


def _record(name, source, replaces, err, times, nbytes, ops, floor_bytes,
            library_ms, scheme="hash"):
    bound, by = _bound(nbytes, ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                scheme=scheme, max_abs_err=err, **times, bound_ms=bound,
                bound_by=by,
                sector_floor_ms=None if floor_bytes is None
                else floor_bytes / HBM_BYTES_PER_S * 1e3,
                library_ms=library_ms)


def _say_times(tag: str, r: dict) -> None:
    floor = "none (no counter rows)" if r["sector_floor_ms"] is None \
        else f"{r['sector_floor_ms']:.4f} ms"
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    num(f"{tag}: kernel {r['ms']:.4f} ms per launch back to back, its own "
        f"device time {r['kernel_ms']} ms (profiler) (host "
        f"{r['host_ms']:.4f} ms per call; one wrapper call "
        f"{r['wrapper_ms']:.4f} ms median); bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); sector floor {floor}; library {lib}; plain "
        f"{r['plain_ms']:.4f} ms per call")


def phase_kernels(device=DEVICE):
    """Kernel == plain version at main-path shapes; K1-K3 under the hash
    and then the minimizer bucket scheme. Returns the kernel records of the
    final JSON line (without launch counts): K1-K4 under the hash scheme,
    then K1-K3 under the minimizer scheme."""
    import numpy as np
    import torch
    from kmerax_torch.spectrum.bloom import make_table

    rng = np.random.default_rng(SEED)
    recs, mz = [], []
    for scheme, out in (("hash", recs), ("minimizer", mz)):
        out.append(_check_k1(rng, device, scheme))
        out.append(_check_k1r(rng, device, scheme))
        tk = make_table(_params(31), device)
        out.append(_check_k2(rng, tk, device, scheme=scheme))
        out.append(_check_k3(rng, tk, _fill3, 4 * K_READS, device,
                             scheme=scheme))
        # timed once: every profiler session in this process makes the
        # later ones likelier to drop events (phase 7's p16 count trace)
        out.extend(_check_slots(rng, tk, device, scheme=scheme,
                                timed=(31,) if scheme == "hash" else ()))
        del tk
        torch.cuda.empty_cache()
        if scheme == "hash":
            recs.append(_check_k4(rng, device))
    _check_merge(rng, device)
    recs.append(_check_k5(rng, device))
    _check_k5_partitions(rng, device)
    for h, m in zip(recs, mz):
        num(f"phase2 {h['name']} at k=31, hash / minimizer scheme: kernel "
            f"{h['kernel_ms']} / {m['kernel_ms']} ms (profiler), "
            f"{h['ms']:.4f} / {m['ms']:.4f} ms back to back, bound "
            f"{h['bound_ms']:.4f} ({h['bound_by']}) / {m['bound_ms']:.4f} "
            f"({m['bound_by']}) ms")
    return recs + mz + _check_p16(rng, device, recs[0]["library_ms"])


# one exact flush of the benchmark's ecoli cell: 15 batches of 4,096 reads
# x (160 - 31 + 1) pending rows, onto a resident spectrum of 5 M distinct
# (the cell ends near 7.66 M); ~8 % sentinel rows (150 bp reads in 160)
MERGE_PENDING, MERGE_RESIDENT = 15 * 4096 * 130, 5_000_000
MERGE_SENTINEL = 0.08


def _check_merge(rng, device) -> None:
    """The count's device merge (spectrum/exact.py::merge_pending) at one
    flush of the ecoli cell, k = 31 and 63: equal to np_merge_counted on
    the host rows, and its wall a flush (the first call apart) beside the
    host merge's."""
    import numpy as np
    import torch
    from kmerax_torch.spectrum.exact import (
        SENTINEL_WORD, merge_pending, np_merge_counted, rows_to_keys,
        spectrum_to_host,
    )

    for k in (31, 63):
        w = (k + 15) // 16

        def rows(n):
            r = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
            r = r.astype(np.uint32)
            r[:, -1] &= np.uint32((1 << (2 * k - 32 * (w - 1))) - 1)
            return r

        uniq, counts = np_merge_counted(
            rows(MERGE_RESIDENT), rng.integers(1, 60, MERGE_RESIDENT))
        n_old = MERGE_PENDING // 2
        pend = np.concatenate([
            uniq[rng.integers(0, len(uniq), n_old)],
            rows(MERGE_PENDING - n_old)])
        pend[rng.random(MERGE_PENDING) < MERGE_SENTINEL] = SENTINEL_WORD
        keys = rows_to_keys(torch.from_numpy(uniq.view(np.int32)).to(device))
        cnt = torch.from_numpy(counts).to(device)
        dpend = torch.from_numpy(pend.view(np.int32)).to(device)
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = merge_pending(keys, cnt, dpend)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got_u, got_c = spectrum_to_host(out[0], out[1], w)
        d2h = time.perf_counter() - t0
        t0 = time.perf_counter()
        new = pend[~np.all(pend == SENTINEL_WORD, axis=1)]
        want_u, want_c = np_merge_counted(
            np.concatenate([uniq, new]),
            np.concatenate([counts, np.ones(len(new), np.int64)]))
        host = time.perf_counter() - t0
        if not (np.array_equal(got_u, want_u)
                and np.array_equal(got_c, want_c)
                and out[2] == len(uniq) + len(new)):
            raise AssertionError(f"merge_pending != np_merge_counted at "
                                 f"k={k}")
        del keys, cnt, dpend, out
        torch.cuda.empty_cache()
        num(f"phase2 merge_pending k={k}: {MERGE_PENDING} pending rows "
            f"({len(new)} valid) onto {len(uniq)} resident -> "
            f"{len(want_u)} distinct, == np_merge_counted; wall a flush "
            f"{1e3 * float(np.median(walls[1:])):.2f} ms (first call "
            f"{1e3 * walls[0]:.2f} ms), copy back {1e3 * d2h:.1f} ms; the "
            f"host merge {host:.2f} s")


# K5's shapes (k, solid nodes C), one partition each: the chr21 cell's
# graph after its re-count (W = 2) and the two-pass cell's at k2 (W = 4),
# as the benchmark's jobs have them (~0.47 M and ~0.77 M solid k-mers)
K5_SHAPES = ((31, 470_000), (63, 775_000))
# and config 1's graph (W = 2, ~4.6 M solid k-mers) as the main path joins
# it: one launch a 2^20-row partition, the last one partial
K5_PARTITIONED = (31, C1_GENOME, 1 << 20)


def _solid_rows(rng, k: int, C: int, device):
    """About C sorted distinct canonical k-mers ((C', W) uint32) of a random
    genome of 0.8 C bases (a path) and of 2k-base pieces of it with one
    substitution in the middle each (tips and bubbles, so nodes have up to
    four successors)."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import canonical_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.spectrum.exact import np_merge_counted

    G = int(0.8 * C)
    genome = rng.integers(0, 4, G).astype(np.int64)
    R = (C - G) // k
    at = rng.integers(0, G - 2 * k, R)
    pieces = genome[at[:, None] + np.arange(2 * k)]
    pieces[:, k] = (pieces[:, k] + rng.integers(1, 4, R)) % 4
    rows = []
    for seqs in (genome[None], pieces):
        words, valid = extract_kmers(torch.from_numpy(seqs).to(device), k)
        canon, _ = canonical_words(words[valid], k)
        rows.append(canon.cpu().numpy().astype(np.uint32))
    rows = np.concatenate(rows)
    return np_merge_counted(rows, np.ones(len(rows), np.int64))[0]


def _check_k5(rng, device) -> dict:
    """K5 (`solid_join`) == its plain version at K5_SHAPES, one launch over
    a partition of every node, and its times there: the kernel's, the
    plain version's and, at W <= 2, `torch.searchsorted`'s on the keys
    packed into one int64 (the lower bounds alone) as library_ms. Bound:
    the candidates as 32-bit words (the int64 words the kernel is handed
    carry 32 bits each), is_fwd, the keys (each once) and the outputs over
    the HBM rate, or (ceil(log2 C) + 1) steps of W + 3 int32 operations a
    search. Returns the record at the two-pass cell's shape, with
    `by_shape` holding both."""
    import math

    import numpy as np
    import torch
    from kmerax_torch.core.codec import M32
    from kmerax_torch.graph.join_kernels import lower_bound_plain, \
        solid_join, solid_join_plain
    from kmerax_torch.graph.partitioned import _extensions

    by_shape = {}
    for k, C in K5_SHAPES:
        uniq = _solid_rows(rng, k, C, device)
        C, W = uniq.shape
        keys = torch.from_numpy(uniq.view(np.int32)).to(device)
        cand, fwd = _extensions(keys.to(torch.int64) & M32, k)

        def edges():
            return [torch.zeros((C, 2), dtype=torch.int32, device=device)
                    for _ in range(3)]

        got, want = edges(), edges()
        solid_join(keys, cand, fwd, *got, 0)
        solid_join_plain(keys, cand, fwd, *want, 0)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K5 != plain at k={k}, C={C}")
        deg = got[0].cpu().numpy()
        times = _timed(lambda: solid_join(keys, cand, fwd, *got, 0),
                       lambda: solid_join_plain(keys, cand, fwd, *want, 0),
                       "solid_join")
        lib_ms = None
        if W <= 2:
            def packed(words):
                words = words.to(torch.int64) & M32
                if W == 2:
                    words = (words[..., 1:] << 32) | words[..., :1]
                return words[..., 0] ^ -(1 << 63)   # signed order = unsigned
            kp, qp = packed(keys), packed(cand).reshape(-1)
            lb = lower_bound_plain(keys.to(torch.int64) & M32,
                                   cand.reshape(-1, W))
            if not torch.equal(torch.searchsorted(kp, qp), lb):
                raise AssertionError(f"torch.searchsorted on the packed "
                                     f"keys != the lower bounds at k={k}")
            lib_ms = _per_launch_ms(lambda: torch.searchsorted(kp, qp))[0]
        nq = 8 * C
        nbytes = nq * W * 4 + nq + C * W * 4 + 3 * 2 * C * 4
        ops = nq * (math.ceil(math.log2(C)) + 1) * (W + 3)
        rec = _record("solid_join", "kmerax_torch/csrc/graph.cu",
                      "none: the JAX package joins on the host "
                      "(kmerax/graph/partitioned.py::solid_edges_host)",
                      0, times, nbytes, ops, None, lib_ms)
        _say_times(f"phase2 K5 solid_join k={k} C={C} W={W}", rec)
        num(f"phase2 K5 k={k}: == plain; out-degrees 0/1/2+: "
            f"{int((deg == 0).sum())} / {int((deg == 1).sum())} / "
            f"{int((deg >= 2).sum())} of {2 * C} (node, orientation)s")
        by_shape[f"k={k} C={C}"] = {key: rec[key] for key in (
            "ms", "kernel_ms", "host_ms", "wrapper_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
        del keys, cand, fwd, got, want
        torch.cuda.empty_cache()
    rec["by_shape"] = by_shape
    return rec


def _check_k5_partitions(rng, device) -> None:
    """K5 at K5_PARTITIONED, one launch a partition at rows 0, P, 2P, ..
    as graph/partitioned.py::solid_edges_host makes them, == the plain
    version over all the nodes at once: the whole edge arrays."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import M32
    from kmerax_torch.graph.join_kernels import solid_join, solid_join_plain
    from kmerax_torch.graph.partitioned import _extensions

    k, C, part = K5_PARTITIONED
    uniq = _solid_rows(rng, k, C, device)
    C = len(uniq)
    keys = torch.from_numpy(uniq.view(np.int32)).to(device)
    got = [torch.zeros((C, 2), dtype=torch.int32, device=device)
           for _ in range(3)]
    want = [torch.zeros_like(t) for t in got]
    starts = range(0, C, part)
    for s in starts:
        cand, fwd = _extensions(keys[s:s + part].to(torch.int64) & M32, k)
        solid_join(keys, cand, fwd, *got, s)
    del cand, fwd
    cand, fwd = _extensions(keys.to(torch.int64) & M32, k)
    solid_join_plain(keys, cand, fwd, *want, 0)
    if device != "cpu":
        torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        bad = [name for name, a, b in zip(("outdeg", "succ_v", "succ_o"),
                                          got, want) if not torch.equal(a, b)]
        raise AssertionError(f"K5 in {len(starts)} partitions of {part} rows "
                             f"!= plain over all {C} nodes at k={k}: {bad}")
    num(f"phase2 K5 k={k} C={C}: {len(starts)} launches at rows 0, {part}, "
        f".., {starts[-1]} (the last {C - starts[-1]} rows) == plain over "
        f"all the nodes at once")
    del keys, cand, fwd, got, want
    if device != "cpu":
        torch.cuda.empty_cache()


def _check_p16(rng, device, index_add_ms):
    """K1, K2 and K3 on p16 counters (2^29 counters, 1 GiB of words) ==
    their plain versions at k in K_CHECKED under both bucket schemes,
    K1's words unpacked == min(K1's i32 table, SAT16), and the saturation
    case (`_p16_saturation`); then the layouts' times at 2^24 and 2^29
    counters (`_by_width`). Returns the p16 records, hash scheme, k=31
    (max_abs_err over both schemes): no PyTorch call computes a
    saturating halfword add or its probe, so library_ms is None, and the
    i32 K1's `index_add_` time stands beside K1's for reference."""
    import torch
    from kmerax_torch.spectrum.bloom import make_table

    recs = {}
    for scheme in ("hash", "minimizer"):
        got = [_check_k1_p16(rng, device, scheme)]
        tk = make_table(_params(31, counter="p16"), device)
        timed = (31,) if scheme == "hash" else ()
        got.append(_check_k2(rng, tk, device, scheme=scheme, counter="p16",
                             timed=timed))
        got.append(_check_k3(rng, tk, _fill3, 4 * K_READS, device,
                             scheme=scheme, counter="p16", timed=timed))
        _check_slots(rng, tk, device, scheme=scheme, counter="p16",
                     timed=())
        del tk
        torch.cuda.empty_cache()
        for i, r in enumerate(got):
            if i in recs:
                recs[i]["max_abs_err"] = max(recs[i]["max_abs_err"],
                                             r["max_abs_err"])
            else:
                recs[i] = r
    recs[0]["max_abs_err"] = max(recs[0]["max_abs_err"],
                                 _p16_saturation(device),
                                 _p16_contention(device))
    recs[0]["index_add_i32_ms"] = index_add_ms
    num(f"phase2 K1 bloom_insert_p16: library none (no one PyTorch call "
        f"computes a saturating halfword add); for reference, the i32 "
        f"index_add_ at the same batch's lanes {index_add_ms} ms")
    widths = _by_width(rng, device)
    out = [recs[i] for i in range(3)]
    for r in out:
        base = r["name"].removesuffix("_p16")
        r["ms_by_width"] = {w: v[base] for w, v in widths.items()}
    return out


def _check_k1_p16(rng, device, scheme):
    """K1 on p16 counters == its plain version on one config-1 batch (4096
    x 160 int8 into 2^29 counters) at k in K_CHECKED under the bucket
    `scheme`: the words, the pending rows written from a nonzero row offset
    and the valid count; and its words unpacked == min(K1's i32 table,
    SAT16) on the same batch. Returns the record at k=31, timed as the
    count step calls it, under the hash scheme; else {"max_abs_err"}."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import canonical_words, num_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.spectrum.bloom import SAT16, make_table, unpack16
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_insert, bloom_insert_plain
    from kmerax_torch.spectrum.exact import sentinel_rows

    B, L, LW, d = K_READS, K_LEN, K_LOG2_WIDTH, 4
    rec, err_max = None, 0
    for k in K_CHECKED:
        p = _params(k, scheme, counter="p16")
        reads, _ = _reads(rng, B, L, k)
        bases = torch.as_tensor(reads.astype(np.int8), device=device)
        W, rows = num_words(k), B * (L - k + 1)
        outs = []
        for fn in (bloom_insert, bloom_insert_plain):
            table = make_table(p, device)
            pending = sentinel_rows(2 * rows, W, device)
            n_valid = fn(table, bases, p, pending, rows)
            torch.cuda.synchronize()
            outs.append((table, pending, n_valid))
        (tk, pk, nk), (tp, pp, np_) = outs
        err = max(int((tk - tp).abs().max()),
                  int((pk.long() - pp.long()).abs().max()),
                  abs(int(nk) - int(np_)))
        if not (torch.equal(tk, tp) and torch.equal(pk, pp)
                and int(nk) == int(np_)):
            raise AssertionError(f"K1 p16 differs from plain at k={k}, "
                                 f"{scheme} scheme (max {err})")
        if not 0 < int(nk) < rows:
            raise AssertionError(f"K1 p16 test is degenerate at k={k}")
        del tp, pp, outs
        t32 = make_table(_params(k, scheme), device)
        bloom_insert(t32, bases, _params(k, scheme))
        if not torch.equal(unpack16(tk), t32.clamp_(max=SAT16)):
            raise AssertionError(f"K1 p16 words unpacked != min(K1 i32, "
                                 f"SAT16) at k={k}, {scheme} scheme")
        del t32
        err_max = max(err_max, err)
        say(f"phase2 K1 bloom_insert_p16 == plain at k={k}, {scheme} "
            f"scheme: {B} x {L} int8 batch into 2^{LW} p16 counters "
            f"({tk.numel()} words): words, {rows} pending rows from row "
            f"{rows} and valid count {int(nk)} equal; words unpacked == "
            f"min(K1's i32 table, SAT16)")
        if k == 31 and scheme == "hash":
            words, valid = extract_kmers(bases, k)
            canon, _ = canonical_words(words, k)
            blk, lp = blocks_lanepack(p, canon)
            del words, canon
            lanes, sectors = _probe_traffic(tk, blk.reshape(-1),
                                            lp.reshape(-1),
                                            valid.reshape(-1), d)
            del blk, lp, valid
            times = _timed(lambda: bloom_insert(tk, bases, p, pk, rows),
                           lambda: bloom_insert_plain(tk, bases, p, pk,
                                                      rows),
                           "bloom_insert_kernel")
            io_bytes = B * L + 4 * W * rows + 8
            rec = _record("bloom_insert_p16", "kmerax_torch/csrc/bloom.cu",
                          "kmerax/spectrum/pallas_bloom.py:97", err, times,
                          io_bytes + 2 * _COUNTER_BYTES["p16"] * lanes,
                          _kmer_ops(W, rows, int(nk), lanes),
                          io_bytes + 2 * SECTOR * sectors, None, scheme)
            _say_times(f"phase2 K1 bloom_insert_p16 at k={k}, {scheme} "
                       f"scheme: {lanes} counter lanes in {sectors} "
                       f"sectors", r=rec)
        del tk, pk
        torch.cuda.empty_cache()
    if rec is None:
        return {"max_abs_err": err_max}
    rec["max_abs_err"] = err_max
    return rec


def _p16_saturation(device) -> int:
    """One read's k-mers inserted until their p16 counters pass SAT16: a
    batch of 4096 x 160 whose first 2048 rows are one read (130 k-mers at
    k=31, so 2048 warps CAS the same words) and whose other rows are
    random, inserted 17 times (34,816 times the read: past SAT16 by one
    batch) into 2^24 counters
    by K1 p16, by its plain version, and by K1 on i32 counters: the p16
    words equal, unpacked == min(i32, SAT16), the read's counters at
    SAT16. Returns the max abs difference (0)."""
    import numpy as np
    import torch
    from kmerax_torch.spectrum.bloom import SAT16, make_table, unpack16
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
        bloom_insert_plain

    rng = np.random.default_rng(SEED + 16)
    B, L, k = K_READS, K_LEN, 31
    n = -(-(SAT16 + 1) // (B // 2)) + 1          # 17 at B = 4096
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    reads[:B // 2] = reads[0]
    bases = torch.as_tensor(reads, device=device)
    p, pi = _params(k, log2_width=24, counter="p16"), _params(k,
                                                              log2_width=24)
    tk, tp, t32 = make_table(p, device), make_table(p, device), \
        make_table(pi, device)
    for _ in range(n):
        bloom_insert(tk, bases, p)
        bloom_insert_plain(tp, bases, p)
        bloom_insert(t32, bases, pi)
    torch.cuda.synchronize()
    err = int((tk - tp).abs().max())
    if not torch.equal(tk, tp):
        raise AssertionError(f"K1 p16 differs from plain at saturation "
                             f"(max {err})")
    c16 = unpack16(tk)
    if not torch.equal(c16, t32.clamp(max=SAT16)):
        raise AssertionError("K1 p16 unpacked != min(K1 i32, SAT16) at "
                             "saturation")
    n_sat = int((c16 == SAT16).sum())
    if not (int(t32.max()) > SAT16 and n_sat >= 4 * (L - k + 1) // 2):
        raise AssertionError(f"saturation case is degenerate: i32 max "
                             f"{int(t32.max())}, {n_sat} counters at SAT16")
    say(f"phase2 K1 bloom_insert_p16 saturation: one read in {B // 2} of "
        f"{B} rows, {n} launches ({n * B // 2} times the read) into 2^24 "
        f"counters: words == plain, unpacked == min(i32, SAT16) (i32 max "
        f"{int(t32.max())}), {n_sat} counters at SAT16")
    return err


def _p16_contention(device) -> int:
    """K1 p16 where its CASes meet and retry: one 4096 x 160 batch (k=31)
    inserted again and again into 2^10 counters (8 block rows in 4 word
    rows), so that a warp step's probes hit both halves of one word and
    k-mers with a repeated lane, until the counters pass SAT16 inside a
    launch. After every launch K1 p16's words == its plain version's and,
    unpacked, == min(K1 i32, SAT16). Returns the max abs difference (0)."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import canonical_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.spectrum.bloom import SAT16, make_table, unpack16
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_insert, bloom_insert_plain

    rng = np.random.default_rng(SEED + 17)
    B, L, k, lw = K_READS, K_LEN, 31, 10
    reads, _ = _reads(rng, B, L, k)
    bases = torch.as_tensor(reads.astype(np.int8), device=device)
    p, pi = _params(k, log2_width=lw, counter="p16"), _params(k,
                                                              log2_width=lw)
    # the collisions the batch holds: k-mers with a repeated lane, and
    # warp steps (32 windows of a read) whose probes hit both halves of a
    # word
    words, valid = extract_kmers(bases, k)
    blk, lp = blocks_lanepack(p, canonical_words(words, k)[0])
    lanes = torch.stack([(lp.long() >> (7 * i)) & 127 for i in range(4)], -1)
    rep = int(((lanes[..., :, None] == lanes[..., None, :]).sum((-1, -2))
               > 4)[valid].sum())
    step = (torch.arange(B, device=device)[:, None] * L
            + torch.arange(valid.shape[1], device=device)[None, :] // 32)
    word = ((blk.long() >> 1) * 128)[..., None] + lanes
    key = (step[..., None] << lw) + word
    half = (blk.long() & 1)[..., None].expand_as(key)
    both = torch.unique(torch.unique(key[valid] * 2 + half[valid]) >> 1,
                        return_counts=True)[1]
    n_both = int((both == 2).sum())
    del words, blk, lp, lanes, step, word, key, half
    if not (rep > 0 and n_both > 0):
        raise AssertionError(f"contention case is degenerate: {rep} k-mers "
                             f"with a repeated lane, {n_both} words hit on "
                             f"both halves in one warp step")
    tk, tp, t32 = make_table(p, device), make_table(p, device), \
        make_table(pi, device)
    err, crossed, n = 0, 0, 0
    while int(t32.min()) <= SAT16:
        if n == 40:
            raise AssertionError("contention case: counters below SAT16 "
                                 "after 40 launches")
        before = t32.clone()
        bloom_insert(tk, bases, p)
        bloom_insert_plain(tp, bases, p)
        bloom_insert(t32, bases, pi)
        torch.cuda.synchronize()
        n += 1
        err = max(err, int((tk - tp).abs().max()))
        if not torch.equal(tk, tp):
            raise AssertionError(f"K1 p16 differs from plain under "
                                 f"contention at launch {n} (max {err})")
        if not torch.equal(unpack16(tk), t32.clamp(max=SAT16)):
            raise AssertionError(f"K1 p16 unpacked != min(K1 i32, SAT16) "
                                 f"under contention at launch {n}")
        crossed += int(((before < SAT16) & (t32 > SAT16)).sum())
    if crossed == 0:
        raise AssertionError("no counter passed SAT16 inside a launch")
    say(f"phase2 K1 bloom_insert_p16 contention: {B} x {L} batch (k=31, "
        f"{int(valid.sum())} k-mers, {rep} with a repeated lane, {n_both} "
        f"words hit on both halves in one warp step) into 2^{lw} counters, "
        f"{n} launches: words == plain and unpacked == min(i32, SAT16) "
        f"after each; {crossed} counters passed SAT16 inside a launch")
    return err


def _by_width(rng, device) -> dict:
    """The L2 question: K1, K2 and K3 at k=31 (hash scheme) on i32 and on
    p16 counters at the CLI's 2^24 counters (a 64 MiB i32 table, above the
    50 MB L2; 32 MiB of p16 words, below it) and at config 1's 2^29. Each
    kernel's own device ms per launch (profiler, 50 launches each, one
    profiler session for the three), in turns i32, p16, p16, i32 on the same
    inputs: K1 inserts one batch into a zeroed table (with its pending
    rows), K2 and K3 then probe that table at t=3. Returns {"2^LW": {kernel:
    {"i32": [ms, ms], "p16": [ms, ms]}}}, K1's with "bound": {layout:
    {bound_ms, bound_by, sector_floor_ms}} at that width."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kmerax_torch.core.codec import canonical_words, num_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.ops.correct_kernels import correct_eval_scores
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_insert, bloom_query_solid
    from kmerax_torch.spectrum.exact import sentinel_rows

    B, L, k, Q, t = K_READS, K_LEN, 31, 4 * K_READS, 3
    reads, lengths = _reads(rng, B, L, k)
    fresh, flen = _reads(rng, B, L, k)
    bases8 = torch.as_tensor(reads.astype(np.int8), device=device)
    q = torch.as_tensor(np.concatenate([reads[:B // 2], fresh[B // 2:]]),
                        device=device)
    q_lj = torch.as_tensor(np.concatenate([lengths[:B // 2],
                                           flen[B // 2:]]) - k,
                           device=device)
    lens = torch.as_tensor(lengths, device=device)
    k3 = (torch.as_tensor(reads, device=device), lens, lens - k,
          torch.as_tensor(rng.integers(0, B, Q).astype(np.int32),
                          device=device),
          torch.as_tensor(rng.integers(0, L, Q).astype(np.int32),
                          device=device))
    W, rows = num_words(k), B * (L - k + 1)
    pending = sentinel_rows(rows, W, device)
    words, valid = extract_kmers(bases8, k)
    canon, _ = canonical_words(words, k)
    n_valid, valid = int(valid.sum()), valid.reshape(-1)
    del words
    names = {"bloom_insert": "bloom_insert_kernel",
             "bloom_query_solid": "bloom_query_solid_kernel",
             "correct_eval_scores": "correct_eval_scores_kernel"}
    out = {}
    for lw in (24, K_LOG2_WIDTH):
        res = {n: {"i32": [], "p16": []} for n in names}
        # K1's bound and sector floor at this width, each layout
        blk, lp = blocks_lanepack(_params(k, "hash", lw), canon)
        lanes, sectors = _probe_traffic(None, blk.reshape(-1),
                                        lp.reshape(-1), valid, 4)
        del blk, lp
        io_bytes = B * L + 4 * W * rows + 8
        res["bloom_insert"]["bound"] = {}
        for counter, cb in _COUNTER_BYTES.items():
            bound, by = _bound(io_bytes + 2 * cb * lanes,
                               _kmer_ops(W, rows, n_valid, lanes))
            res["bloom_insert"]["bound"][counter] = dict(
                bound_ms=bound, bound_by=by, sector_floor_ms=(
                    io_bytes + 2 * SECTOR * sectors) / HBM_BYTES_PER_S * 1e3)
        for counter in ("i32", "p16", "p16", "i32"):
            p = _params(k, "hash", lw, counter)
            table = make_table(p, device)
            calls = {
                "bloom_insert": lambda: bloom_insert(table, bases8, p,
                                                     pending, 0),
                "bloom_query_solid": lambda: bloom_query_solid(
                    table, q, q_lj, p, t),
                "correct_eval_scores": lambda: correct_eval_scores(
                    p, table, t, *k3)}
            for fn in calls.values():          # warm-up; K1 fills 3 times
                for _ in range(3):
                    fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for fn in calls.values():
                    for _ in range(50):
                        fn()
                torch.cuda.synchronize()
            for name, kern in names.items():
                us = [e.self_device_time_total / e.count
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and kern in e.key and e.count]
                res[name][counter].append(us[0] * 1e-3 if us else None)
            del table
            torch.cuda.empty_cache()
        out[f"2^{lw}"] = res
        for name, v in res.items():
            num(f"phase2 {name} at 2^{lw} counters (k=31, hash scheme), "
                f"its own device ms per launch (profiler), turns i32, p16, "
                f"p16, i32: i32 {v['i32']}, p16 {v['p16']}"
                + "".join(f"; {c} bound {b['bound_ms']:.4f} ms "
                          f"({b['bound_by']}), sector floor "
                          f"{b['sector_floor_ms']:.4f} ms"
                          for c, b in v.get("bound", {}).items()))
    return out


def _check_k1(rng, device, scheme="hash"):
    """K1 == its plain version on one config-1 batch (4096 x 160 int8 into
    2^29 counters) at k in K_CHECKED under the bucket `scheme`: table
    bytes, the pending rows written from a nonzero row offset, and the
    valid count; timed at k in K_TIMED. Returns the kernel record at k=31,
    timed as the count step calls it."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import canonical_words, num_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_insert, bloom_insert_plain
    from kmerax_torch.spectrum.exact import sentinel_rows

    B, L, LW, d = K_READS, K_LEN, K_LOG2_WIDTH, 4
    rec, err_max = None, 0
    for k in K_CHECKED:
        p = _params(k, scheme)
        reads, _ = _reads(rng, B, L, k)
        bases = torch.as_tensor(reads.astype(np.int8), device=device)
        W, rows = num_words(k), B * (L - k + 1)
        outs = []
        for fn in (bloom_insert, bloom_insert_plain):
            table = make_table(p, device)
            pending = sentinel_rows(2 * rows, W, device)
            n_valid = fn(table, bases, p, pending, rows)
            torch.cuda.synchronize()
            outs.append((table, pending, n_valid))
        (tk, pk, nk), (tp, pp, np_) = outs
        err = max(int((tk - tp).abs().max()),
                  int((pk.long() - pp.long()).abs().max()),
                  abs(int(nk) - int(np_)))
        if not (torch.equal(tk, tp) and torch.equal(pk, pp)
                and int(nk) == int(np_)):
            raise AssertionError(f"K1 differs from plain at k={k}, "
                                 f"{scheme} scheme (max {err})")
        if not 0 < int(nk) < rows:
            raise AssertionError(f"K1 test is degenerate at k={k}")
        err_max = max(err_max, err)
        del tp, pp
        if k not in K_TIMED:
            say(f"phase2 K1 bloom_insert == plain at k={k}, {scheme} scheme: "
                f"{B} x {L} int8 batch into 2^{LW} counters, table bytes, "
                f"{rows} pending rows from row {rows} and valid count "
                f"{int(nk)} equal")
            del tk, pk
            torch.cuda.empty_cache()
            continue
        # the counters and sectors these k-mers touch, and the one PyTorch
        # call that adds the same ones at precomputed flat lane indices
        words, valid = extract_kmers(bases, k)
        canon, fwd = canonical_words(words, k)
        mmers = _mmers(p, valid, fwd)
        blk, lp = blocks_lanepack(p, canon)
        del canon, fwd
        blk, lp, valid = blk.reshape(-1), lp.reshape(-1), valid.reshape(-1)
        lanes, sectors = _probe_traffic(tk, blk, lp, valid, d)
        idx = (blk.long()[:, None] * 128 + torch.stack(
            [(lp.long() >> (7 * j)) & 127 for j in range(d)], -1))[valid]
        idx = idx.reshape(-1)
        ones = torch.ones(idx.numel(), dtype=torch.int32, device=device)
        lib, _ = _per_launch_ms(lambda: tk.index_add_(0, idx, ones))
        del words, blk, lp, valid, idx, ones
        times = _timed(lambda: bloom_insert(tk, bases, p, pk, rows),
                       lambda: bloom_insert_plain(tk, bases, p, pk, rows),
                       "bloom_insert_kernel")
        io_bytes = B * L + 4 * W * rows + 8
        r = _record("bloom_insert", "kmerax_torch/csrc/bloom.cu",
                    "kmerax/spectrum/pallas_bloom.py:42", err, times,
                    io_bytes + 8 * lanes,
                    _kmer_ops(W, rows, int(nk), lanes, mmers),
                    io_bytes + 2 * SECTOR * sectors, lib, scheme)
        _say_times(f"phase2 K1 bloom_insert == plain at k={k}, {scheme} "
                   f"scheme: {B} x {L} "
                   f"int8 batch into 2^{LW} counters, table bytes, {rows} "
                   f"pending rows from row {rows} and valid count "
                   f"{int(nk)} equal; {lanes} counter lanes in {sectors} "
                   f"sectors; {mmers} (m-mer, strand) pairs mixed", r)
        if k == 31:
            rec = r
        del tk, pk
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err_max
    return rec


def _rows_ops(p, n_kmers, lanes):
    """int32 operations of K1r on routed canonical rows: per valid k-mer
    two murmur3 hashes (2 x (9W + 8)), the block mask (1) and, under the
    minimizer scheme, its k-m+1 m-mers (rows of different reads share
    none: each is extracted (3), mixed (8) and entered into the minimum
    (2)) and the bucket and block (5); per counter lane its address (3)
    and its atomic add (1)."""
    from kmerax_torch.core.codec import num_words

    ops = n_kmers * (18 * num_words(p.k) + 17) + 4 * lanes
    if p.bucket_scheme == "minimizer":
        ops += n_kmers * (13 * (p.k - p.minimizer_m + 1) + 5)
    return ops


SHARDS = (1, 2, 4, 8)


def _k1r_orders(t, rows, rv, p, lb, pend, off) -> dict:
    """K1r's own device ms per launch, and index_add_'s at the same lanes,
    on the same routed rows in three orders: as routed; sorted by their
    local block; grouped (stably) into the slice's 512 MiB and its 256 MiB
    regions. Valid rows lead the sorted and grouped orders, the sentinel
    slots follow: only the order in which the counter rows are visited
    differs."""
    import torch
    from kmerax_torch.core.codec import M32
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_insert_rows

    blk, lp = blocks_lanepack(p, rows.long() & M32)
    blk = blk.long() & ((1 << (lb - 7)) - 1)
    lanes = torch.stack([(lp.long() >> (7 * j)) & 127
                         for j in range(p.num_hashes)], -1)
    # a 2^s MiB region holds 2^(s + 11) blocks of 512 bytes
    keys = {"routed": None, "sorted by block": blk,
            "512 MiB regions": blk >> 20, "256 MiB regions": blk >> 19}
    out = {}
    for name, key in keys.items():
        if key is None:
            r, v, b, ln = rows, rv, blk, lanes
        else:
            o = torch.argsort(torch.where(rv, key, 1 << 40), stable=True)
            r, v, b, ln = rows[o].contiguous(), rv[o], blk[o], lanes[o]
        idx = (b[:, None] * 128 + ln)[v].reshape(-1)
        ones = torch.ones(idx.numel(), dtype=torch.int32, device=t.device)
        ms = _kernel_ms(lambda: bloom_insert_rows(t, r, v, p, lb, pend, off),
                        "bloom_insert_rows")
        lib, _ = _per_launch_ms(lambda: t.index_add_(0, idx, ones))
        out[name] = {"kernel_ms": ms, "index_add_ms": lib}
        del r, v, b, ln, idx, ones
    return out


def _k1r_by_spt(t, rows, rv, p, lb, pend, off) -> dict:
    """K1r's own device ms per launch on these rows with each number of
    routed slots a thread it takes (1, 2, 4), against the one
    `k1r_slots_per_thread` picks for them."""
    from kmerax_torch.spectrum import bloom_kernels as bk

    pick = bk.k1r_slots_per_thread
    out = {"picked": pick(rows.shape[0])}
    try:
        for spt in (1, 2, 4):
            bk.k1r_slots_per_thread = lambda n, spt=spt: spt
            out[spt] = _kernel_ms(
                lambda: bk.bloom_insert_rows(t, rows, rv, p, lb, pend, off),
                "bloom_insert_rows")
    finally:
        bk.k1r_slots_per_thread = pick
    return out


def _k1r_same(rows, rv, p, lb, off, device, what: str):
    """K1r and its plain version on the same routed rows, each into a
    fresh slice and a sentinel-filled pending buffer of off + N rows:
    slices, whole pending buffers and returned counts equal, the count ==
    the valid rows. Returns (the kernel's slice, max abs difference)."""
    import torch
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert_rows, \
        bloom_insert_rows_plain
    from kmerax_torch.spectrum.exact import sentinel_rows

    outs = []
    for fn in (bloom_insert_rows, bloom_insert_rows_plain):
        t = torch.zeros(1 << lb, dtype=torch.int32, device=device)
        pend = sentinel_rows(off + rows.shape[0], rows.shape[1], device)
        n = int(fn(t, rows, rv, p, lb, pend, off))
        torch.cuda.synchronize()
        outs.append((t, pend, n))
    (tk, pk, nk), (tp, pp, np_) = outs
    err = max(int((tk - tp).abs().max()),
              int((pk.long() - pp.long()).abs().max()), abs(nk - np_))
    if not (torch.equal(tk, tp) and torch.equal(pk, pp)
            and nk == np_ == int(rv.sum())):
        raise AssertionError(f"K1r differs from plain at {what} (max "
                             f"{err}; counts {nk} / {np_})")
    return tk, err


def _k1r_patterns(rows, rv, p, lb, device, scheme) -> int:
    """K1r == its plain version on valid masks that route_prep does not
    make: the routed slots shuffled, every slot valid, none valid, and the
    rows from slot 1 on (tiles that start mid-block of route_prep's
    layout), each with every number of routed slots a thread the kernel
    takes. Returns the max abs difference."""
    import torch
    from kmerax_torch.spectrum import bloom_kernels as bk

    g = torch.Generator(device=device).manual_seed(SEED)
    perm = torch.randperm(rows.shape[0], generator=g, device=device)
    cases = {"shuffled": (rows[perm].contiguous(), rv[perm]),
             "all valid": (rows, torch.ones_like(rv)),
             "none valid": (rows, torch.zeros_like(rv)),
             "from slot 1": (rows[1:], rv[1:])}
    err, pick = 0, bk.k1r_slots_per_thread
    try:
        for spt in (1, 2, 4):
            bk.k1r_slots_per_thread = lambda n, spt=spt: spt
            for name, (r, v) in cases.items():
                _, e = _k1r_same(r, v, p, lb, 5, device,
                                 f"k={p.k}, {name}, {spt} slots a thread, "
                                 f"{scheme} scheme")
                err = max(err, e)
    finally:
        bk.k1r_slots_per_thread = pick
    num(f"phase2 K1r == plain at k={p.k}, S=1, {scheme} scheme, on masks "
        f"route_prep does not make ({', '.join(cases)}), at 1, 2 and 4 "
        f"routed slots a thread")
    return err


def _check_k1r(rng, device, scheme="hash"):
    """K1r == its plain version on the routed rows of one config-1 batch
    (4096 x 160 int8, 2^29 counters in all) at k in K_CHECKED under the
    bucket `scheme`: the batch's k-mers routed by the plain route prep
    (spectrum/sharded.py::route_prep, route_safety 4, one sender) to S =
    1, 2, 4 and 8 shards; each shard's slice, its pending buffer (the
    valid rows compacted from a nonzero row offset, the rest untouched)
    and the returned count equal, and the S slices, concatenated, equal
    K1's whole table on the same batch; at k=31, S=1 also on valid masks
    route_prep does not make (`_k1r_patterns`). Returns the kernel record
    at k=31 and S=1 (a one-rank mesh's shapes, timed, with the three
    orders of `_k1r_orders` under the hash scheme), and under the hash
    scheme each S's kernel time on one shard's rows."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import M32, canonical_words, num_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_insert, bloom_insert_rows, bloom_insert_rows_plain
    from kmerax_torch.spectrum.exact import sentinel_rows
    from kmerax_torch.spectrum.sharded import ShardedParams, route_prep

    B, L, LW, d = K_READS, K_LEN, K_LOG2_WIDTH, 4
    rec, err_max, ms_by_shards, ms_by_spt = None, 0, {}, {}
    for k in K_CHECKED:
        p = _params(k, scheme)
        W = num_words(k)
        reads, _ = _reads(rng, B, L, k)
        bases = torch.as_tensor(reads.astype(np.int8), device=device)
        whole = make_table(p, device)
        n_valid = int(bloom_insert(whole, bases, p))
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        flat, fvalid = canon.reshape(-1, W), valid.reshape(-1)
        del words, valid, canon
        for S in SHARDS:
            sp = ShardedParams(p, S)
            send, ovf, _ = route_prep(flat, fvalid, sp)
            if int(ovf):
                raise AssertionError(f"route overflow {int(ovf)} at S={S}")
            lb, cap = sp.local_bits, send.shape[0] // S
            slices, err = [], 0
            for s in range(S):
                blk = send[s * cap:(s + 1) * cap]
                rows, rv = blk[:, :W].contiguous(), blk[:, W] != 0
                tk, e = _k1r_same(rows, rv, p, lb, cap, device,
                                  f"k={k}, S={S}, shard {s}, {scheme} "
                                  f"scheme")
                err = max(err, e)
                slices.append(tk)
            cat = torch.cat(slices)
            if not torch.equal(cat, whole):
                raise AssertionError(f"K1r's {S} slices != K1's table at "
                                     f"k={k}, {scheme} scheme")
            del cat, slices
            err_max = max(err_max, err)
            num(f"phase2 K1r bloom_insert_rows == plain at k={k}, S={S}, "
                f"{scheme} scheme: {S} shard(s) of 2^{lb} counters, "
                f"{cap} routed rows each, slices and pending rows equal, "
                f"their concatenation == K1's 2^{LW}-counter table "
                f"({n_valid} k-mers)")
            if k != 31 or (S != 1 and scheme != "hash"):
                continue
            rows, rv = send[:cap, :W].contiguous(), send[:cap, W] != 0
            if S == 1:
                err_max = max(err_max, _k1r_patterns(rows, rv, p, lb,
                                                     device, scheme))
            t = torch.zeros(1 << lb, dtype=torch.int32, device=device)
            pend = sentinel_rows(2 * cap, W, device)
            if scheme == "hash":
                ms_by_spt[S] = _k1r_by_spt(t, rows, rv, p, lb, pend, cap)
            if S != 1:
                ms_by_shards[S] = _kernel_ms(
                    lambda: bloom_insert_rows(t, rows, rv, p, lb, pend,
                                              cap),
                    "bloom_insert_rows")
                del t, pend
                continue
            # the counters and sectors these rows touch, and the one
            # PyTorch call that adds the same ones at precomputed flat
            # lane indices of the slice
            blk, lp = blocks_lanepack(p, rows.long() & M32)
            blk = blk & ((1 << (lb - 7)) - 1)
            lanes, sectors = _probe_traffic(t, blk, lp, rv, d)
            idx = (blk.long()[:, None] * 128 + torch.stack(
                [(lp.long() >> (7 * j)) & 127 for j in range(d)], -1))[rv]
            idx = idx.reshape(-1)
            ones = torch.ones(idx.numel(), dtype=torch.int32, device=device)
            lib, _ = _per_launch_ms(lambda: t.index_add_(0, idx, ones))
            del blk, lp, idx, ones
            times = _timed(
                lambda: bloom_insert_rows(t, rows, rv, p, lb, pend, cap),
                lambda: bloom_insert_rows_plain(t, rows, rv, p, lb, pend,
                                                cap),
                "bloom_insert_rows")
            n_rows, n_ok = rows.shape[0], int(rv.sum())
            # the valid byte of every slot, the words of the valid rows
            # (a sentinel slot's are never needed) and their pending rows:
            # only the valid rows are written
            io_bytes = n_rows + 4 * W * n_ok + 4 * W * n_ok
            rec = _record("bloom_insert_rows", "kmerax_torch/csrc/bloom.cu",
                          "kmerax/spectrum/pallas_bloom.py:42", err, times,
                          io_bytes + 8 * lanes,
                          _rows_ops(p, n_ok, lanes),
                          io_bytes + 2 * SECTOR * sectors, lib, scheme)
            ms_by_shards[S] = times["kernel_ms"]
            _say_times(f"phase2 K1r bloom_insert_rows at k=31, S=1, {scheme}"
                       f" scheme: {n_rows} routed rows ({n_ok} "
                       f"valid) into 2^{lb} counters, pending rows from row "
                       f"{cap}; {lanes} counter lanes in {sectors} sectors",
                       rec)
            if scheme == "hash":
                rec["ms_by_order"] = _k1r_orders(t, rows, rv, p, lb, pend,
                                                 cap)
                num(f"phase2 K1r at k=31, S=1, hash scheme, the same rows in "
                    f"three orders (its own device ms, and index_add_'s at "
                    f"the same lanes): {rec['ms_by_order']}")
            del t, pend
        del whole, flat, fvalid, send, bases
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err_max
    if scheme == "hash":
        num(f"phase2 K1r at k=31, hash scheme, its own device ms per launch "
            f"by shard count S (one shard's routed rows, S * cap / S): "
            f"{ms_by_shards}; by S and routed slots a thread (the wrapper "
            f"takes k1r_slots_per_thread's): {ms_by_spt}")
        rec["ms_by_shards"] = ms_by_shards
        rec["ms_by_spt"] = ms_by_spt
    return rec


def _check_k2(rng, tk, device, ks=K_CHECKED, real=None,
              phase="phase2", scheme="hash", counter="i32", timed=K_TIMED):
    """K2 == bloom_query_solid_plain at k in ks on a 4096 x 160 int32 batch
    (Ns, ragged lengths, 2 % of the reads shorter than k, so last_j < 0)
    whose first half `_fill3` inserted three times into the table `tk` and
    whose second half is fresh, at t=3; and first, when `real` holds the
    arguments of a K2 call on the main path, on those; addressed under the
    bucket `scheme`. Exact. Returns the record of that call, else of
    k=31, with each timed k's times, bound and floor (`by_k`)."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import canonical_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
        bloom_query_solid, bloom_query_solid_plain

    B, L, d = K_READS, K_LEN, 4
    LW = (tk.numel() * (2 if counter == "p16" else 1)).bit_length() - 1
    name = "bloom_query_solid" if counter == "i32" \
        else "bloom_query_solid_p16"

    def cases():
        if real is not None:          # first: `_fill3` overwrites the table
            pk, t_real, (bases, last_j) = real
            yield f"k={pk.k}, main-path call", pk, t_real, bases, last_j
        for k in ks:
            pk = _params(k, scheme, LW, counter)
            seen, slen = _reads(rng, B, L, k)
            _fill3(tk, pk, seen)
            fresh, flen = _reads(rng, B, L, k)
            reads = np.concatenate([seen[:B // 2], fresh[B // 2:]])
            lengths = np.concatenate([slen[:B // 2], flen[B // 2:]])
            short = np.nonzero(rng.random(B) < 0.02)[0]
            lengths[short] = rng.integers(0, k, short.size)
            for i in short:
                reads[i, lengths[i]:] = 4
            yield (f"k={k}, {scheme} scheme, {counter} counters", pk, 3,
                   torch.as_tensor(reads, device=device),
                   torch.as_tensor(lengths - k, device=device))

    rec, err_max, by_k = None, 0, {}
    for tag, pk, t, bases, last_j in cases():
        k, W = pk.k, (pk.k + 15) // 16
        sk = bloom_query_solid(tk, bases, last_j, pk, t)
        torch.cuda.synchronize()
        sp = bloom_query_solid_plain(tk, bases, last_j, pk, t)
        torch.cuda.synchronize()
        err = int((sk.to(torch.int32) - sp.to(torch.int32)).abs().max())
        if not torch.equal(sk, sp):
            raise AssertionError(f"K2 solidity differs from plain at {tag}")
        err_max = max(err_max, err)
        nk = L - k + 1
        existing = (torch.arange(nk, device=bases.device)[None, :]
                    <= last_j[:, None])
        n_solid, n_win = int(sk.sum()), int(existing.sum())
        if not 0 < n_solid < n_win:
            raise AssertionError(f"K2 test is degenerate at {tag}: "
                                 f"{n_solid} of {n_win} solid")
        if real is None and k not in timed:
            say(f"{phase} K2 {name} == plain at {tag}: {n_solid} of "
                f"{n_win} windows solid at t={t}")
            continue
        words, valid = extract_kmers(bases, k)
        canon, fwd = canonical_words(words, k)
        blk, lp = blocks_lanepack(pk, canon)
        mmers = _mmers(pk, valid & existing, fwd)
        live = (valid & existing).reshape(-1)
        lanes, sectors = _probe_traffic(tk, blk.reshape(-1), lp.reshape(-1),
                                        live, d, t, pk.counter)
        del words, valid, canon, fwd, blk, lp
        times = _timed(lambda: bloom_query_solid(tk, bases, last_j, pk, t),
                       lambda: bloom_query_solid_plain(tk, bases, last_j, pk,
                                                       t),
                       "bloom_query_solid_kernel")
        io_bytes = 4 * bases.numel() + 4 * B + B * nk
        r = _record(name, "kmerax_torch/csrc/bloom.cu",
                    "kmerax/spectrum/pallas_bloom.py:190" if counter == "i32"
                    else "kmerax/spectrum/pallas_bloom.py:232", err, times,
                    io_bytes + _COUNTER_BYTES[pk.counter] * lanes,
                    _kmer_ops(W, B * nk, int(live.sum()), lanes, mmers),
                    io_bytes + SECTOR * sectors, None, pk.bucket_scheme)
        _say_times(f"{phase} K2 {name} == plain at {tag}: "
                   f"{B} x {L} int32 batch, {n_win} windows in [0, last_j], "
                   f"{int(live.sum())} valid, {n_solid} solid at t={t}; "
                   f"{lanes} counter lanes read in {sectors} sectors; "
                   f"{mmers} (m-mer, strand) pairs mixed", r)
        if real is None:
            by_k[k] = {key: r[key] for key in ("kernel_ms", "ms", "bound_ms",
                                               "bound_by", "sector_floor_ms")}
        if rec is None or (k == 31 and real is None):
            rec = r
    if rec is None:                   # no case timed
        return {"max_abs_err": err_max}
    rec["max_abs_err"] = err_max
    if by_k:
        rec["by_k"] = by_k
        num(f"{phase} K2 {name}, {scheme} scheme, by k: " + "; ".join(
            f"k={k} kernel {v['kernel_ms']} ms, bound {v['bound_ms']:.4f} "
            f"({v['bound_by']}), floor {v['sector_floor_ms']:.4f}"
            for k, v in by_k.items()))
    return rec


def _k3_traffic(pk, table, t, args):
    """(probed k-mers, counters read, distinct sectors, (m-mer, strand)
    pairs of the minimizers) of one K3 call: every window its plain version
    probes, each read up to its first lane below t."""
    from kmerax_torch.ops import correct
    from kmerax_torch.spectrum.bloom import blocks_lanepack

    tot = [0, 0, 0, 0]
    canonical_words, strands = correct.canonical_words, []

    def canonical_fwd(words, k):          # keeps the probed k-mers' strands
        canon, fwd = canonical_words(words, k)
        strands.append(fwd)
        return canon, fwd

    def solid_fn(cw, v):
        v = v & (args[4] >= 0).view(-1, *(1,) * (v.dim() - 1))  # dead
        block, lp = blocks_lanepack(pk, cw)
        block, lp, vf = block.reshape(-1), lp.reshape(-1), v.reshape(-1)
        lanes, sectors = _probe_traffic(table, block, lp, vf, pk.num_hashes,
                                        t, pk.counter)
        tot[0] += int(vf.sum())
        tot[1] += lanes
        tot[2] += sectors
        tot[3] += _k3_mmers(pk, v, strands[-1], args)
        return v        # the scores are not used
    correct.canonical_words = canonical_fwd
    try:
        correct._eval_scores(*args, pk.k, solid_fn)
    finally:
        correct.canonical_words = canonical_words
    return tot


def _check_k3(rng, tk, fill, Q, device, ks=K_CHECKED, real=None,
              phase="phase2", scheme="hash", counter="i32", timed=K_TIMED):
    """K3 == eval_scores_plain at k in ks on Q entries over a 4096 x 160
    batch whose k-mers `fill` inserted three times into the table `tk`:
    negative window starts (positions < k-1), padding entries (-1) and
    reads with N; and first, when `real` holds the arguments of a K3 call
    on the main path, on those; addressed under the bucket `scheme`.
    Returns the record of that call, else of k=31."""
    import numpy as np
    import torch
    from kmerax_torch.ops.correct_kernels import correct_eval_scores, \
        eval_scores_plain

    B, L, d = K_READS, K_LEN, 4
    LW = (tk.numel() * (2 if counter == "p16" else 1)).bit_length() - 1
    name = "correct_eval_scores" if counter == "i32" \
        else "correct_eval_scores_p16"

    def cases():
        if real is not None:          # first: `fill` overwrites the table
            pk, t_real, args = real
            yield (f"k={pk.k}, main-path call of {args[3].numel()} "
                   f"entries", pk, t_real, args)
        for k in ks:
            pk = _params(k, scheme, LW, counter)
            reads, lengths = _reads(rng, B, L, k)
            fill(tk, pk, reads)
            bases = torch.as_tensor(reads, device=device)
            lens = torch.as_tensor(lengths, device=device)
            ent_r = torch.as_tensor(rng.integers(0, B, Q).astype(np.int32),
                                    device=device)
            ent_i = rng.integers(0, L, Q).astype(np.int32)
            ent_i[:Q // 16] = -1
            ent_i[Q // 16:Q // 8] = rng.integers(0, k - 1, Q // 16)
            ent_i = torch.as_tensor(ent_i, device=device)
            yield (f"k={k}, {scheme} scheme, {counter} counters, {Q} "
                   f"entries", pk, 3, (bases, lens, lens - k, ent_r, ent_i))

    rec = None
    err_max = 0
    for tag, pk, t, args in cases():
        k = pk.k
        sk = correct_eval_scores(pk, tk, t, *args)
        torch.cuda.synchronize()
        sp = eval_scores_plain(pk, tk, t, *args)
        torch.cuda.synchronize()
        err = int((sk - sp).abs().max())
        if not torch.equal(sk, sp):
            raise AssertionError(f"K3 scores differ from plain at {tag}")
        if int(sk.sum()) == 0:
            raise AssertionError(f"K3 test is degenerate at {tag}")
        err_max = max(err_max, err)
        if real is None and k not in timed:
            say(f"{phase} K3 {name} == plain at {tag}: score sum "
                f"{int(sk.sum())}")
            continue
        Qc = args[3].numel()
        W = (k + 15) // 16
        n_kmers, lanes, sectors, mmers = _k3_traffic(pk, tk, t, args)
        base_bytes = 4 * min(Qc * (2 * k - 1), args[0].numel())
        io_bytes = 8 * Qc + 8 * Qc + base_bytes + 16 * Qc
        times = _timed(lambda: correct_eval_scores(pk, tk, t, *args),
                       lambda: eval_scores_plain(pk, tk, t, *args),
                       "correct_eval_scores_kernel", 5)
        r = _record(name, "kmerax_torch/csrc/correct.cu",
                    "kmerax/ops/pallas_correct.py:74" if counter == "i32"
                    else "kmerax/ops/pallas_correct.py:266", err, times,
                    io_bytes + _COUNTER_BYTES[pk.counter] * lanes,
                    _kmer_ops(W, n_kmers, n_kmers, lanes, mmers),
                    io_bytes + SECTOR * sectors, None, pk.bucket_scheme)
        _say_times(f"{phase} K3 {name} == plain at {tag}: "
                   f"score "
                   f"sum {int(sk.sum())}, {n_kmers} k-mers probed, {lanes} "
                   f"counter lanes read in {sectors} sectors; {mmers} "
                   f"(m-mer, strand) pairs mixed", r)
        # the main-path call's record where there is one, else k=31's
        if rec is None or (k == 31 and real is None):
            rec = r
    if rec is None:                   # no case timed
        return {"max_abs_err": err_max}
    rec["max_abs_err"] = err_max
    return rec


def _plain_correct(params, table, t, bases, lengths, **kw):
    """correct_batch on the card with K2's and K3's plain versions: the
    kernel step's plain version."""
    import torch
    from kmerax_torch.ops.correct import _accept, correct_batch
    from kmerax_torch.ops.correct_kernels import eval_scores_plain
    from kmerax_torch.spectrum.bloom_kernels import bloom_query_solid_plain

    def window_fn(b, lj):
        s = bloom_query_solid_plain(table, b, lj, params, t)
        j = torch.arange(s.shape[1], dtype=torch.int32, device=b.device)
        return s, j[None, :] <= lj[:, None]

    def eval_fn(b, ln, lj, er, ei):
        return _accept(eval_scores_plain(params, table, t, b, ln, lj,
                                         er.to(torch.int32),
                                         ei.to(torch.int32)), b, er, ei)
    return correct_batch(bases, lengths, params.k, t, None,
                         window_fn=window_fn, eval_fn=eval_fn, **kw)


def _slot_reads(rng, k: int):
    """Config 1's batch shape for the correct round's kernels: (clean,
    noisy) (K_READS, K_LEN) int32 reads of a 200 kb genome and their
    lengths; noisy carries 1 % substitutions and 0.3 % Ns, 10 % of the
    reads are shorter (>= k) and 2 % shorter than k."""
    import numpy as np

    B, L = K_READS, K_LEN
    genome = rng.integers(0, 4, 200_000).astype(np.int32)
    clean = genome[rng.integers(0, len(genome) - L, B)[:, None]
                   + np.arange(L)[None, :]]
    noisy = np.where(rng.random(clean.shape) < 0.01,
                     (clean + rng.integers(1, 4, clean.shape)) % 4, clean)
    noisy[rng.random(noisy.shape) < 0.003] = 4
    lengths = np.full(B, L, np.int32)
    short = rng.random(B) < 0.1
    lengths[short] = rng.integers(k, L + 1, short.sum())
    tiny = rng.random(B) < 0.02
    lengths[tiny] = rng.integers(0, k, tiny.sum())
    noisy[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return clean, noisy.astype(np.int32), lengths


def _check_slots(rng, tk, device, phase="phase2", scheme="hash",
                 counter="i32", timed=K_TIMED):
    """The correct round's kernels at k in K_TIMED on config 1's batch
    shape (`_slot_reads`; its clean reads inserted three times into `tk`,
    t=3), each == its plain version exactly: K6 correct_candidates (slots
    and done), K3 over the whole slot grid == K3 on the live slots alone
    (the compacted call) with zero at the dead ones, K7 correct_apply in a
    round before the last and in the last (bases, edits, done, the output
    rows and n_edits), and the whole kernel step (make_slot_step) ==
    correct_batch with K2's and K3's plain versions on the same int8
    batch. At each k in `timed`, K6 and K7 (the last round's form) are
    timed and recorded, and K3 on the slot grid and compacted. Returns the
    K6 and K7 records of k=31 ([] where none is timed)."""
    import torch
    from kmerax_torch.ops.correct_kernels import SLOTS, \
        apply_slots_plain, correct_apply, correct_candidates, \
        correct_eval_scores, make_slot_step, round_candidates_plain
    from kmerax_torch.spectrum.bloom_kernels import bloom_query_solid

    B, L, t, C = K_READS, K_LEN, 3, SLOTS
    max_runs, max_edits = 8, 8
    LW = (tk.numel() * (2 if counter == "p16" else 1)).bit_length() - 1
    ent_r = torch.arange(B * C, dtype=torch.int32, device=device) // C
    recs = []
    for k in K_TIMED:
        pk = _params(k, scheme, LW, counter)
        tag = f"k={k}, {scheme} scheme, {counter} counters"
        clean, noisy, lengths = _slot_reads(rng, k)
        _fill3(tk, pk, clean)
        cur = torch.as_tensor(noisy, device=device)
        lens = torch.as_tensor(lengths, device=device)
        last_j = lens - k
        solid = bloom_query_solid(tk, cur, last_j, pk, t)
        done0 = torch.zeros(B, dtype=torch.int32, device=device)
        dk, dp = done0.clone(), done0.clone()
        ck = correct_candidates(solid, last_j, dk, k, max_runs)
        cp = round_candidates_plain(solid, last_j, dp, k, max_runs)
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(dk, dp)):
            raise AssertionError(f"K6 differs from plain at {tag}")
        live = ck.view(-1) >= 0
        n_live = int(live.sum())
        if not 0 < n_live < B * C:
            raise AssertionError(f"K6 test is degenerate at {tag}: "
                                 f"{n_live} live slots")
        grid = correct_eval_scores(pk, tk, t, cur, lens, last_j, ent_r,
                                   ck.view(-1))
        compact = correct_eval_scores(pk, tk, t, cur, lens, last_j,
                                      ent_r[live], ck.view(-1)[live])
        torch.cuda.synchronize()
        if not (torch.equal(grid[live], compact)
                and not grid[~live].any()):
            raise AssertionError(f"K3 on the slot grid differs from its "
                                 f"compacted call at {tag}")
        bytes_io = dict(cands=4 * B * C, scores=16 * B * C, state=16 * B)
        # edits so far drawn in 0..max_edits, so the last round reverts
        ed0 = torch.as_tensor(rng.integers(0, max_edits + 1, B),
                              dtype=torch.int32, device=device)
        for last in (False, True):
            orig = cur.to(torch.int8) if last else None
            got, want = [], []
            for fn, out in ((correct_apply, got), (apply_slots_plain, want)):
                bs, ed, dn = cur.clone(), ed0.clone(), dk.clone()
                res = fn(bs, ck, grid, ed, dn, k, orig, max_edits)
                out.extend([bs, ed, dn, *(res or ())])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K7 differs from plain at {tag}, "
                                     f"{'last' if last else 'first'} round")
        n_applied = int((got[1] - ed0).sum())
        n_reverted = int((got[1] > max_edits).sum())
        if n_applied == 0 or n_reverted == 0:
            raise AssertionError(f"K7 test is degenerate at {tag}: "
                                 f"{n_applied} applied, {n_reverted} "
                                 f"reverted")
        kw = dict(rounds=2, max_runs=max_runs, max_edits=max_edits)
        bases = cur.to(torch.int8)
        fk, nek = make_slot_step(pk, tk, t, **kw)(bases, lens)
        fp, nep = _plain_correct(pk, tk, t, bases, lens, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(fk, fp.to(torch.int8)) and torch.equal(nek, nep)):
            raise AssertionError(f"the kernel step differs from "
                                 f"correct_batch at {tag}")
        msg = (f"{phase} K6, K3 on the slot grid, K7 and the kernel step == "
               f"plain at {tag}: {B} x {L}, {n_live} of {B * C} slots "
               f"live, {n_applied} edits applied in the round, "
               f"{n_reverted} reads past max_edits in the last; step: "
               f"{int(nek.sum())} edits kept in {int((nek > 0).sum())} "
               f"reads")
        if k not in timed:
            say(msg)
            continue
        say(msg)
        nk = L - k + 1
        # K6: the solidity, last_j, done read and written, the slots
        b6 = B * nk + 4 * B + 8 * B + bytes_io["cands"]
        dcopy = done0.clone()

        def k6():
            dcopy.copy_(done0)
            correct_candidates(solid, last_j, dcopy, k, max_runs)

        def k6_plain():
            dcopy.copy_(done0)
            round_candidates_plain(solid, last_j, dcopy, k, max_runs)
        t6 = _timed(k6, k6_plain, "correct_candidates_kernel", 5)
        r6 = _record("correct_candidates", "kmerax_torch/csrc/correct.cu",
                     "none (XLA glue: kmerax/ops/correct.py::"
                     "_weak_run_candidates and the cap)", 0, t6, b6, 0,
                     None, None, scheme)
        # K7, last round: slots, scores, the bases under the live slots
        # and the edits, state, the output rows (int8) from the round's
        # int32 rows, n_edits
        b7 = (bytes_io["cands"] + bytes_io["scores"] + 4 * n_live
              + 4 * n_applied + bytes_io["state"] + 4 * B * L + B * L
              + 4 * B)
        bs, ed, dn = cur.clone(), ed0.clone(), dk.clone()
        orig = cur.to(torch.int8)

        def k7(fn=correct_apply):
            bs.copy_(cur)
            ed.copy_(ed0)
            dn.copy_(dk)
            fn(bs, ck, grid, ed, dn, k, orig, max_edits)
        t7 = _timed(k7, lambda: k7(apply_slots_plain),
                    "correct_apply_kernel", 5)
        r7 = _record("correct_apply", "kmerax_torch/csrc/correct.cu",
                     "none (XLA glue: kmerax/ops/correct.py::_accept, "
                     "_apply)", 0, t7, b7, 0, None, None, scheme)
        g_ms = _kernel_ms(lambda: correct_eval_scores(
            pk, tk, t, cur, lens, last_j, ent_r, ck.view(-1)),
            "correct_eval_scores_kernel")
        c_er, c_ei = ent_r[live], ck.view(-1)[live]
        c_ms = _kernel_ms(lambda: correct_eval_scores(
            pk, tk, t, cur, lens, last_j, c_er, c_ei),
            "correct_eval_scores_kernel")
        r6["k3_slot_grid_kernel_ms"], r6["k3_compacted_kernel_ms"] = g_ms, \
            c_ms
        _say_times(f"{phase} K6 correct_candidates at {tag} ({B} reads, "
                   f"{nk} windows each; ms includes a {4 * B}-byte copy "
                   f"of done)", r6)
        _say_times(f"{phase} K7 correct_apply, last round, at {tag} "
                   f"({n_live} live slots, {n_applied} applied; ms "
                   f"includes the copies back of the round's state)", r7)
        num(f"{phase} K3 {tag}: the slot grid ({B * C} slots, {n_live} "
            f"live) {g_ms} ms, the compacted call ({n_live} entries) "
            f"{c_ms} ms (profiler)")
        if k == 31:
            recs = [r6, r7]
    return recs


def _align_inputs(rng, B, L, band):
    """One align batch as ops/align.py::_extend_and_score hands it to K4:
    (B, L) int32 query and target windows of a shared genome, the query
    shifted by up to +-3 bases in a third of the rows (gaps), with 2 %
    substitutions and Ns; lengths mostly 150, ragged rows, qlen = 0,
    tlen = 0 and |tlen - qlen| > band rows; bases past a length are 4."""
    import numpy as np

    genome = rng.integers(0, 4, 200_000).astype(np.int32)
    starts = rng.integers(8, len(genome) - L - 8, B)
    shift = np.where(rng.random(B) < 1 / 3, rng.integers(-3, 4, B), 0)
    tg = genome[starts[:, None] + np.arange(L)]
    q = genome[(starts + shift)[:, None] + np.arange(L)]
    q = np.where(rng.random(q.shape) < 0.02, (q + 1) % 4, q)
    q[rng.random(q.shape) < 0.003] = 4
    qlen = np.full(B, READ_LEN, np.int32)
    tlen = np.full(B, READ_LEN, np.int32)
    rag = rng.random(B) < 0.1
    qlen[rag] = rng.integers(0, L + 1, rag.sum())
    tlen[rag] = np.clip(qlen[rag] + rng.integers(-band, band + 1, rag.sum()),
                        0, L)
    far = rng.random(B) < 0.02
    qlen[far] = L
    tlen[far] = rng.integers(0, L - band, far.sum())
    qlen[0], tlen[1] = 0, 0
    ar = np.arange(L)[None, :]
    q = np.where(ar < qlen[:, None], q, 4).astype(np.int32)
    tg = np.where(ar < tlen[:, None], tg, 4).astype(np.int32)
    return q, tg, qlen, tlen


def _check_k4(rng, device):
    """K4 at the align stage's shapes (K_READS = 4096 reads x 160) at the
    default band 15 and the widest band 63 (W = 127), in every
    lanes-per-read layout G: each equal to the plain version, each timed;
    the record is the wrapper's (G = LANES) at band 15, with every G's
    time."""
    import torch
    from kmerax_torch.ops.align_kernels import LANE_CHOICES, LANES, \
        NEG_INF, banded_align_scores, banded_align_scores_lanes, \
        banded_align_scores_plain as align_plain

    rec = None
    for band in (15, 63):
        args = [torch.as_tensor(a, device=device)
                for a in _align_inputs(rng, K_READS, K_LEN, band)]
        sp = align_plain(*args, band)
        torch.cuda.synchronize()
        by_g, err = {}, 0
        for G in LANE_CHOICES:
            sk = banded_align_scores_lanes(*args, band, G)
            torch.cuda.synchronize()
            err = max(err, int((sk.to(torch.int64)
                                - sp.to(torch.int64)).abs().max()))
            if not torch.equal(sk, sp):
                raise AssertionError(f"K4 scores differ from plain at band "
                                     f"{band}, G={G}")
            by_g[G] = _kernel_ms(
                lambda: banded_align_scores_lanes(*args, band, G),
                "banded_align_kernel")
        sk = banded_align_scores(*args, band)
        if not torch.equal(sk, sp):
            raise AssertionError(f"K4 wrapper differs at band {band}")
        n_pos, n_inf = int((sk > 0).sum()), int((sk == NEG_INF).sum())
        if not (n_pos > K_READS // 2 and n_inf > 0):
            raise AssertionError(f"K4 test is degenerate at band {band}: "
                                 f"{n_pos} positive, {n_inf} NEG_INF")
        fastest = min(by_g, key=lambda g: by_g[g] or float("inf"))
        num(f"phase2 K4 at band {band}, the kernel's own device ms per "
            f"launch (profiler) by lanes per read G: " + ", ".join(
                f"G={g} {ms}" for g, ms in by_g.items())
            + f"; fastest G={fastest}, the wrapper's G={LANES}")
        # cells: the rows up to qlen of every read inside the band gate,
        # 2 band + 1 diagonals each, ~10 int32 operations per cell (score
        # select, three adds, three maxes, band masks)
        q, tg, qlen, tlen = args
        run = (tlen - qlen).abs() <= band
        cells = int(qlen[run].long().sum()) * (2 * band + 1)
        times = _timed(lambda: banded_align_scores(*args, band),
                       lambda: align_plain(*args, band),
                       "banded_align_kernel")
        r = _record("banded_align_scores", "kmerax_torch/csrc/align.cu",
                    "kmerax/ops/pallas_align.py:49", err, times,
                    4 * (q.numel() + tg.numel()) + 12 * q.shape[0],
                    10 * cells, None, None)
        r["ms_by_lanes"] = {f"band{band}": by_g}
        _say_times(f"phase2 K4 banded_align_scores == plain at band {band} "
                   f"(G={LANES}): {K_READS} reads x {K_LEN}, "
                   f"{n_pos} positive, {n_inf} NEG_INF, {cells} cells", r)
        if rec is None:
            rec = r
        else:
            rec["ms_by_lanes"].update(r["ms_by_lanes"])
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


# ---------------------------------------------------------------- phase 3

def _golden_reads(workdir: str, name: str, seed: int, coverage: int):
    """A golden dataset of tests/golden (ecoli_like, 1,500 bp, reads of
    100, error 0.008) written as FASTQ. Returns (path, reads)."""
    from sim import ecoli_like, make_fastq

    _, reads = ecoli_like(seed=seed, genome_len=1500, coverage=coverage,
                          read_len=100, error_rate=0.008)
    path = os.path.join(workdir, f"{name}.fastq")
    with open(path, "wb") as f:
        f.write(make_fastq(reads))
    return path, reads


def _oracle_correct(reads, k: int, t: int, query, out_fq: str, what: str):
    """oracle.correct_read of every read with `query`; raises unless the
    FASTQ at out_fq holds exactly those reads. Returns the fixed reads."""
    import oracle

    buf = io.BytesIO()
    fixed_all = []
    for r in reads:
        fixed = oracle.correct_read(r.bases, k, t, query)
        fixed_all.append(fixed)
        buf.write(f"@{r.name}\n{oracle.bases_to_seq(fixed)}\n+\n{r.qual}\n"
                  .encode())
    with open(out_fq, "rb") as f:
        if f.read() != buf.getvalue():
            raise AssertionError(f"{what} FASTQ differs from the oracle's")
    return fixed_all


def _oracle_assembly(fixed_all, k: int, out_fa: str, what: str) -> bytes:
    """The oracle's unitig FASTA of the corrected reads at k, with its auto
    threshold; raises unless the FASTA at out_fa is byte-equal."""
    import oracle

    csp = oracle.ExactSpectrum(k)
    csp.add_reads(fixed_all)
    ct = oracle.auto_threshold(oracle.histogram_of(csp.sorted_items()[1]))
    want = oracle.assemble_fasta(csp, ct, k).encode()
    with open(out_fa, "rb") as f:
        if f.read() != want:
            raise AssertionError(f"{what} FASTA differs from the oracle's")
    return want


def _oracle_threshold(reads, k: int) -> tuple:
    """(the oracle's exact spectrum of the reads at k, its auto
    threshold)."""
    import oracle

    sp = oracle.ExactSpectrum(k)
    sp.add_reads([r.bases for r in reads])
    return sp, oracle.auto_threshold(oracle.histogram_of(
        sp.sorted_items()[1]))


def phase_golden(workdir: str, device=DEVICE):
    """tests/golden/test_pipeline.py's dataset and config through the
    port's run_pipeline under the hash and the minimizer bucket scheme, and
    through `correct --use-exact`; tests/golden/test_twopass.py's through
    `pipeline --k2 63`; FASTQ and FASTA bytes equal to the oracle's. Then
    the `align` subcommand's TSV against the oracle's rows. Returns the
    minimizer run's launches."""
    import oracle
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.pipeline.run import run_pipeline
    from kmerax_torch.utils import cuda

    cfg = KmeraxConfig(k=31, bloom_log2_width=18, bloom_hashes=4,
                       batch_reads=128, max_read_len=100,
                       exact_capacity=1 << 17)
    path, reads = _golden_reads(workdir, "golden", 55, 30)
    k = cfg.k
    sp, t = _oracle_threshold(reads, k)
    launches = {}
    for scheme in ("hash", "minimizer"):
        out_fq = os.path.join(workdir, f"golden.{scheme}.fastq")
        out_fa = os.path.join(workdir, f"golden.{scheme}.fasta")
        cuda.reset_launches()
        res = run_pipeline(cfg.replace(bucket_scheme=scheme), [path], out_fq,
                           out_fa, device=device)
        launches[scheme] = dict(cuda.LAUNCHES)
        if res["threshold"] != t:
            raise AssertionError(f"threshold {res['threshold']} != oracle "
                                 f"{t}")
        obl = oracle.CountingBloomOracle(
            k, log2_width=cfg.bloom_log2_width, num_hashes=cfg.bloom_hashes,
            minimizer_m=MINIMIZER_M, log2_buckets=LOG2_BUCKETS,
            bucket_scheme=scheme)
        obl.add_reads([r.bases for r in reads])
        fixed = _oracle_correct(reads, k, t, obl.query, out_fq,
                                f"golden ({scheme} scheme)")
        want = _oracle_assembly(fixed, k, out_fa,
                                f"golden ({scheme} scheme)")
        say(f"phase3 golden, {scheme} scheme: {len(reads)} reads, threshold "
            f"{t}, {res['edited_reads']} edited, {res['unitigs']} "
            f"unitig(s); FASTQ and FASTA bytes equal to the oracle's; "
            f"launches {launches[scheme]}")
        if scheme == "hash":
            out_fq_hash, out_fa_hash, fixed_all = out_fq, out_fa, fixed
            want_hash = want
    for name in MAIN_PATH_KERNELS:
        if launches["minimizer"][name] <= 0:
            raise AssertionError(f"{name} never launched under the "
                                 f"minimizer scheme")
    # the mesh count's driver under the minimizer scheme (K1r's minimizer
    # instantiation on a path), one rank over NCCL
    mz, _, wall, _ = _sharded_vs_one(
        cfg.replace(bucket_scheme="minimizer"), [path])
    say(f"phase3 golden, minimizer scheme: run_count_sharded (world-size-1 "
        f"NCCL) == run_count, {wall:.2f} s; launches {mz}")

    # correct --use-exact: solidity from the exact spectrum
    out_x = os.path.join(workdir, "golden.exact.fastq")
    stats, _ = _cli("phase3", workdir, [
        "correct", "--in", path, "--out", out_x, "--use-exact", "-k", "31",
        "--bloom-log2-width", "18", "--batch-reads", "128",
        "--max-read-len", "100", "--exact-capacity", str(1 << 17),
        "--device", device])
    _oracle_correct(reads, k, t, sp.query, out_x, "golden --use-exact")
    say(f"phase3 golden correct --use-exact: {stats}; FASTQ bytes equal to "
        f"oracle.correct_read with the ExactSpectrum query")

    # pipeline --k2 63 on tests/golden/test_twopass.py's dataset
    tp_path, tp_reads = _golden_reads(workdir, "twopass_reads", 101, 35)
    tp_fq = os.path.join(workdir, "twopass.fastq")
    tp_fa = os.path.join(workdir, "twopass.fasta")
    res, _ = _cli("phase3", workdir, [
        "pipeline", "--in", tp_path, "--out-fastq", tp_fq, "--out-fasta",
        tp_fa, "--k2", "63", "-k", "31", "--bloom-log2-width", "17",
        "--batch-reads", "128", "--max-read-len", "100", "--exact-capacity",
        str(1 << 17), "--device", device])
    _, t1 = _oracle_threshold(tp_reads, 31)
    obl = oracle.CountingBloomOracle(31, log2_width=17, num_hashes=4)
    obl.add_reads([r.bases for r in tp_reads])
    fixed = _oracle_correct(tp_reads, 31, t1, obl.query, tp_fq,
                            "two-pass pass 1")
    _oracle_assembly(fixed, 63, tp_fa, "two-pass k=63")
    if res["threshold_k1"] != t1:
        raise AssertionError(f"threshold_k1 {res['threshold_k1']} != {t1}")
    say(f"phase3 golden pipeline --k2 63: {res}; pass-1 FASTQ equal to the "
        f"oracle's at k=31 and FASTA to oracle.assemble_fasta at k=63")

    out_fq, out_fa, want = out_fq_hash, out_fa_hash, want_hash
    # the align subcommand: corrected reads back to the golden's contigs
    from oracle.align import build_contig_index as oracle_index
    from oracle.align import validate_read
    from oracle.codec import seq_to_bases

    tsv = os.path.join(workdir, "golden.tsv")
    stats, _ = _cli("phase3", workdir, [
        "align", "--in", out_fq, "--contigs", out_fa, "--out", tsv, "-k",
        str(k), "--batch-reads", "128", "--max-read-len", "100", "--device",
        device])
    contigs = [seq_to_bases(ln) for ln in want.decode().splitlines()
               if not ln.startswith(">")]
    cat, index = oracle_index(contigs, k)
    with open(tsv) as f:
        rows = f.read().splitlines()
    if len(rows) != len(reads):
        raise AssertionError(f"align TSV has {len(rows)} rows")
    for r, fixed, row in zip(reads, fixed_all, rows):
        name, found, strand, pos, score, _ = row.split("\t")
        wf, ws, wp, wsc = validate_read(fixed, cat, index, k, cfg.band)
        if (name, int(found), int(strand), int(pos), int(score)) != \
                (r.name, int(wf), ws, wp, wsc):
            raise AssertionError(f"align TSV row differs from the oracle: "
                                 f"{row!r} vs {(wf, ws, wp, wsc)}")
    say(f"phase3 golden align: {len(rows)} TSV rows equal to "
        f"oracle.align.validate_read; {stats}")
    return {"golden_minimizer_pipeline": launches["minimizer"],
            "golden_minimizer_sharded_count": mz}


# ---------------------------------------------------------------- phase 4

def simulate_pairs(workdir: str, G: int, coverage: int, error: float):
    """PE150 reads with the model of kmerax/bench/acceptance.py (tests/sim.py
    simulate_pairs: insert ~ N(3*150, 150//4) clipped to [300, G], R1
    forward from the fragment start, R2 reverse-complement from its end,
    uniform substitutions at `error`, quals 30..39) on a random genome of G
    bases, drawn vectorized. Writes reads_1/2.fastq; returns (paths, noisy,
    truth, seq_off) with (n, 150) uint8 arrays in file order (R1 then R2)
    and the sequence's byte offset in a record."""
    import numpy as np

    R = READ_LEN
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=G, dtype=np.int64).astype(np.uint8)
    n_pairs = (G * coverage // R) // 2
    rng = np.random.default_rng(SEED + 1)
    ins = np.clip(rng.normal(3 * R, R // 4, n_pairs), 2 * R, G).astype(
        np.int64)
    pos = rng.integers(0, G - ins + 1)
    ar = np.arange(R)
    t1 = genome[pos[:, None] + ar]
    t2 = 3 - genome[(pos + ins - R)[:, None] + ar][:, ::-1]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths, noisy, truth = [], [], []
    for mate, true in ((1, t1), (2, t2)):
        errs = rng.random(true.shape) < error
        shifts = rng.integers(1, 4, true.shape).astype(np.uint8)
        b = np.where(errs, (true + shifts) % 4, true).astype(np.uint8)
        qual = (rng.integers(30, 40, true.shape) + 33).astype(np.uint8)
        names = np.frombuffer(b"".join(
            b"SIML1C001R%09d/%d" % (i, mate) for i in range(n_pairs)),
            np.uint8).reshape(n_pairs, -1)
        nl = names.shape[1]
        rec = np.empty((n_pairs, nl + 2 * R + 6), np.uint8)
        rec[:, 0] = ord("@")
        rec[:, 1:1 + nl] = names
        o = 1 + nl
        rec[:, o] = 10
        rec[:, o + 1:o + 1 + R] = acgt[b]
        o += 1 + R
        rec[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, o + 3:o + 3 + R] = qual
        rec[:, -1] = 10
        p = os.path.join(workdir, f"reads_{mate}.fastq")
        rec.tofile(p)
        paths.append(p)
        noisy.append(b)
        truth.append(true)
    return paths, noisy, truth, 1 + nl + 1


def _read_fixed(path: str, n: int, seq_off: int, R: int):
    """Sequence bases of a fixed-width FASTQ written by the pipeline."""
    import numpy as np

    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    raw = np.fromfile(path, np.uint8)
    width = raw.size // n
    if raw.size != n * width:
        raise AssertionError(f"{path}: {raw.size} bytes for {n} records")
    return lut[raw.reshape(n, width)[:, seq_off:seq_off + R]]


def _accuracy(outs, noisy, truth, seq_off):
    """(errors_before, errors_remaining, errors_introduced, gain) of the
    corrected FASTQ files against the simulated truth."""
    before = after = introduced = 0
    for p, b, tr in zip(outs, noisy, truth):
        fixed = _read_fixed(p, len(b), seq_off, READ_LEN)
        e0 = b != tr
        e1 = fixed != tr
        before += int(e0.sum())
        after += int((e0 & e1).sum())
        introduced += int((~e0 & e1).sum())
    return before, after, introduced, (before - after - introduced) / max(
        before, 1)


def _cli(tag: str, workdir: str, argv):
    """Run kmerax_torch.cli with argv; returns (its JSON result, wall s)."""
    from kmerax_torch.cli import main as cli_main

    say(f"{tag} kmerax_torch.cli " + " ".join(
        a if not a.startswith(workdir) else os.path.basename(a)
        for a in argv))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), wall


def _stages(metrics: str) -> dict:
    stages = {}
    with open(metrics) as f:
        for ln in f:
            rec = json.loads(ln)
            stages.setdefault(rec["stage"], []).append(rec)
    return stages


def _print_stages(tag: str, stages: dict) -> None:
    cnt, cor = stages["count"][0], stages["correct"][0]
    asm = stages["assemble"][0]
    num(f"{tag} count: {cnt['wall_s']} s, {cnt['kmers']} k-mers, "
        f"{cnt['kmers'] / cnt['wall_s']:.1f} k-mers/s, threshold "
        f"{cnt['threshold']}")
    num(f"{tag} correct: {cor['wall_s']} s, {cor['reads']} reads, "
        f"{cor['reads'] / cor['wall_s']:.1f} reads/s, "
        f"{cor['edited_reads']} edited, {cor['edits']} edits")
    num(f"{tag} assemble (re-count {stages['count'][1]['wall_s']} s "
        f"included): {asm['wall_s']} s, {asm['unitigs']} unitigs")


def _fill3(tk, pk, reads) -> None:
    """Zero the table and insert the k-mers of `reads` three times."""
    import numpy as np
    import torch
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert

    bases = torch.as_tensor(reads.astype(np.int8), device=tk.device)
    tk.zero_()
    for _ in range(3):
        bloom_insert(tk, bases, pk)


def _profile_window(fn, batches, names):
    """One torch.profiler window over fn(*b) for b in batches: (host wall s,
    device seconds of all kernels and copies, {name: device seconds of the
    kernels whose name holds it}, the number of kernels launched: device
    events other than copies and memsets); device seconds are None where
    the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            fn(*b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, by, n_kernels = 0.0, dict.fromkeys(names, 0.0), 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        total += us * 1e-6
        if not e.key.startswith(("Memcpy", "Memset")):
            n_kernels += e.count
        for name in names:
            if name in e.key:
                by[name] += us * 1e-6
    return wall, (total or None), by if total else None, n_kernels


def _device_steps(tag: str, paths, cfg_kw: dict, threshold: int,
                  n_window: int = 20):
    """The count stage's device steps on every batch of `paths`, on the
    config's wire as run_count sends them (the unpack on the 2-bit wire,
    then K1), each synchronised and timed on the host clock (the parse and
    the H2D copy are not in the time; K1's share is timed after a sync
    that ends the unpack), then one profiler window of `n_window` count
    batches and one of `n_window` correct batches of the kernel step
    (make_correct_step) against the finished table. Returns (params,
    table, the arguments of the first correct batch's first K3 call, those
    of its first K2 call)."""
    import torch
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.core.codec import num_words
    from kmerax_torch.io.batcher import BackgroundBatcher
    from kmerax_torch.ops import correct_kernels
    from kmerax_torch.io.wire import send_batch, unwire
    from kmerax_torch.pipeline.correct import make_correct_step
    from kmerax_torch.pipeline.count import _count_steps
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert
    from kmerax_torch.spectrum.exact import sentinel_rows

    cfg = KmeraxConfig(**cfg_kw)
    params, _, P, pend_rows = _count_steps(cfg, cfg.k)
    table = make_table(params, DEVICE)
    pending = sentinel_rows(P, num_words(cfg.k), DEVICE)
    off, keep, secs, k1, n_packed = 0, [], [], [], 0
    for batch in BackgroundBatcher(paths, cfg.batch_reads, cfg.max_read_len):
        rows, lengths, packed = send_batch(batch, DEVICE, cfg.wire_pack)
        n_packed += packed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bases = unwire(rows, lengths, packed, cfg.max_read_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bloom_insert(table, bases, params, pending, off)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        secs.append(t2 - t0)
        k1.append(t2 - t1)
        off = (off + pend_rows) % P
        if len(keep) < n_window:
            keep.append((bases, lengths))
    num(f"{tag} count device step, synchronised, wire_pack="
        f"{cfg.wire_pack} ({n_packed} of {len(secs)} batches packed): "
        f"median {statistics.median(secs) * 1e3:.4f} ms (unpack + K1), "
        f"mean {statistics.mean(secs) * 1e3:.4f} ms, total "
        f"{sum(secs):.4f} s; K1 alone median "
        f"{statistics.median(k1) * 1e3:.4f} ms")

    t = threshold
    correct = make_correct_step(params, table, t, rounds=cfg.rounds,
                                max_runs=cfg.max_runs,
                                max_edits=cfg.max_edits)
    first, first_k2 = [], []
    k2, k3 = correct_kernels.bloom_query_solid, \
        correct_kernels.correct_eval_scores

    def spy_k2(tk, bases, last_j, p, tt):
        if not first_k2:
            first_k2.append((bases.clone(), last_j.clone()))
        return k2(tk, bases, last_j, p, tt)

    def spy_k3(p, tk, tt, bases, lengths, last_j, ent_r, ent_i):
        if not first:
            first.append((bases.clone(), lengths.clone(), last_j.clone(),
                          ent_r.clone(), ent_i.clone()))
        return k3(p, tk, tt, bases, lengths, last_j, ent_r, ent_i)

    # warm-up; records the kernel step's first K2 and K3 calls
    correct_kernels.bloom_query_solid = spy_k2
    correct_kernels.correct_eval_scores = spy_k3
    try:
        correct(*keep[0])
    finally:
        correct_kernels.bloom_query_solid = k2
        correct_kernels.correct_eval_scores = k3
    # the count window in a child process of its own: in this process,
    # after the script's many profiler sessions, it recorded 6-18 of its
    # ~40 kernels
    cw = _child("count_window", {"paths": list(paths), "cfg": cfg_kw,
                                 "n": n_window})
    windows = [(f"count (child process, {cw['packed']} packed)",
                (cw["wall"], cw["device"], cw["by"], cw["kernels"]))]
    windows.append(("correct", _profile_window(
        correct, keep, ("bloom_query_solid_kernel",
                        "correct_candidates_kernel",
                        "correct_eval_scores_kernel",
                        "correct_apply_kernel"))))
    for stage, (wall, dev, by, n_k) in windows:
        if dev is None:
            num(f"{tag} profiler, {len(keep)} {stage} batches: wall "
                f"{wall:.4f} s; the profiler showed no device time")
            continue
        per = (f"{n_k / (len(keep) * cfg.rounds):.1f} per round "
               f"({cfg.rounds} rounds a batch)" if stage == "correct"
               else f"{n_k / len(keep):.1f} per batch")
        num(f"{tag} profiler, {len(keep)} {stage} batches: wall {wall:.4f} "
            f"s, device busy {dev:.4f} s ({dev / wall:.2%}); {n_k} kernels "
            f"launched, {per}; " + ", ".join(
                f"{n} {s:.4f} s ({s / wall:.2%} of the wall)"
                for n, s in by.items()))
    args = first[0]
    num(f"{tag} first correct batch: K3 called on the slot grid of "
        f"{args[3].numel()} entries, {int((args[4] >= 0).sum())} of them "
        f"live")
    return params, table, args, first_k2[0]


def phase_config1(workdir: str, recs=None,
                  coverage: int = C1_COVERAGE):
    import torch
    from kmerax_torch.utils import cuda

    if coverage != C1_COVERAGE:
        say(f"phase4 CUT: coverage {coverage}x instead of {C1_COVERAGE}x")
    t0 = time.perf_counter()
    paths, noisy, truth, seq_off = simulate_pairs(workdir, C1_GENOME,
                                                  coverage, C1_ERROR)
    n_reads = sum(len(b) for b in noisy)
    num(f"phase4 simulated {n_reads} reads (PE{READ_LEN}, genome "
        f"{C1_GENOME} bp, {coverage}x) in {time.perf_counter() - t0:.1f} s")

    outs = [os.path.join(workdir, f"corrected_{i + 1}.fastq")
            for i in range(2)]
    fasta = os.path.join(workdir, "contigs.fasta")
    metrics = os.path.join(workdir, "metrics.jsonl")
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    result, wall = _cli("phase4", workdir, [
        "pipeline", "--in", *paths, "--out-fastq", *outs, "--out-fasta",
        fasta, "--metrics", metrics, "--device", DEVICE, *C1_ARGS])
    launches = dict(cuda.LAUNCHES)
    stages = _stages(metrics)
    _print_stages("phase4", stages)
    num(f"phase4 end to end: {wall:.2f} s, {n_reads / wall:.1f} reads/s; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    num(f"phase4 kernel launches on the main path: {launches}")
    if torch.cuda.max_memory_allocated() > C1_PEAK_BYTES + C1_UNPACK_BYTES:
        raise AssertionError("config 1 peak device memory above "
                             f"{C1_PEAK_BYTES} + {C1_UNPACK_BYTES} bytes")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")
    # the kernel step: K2, K6, K3 and K7 once a round, and the round count
    # in the correct record
    rounds = stages["correct"][0]["counters"].get("correct.rounds_on_card")
    if not (launches["correct_candidates"] == launches["correct_apply"]
            == launches["correct_eval_scores"]
            == launches["bloom_query_solid"] == rounds):
        raise AssertionError(f"the correct step's launches {launches}, "
                             f"correct.rounds_on_card {rounds}")
    _check_join("phase4", launches, stages["assemble"][0])

    before, after, introduced, gain = _accuracy(outs, noisy, truth, seq_off)
    num(f"phase4 accuracy: errors_before {before}, errors_remaining "
        f"{after}, errors_introduced {introduced}, gain {gain:.4f}")
    if introduced != 0:
        raise AssertionError(f"{introduced} errors introduced")
    if gain < 0.9:
        raise AssertionError(f"gain {gain:.4f} < 0.9")
    if result["unitigs"] <= 0 or result["reads"] != n_reads:
        raise AssertionError(f"bad pipeline result {result}")

    # outside the launch count: device steps, profiler shares, K2 on the
    # main path's own call, and K3 on its own call and at its entry count
    # (K2's first: K3's cases refill the table)
    import numpy as np

    params, table, args, k2_args = _device_steps("phase4", paths, C1_CFG,
                                                 result["threshold"])
    k2 = _check_k2(None, table, DEVICE, ks=(),
                   real=(params, result["threshold"], k2_args),
                   phase="phase4")
    k3 = _check_k3(np.random.default_rng(SEED + 3), table, _fill3,
                   args[3].numel(), DEVICE, ks=K_TIMED,
                   real=(params, result["threshold"], args), phase="phase4")
    del table
    torch.cuda.empty_cache()
    if recs is not None:
        names = [r["name"] for r in recs]
        i = names.index("bloom_query_solid")
        k2["max_abs_err"] = max(k2["max_abs_err"], recs[i]["max_abs_err"])
        recs[i] = k2
        recs[names.index("correct_eval_scores")] = k3
    return {"config1_pipeline": launches}


# ---------------------------------------------------------------- phase 5

def _check_join(tag: str, launches: dict, asm: dict) -> None:
    """The graph's join ran through K5, one launch a partition, and every
    join query was counted on the card (the assemble record's spans and
    counters)."""
    parts = asm["spans"]["assemble.extend"][1]
    ct = asm["counters"]
    num(f"{tag} K5 solid_join: {launches['solid_join']} launches, {parts} "
        f"partitions; join queries {ct['assemble.join_queries']}, on the "
        f"card {ct.get('assemble.join_on_card')}")
    if not 0 < launches["solid_join"] == parts:
        raise AssertionError(f"{tag}: K5 launched {launches['solid_join']} "
                             f"times for {parts} partitions")
    if ct.get("assemble.join_on_card") != ct["assemble.join_queries"]:
        raise AssertionError(f"{tag}: the card joined "
                             f"{ct.get('assemble.join_on_card')} of "
                             f"{ct['assemble.join_queries']} queries")


def phase_config3(workdir: str):
    """Config 3 through `pipeline --validate`, then the same corrected reads
    and contigs through the `align` subcommand. Returns each run's own
    launches."""
    import torch
    from kmerax_torch.utils import cuda

    say(f"phase5 CUT: genome {C3_GENOME} bp, not chr21's {C3_FULL_GENOME} "
        f"bp")
    t0 = time.perf_counter()
    paths, noisy, truth, seq_off = simulate_pairs(workdir, C3_GENOME,
                                                  C3_COVERAGE, C3_ERROR)
    n_reads = sum(len(b) for b in noisy)
    num(f"phase5 simulated {n_reads} reads (PE{READ_LEN}, genome "
        f"{C3_GENOME} bp, {C3_COVERAGE}x, error {C3_ERROR}) in "
        f"{time.perf_counter() - t0:.1f} s")

    outs = [os.path.join(workdir, f"corrected_{i + 1}.fastq")
            for i in range(2)]
    fasta = os.path.join(workdir, "contigs.fasta")
    metrics = os.path.join(workdir, "metrics.jsonl")
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    result, wall = _cli("phase5", workdir, [
        "pipeline", "--in", *paths, "--out-fastq", *outs, "--out-fasta",
        fasta, "--validate", "--metrics", metrics, "--device", DEVICE,
        *C3_ARGS])
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stages = _stages(metrics)
    _print_stages("phase5", stages)
    aln = stages["align"][0]
    num(f"phase5 align: {aln['wall_s']} s, {aln['reads']} reads, "
        f"{aln['reads'] / aln['wall_s']:.1f} reads/s; index of "
        f"{aln['index_kmers']} k-mers built in {aln['index_s']} s, cuckoo "
        f"table {aln['table_bytes']} bytes")
    with open(fasta) as f:
        lens = sorted((len(ln) - 1 for ln in f if not ln.startswith(">")),
                      reverse=True)
    num(f"phase5 end to end: {wall:.2f} s, {n_reads / wall:.1f} reads/s; "
        f"peak device memory {peak} bytes; {result['unitigs']} unitigs, "
        f"{sum(lens)} contig bases, longest {lens[0] if lens else 0}")
    num(f"phase5 validate: {result['validate']}")
    num(f"phase5 kernel launches: {launches}")
    for name in ONE_DEVICE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")
    _check_join("phase5", launches, stages["assemble"][0])

    before, after, introduced, gain = _accuracy(outs, noisy, truth, seq_off)
    num(f"phase5 accuracy: errors_before {before}, errors_remaining "
        f"{after}, errors_introduced {introduced}, gain {gain:.4f}")
    val = result["validate"]
    bars = [(introduced <= 0.001 * before,
             f"errors_introduced {introduced} > 0.001 x {before}"),
            (gain >= 0.95, f"gain {gain:.4f} < 0.95"),
            (val["reads"] == n_reads, f"validated {val['reads']} reads"),
            (val["aligned_frac"] >= 0.999,
             f"aligned_frac {val['aligned_frac']} < 0.999"),
            (val["mean_identity"] >= 0.999,
             f"mean_identity {val['mean_identity']} < 0.999"),
            (result["reads"] == n_reads and result["unitigs"] > 0,
             f"bad pipeline result {result}")]
    for ok, msg in bars:
        if not ok:
            raise AssertionError(msg)

    # the align subcommand on the same corrected reads and contigs
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    stats, awall = _cli("phase5", workdir, [
        "align", "--in", *outs, "--contigs", fasta, "--device", DEVICE,
        *C3_ARGS])
    alaunch = dict(cuda.LAUNCHES)
    num(f"phase5 align subcommand: {awall:.2f} s end to end, "
        f"{n_reads / awall:.1f} reads/s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; {stats}; launches "
        f"{alaunch}")
    if stats != val:
        raise AssertionError(f"align stats {stats} != validate stats {val}")
    if alaunch["banded_align_scores"] <= 0:
        raise AssertionError("K4 never launched by the align subcommand")
    return {"config3_pipeline_validate": launches, "config3_align": alaunch}


# ---------------------------------------------------------------- phase 6

def _contig_bases(fasta: str) -> int:
    with open(fasta) as f:
        return sum(len(ln) - 1 for ln in f if not ln.startswith(">"))


def _bars(tag: str, outs, noisy, truth, seq_off) -> None:
    """Config 3's accuracy bars: errors introduced <= 0.001 x before, gain
    >= 0.95."""
    before, after, introduced, gain = _accuracy(outs, noisy, truth, seq_off)
    num(f"{tag} accuracy: errors_before {before}, errors_remaining {after}, "
        f"errors_introduced {introduced}, gain {gain:.4f}")
    if introduced > 0.001 * before:
        raise AssertionError(f"{tag}: errors_introduced {introduced} > "
                             f"0.001 x {before}")
    if gain < 0.95:
        raise AssertionError(f"{tag}: gain {gain:.4f} < 0.95")


def _same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what}: {os.path.basename(a)} differs "
                                 f"from {os.path.basename(b)}")


def phase_config5(workdir: str):
    """BASELINE config 5 (two-pass k=31 -> k2=63, correct + assemble) on a
    0.5 Mb genome: (a) `pipeline --k2 63` through the CLI, held to config
    3's bars; (b) run_two_pass with a workdir, crashed after the count_k2
    checkpoint and resumed, byte-equal to (a); (c) `correct --spectrum`
    and `assemble --spectrum` on (b)'s checkpoints, byte-equal to (a), and
    `correct --use-exact`. Returns each run's own launches."""
    import torch
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.pipeline import twopass
    from kmerax_torch.utils import cuda

    t_phase = time.perf_counter()
    say(f"phase6 CUT: genome {C5_GENOME} bp (a quarter of "
        f"ACCEPTANCE_full_c5.json's), not the human genome's 3.1 Gb")
    paths, noisy, truth, seq_off = simulate_pairs(workdir, C5_GENOME,
                                                  C5_COVERAGE, C5_ERROR)
    n_reads = sum(len(b) for b in noisy)
    # a count pass streams both files as one sequence of batches
    n_batches = -(-n_reads // C5_CFG["batch_reads"])
    num(f"phase6 simulated {n_reads} reads (PE{READ_LEN}, genome "
        f"{C5_GENOME} bp, {C5_COVERAGE}x, error {C5_ERROR}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    runs = {}

    def outs(tag):
        return ([os.path.join(workdir, f"{tag}_{i + 1}.fastq")
                 for i in range(2)], os.path.join(workdir, f"{tag}.fasta"))

    # (a) pipeline --k2 63
    a_fq, a_fa = outs("a")
    metrics = os.path.join(workdir, "metrics.jsonl")
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    res, wall = _cli("phase6", workdir, [
        "pipeline", "--in", *paths, "--out-fastq", *a_fq, "--out-fasta",
        a_fa, "--k2", "63", "--metrics", metrics, "--device", DEVICE,
        *C5_ARGS])
    runs["config5_pipeline_k2"] = dict(cuda.LAUNCHES)
    st = _stages(metrics)
    c1, c2 = st["count"]
    num(f"phase6 (a) stages: count k=31 {c1['wall_s']} s "
        f"({c1['kmers'] / c1['wall_s']:.1f} k-mers/s, threshold "
        f"{c1['threshold']}), correct {st['correct'][0]['wall_s']} s "
        f"({st['correct'][0]['reads'] / st['correct'][0]['wall_s']:.1f} "
        f"reads/s), count k=63 {c2['wall_s']} s (threshold "
        f"{c2['threshold']}), assemble {st['assemble'][0]['wall_s']} s")
    bases = _contig_bases(a_fa)
    num(f"phase6 (a) end to end: {wall:.2f} s, {n_reads / wall:.1f} reads/s; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes; "
        f"{res}; {bases} contig bases; launches "
        f"{runs['config5_pipeline_k2']}")
    if runs["config5_pipeline_k2"]["bloom_insert"] != 2 * n_batches:
        raise AssertionError(f"K1 launched "
                             f"{runs['config5_pipeline_k2']['bloom_insert']} "
                             f"times, not once per batch of both passes "
                             f"({2 * n_batches})")
    for name in MAIN_PATH_KERNELS:
        if runs["config5_pipeline_k2"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched")
    _check_join("phase6 (a)", runs["config5_pipeline_k2"],
                st["assemble"][0])
    if res["reads"] != n_reads or abs(bases - C5_GENOME) > 0.05 * C5_GENOME:
        raise AssertionError(f"bad two-pass result {res}, {bases} bases")
    _bars("phase6 (a)", a_fq, noisy, truth, seq_off)

    # (b) crash after the count_k2 checkpoint, then resume
    b_fq, b_fa = outs("b")
    work = os.path.join(workdir, "work")
    cfg = KmeraxConfig(**C5_CFG, k2=63)
    secs = {"save": 0.0, "load": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[key] += time.perf_counter() - t0
        return run

    def boom(*a, **kw):
        raise RuntimeError("injected failure after the count_k2 checkpoint")

    orig = {n: getattr(twopass, n) for n in
            ("save_state", "load_spectrum", "assemble_to_fasta")}
    cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        twopass.save_state = timed("save", orig["save_state"])
        twopass.load_spectrum = timed("load", orig["load_spectrum"])
        twopass.assemble_to_fasta = boom
        try:
            twopass.run_two_pass(cfg, paths, b_fq, b_fa, workdir=work,
                                 device=DEVICE)
            raise AssertionError("the injected failure did not happen")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        crash_wall = time.perf_counter() - t0
        twopass.assemble_to_fasta = orig["assemble_to_fasta"]
        t0 = time.perf_counter()
        twopass.run_two_pass(cfg, paths, b_fq, b_fa, workdir=work,
                             device=DEVICE)
        resume_wall = time.perf_counter() - t0
    finally:
        for n, fn in orig.items():
            setattr(twopass, n, fn)
    runs["config5_crash_resume"] = dict(cuda.LAUNCHES)
    ck = {stage: sum(os.path.getsize(os.path.join(work, stage, f))
                     for f in os.listdir(os.path.join(work, stage)))
          for stage in ("count_k1", "count_k2")}
    for a, b in zip(a_fq + [a_fa], b_fq + [b_fa]):
        _same_bytes(b, a, "phase6 (b) resume")
    num(f"phase6 (b) crash after the count_k2 checkpoint at "
        f"{crash_wall:.2f} s, resume {resume_wall:.2f} s; FASTQ and FASTA "
        f"bytes equal to (a); checkpoint bytes {ck}; save "
        f"{secs['save']:.4f} s (two saves), load {secs['load']:.4f} s")

    # (c) the subcommands on (b)'s checkpoints
    c_fq, c_fa = outs("c")
    cuda.reset_launches()
    stats, cwall = _cli("phase6", workdir, [
        "correct", "--in", *paths, "--out", *c_fq, "--spectrum",
        os.path.join(work, "count_k1"), "--device", DEVICE, *C5_ARGS])
    runs["config5_correct_spectrum"] = dict(cuda.LAUNCHES)
    for a, b in zip(a_fq, c_fq):
        _same_bytes(b, a, "phase6 (c) correct --spectrum")
    cuda.reset_launches()
    astats, awall = _cli("phase6", workdir, [
        "assemble", "--spectrum", os.path.join(work, "count_k2"), "--out",
        c_fa, "--device", DEVICE, *C5_ARGS, "-k", "63"])   # the last -k
    runs["config5_assemble_spectrum"] = dict(cuda.LAUNCHES)
    if runs["config5_assemble_spectrum"]["solid_join"] <= 0:
        raise AssertionError("K5 never launched by assemble --spectrum")
    _same_bytes(c_fa, a_fa, "phase6 (c) assemble --spectrum")
    num(f"phase6 (c) correct --spectrum: {cwall:.2f} s, "
        f"{n_reads / cwall:.1f} reads/s, {stats}; assemble --spectrum -k 63: "
        f"{awall:.2f} s, {astats}; bytes equal to (a)'s")
    x_fq, _ = outs("x")
    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    xstats, xwall = _cli("phase6", workdir, [
        "correct", "--in", *paths, "--out", *x_fq, "--use-exact",
        "--spectrum", os.path.join(work, "count_k1"), "--device", DEVICE,
        *C5_ARGS])
    runs["config5_correct_exact"] = dict(cuda.LAUNCHES)
    num(f"phase6 (c) correct --use-exact --spectrum: {xwall:.2f} s, "
        f"{n_reads / xwall:.1f} reads/s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes, {xstats}")
    _bars("phase6 (c) --use-exact", x_fq, noisy, truth, seq_off)
    return runs


# ---------------------------------------------------------------- phase 7

# run_preset's sizes (kmerax/bench/runners.py): count and align 16,384
# reads, correct min(16,384, 8,192), e2e 65,536 (fixed); reads of 150
BENCH_READS = 16384
BENCH_CORRECT_READS = 8192
E2E_READS = 65536
# BASELINE config 2 (acceptance.py CONFIGS[2], S. cerevisiae PE100 80x,
# k=25) at --scale 5: a 300,000 bp genome, 240,000 reads; acceptance.py's
# rule gives distinct = 6,300,000, a 2^26-counter Bloom table (256 MiB)
# and exact_capacity 2^24. (--scale 20, 960,000 reads, took 162 s of a
# call whose seven phases projected past 1,200 s on a slow host; --scale
# 10 ran in a script that passed 1,200 s on another.)
C2_SCALE = "5"
C2_FULL_GENOME = 12_157_105


def _child(name: str, arg) -> dict:
    """Run `_CHILDREN[name](arg)` in a child process of its own (a fresh
    CUDA context and profiler); returns the JSON of its last line."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", name,
         json.dumps(arg)], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    if res.returncode != 0:
        raise AssertionError(f"child {name} failed ({res.returncode}):\n"
                             + res.stderr[-6000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def _child_count_window(arg) -> dict:
    """The profiler window of phase 4's count step on the first `n` batches
    of `paths` as run_count sends them (on the config's wire: the unpack
    on the 2-bit wire, then one K1 launch), in this process alone."""
    import torch
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.core.codec import num_words
    from kmerax_torch.io.batcher import BackgroundBatcher
    from kmerax_torch.io.wire import send_batch, unwire
    from kmerax_torch.pipeline.count import _count_steps
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert
    from kmerax_torch.spectrum.exact import sentinel_rows

    cfg = KmeraxConfig(**arg["cfg"])
    params, _, P, _ = _count_steps(cfg, cfg.k)
    table = make_table(params, DEVICE)
    pending = sentinel_rows(P, num_words(cfg.k), DEVICE)
    keep = []
    for batch in BackgroundBatcher(arg["paths"], cfg.batch_reads,
                                   cfg.max_read_len):
        keep.append(send_batch(batch, DEVICE, cfg.wire_pack))
        if len(keep) == arg["n"]:
            break

    def step(rows, lengths, packed):
        bloom_insert(table, unwire(rows, lengths, packed, cfg.max_read_len),
                     params, pending, 0)
    step(*keep[0])                                             # warm-up
    torch.cuda.synchronize()
    wall, dev, by, n_k = _profile_window(step, keep, ("bloom_insert_kernel",))
    return {"batches": len(keep), "packed": sum(p for _, _, p in keep),
            "wall": wall, "device": dev, "by": by, "kernels": n_k}


def _child_traced_cli(arg) -> dict:
    """kmerax_torch.cli with `argv` under KMERAX_TRACE_DIR=`trace`, in
    this process alone: its JSON result, wall and kernel launches."""
    from kmerax_torch.utils import cuda

    os.environ["KMERAX_TRACE_DIR"] = arg["trace"]
    with contextlib.redirect_stdout(sys.stderr):
        res, wall = _cli("phase7", arg["workdir"], arg["argv"])
    return {"result": res, "wall": wall, "launches": dict(cuda.LAUNCHES)}


def _trace_stats(prof) -> dict:
    """Device events of a profiler session, from its chrome trace: kernel
    launches by name, and copies by (direction, bytes) with their count
    and device microseconds."""
    kernels, copies = {}, {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        if name.startswith("Memcpy"):
            d = "HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name \
                else "DtoD"
            key = f"{d} {(ev.get('args') or {}).get('bytes')}"
            n, us = copies.get(key, (0, 0.0))
            copies[key] = (n + 1, us + float(ev.get("dur", 0)))
        elif ev.get("cat") == "kernel":
            short = name.split("(")[0][-60:]
            kernels[short] = kernels.get(short, 0) + 1
    return {"kernels": kernels,
            "copies": {k: {"n": n, "us": us} for k, (n, us)
                       in sorted(copies.items())}}


def _child_wire(arg) -> dict:
    """`bench --preset e2e` at its size on each wire, each stage under its
    own profiler session: the stage's copies and kernels (_trace_stats)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import kmerax_torch.pipeline.correct as correct
    import kmerax_torch.pipeline.count as count
    from kmerax_torch.bench import runners
    from kmerax_torch.config import KmeraxConfig

    # warm-up: the stages' first launches in this process (lazy module
    # loading) and the profiler's first session (CUPTI's start) are not
    # the wire's
    runners.bench_e2e(KmeraxConfig(), n_reads=8192, device=DEVICE)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
    out = {}
    for wire in ("packed", "int8"):
        stages = {}
        real = {(count, "run_count"): count.run_count,
                (correct, "run_correct"): correct.run_correct}

        def profiled(fn, name):
            def run(*a, **kw):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    r = fn(*a, **kw)
                    torch.cuda.synchronize()
                stages[name] = _trace_stats(prof)
                return r
            return run
        try:
            for (mod, name), fn in real.items():
                setattr(mod, name, profiled(fn, name))
            res = runners.bench_e2e(KmeraxConfig(wire_pack=wire == "packed"),
                                    device=DEVICE)
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)
        out[wire] = {"stages": stages, "count_wall_s": res["count_wall_s"],
                     "correct_wall_s": res["correct_wall_s"]}
    return out


def _child_kernel_times(arg) -> dict:
    """Each kernel's own device ms per launch (profiler, 50 launches after
    3) in the checkout `arg["tree"]`, whose kmerax_torch this process
    imports and builds: K1 (with its pending rows), K2 (t=3) and K3
    (16,384 entries, t=3), both on the table K1's batch filled three
    times, at k in K_TIMED, and K1r (the batch's k-mers routed to one
    shard) at k=31, on 2^K_LOG2_WIDTH i32 counters; K1 at k=31 also on
    i32 and p16 counters at 2^24 and on p16 at 2^K_LOG2_WIDTH (keys "K1
    SCHEME k=31 2^LW LAYOUT"); under both bucket schemes, on phase 2's
    shapes drawn from one seed a k, so that every checkout times the same
    work."""
    sys.path.insert(0, os.path.abspath(arg["tree"]))
    import numpy as np
    import torch
    import kmerax_torch
    from kmerax_torch.core.codec import canonical_words, num_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.ops.correct_kernels import correct_eval_scores
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
        bloom_insert_rows, bloom_query_solid
    from kmerax_torch.spectrum.exact import sentinel_rows
    from kmerax_torch.spectrum.sharded import ShardedParams, route_prep

    if not kmerax_torch.__file__.startswith(sys.path[0] + os.sep):
        raise AssertionError(f"kmerax_torch from {kmerax_torch.__file__}, "
                             f"not {sys.path[0]}")
    B, L, Q, dev = K_READS, K_LEN, 4 * K_READS, DEVICE
    out = {}
    for scheme in ("hash", "minimizer"):
        for k in K_TIMED:
            rng = np.random.default_rng(SEED + k)
            p, W = _params(k, scheme), num_words(k)
            reads, lengths = _reads(rng, B, L, k)
            bases8 = torch.as_tensor(reads.astype(np.int8), device=dev)
            table = make_table(p, dev)
            pending = sentinel_rows(B * (L - k + 1), W, dev)
            out[f"K1 {scheme} k={k}"] = _kernel_ms(
                lambda: bloom_insert(table, bases8, p, pending, 0),
                "bloom_insert_kernel")
            if k == 31:                 # the layouts at both widths
                for lw, counter in ((24, "i32"), (24, "p16"),
                                    (K_LOG2_WIDTH, "p16")):
                    pw = _params(k, scheme, lw, counter)
                    tw = make_table(pw, dev)
                    out[f"K1 {scheme} k={k} 2^{lw} {counter}"] = _kernel_ms(
                        lambda: bloom_insert(tw, bases8, pw, pending, 0),
                        "bloom_insert_kernel")
                    del tw
            del pending
            _fill3(table, p, reads)
            bases = torch.as_tensor(reads, device=dev)
            lens = torch.as_tensor(lengths, device=dev)
            ent_i = rng.integers(0, L, Q).astype(np.int32)
            ent_i[:Q // 16] = -1
            ent_i[Q // 16:Q // 8] = rng.integers(0, k - 1, Q // 16)
            args = (bases, lens, lens - k,
                    torch.as_tensor(rng.integers(0, B, Q).astype(np.int32),
                                    device=dev),
                    torch.as_tensor(ent_i, device=dev))
            out[f"K3 {scheme} k={k}"] = _kernel_ms(
                lambda: correct_eval_scores(p, table, 3, *args),
                "correct_eval_scores_kernel")
            out[f"K2 {scheme} k={k}"] = _kernel_ms(
                lambda: bloom_query_solid(table, bases, lens - k, p, 3),
                "bloom_query_solid_kernel")
            if k == 31:
                words, valid = extract_kmers(bases8, k)
                canon, _ = canonical_words(words, k)
                sp = ShardedParams(p, 1)
                send, _, _ = route_prep(canon.reshape(-1, W),
                                        valid.reshape(-1), sp)
                rows, rv = send[:, :W].contiguous(), send[:, W] != 0
                lb, cap = sp.local_bits, send.shape[0]
                t = torch.zeros(1 << lb, dtype=torch.int32, device=dev)
                pend = sentinel_rows(2 * cap, W, dev)
                out[f"K1r {scheme} k={k}"] = _kernel_ms(
                    lambda: bloom_insert_rows(t, rows, rv, p, lb, pend, cap),
                    "bloom_insert_rows")
                del words, valid, canon, send, rows, rv, t, pend
            del table, args
            torch.cuda.empty_cache()
    return out


def turns(trees) -> None:
    """`python3 chip_smoke.py --turns TREE...`: _child_kernel_times in each
    checkout, in the order given (e.g. parent, change, change, parent),
    each in a process of its own; prints each turn's times and then, per
    kernel, its times in turn order, with the card's name and power
    limit."""
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(CARD)
    res = []
    for tree in trees:
        res.append(_child("kernel_times", {"tree": tree}))
        num(f"turn {tree}: {json.dumps(res[-1])}")
    for key in res[0]:
        num(f"turns {key} (own device ms per launch, profiler): "
            + ", ".join(f"{tree} {r[key]}" for tree, r in zip(trees, res)))


_CHILDREN = {"count_window": _child_count_window, "wire": _child_wire,
             "kernel_times": _child_kernel_times,
             "traced_cli": _child_traced_cli}


def _say_wire(prof: dict, n_batches: int, B: int, L: int) -> None:
    """The wire's copies per batch and the count step's launches per
    batch, from each wire's profiled e2e stages (`_child_wire`)."""
    cols = (L + 3) // 4
    for wire, rec in prof.items():
        for stage, st in rec["stages"].items():
            per = {d: sum(c["us"] for k, c in st["copies"].items()
                          if k.startswith(d)) / n_batches * 1e-3
                   for d in ("HtoD", "DtoH")}
            rows = {f"HtoD {B * L}": "int8 rows H2D",
                    f"HtoD {B * cols}": "packed rows H2D",
                    f"DtoH {B * L}": "int8 rows D2H",
                    f"DtoH {B * cols}": "packed rows D2H"}
            seen = ", ".join(
                f"{name} {c['n']} x {c['us'] / c['n'] * 1e-3:.4f} ms"
                for k, name in rows.items() if (c := st["copies"].get(k)))
            n_k = sum(st["kernels"].values())
            num(f"phase7 wire {wire}, {stage} ({n_batches} batches of "
                f"{B} x {L}): H2D {per['HtoD']:.4f} ms and D2H "
                f"{per['DtoH']:.4f} ms of copies a batch (device time, all "
                f"copies); {seen}; {n_k} kernels, {n_k / n_batches:.2f} a "
                f"batch")
            say(f"phase7 wire {wire}, {stage}: copies {st['copies']}; "
                f"kernels {st['kernels']}")
        num(f"phase7 wire {wire}: profiled e2e walls count "
            f"{rec['count_wall_s']:.3f} s, correct {rec['correct_wall_s']:.3f}"
            f" s")


def _bench_first_batches(device) -> dict:
    """The presets' first batches at (B, 150) on the card, each kernel path
    against its plain version, exactly: K1's table and valid count (count
    preset), the correct step's rows and n_edits (K2, K6, K3, K7, correct
    preset) and K4's scores (align preset, its first call in
    validate_batch). Returns each kernel's max_abs_err."""
    import torch
    import kmerax_torch.ops.align as align
    from kmerax_torch.bench import runners
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.ops.align_kernels import banded_align_scores, \
        banded_align_scores_plain
    from kmerax_torch.pipeline.correct import make_correct_step
    from kmerax_torch.spectrum.bloom import make_table
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
        bloom_insert_plain

    cfg = KmeraxConfig()              # the CLI's defaults, as `bench` runs
    err = {}
    params, batches = runners.count_setup(cfg, BENCH_READS, READ_LEN, device)
    tk, tp = make_table(params, device), make_table(params, device)
    nk = bloom_insert(tk, batches[0], params)
    np_ = bloom_insert_plain(tp, batches[0], params)
    torch.cuda.synchronize()
    err["bloom_insert"] = max(int((tk - tp).abs().max()),
                              abs(int(nk) - int(np_)))
    if err["bloom_insert"] or int(nk) != BENCH_READS * (READ_LEN - cfg.k + 1):
        raise AssertionError(f"K1 differs from plain on the count preset's "
                             f"batch 0 ({err['bloom_insert']}, {int(nk)})")
    num(f"phase7 K1 == plain on the count preset's batch 0: "
        f"{tuple(batches[0].shape)} int8 into 2^{params.log2_width} "
        f"counters, table bytes and {int(nk)} valid k-mers equal")
    del batches, tk, tp

    params, table, batches, lengths = runners.correct_setup(
        cfg, BENCH_CORRECT_READS, READ_LEN, device)
    t = 3
    kw = dict(rounds=cfg.rounds, max_runs=cfg.max_runs,
              max_edits=cfg.max_edits)
    fk, nek = make_correct_step(params, table, t, **kw)(batches[0], lengths)
    fp, nep = _plain_correct(params, table, t, batches[0], lengths, **kw)
    torch.cuda.synchronize()
    e = max(int((fk.to(torch.int32) - fp).abs().max()),
            int((nek - nep).abs().max()))
    for name in ("bloom_query_solid", "correct_candidates",
                 "correct_eval_scores", "correct_apply"):
        err[name] = e
    if e or int(nek.sum()) == 0:
        raise AssertionError(f"the correct step (K2, K6, K3, K7) differs "
                             f"from its plain version on the correct "
                             f"preset's batch 0 ({e}, {int(nek.sum())} "
                             f"edits)")
    num(f"phase7 correct step (K2, K6, K3, K7) == plain on the correct "
        f"preset's batch 0: {tuple(batches[0].shape)} at t={t}, corrected "
        f"rows and "
        f"n_edits equal, {int(nek.sum())} edits in "
        f"{int((nek > 0).sum())} reads")
    del batches, table

    cat_dev, index, batches, lengths = runners.align_setup(
        cfg, BENCH_READS, READ_LEN, device)
    calls = []

    def spy(*a):
        calls.append(a)
        return banded_align_scores(*a)
    align.banded_align_scores = spy
    try:
        found = align.validate_batch(cat_dev, index, batches[0], lengths,
                                     cfg.k, cfg.band)[0]
    finally:
        align.banded_align_scores = banded_align_scores
    args = calls[0]
    sk = banded_align_scores(*args)
    sp = banded_align_scores_plain(*args)
    torch.cuda.synchronize()
    err["banded_align_scores"] = int((sk.to(torch.int64)
                                      - sp.to(torch.int64)).abs().max())
    if err["banded_align_scores"] or int((sk > 0).sum()) == 0:
        raise AssertionError("K4 differs from plain on the align preset's "
                             "batch 0")
    num(f"phase7 K4 == plain on the align preset's batch 0: "
        f"{tuple(args[0].shape)} at band {args[4]}, {int(found.sum())} reads "
        f"found, {int((sk > 0).sum())} positive scores equal")
    return err


def phase_bench(workdir: str, recs=None):
    """`bench` on the card: (1) `bench --preset all` at run_preset's sizes
    through the CLI (the launches counted); (2) the presets' first batches
    against the plain versions (`_bench_first_batches`); (3) the wire:
    `bench --preset e2e` with `--no-wire-pack`, then again on the 2-bit
    wire, and in a child process each wire's profiled e2e for its copies
    and the count step's launches per batch; (4) BASELINE config 2 through
    `bench --acceptance 2 --scale 5`, held to its accuracy bars. Returns
    the launches of (1) and (4)."""
    import torch
    from kmerax_torch.utils import cuda

    runs = {}
    cuda.reset_launches()
    res, wall = _cli("phase7", workdir, [
        "bench", "--preset", "all", "--reads", str(BENCH_READS), "--device",
        DEVICE])
    runs["bench_presets"] = dict(cuda.LAUNCHES)
    for preset, r in res.items():
        num(f"phase7 bench {preset}: {r}")
    num(f"phase7 bench --preset all: {wall:.2f} s; launches "
        f"{runs['bench_presets']}")
    for name in ONE_DEVICE_KERNELS:
        if runs["bench_presets"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched by bench")

    err = _bench_first_batches(DEVICE)
    if recs is not None:
        for r in recs:
            if r["scheme"] == "hash" and r["name"] in err:
                r["max_abs_err"] = max(r["max_abs_err"], err[r["name"]])

    walls = {"packed": [res["e2e"]]}
    for wire, extra in (("int8", ["--no-wire-pack"]), ("packed", [])):
        r, _ = _cli("phase7", workdir, ["bench", "--preset", "e2e",
                                        "--device", DEVICE, *extra])
        walls.setdefault(wire, []).append(r)
    for wire, rs in walls.items():
        num(f"phase7 bench e2e on the {wire} wire: " + "; ".join(
            f"count {r['count_wall_s']:.3f} s, correct "
            f"{r['correct_wall_s']:.3f} s, {r['value']:.1f} reads/s"
            for r in rs))
    from kmerax_torch.config import KmeraxConfig

    dflt = KmeraxConfig()         # the CLI's defaults, as `bench` runs
    _say_wire(_child("wire", {}), -(-E2E_READS // dflt.batch_reads),
              dflt.batch_reads, dflt.max_read_len)
    runs.update(_mesh_e2e(workdir))

    say(f"phase7 CUT: config 2 at --scale {C2_SCALE}: genome "
        f"{int(60_000 * float(C2_SCALE))} bp, not S. cerevisiae's "
        f"{C2_FULL_GENOME} bp")
    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # keep the acceptance run's count (its arrays, copied to the host at
    # the end of run_count, its wall and its host merges) for the sharded
    # count's check below: wrap the run_count of every module a stage
    # calls it through, as the benchmark's recorder does
    import kmerax_torch.pipeline.count as count
    import kmerax_torch.pipeline.run as run_mod
    import kmerax_torch.pipeline.twopass as twopass_mod
    mods = (count, run_mod, twopass_mod)
    real_counts, kept = [mod.run_count for mod in mods], []

    def keep(real_count):
        def keep_count(*a, **kw):
            t0 = time.perf_counter()
            state = real_count(*a, **kw)
            torch.cuda.synchronize()
            kept.append({"wall": time.perf_counter() - t0,
                         "flushes": count.LAST_COUNT_FLUSHES,
                         "want": _count_arrays(state)})
            return state
        return keep_count
    for mod, real_count in zip(mods, real_counts):
        mod.run_count = keep(real_count)
    try:
        rep, wall = _cli("phase7", workdir, [
            "bench", "--acceptance", "2", "--scale", C2_SCALE, "--device",
            DEVICE])
    finally:
        for mod, real_count in zip(mods, real_counts):
            mod.run_count = real_count
    runs["config2_acceptance"] = dict(cuda.LAUNCHES)
    try:
        st = _stages(os.path.join(rep["workdir"], "metrics.jsonl"))
        runs.update(_sharded_count(rep, kept[0]))
        _keep_config2(rep, kept[0]["want"])
    finally:
        shutil.rmtree(rep["workdir"], ignore_errors=True)
    cnt, cor = st["count"][0], st["correct"][0]
    acc = rep["accuracy"]
    num(f"phase7 config 2: {rep['reads']} reads (PE100, genome "
        f"{rep['genome_len']} bp, 80x, k=25), threshold {rep['threshold']}; "
        f"count {cnt['wall_s']} s ({cnt['kmers'] / cnt['wall_s']:.1f} "
        f"k-mers/s), correct {cor['wall_s']} s "
        f"({cor['reads'] / cor['wall_s']:.1f} reads/s); run_config wall "
        f"{rep['wall_s']:.2f} s (stages), {wall:.2f} s with the simulation "
        f"and the accuracy count; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; launches "
        f"{runs['config2_acceptance']}")
    num(f"phase7 config 2 accuracy: {acc}")
    if acc["errors_introduced"] > 0.001 * acc["errors_before"]:
        raise AssertionError(f"config 2: {acc['errors_introduced']} "
                             f"introduced > 0.001 x {acc['errors_before']}")
    if acc["gain"] < 0.9:
        raise AssertionError(f"config 2: gain {acc['gain']} < 0.9")
    for name in MAIN_PATH_KERNELS:
        if runs["config2_acceptance"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched by config 2")
    runs.update(_config2_p16(workdir))
    _mesh_on_cuda()
    return runs


def _kernel_name(full: str) -> str:
    """A kernel's name and template arguments from the profiler's full
    signature ("void (anonymous namespace)::name<...>(args)")."""
    return full.split("(anonymous namespace)::")[-1].split("(")[0]


def _config2_p16(workdir: str) -> dict:
    """Config 2's reads (phase 7's acceptance run, kept in `_C2`) through
    the CLI's staged subcommands on p16 counters, with the acceptance run's
    config and `bloom_counter = "p16"` in a TOML: `count --config
    c2_p16.toml --out spec` with KMERAX_TRACE_DIR set (in a child
    process, `_child_traced_cli`), then `correct
    --spectrum spec`. The corrected FASTQs byte-equal to the i32 acceptance
    run's, the checkpoint's bloom_table 2^(log2_width - 1) words, K1-K3
    launched in their p16 form only, and the count stage's trace naming
    K1's p16 kernel. Returns its launches (path "config2_p16_staged")."""
    import glob
    from kmerax_torch.pipeline.checkpoint import load_spectrum
    from kmerax_torch.utils import cuda

    cfg = dict(_C2["cfg"], bloom_counter="p16")
    toml = os.path.join(workdir, "c2_p16.toml")
    with open(toml, "w") as f:
        f.writelines(f"{key} = {json.dumps(v)}\n" for key, v in cfg.items())
    reads = [os.path.join(_C2["dir"], f"reads_{i}.fastq.gz") for i in (1, 2)]
    want = [os.path.join(_C2["dir"], f"corrected_{i}.fastq") for i in (1, 2)]
    outs = [os.path.join(workdir, f"p16_corrected_{i}.fastq") for i in (1, 2)]
    spec = os.path.join(workdir, "c2_p16_spec")
    trace = os.path.join(workdir, "trace")
    # the traced count in a process of its own: in this one, after the
    # script's many profiler sessions, its trace came to miss K1 launches
    # (57 of 59), as the count window of phase 4 did
    count = _child("traced_cli", {"workdir": workdir, "trace": trace,
                                  "argv": ["count", "--in", *reads, "--out",
                                           spec, "--config", toml,
                                           "--device", DEVICE]})
    cnt, w_count = count["result"], count["wall"]
    cuda.reset_launches()
    cor, w_correct = _cli("phase7", workdir, [
        "correct", "--in", *reads, "--spectrum", spec, "--out", *outs,
        "--config", toml, "--device", DEVICE])
    launches = {name: n + count["launches"][name]
                for name, n in cuda.LAUNCHES.items()}
    for got, ref in zip(outs, want):
        _same_bytes(got, ref, "config 2 on p16 counters, staged, against "
                              "the i32 acceptance run")
    _, arrays = load_spectrum(spec)
    n_words = len(arrays["bloom_table"])
    if n_words != 1 << (cfg["bloom_log2_width"] - 1):
        raise AssertionError(f"p16 checkpoint: bloom_table of {n_words} "
                             f"words for 2^{cfg['bloom_log2_width']} "
                             f"counters")
    for name in MAIN_PATH_KERNELS:
        if launches[name + "_p16"] <= 0 or launches[name] != 0:
            raise AssertionError(f"config 2 on p16 counters: {name} "
                                 f"launches {launches}")
    files = glob.glob(os.path.join(trace, "count", "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"count trace: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    k1 = [ev for ev in events if ev.get("cat") == "kernel"
          and "bloom_insert_kernel" in ev.get("name", "")
          and "CounterP16" in ev["name"]]
    if len(k1) != launches["bloom_insert_p16"]:
        raise AssertionError(f"count trace holds {len(k1)} K1 p16 kernels "
                             f"for {launches['bloom_insert_p16']} launches")
    num(f"phase7 config 2 on p16 counters (staged CLI, 2^"
        f"{cfg['bloom_log2_width']} counters in {n_words} words, "
        f"{n_words * 4} bytes): count {w_count:.2f} s (traced, "
        f"KMERAX_TRACE_DIR; {cnt['kmers']} k-mers, threshold "
        f"{cnt['threshold']}), correct --spectrum {w_correct:.2f} s "
        f"({cor['edited_reads']} reads edited); FASTQs byte-equal to the "
        f"i32 acceptance run's; launches {launches}; the count trace names "
        f"{_kernel_name(k1[0]['name'])} {len(k1)} times")
    return {"config2_p16_staged": launches}


# phase 7's config-2 inputs, outputs and spectrum, kept for phase 8
_C2: dict = {}


def _keep_config2(rep: dict, want: dict) -> None:
    """Move config 2's reads and corrected FASTQs out of the acceptance
    run's workdir into a directory of their own, and keep its exact
    spectrum, histogram and threshold (not its table) for phase 8."""
    from kmerax_torch.bench.acceptance import CONFIGS, sized_config

    d = tempfile.mkdtemp(prefix="kmerax_c2_")
    for f in ("reads_1.fastq.gz", "reads_2.fastq.gz", "corrected_1.fastq",
              "corrected_2.fastq"):
        shutil.move(os.path.join(rep["workdir"], f), os.path.join(d, f))
    cfg = sized_config(CONFIGS[2], rep["genome_len"], rep["reads"])
    _C2.update(dir=d, reads=rep["reads"], cfg=dict(
        k=cfg.k, bloom_log2_width=cfg.bloom_log2_width,
        exact_capacity=cfg.exact_capacity, batch_reads=cfg.batch_reads,
        max_read_len=cfg.max_read_len),
        **{key: want[key] for key in ("uniq", "counts", "hist",
                                      "threshold")})


def _count_arrays(state) -> dict:
    """A count's table, host spectrum, histogram and threshold on the
    host."""
    return {"table": state.bloom_table.cpu().numpy(),
            "uniq": state.host.uniq, "counts": state.host.counts,
            "hist": state.hist, "threshold": state.threshold,
            "reads": state.n_reads, "kmers": state.n_kmers}


def _same_arrays(got: dict, want: dict, what: str) -> None:
    import numpy as np

    for key, w in want.items():
        if not np.array_equal(np.asarray(got[key]), np.asarray(w)):
            raise AssertionError(f"{what}: {key} differs from run_count's")


def _sharded_vs_one(cfg, paths, want=None):
    """run_count_sharded over a world-size-1 NCCL group (a `file://`
    rendezvous) against run_count (the one-device path run_count takes at
    1 x 1) on the same reads (`want`: its `_count_arrays`, else it runs
    here): table, host spectrum, histogram and threshold byte-equal, and
    K1r launched once a batch (and once a replay). Returns (its launches,
    its arrays, its wall, its host merges)."""
    import torch
    import kmerax_torch.pipeline.count as count
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.utils import cuda

    if want is None:
        want = _count_arrays(count.run_count(cfg, paths, device=DEVICE))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        mesh = dmesh.init_mesh(dmesh.MeshSpec(1, 1), DEVICE, 0, 1,
                               "file://" + os.path.join(td, "rendezvous"))
        try:
            cuda.reset_launches()
            t0 = time.perf_counter()
            state = count.run_count_sharded(cfg, paths, device=DEVICE,
                                            mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(cuda.LAUNCHES)
            flushes = count.LAST_COUNT_FLUSHES
            got = _count_arrays(state)
            if not torch.equal(state.sharded_table, state.bloom_table):
                raise AssertionError("the one-rank slice != its table")
            del state
        finally:
            dmesh.shutdown()
    torch.cuda.empty_cache()
    _same_arrays(got, want, f"run_count_sharded on NCCL (world 1), "
                            f"{cfg.bucket_scheme} scheme")
    n_batches = -(-got["reads"] // cfg.batch_reads)
    if launches["bloom_insert_rows"] != n_batches + count.LAST_COUNT_RETRIES:
        raise AssertionError(f"K1r launched {launches['bloom_insert_rows']}"
                             f" times for {n_batches} batches")
    return launches, got, wall, flushes


def _sharded_count(rep: dict, one: dict) -> dict:
    """The mesh count's driver on config 2's reads (`_sharded_vs_one`),
    against `one`, the acceptance run's own run_count in this call: its
    arrays (`want`), its wall and its host merges. Returns its launches
    (path "config2_sharded_count")."""
    import kmerax_torch.pipeline.count as count
    from kmerax_torch.bench.acceptance import CONFIGS, sized_config

    cfg = sized_config(CONFIGS[2], rep["genome_len"], rep["reads"])
    paths = [os.path.join(rep["workdir"], f"reads_{i}.fastq.gz")
             for i in (1, 2)]
    want = one["want"]
    launches, got, wall, flushes = _sharded_vs_one(cfg, paths, want)
    num(f"phase7 sharded count driver (world-size-1 NCCL, mesh 1 x 1) on "
        f"config 2's {rep['reads']} reads, k={cfg.k}, 2^"
        f"{cfg.bloom_log2_width} counters: table ({len(got['table'])} "
        f"counters), host spectrum ({len(got['uniq'])} distinct), histogram "
        f"and threshold {got['threshold']} byte-equal to run_count's; "
        f"count wall {wall:.2f} s against the acceptance run's run_count "
        f"{one['wall']:.2f} s in this call ({wall / one['wall']:.3f}x), "
        f"{got['kmers'] / wall:.1f} k-mers/s; host merges of the pending "
        f"buffer {flushes} against run_count's {one['flushes']}; route "
        f"retries {count.LAST_COUNT_RETRIES}, route_safety at the end "
        f"{count.LAST_ROUTE_SAFETY}; launches {launches}")
    _mesh_count(cfg, paths, want, rep["workdir"])
    return {"config2_sharded_count": launches}


def _mesh_count(cfg, paths, want: dict, workdir: str) -> None:
    """Where the host has two cards or more: `count` through the CLI on a
    1 x S mesh of NCCL ranks (S the largest power of two <= the cards, at
    most 8), its saved spectrum == `want` (run_count's)."""
    import numpy as np
    import torch
    from kmerax_torch.pipeline.checkpoint import load_spectrum

    have = torch.cuda.device_count()
    if have < 2:
        return
    S = 1 << (min(have, 8).bit_length() - 1)
    out = os.path.join(workdir, f"spectrum_1x{S}")
    res, wall = _cli("phase7", workdir, [
        "count", "--in", *paths, "--out", out, "--device", DEVICE,
        "--mesh-bucket", str(S), *_cli_args(dict(
            k=cfg.k, bloom_log2_width=cfg.bloom_log2_width,
            exact_capacity=cfg.exact_capacity, batch_reads=cfg.batch_reads,
            max_read_len=cfg.max_read_len))])
    _, arrays = load_spectrum(out)
    if "exact_uniq" in arrays:
        n = int(arrays["exact_n"])
        uniq, counts = arrays["exact_uniq"][:n], arrays["exact_counts"][:n]
    else:
        uniq, counts = arrays["host_uniq"], arrays["host_counts"]
    got = {"table": arrays["bloom_table"], "uniq": uniq,
           "counts": counts.astype(np.int64), "hist": arrays["hist"],
           "threshold": res["threshold"], "kmers": res["kmers"]}
    _same_arrays(got, {key: want[key] for key in got},
                 f"count on a 1 x {S} NCCL mesh")
    num(f"phase7 mesh count: `count --mesh-bucket {S}` on {S} cards "
        f"(NCCL), {wall:.2f} s with the ranks' start; table, spectrum, "
        f"histogram and threshold equal run_count's")


def _mesh_e2e(workdir: str) -> dict:
    """The e2e preset's stages on a mesh (`runners.e2e_stages`, what
    `bench_e2e` launches on D·S > 1 ranks or across hosts) on e2e's FASTQ
    (E2E_READS reads, `runners.write_e2e_fastq`): (1) here, as `bench_e2e`
    runs them on one device; (2) over a one-rank NCCL mesh (MeshSpec(1, 1),
    launched explicitly): K1, K2 and K3 launched in the spawned rank, the
    corrected FASTQ byte-equal to (1)'s, its walls and `launch_s` beside
    (1)'s; (3) where the host has two cards or more, `bench --preset e2e
    --mesh-bucket S` through the CLI on S NCCL ranks, and the stages on a
    1 x S mesh byte-equal to (1). Returns the launches of (2) (path
    "e2e_one_rank_mesh")."""
    import torch
    from kmerax_torch.bench.runners import e2e_stages, write_e2e_fastq
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.pipeline.run import restore_observed, with_observed
    from kmerax_torch.utils import cuda

    fq = os.path.join(workdir, "e2e.fastq")
    write_e2e_fastq(fq, E2E_READS, READ_LEN)
    outs = {n: os.path.join(workdir, f"e2e_{n}.fastq")
            for n in ("one", "rank", "mesh")}
    one = e2e_stages(KmeraxConfig(), fq, outs["one"], DEVICE)
    torch.cuda.empty_cache()
    cuda.reset_launches()
    t0 = time.perf_counter()
    walls, obs = dmesh.launch(dmesh.MeshSpec(1, 1), DEVICE, with_observed,
                              e2e_stages, KmeraxConfig(), fq, outs["rank"],
                              DEVICE)
    launch_s = (time.perf_counter() - t0 - walls["count_wall_s"]
                - walls["correct_wall_s"])
    restore_observed(obs)
    launches = dict(cuda.LAUNCHES)
    _same_bytes(outs["rank"], outs["one"],
                "phase7 e2e stages in a one-rank NCCL mesh")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched by the e2e "
                                 f"stages in a spawned rank")
    num(f"phase7 e2e stages ({E2E_READS} reads, the e2e preset's FASTQ) in "
        f"a spawned rank of a one-rank NCCL mesh: count "
        f"{walls['count_wall_s']:.3f} s, correct "
        f"{walls['correct_wall_s']:.3f} s, launch_s {launch_s:.3f} s; in "
        f"this process: count {one['count_wall_s']:.3f} s, correct "
        f"{one['correct_wall_s']:.3f} s; corrected FASTQ byte-equal; "
        f"launches in the rank {launches}")
    have = torch.cuda.device_count()
    if have >= 2:
        S = 1 << (min(have, 8).bit_length() - 1)
        res, wall = _cli("phase7", workdir, [
            "bench", "--preset", "e2e", "--mesh-bucket", str(S), "--device",
            DEVICE])
        dmesh.launch(dmesh.MeshSpec(1, S), DEVICE, e2e_stages,
                     KmeraxConfig(mesh_bucket=S), fq, outs["mesh"], DEVICE)
        _same_bytes(outs["mesh"], outs["one"],
                    f"phase7 e2e stages on a 1 x {S} NCCL mesh")
        num(f"phase7 `bench --preset e2e --mesh-bucket {S}` on {S} cards "
            f"(NCCL): {res}, {wall:.2f} s; the stages on a 1 x {S} mesh "
            f"wrote the one-device bytes")
    return {"e2e_one_rank_mesh": launches}


def _mesh_on_cuda() -> None:
    """A mesh of more ranks than the host's cards, on cuda, raises the JAX
    package's error before it starts a rank (no fall-back to gloo or the
    CPU): `pipeline` on a 2 x 2 mesh, and `bench --preset e2e` on a 1 x 2
    mesh where there is one card. A multi-rank mesh runs only where there
    are cards for it."""
    import torch
    from kmerax_torch.cli import main as cli_main
    from kmerax_torch.dist import mesh as dmesh

    have = torch.cuda.device_count()
    want = f"mesh 2x2 needs 4 devices, have {have}"
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "r.fastq")
        with open(fq, "wb") as f:
            f.write(b"@r\n" + b"ACGT" * 10 + b"\n+\n" + b"I" * 40 + b"\n")
        try:
            cli_main(["pipeline", "--in", fq, "--out-fastq",
                      os.path.join(td, "o.fastq"), "--device", DEVICE,
                      "--mesh-data", "2", "--mesh-bucket", "2"])
            raised = None
        except ValueError as e:
            raised = str(e)
    if have < 4 and raised != want:
        raise AssertionError(f"a 2 x 2 mesh on {have} card(s): {raised!r}, "
                             f"expected {want!r}")
    if have < 2:
        want2 = f"mesh 1x2 needs 2 devices, have {have}"
        real_launch, started = dmesh.launch, []

        def launch(*a, **kw):
            started.append(a[0])
            return real_launch(*a, **kw)
        dmesh.launch = launch
        try:
            cli_main(["bench", "--preset", "e2e", "--mesh-bucket", "2",
                      "--device", DEVICE])
            raised2 = None
        except ValueError as e:
            raised2 = str(e)
        finally:
            dmesh.launch = real_launch
        if raised2 != want2 or started:
            raise AssertionError(f"bench --preset e2e on a 1 x 2 mesh on "
                                 f"{have} card: {raised2!r} (expected "
                                 f"{want2!r}), launches {started}")
        say(f"phase7 mesh: `bench --preset e2e --mesh-bucket 2 --device "
            f"{DEVICE}` raised {raised2!r} before any rank or preset ran")
    say(f"phase7 mesh: {have} card(s) here: `pipeline --mesh-data 2 "
        f"--mesh-bucket 2 --device {DEVICE}` raised {raised!r}; a mesh of "
        f"more than one rank was not run on the card (NCCL puts one rank "
        f"on a card; the multi-rank mesh is checked on the CPU with gloo)"
        if have < 2 else
        f"phase7 mesh: {have} cards here; a 2 x 2 mesh raised {raised!r}")


# ---------------------------------------------------------------- phase 8

# phase 8's cut: the first C8_PAIRS pairs of config 2's 120,000, so the
# phase stays inside its 90 s (two pipelines, a count and two assemblies
# on it, each multi-host CLI call starting a rank process): 60,000 pairs
# took 94.8 s on an NVIDIA H100 80GB HBM3 at 700 W
C8_PAIRS = 40_000
C8_TIMEOUT = 600            # seconds the two host processes may take


def _prefix_fastq(src: str, dst: str, n: int) -> None:
    import gzip

    with gzip.open(src, "rb") as f, open(dst, "wb") as out:
        for _ in range(4 * n):
            out.write(f.readline())


def _phase8_host(spec_npz: str, cfg_kw: dict, t: int, workdir: str) -> dict:
    """One emulated host of phase 8 (a rank of a 2 x 1 gloo mesh over two
    hosts): its half of every count of phase 7's spectrum (host 0 the
    floor, host 1 the rest; a row whose half is 0 stays off), then
    shard_spectrum, the global histogram, assemble_sharded and the
    sharded checkpoint's save and load, each step's wall kept; writes
    host{p}.json."""
    import numpy as np
    import kmerax_torch.graph.sharded as gs
    import kmerax_torch.spectrum.host_sharded as hs
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.pipeline.checkpoint import load_spectrum, \
        save_spectrum
    from kmerax_torch.pipeline.count import CountState

    m = dmesh.current()
    p, k = m.host, cfg_kw["k"]
    with np.load(spec_npz) as z:
        uniq, counts = z["uniq"], z["counts"]
    c = counts // 2 if p == 0 else counts - counts // 2
    keep = c > 0
    uniq, c = np.ascontiguousarray(uniq[keep]), c[keep]
    walls = {}
    t0 = time.perf_counter()
    sh = hs.shard_spectrum(uniq, c, k, p, m.n_hosts)
    walls["shard_spectrum"] = time.perf_counter() - t0
    del uniq, c
    t0 = time.perf_counter()
    hist = sh.histogram(255)
    n_unique = sh.n_unique
    walls["histogram"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = gs.assemble_sharded(sh, t, k, os.path.join(workdir, "sharded.fasta"),
                            device="cpu")
    walls["assemble_sharded"] = time.perf_counter() - t0
    ckpt = os.path.join(workdir, "ckpt")
    cfg = KmeraxConfig(**cfg_kw)
    t0 = time.perf_counter()
    save_spectrum(ckpt, CountState(cfg, None, hist, t, 0, 0, host=sh))
    dmesh.host_barrier("save", leaders=True)
    walls["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    manifest, arrays = load_spectrum(ckpt, p, m.n_hosts)
    walls["load"] = time.perf_counter() - t0
    same = (manifest["host_shard"] == [p, m.n_hosts]
            and np.array_equal(arrays["host_uniq"], sh.local.uniq)
            and np.array_equal(arrays["host_counts"], sh.local.counts)
            and np.array_equal(arrays["hist"], hist))
    out = {"host": p, "resident": sh.n_unique_local, "distinct": n_unique,
           "hist": [int(x) for x in hist], "unitigs": n,
           "exchange": dict(hs.LAST_EXCHANGE), "stats": dict(gs.LAST_STATS),
           "walls": walls, "ckpt_same": bool(same)}
    with open(os.path.join(workdir, f"host{p}.json"), "w") as f:
        json.dump(out, f)
    return out


def phase_multihost(workdir: str):
    """The multi-host path on the card at world size 1, and the host-side
    modules at config 2's size.

    (1) `pipeline --coordinator 127.0.0.1:P --num-procs 1 --process-id 0`
    (a `tcp://` rendezvous and a one-rank NCCL group) on a prefix of phase
    7's config-2 reads: FASTQ and FASTA byte-equal to the one-device
    `pipeline` on the same reads, and K1-K3 launched; then `count` to a
    checkpoint and `assemble --spectrum` from it through the same flags,
    the FASTA byte-equal to the one-device `assemble --spectrum`.
    (2) phase 7's config-2 exact spectrum (not counted again), split
    between two host processes that this script's `launch` starts (gloo;
    these modules move numpy arrays only): shard_spectrum, the global
    histogram (== phase 7's), assemble_sharded (FASTA == the one-device
    assembly of the same spectrum) and the sharded checkpoint's save and
    load; each step's wall, each host's resident rows and the rows it
    received. Returns the launches of (1)."""
    import numpy as np
    import torch
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.graph.partitioned import assemble_host
    from kmerax_torch.io.fasta import write_fasta
    from kmerax_torch.spectrum.host import HostSpectrum
    from kmerax_torch.utils import cuda

    c2 = dict(_C2)
    _C2.clear()
    # a hung rank fails the phase instead of the call
    dmesh.LAUNCH_TIMEOUT, timeout = C8_TIMEOUT, dmesh.LAUNCH_TIMEOUT
    try:
        args = _cli_args(c2["cfg"])
        say(f"phase8 CUT: the first {C8_PAIRS} of config 2's "
            f"{c2['reads'] // 2} pairs (phase 7's reads), for the 90 s "
            f"budget of this phase")
        ins = [os.path.join(workdir, f"r{i}.fastq") for i in (1, 2)]
        for i, dst in zip((1, 2), ins):
            _prefix_fastq(os.path.join(c2["dir"], f"reads_{i}.fastq.gz"),
                          dst, C8_PAIRS)
        runs = {}

        def pipeline(tag, extra):
            out = [os.path.join(workdir, f"{tag}_{i}.fastq") for i in (1, 2)]
            fa = os.path.join(workdir, f"{tag}.fasta")
            cuda.reset_launches()
            res, wall = _cli("phase8", workdir, ["pipeline", "--in", *ins,
                                        "--out-fastq", *out, "--out-fasta",
                                        fa, "--device", DEVICE, *args,
                                        *extra])
            return res, wall, dict(cuda.LAUNCHES), out + [fa]

        port = _free_port()
        hosts = ["--coordinator", f"127.0.0.1:{port}", "--num-procs", "1",
                 "--process-id", "0"]
        one, w_one, _, f_one = pipeline("one", [])
        err = os.path.join(workdir, "mh.stderr")
        with _stderr_to(err):
            res, w_mh, launches, f_mh = pipeline("mh", hosts)
        tags = _host_tags(err, "phase8 multi-host pipeline")
        if tags != {0}:
            raise AssertionError(f"phase8 multi-host pipeline: log lines "
                                 f"tagged hosts {sorted(tags)}, not [host0]")
        runs["config2_prefix_multihost_pipeline"] = launches
        if res != one:
            raise AssertionError(f"multi-host pipeline {res} != {one}")
        for a, b in zip(f_mh, f_one):
            _same_bytes(a, b, "phase8 multi-host pipeline (world 1)")
        for name in MAIN_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched by the "
                                     f"multi-host pipeline")
        num(f"phase8 `pipeline` over a tcp:// rendezvous at 127.0.0.1:"
            f"{port} (one NCCL rank): {res}; FASTQ and FASTA byte-equal to "
            f"the one-device run's; wall {w_mh:.2f} s with the rank's "
            f"start, one-device {w_one:.2f} s; launches {launches}; every "
            f"log line on its stderr tagged [host0]")

        spec = os.path.join(workdir, "spec")
        port = _free_port()
        hosts = ["--coordinator", f"127.0.0.1:{port}", "--num-procs", "1",
                 "--process-id", "0"]
        rc, w_count = _cli("phase8", workdir, ["count", "--in", *ins, "--out", spec,
                                      "--device", DEVICE, *args, *hosts])
        fa = [os.path.join(workdir, f"asm_{t}.fasta") for t in ("mh", "one")]
        port = _free_port()
        ra, w_asm = _cli("phase8", workdir, [
            "assemble", "--spectrum", spec, "--out", fa[0], "--device",
            DEVICE, "--coordinator", f"127.0.0.1:{port}", "--num-procs",
            "1", "--process-id", "0"])
        rb, w_asm1 = _cli("phase8", workdir, [
            "assemble", "--spectrum", spec, "--out", fa[1], "--device",
            DEVICE])
        if ra != rb:
            raise AssertionError(f"assemble --spectrum {ra} != {rb}")
        _same_bytes(fa[0], fa[1], "phase8 multi-host assemble --spectrum")
        num(f"phase8 `count` -> checkpoint {rc} ({w_count:.2f} s) and "
            f"`assemble --spectrum` {ra} ({w_asm:.2f} s) over tcp://, FASTA "
            f"byte-equal to the one-device `assemble --spectrum` "
            f"({w_asm1:.2f} s)")
        say("phase8 fact: the per-host count and correct across two cards "
            "(a world of two NCCL ranks, one card each) cannot run on this "
            f"machine's {torch.cuda.device_count()} card; they run on the "
            "CPU over gloo in the tests")

        # (2) the host-side modules on phase 7's spectrum
        k, t = c2["cfg"]["k"], int(c2["threshold"])
        spec_npz = os.path.join(workdir, "c2_spectrum.npz")
        np.savez(spec_npz, uniq=c2["uniq"], counts=c2["counts"])
        t0 = time.perf_counter()
        seqs = assemble_host(HostSpectrum(c2["uniq"], c2["counts"], k), t, k,
                             device=DEVICE)
        ref_fa = os.path.join(workdir, "one_device.fasta")
        write_fasta(ref_fa, seqs)
        w_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        err = os.path.join(workdir, "hosts.stderr")
        with _stderr_to(err):
            dmesh.launch(dmesh.MeshSpec(2, 1), "cpu", _phase8_host,
                         spec_npz, c2["cfg"], t, workdir, n_hosts=2,
                         host=None)
        w_hosts = time.perf_counter() - t0
        tags = _host_tags(err, "phase8 two host processes")
        if tags != {0, 1}:
            raise AssertionError(f"phase8 two host processes: log lines "
                                 f"tagged hosts {sorted(tags)}, not 0 and 1")
        hs = []
        for p in range(2):
            with open(os.path.join(workdir, f"host{p}.json")) as f:
                hs.append(json.load(f))
        _same_bytes(os.path.join(workdir, "sharded.fasta"), ref_fa,
                    "phase8 assemble_sharded on two hosts")
        n_distinct = len(c2["uniq"])
        for h in hs:
            if h["hist"] != [int(x) for x in c2["hist"]]:
                raise AssertionError(f"host {h['host']}: global histogram "
                                     f"!= phase 7's")
            if h["distinct"] != n_distinct or not h["ckpt_same"]:
                raise AssertionError(f"host {h['host']}: {h}")
            frac = h["resident"] / n_distinct
            if not 0.25 <= frac <= 0.75:
                raise AssertionError(f"host {h['host']} holds {frac:.3f} "
                                     f"of the spectrum")
            st, x = h["stats"], h["exchange"]
            if st["exchange_foreign_rows"] or x["foreign_rows"] or \
                    st["exchange_max_step_rows"] > \
                    st["exchange_max_step_bound"]:
                raise AssertionError(f"host {h['host']} exchanges: {st} {x}")
            num(f"phase8 host {h['host']} of 2 (gloo, CPU ranks; host time "
                f"on this machine): shard_spectrum "
                f"{h['walls']['shard_spectrum']:.2f} s, {h['resident']} of "
                f"{n_distinct} distinct rows resident ({frac:.3f}), received "
                f"{x['received_rows']} rows in {x['steps']} steps (most "
                f"{x['max_step_rows']} a step, chunk {x['chunk']}); "
                f"histogram {h['walls']['histogram']:.2f} s; "
                f"assemble_sharded {h['walls']['assemble_sharded']:.2f} s: "
                f"{st['peak_solid_rows']} of {st['global_solid']} solid rows "
                f"resident, {st['emission_rows']} emission records, "
                f"{st['exchange_rows']} rows received in "
                f"{st['exchange_steps']} exchange steps (most "
                f"{st['exchange_max_step_rows']} a step, bound "
                f"{st['exchange_max_step_bound']}); checkpoint save "
                f"{h['walls']['save']:.2f} s, load {h['walls']['load']:.2f} s")
        num(f"phase8 host-side modules on phase 7's config-2 spectrum "
            f"({n_distinct} distinct k-mers, k={k}, threshold {t}): "
            f"{hs[0]['unitigs']} unitigs, FASTA byte-equal to the "
            f"one-device assembly ({w_ref:.2f} s); two hosts {w_hosts:.2f} s "
            f"with their start; histogram == phase 7's; the sharded "
            f"checkpoint loads back equal")
        return runs
    finally:
        dmesh.LAUNCH_TIMEOUT = timeout
        shutil.rmtree(c2.get("dir", ""), ignore_errors=True)


@contextlib.contextmanager
def _stderr_to(path: str):
    """Inside the block, this process's stderr (fd 2, which the processes
    it starts inherit) goes to `path`; after it, the file is copied to the
    real stderr."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
        with open(path) as f:
            sys.stderr.write(f.read())
        sys.stderr.flush()


def _host_tags(path: str, what: str) -> set:
    """The hosts N of the port's log lines in `path`; raises where a port
    log line lacks the form `HH:MM:SS L [hostN] name: message` or where
    there is none."""
    import re

    tags, n = set(), 0
    for line in open(path):
        if " kmerax_torch" not in line or not re.match(
                r"\d\d:\d\d:\d\d [DIWEC] ", line):
            continue
        m = re.match(r"\d\d:\d\d:\d\d [DIWEC] \[host(\d+)\] "
                     r"kmerax_torch[\w.]*: ", line)
        if m is None:
            raise AssertionError(f"{what}: log line without its host: "
                                 f"{line!r}")
        tags.add(int(m.group(1)))
        n += 1
    if n == 0:
        raise AssertionError(f"{what}: no log line of the port")
    return tags


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    if sys.argv[1:2] == ["--child"]:          # _child: one JSON line
        print(json.dumps(_CHILDREN[sys.argv[2]](json.loads(sys.argv[3]))))
        return 0
    if sys.argv[1:2] == ["--turns"]:
        turns(sys.argv[2:])
        return 0
    t_start = time.perf_counter()
    t0 = t_start
    phase_toolchain()
    recs = phase_kernels()
    num(f"phase1-2 wall {time.perf_counter() - t0:.1f} s")
    paths = {}                       # path -> its own run's launches
    for i, phase in enumerate((phase_golden,
                               functools.partial(phase_config1, recs=recs),
                               phase_config3, phase_config5,
                               functools.partial(phase_bench, recs=recs),
                               phase_multihost),
                              start=3):
        workdir = tempfile.mkdtemp(prefix="kmerax_smoke_")
        t0 = time.perf_counter()
        try:
            paths.update(phase(workdir) or {})
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        num(f"phase{i} wall {time.perf_counter() - t0:.1f} s")
    for r in recs:
        # a path whose name says "minimizer" ran under that scheme only
        by_path = {p: n[r["name"]] for p, n in paths.items()
                   if ("minimizer" in p) == (r["scheme"] == "minimizer")}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    if "jax" in sys.modules or "kmerax" in sys.modules:
        raise AssertionError("the port pulled in jax or kmerax")
    num(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    say(CARD)
    say(json.dumps({"kernels": recs}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
