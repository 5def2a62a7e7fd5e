#!/usr/bin/env python3
"""Smoke test of the kmerax_torch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package (`kmerax/`); the numpy-only
oracle (`oracle/`) and simulator (`tests/sim.py`) are the witnesses.

  1. device and toolchain: card name and power limit, torch/CUDA/nvcc
     versions; builds the CUDA kernels from kmerax_torch/csrc.
  2. each kernel (K1 bloom_insert, K2 bloom_query_solid, K3
     correct_eval_scores, K4 banded_align_scores) against its plain
     PyTorch version on the card at its path's shapes: exact integer
     equality (tolerance 0, all outputs are integers), and the median time
     of each over 20 runs (K4 and its plain version: the event time per
     call over back-to-back calls, the kernel's own device time).
  3. a small golden: the port's pipeline on the card must write corrected
     FASTQ and unitig FASTA bytes equal to the oracle's, and the `align`
     subcommand a TSV whose every row equals oracle.align.validate_read.
  4. BASELINE config 1 at full scale (E. coli K-12 size genome, PE150,
     50x, error rate 0.01, k=31; 2^29-counter Bloom table) through the CLI
     entry point, with launch counts of every kernel, stage rates and
     correction accuracy against the simulated truth.
  5. BASELINE config 3 (human chr21 PE150 30x, error rate 0.005, k=31,
     correct + assemble) on a 6.0 Mb genome, through `pipeline --validate`
     and then the `align` subcommand, with stage walls, launch counts,
     correction accuracy and the validate stats held to their bars.

Every failure raises. The last line is {"ok": true, "device": {...}}.
Exits nonzero without printing a result where CUDA is absent.
"""

from __future__ import annotations

import contextlib
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
C1_GENOME = 4_641_652
C1_COVERAGE = 50
C1_ERROR = 0.01
C1_ARGS = ["-k", "31", "--bloom-log2-width", "29",
           "--exact-capacity", str(1 << 27), "--batch-reads", "4096",
           "--max-read-len", "160"]
# BASELINE config 3 (acceptance.py CONFIGS[3]) at the size of
# ACCEPTANCE_full_c3.json: a 6,000,000 bp genome (chr21 is 46,709,983 bp;
# the cut keeps the smoke inside its time limit), PE150, 30x, error 0.005,
# k=31, 1,200,000 reads. acceptance.py's rule: distinct = G + n*150*0.005*31
# = 33,900,000, so exact_capacity 2^26 and a 2^28-counter Bloom table.
C3_GENOME = 6_000_000
C3_COVERAGE = 30
C3_ERROR = 0.005
C3_ARGS = ["-k", "31", "--bloom-log2-width", "28",
           "--exact-capacity", str(1 << 26), "--batch-reads", "4096",
           "--max-read-len", "160"]
SEED = 42
READ_LEN = 150
# the kernels of count -> correct -> assemble (phase 4); K4 runs only on
# the align-validate path (phase 5)
MAIN_PATH_KERNELS = ("bloom_insert", "bloom_query_solid",
                     "correct_eval_scores")

CARD = ""          # "name, power limit" of the card, set in phase 1


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


def phase_kernels(device="cuda"):
    """Kernel == plain version at main-path shapes. Returns the kernel
    records of the final JSON line (without launch counts)."""
    import numpy as np
    import torch
    from kmerax_torch.core.codec import canonical_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.ops.correct_kernels import correct_eval_scores, \
        eval_scores_plain
    from kmerax_torch.spectrum.bloom import BloomParams, blocks_lanepack, \
        make_table
    from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
        bloom_query_solid, insert_plain, query_solid_plain

    sync = torch.cuda.synchronize
    rng = np.random.default_rng(SEED)
    B, L, LW, d = 4096, 160, 29, 4

    def addressing(params, reads):
        bases = torch.as_tensor(reads, device=device)
        words, valid = extract_kmers(bases, params.k)
        canon, _ = canonical_words(words, params.k)
        block, lp = blocks_lanepack(params, canon)
        return block.reshape(-1), lp.reshape(-1), valid.reshape(-1)

    recs = []
    # K1: one 4096 x 160 batch at k=31 (532,480 k-mers) into 2^29 counters
    p31 = BloomParams(31, LW, d)
    reads, lengths = _reads(rng, B, L, 31)
    blk, lp, valid = addressing(p31, reads)
    tk = make_table(p31, device)
    bloom_insert(tk, blk, lp, valid, d)
    sync()
    tp = make_table(p31, device)
    insert_plain(tp, blk, lp, valid, d)
    sync()
    err = int((tk - tp).abs().max())
    if not torch.equal(tk, tp):
        raise AssertionError(f"K1 table differs from plain (max {err})")
    ms = _median_ms(lambda: bloom_insert(tk, blk, lp, valid, d))
    pms = _median_ms(lambda: insert_plain(tp, blk, lp, valid, d))
    num(f"phase2 K1 bloom_insert == plain: {blk.numel()} k-mers into "
        f"2^{LW} counters, table bytes equal; kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    recs.append(dict(name="bloom_insert", route="cuda",
                     source="kmerax_torch/csrc/bloom.cu",
                     replaces="kmerax/spectrum/pallas_bloom.py:42",
                     max_abs_err=err, ms=ms, plain_ms=pms))
    del tp

    # K2: the same k-mers plus an unseen batch against that table at t=3
    reads2, _ = _reads(rng, B, L, 31)
    blk2, lp2, valid2 = addressing(p31, reads2)
    qb, ql, qv = (torch.cat([blk, blk2]), torch.cat([lp, lp2]),
                  torch.cat([valid, valid2]))
    sk = bloom_query_solid(tk, qb, ql, qv, d, 3)
    sync()
    sp = query_solid_plain(tk, qb, ql, qv, d, 3)
    sync()
    err = int((sk.to(torch.int32) - sp.to(torch.int32)).abs().max())
    if not torch.equal(sk, sp):
        raise AssertionError("K2 solidity differs from plain")
    n_solid = int(sk.sum())
    if not 0 < n_solid < qb.numel():
        raise AssertionError(f"K2 test is degenerate: {n_solid} solid")
    ms = _median_ms(lambda: bloom_query_solid(tk, qb, ql, qv, d, 3))
    pms = _median_ms(lambda: query_solid_plain(tk, qb, ql, qv, d, 3))
    num(f"phase2 K2 bloom_query_solid == plain: {qb.numel()} k-mers, "
        f"{n_solid} solid at t=3; kernel {ms:.4f} ms, plain {pms:.4f} ms")
    recs.append(dict(name="bloom_query_solid", route="cuda",
                     source="kmerax_torch/csrc/bloom.cu",
                     replaces="kmerax/spectrum/pallas_bloom.py:190",
                     max_abs_err=err, ms=ms, plain_ms=pms))

    # K3: Q = 4096 x max_cands = 16,384 entries per k, with negative window
    # starts (positions < k-1), padding entries (-1) and reads with N
    k3 = None
    for k in (25, 31, 63):
        pk = BloomParams(k, LW, d)
        reads, lengths = _reads(rng, B, L, k)
        blk, lp, valid = addressing(pk, reads)
        tk.zero_()
        for _ in range(3):
            bloom_insert(tk, blk, lp, valid, d)
        bases = torch.as_tensor(reads, device=device)
        lens = torch.as_tensor(lengths, device=device)
        last_j = lens - k
        Q = 4 * B
        ent_r = torch.as_tensor(rng.integers(0, B, Q).astype(np.int32),
                                device=device)
        ent_i = rng.integers(0, L, Q).astype(np.int32)
        ent_i[:Q // 16] = -1
        ent_i[Q // 16:Q // 8] = rng.integers(0, k - 1, Q // 16)
        ent_i = torch.as_tensor(ent_i, device=device)
        args = (pk, tk, 3, bases, lens, last_j, ent_r, ent_i)
        sk = correct_eval_scores(*args)
        sync()
        sp = eval_scores_plain(*args)
        sync()
        err = int((sk - sp).abs().max())
        if not torch.equal(sk, sp):
            raise AssertionError(f"K3 scores differ from plain at k={k}")
        if int(sk.sum()) == 0:
            raise AssertionError(f"K3 test is degenerate at k={k}")
        ms = _median_ms(lambda: correct_eval_scores(*args))
        pms = _median_ms(lambda: eval_scores_plain(*args))
        num(f"phase2 K3 correct_eval_scores == plain at k={k}: {Q} entries,"
            f" score sum {int(sk.sum())}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms")
        if k == 31 or k3 is None:
            k3 = dict(name="correct_eval_scores", route="cuda",
                      source="kmerax_torch/csrc/correct.cu",
                      replaces="kmerax/ops/pallas_correct.py:74",
                      max_abs_err=err, ms=ms, plain_ms=pms)
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
    recs.append(k3)
    del tk
    torch.cuda.empty_cache()
    recs.append(_check_k4(rng, device))
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
    """K4 at the align stage's shapes (4096 reads x 160) at the default
    band 15 and the widest band 63 (W = 127)."""
    import torch
    from kmerax_torch.ops.align_kernels import NEG_INF, \
        banded_align_scores, banded_align_scores_plain as align_plain

    rec = None
    for band in (15, 63):
        args = [torch.as_tensor(a, device=device)
                for a in _align_inputs(rng, 4096, 160, band)]
        sk = banded_align_scores(*args, band)
        torch.cuda.synchronize()
        sp = align_plain(*args, band)
        torch.cuda.synchronize()
        err = int((sk.to(torch.int64) - sp.to(torch.int64)).abs().max())
        if not torch.equal(sk, sp):
            raise AssertionError(f"K4 scores differ from plain at band {band}")
        n_pos, n_inf = int((sk > 0).sum()), int((sk == NEG_INF).sum())
        if not (n_pos > 2048 and n_inf > 0):
            raise AssertionError(f"K4 test is degenerate at band {band}: "
                                 f"{n_pos} positive, {n_inf} NEG_INF")
        ms, host = _per_launch_ms(lambda: banded_align_scores(*args, band))
        pms, phost = _per_launch_ms(lambda: align_plain(*args, band), 10)
        wms = _median_ms(lambda: banded_align_scores(*args, band))
        num(f"phase2 K4 banded_align_scores == plain at band {band}: 4096 "
            f"reads x 160, {n_pos} positive, {n_inf} NEG_INF; kernel "
            f"{ms:.4f} ms per launch back to back (host {host:.4f} ms per "
            f"call), one wrapper call {wms:.4f} ms median; plain {pms:.4f} "
            f"ms per call (host {phost:.4f} ms)")
        if rec is None:
            rec = dict(name="banded_align_scores", route="cuda",
                       source="kmerax_torch/csrc/align.cu",
                       replaces="kmerax/ops/pallas_align.py:49",
                       max_abs_err=err, ms=ms, plain_ms=pms)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


# ---------------------------------------------------------------- phase 3

def phase_golden(workdir: str, device="cuda"):
    """tests/golden/test_pipeline.py's dataset and config through the
    port's run_pipeline; FASTQ and FASTA bytes equal to the oracle's."""
    import oracle
    from sim import ecoli_like, make_fastq
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.pipeline.run import run_pipeline

    cfg = KmeraxConfig(k=31, bloom_log2_width=18, bloom_hashes=4,
                       batch_reads=128, max_read_len=100,
                       exact_capacity=1 << 17)
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    path = os.path.join(workdir, "golden.fastq")
    with open(path, "wb") as f:
        f.write(make_fastq(reads))
    out_fq = os.path.join(workdir, "golden.corrected.fastq")
    out_fa = os.path.join(workdir, "golden.fasta")
    res = run_pipeline(cfg, [path], out_fq, out_fa, device=device)

    k = cfg.k
    sp = oracle.ExactSpectrum(k)
    sp.add_reads([r.bases for r in reads])
    t = oracle.auto_threshold(oracle.histogram_of(sp.sorted_items()[1]))
    if res["threshold"] != t:
        raise AssertionError(f"threshold {res['threshold']} != oracle {t}")
    obl = oracle.CountingBloomOracle(k, log2_width=cfg.bloom_log2_width,
                                     num_hashes=cfg.bloom_hashes)
    obl.add_reads([r.bases for r in reads])
    buf = io.BytesIO()
    fixed_all = []
    for r in reads:
        fixed = oracle.correct_read(r.bases, k, t, obl.query)
        fixed_all.append(fixed)
        buf.write(f"@{r.name}\n{oracle.bases_to_seq(fixed)}\n+\n{r.qual}\n"
                  .encode())
    with open(out_fq, "rb") as f:
        if f.read() != buf.getvalue():
            raise AssertionError("golden FASTQ differs from the oracle's")
    csp = oracle.ExactSpectrum(k)
    csp.add_reads(fixed_all)
    ct = oracle.auto_threshold(oracle.histogram_of(csp.sorted_items()[1]))
    want = oracle.assemble_fasta(csp, ct, k).encode()
    with open(out_fa, "rb") as f:
        if f.read() != want:
            raise AssertionError("golden FASTA differs from the oracle's")
    say(f"phase3 golden: {len(reads)} reads, threshold {t}, "
        f"{res['edited_reads']} edited, {res['unitigs']} unitig(s); "
        f"FASTQ and FASTA bytes equal to the oracle's")

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


def phase_config1(workdir: str, coverage: int = C1_COVERAGE):
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
        fasta, "--metrics", metrics, "--device", "cuda", *C1_ARGS])
    launches = dict(cuda.LAUNCHES)
    _print_stages("phase4", _stages(metrics))
    num(f"phase4 end to end: {wall:.2f} s, {n_reads / wall:.1f} reads/s; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    num(f"phase4 kernel launches on the main path: {launches}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")

    before, after, introduced, gain = _accuracy(outs, noisy, truth, seq_off)
    num(f"phase4 accuracy: errors_before {before}, errors_remaining "
        f"{after}, errors_introduced {introduced}, gain {gain:.4f}")
    if introduced != 0:
        raise AssertionError(f"{introduced} errors introduced")
    if gain < 0.9:
        raise AssertionError(f"gain {gain:.4f} < 0.9")
    if result["unitigs"] <= 0 or result["reads"] != n_reads:
        raise AssertionError(f"bad pipeline result {result}")
    return {"config1_pipeline": launches}


# ---------------------------------------------------------------- phase 5

def phase_config3(workdir: str):
    """Config 3 through `pipeline --validate`, then the same corrected reads
    and contigs through the `align` subcommand. Returns each run's own
    launches."""
    import torch
    from kmerax_torch.utils import cuda

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
        fasta, "--validate", "--metrics", metrics, "--device", "cuda",
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched")

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
        "align", "--in", *outs, "--contigs", fasta, "--device", "cuda",
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    t_start = time.perf_counter()
    phase_toolchain()
    recs = phase_kernels()
    paths = {}                       # path -> its own run's launches
    for phase in (phase_golden, phase_config1, phase_config3):
        workdir = tempfile.mkdtemp(prefix="kmerax_smoke_")
        try:
            paths.update(phase(workdir) or {})
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    for r in recs:
        by_path = {p: n[r["name"]] for p, n in paths.items()}
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
