"""What decides `correct`: the reference's results for a dataset, and the
numbers that compare a run's outputs with them, each of which must be 0.

Every comparison is exact: the configurations state exact k-mer counts and
outputs byte-identical to DESIGN.md's algorithms. A configuration with
`k2` is a two-pass job (`pipeline --k2`): count at k, correct, re-count the
corrected reads at k2 and assemble at k2. The control
(`control_outputs`) breaks the first of those guarantees the way a faster
count would be tempted to: it takes each distinct k-mer's count from the
counting Bloom (the least of its counters) instead of counting it exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..sim import fastq_bytes
from . import align, assemble, correct, spectrum, words

@dataclass
class CountOut:
    """One count pass: the exact spectrum, the Bloom counters (where they
    are compared), histogram, threshold and totals."""
    uniq: torch.Tensor              # (M,) int64, or (M, W) words at W > 2
    counts: torch.Tensor            # (M,) int64
    table: torch.Tensor | None
    hist: list
    threshold: int
    n_reads: int
    n_kmers: int


@dataclass
class Outputs:
    counts: list                    # CountOut of each count pass, in order
    fastq: list                     # FASTQ bytes of each corrected file
    fasta: bytes | None = None
    result: dict = field(default_factory=dict)   # edits, validate stats


def reference_outputs(ds, cfg: dict, stages: list, device) -> Outputs:
    """The results DESIGN.md's algorithms give for dataset `ds` under the
    configuration `cfg` and the job's `stages`."""
    return _outputs(ds, cfg, stages, device, exact=True)


def control_outputs(ds, cfg: dict, stages: list, device) -> Outputs:
    """The control: the reference with every spectrum count read from the
    counting Bloom instead of counted exactly."""
    return _outputs(ds, cfg, stages, device, exact=False)


def check_job(cfg: dict, stages: list) -> None:
    """Raises for a job the reference cannot follow: a two-pass job runs
    count, correct and the re-count at k2, and never validates."""
    if cfg.get("k2") and ("validate" in stages
                          or not {"count", "correct"} <= set(stages)):
        raise ValueError(f"a two-pass job (k2 = {cfg['k2']}) runs count, "
                         f"correct and [assemble], not {stages}: the CLI "
                         "does not validate two-pass jobs")


def _count(reads, cfg, device, exact: bool, bloom: bool,
           k: int) -> CountOut:
    lw, d = cfg["bloom_log2_width"], cfg["bloom_hashes"]
    sp = spectrum.count(reads, k, lw if (bloom or not exact) else None, d,
                        device)
    counts, hist, t = sp.counts, sp.hist, sp.threshold
    if not exact:
        counts = sp.table[spectrum.probes(sp.uniq, k, lw, d)].amin(-1)
        hist = spectrum.histogram(counts)
        t = spectrum.first_valley(hist)
    return CountOut(sp.uniq, counts, sp.table if bloom else None, hist, t,
                    sum(len(r) for r in reads), sp.n_kmers)


def _outputs(ds, cfg, stages, device, exact: bool) -> Outputs:
    check_job(cfg, stages)
    k = cfg["k"]
    first = _count(ds.bases, cfg, device, exact, bloom=True, k=k)
    out = Outputs([first], [])
    if "correct" not in stages:
        return out
    solid = spectrum.solid_query(first.table, k, cfg["bloom_log2_width"],
                                 cfg["bloom_hashes"], first.threshold)
    fixed = []
    edits = edited = 0
    for b, names, quals in zip(ds.bases, ds.names, ds.quals):
        f, e = correct.correct(b, solid, k, rounds=cfg["rounds"],
                               max_runs=cfg["max_runs"],
                               max_edits=cfg["max_edits"], device=device)
        f = f.cpu().numpy()
        fixed.append(f)
        out.fastq.append(fastq_bytes(names, f, quals))
        edits += int(e.sum())
        edited += int((e > 0).sum())
    out.result.update(edits=edits, edited_reads=edited)
    if cfg.get("k2"):
        # pass 2 (pipeline/twopass.py): the corrected reads at k2, whether
        # or not the job assembles
        k = cfg["k2"]
    elif "assemble" not in stages:
        return out
    recount = _count(fixed, cfg, device, exact, bloom=False, k=k)
    out.counts.append(recount)
    if "assemble" not in stages:
        return out
    seqs = assemble.unitigs(recount.uniq, recount.counts, recount.threshold,
                            k)
    out.fasta = assemble.fasta_text(seqs)
    if "validate" in stages:
        out.result["validate"] = align.validate(
            fixed, seqs, k, cfg["band"], cfg["batch_reads"], device)
    return out


def _spectrum_diff(p: CountOut, r: CountOut) -> int:
    """k-mers in one spectrum only, plus shared k-mers whose counts
    differ."""
    pu, ru = p.uniq.to(r.uniq.device), r.uniq
    if pu.shape[1:] != ru.shape[1:]:
        return pu.shape[0] + ru.shape[0]    # k-mers of another k: none shared
    if ru.dim() == 2:
        pu, ru = words.ranks(pu, ru)
    pc = p.counts.to(r.uniq.device)
    if pu.numel() == ru.numel() and torch.equal(pu, ru):
        return int((pc != r.counts).sum())
    at = torch.searchsorted(ru, pu).clamp(max=max(ru.numel() - 1, 0))
    shared = (ru[at] == pu) if ru.numel() else torch.zeros_like(pu).bool()
    n_shared = int(shared.sum())
    differ = int((pc[shared] != r.counts[at[shared]]).sum())
    return (pu.numel() - n_shared) + (ru.numel() - n_shared) + differ


def _records(fq: bytes):
    lines = fq.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return lines[0::4], lines[1::4], lines[3::4]


def _fastq_diff(p: bytes, r: bytes) -> int:
    """Records whose name, sequence or qualities differ, plus the
    difference in record counts."""
    pn, ps, pq = _records(p)
    rn, rs, rq = _records(r)
    n = min(len(pn), len(rn))
    bad = np.zeros(n, bool)
    for a, b in ((pn, rn), (ps, rs), (pq, rq)):
        bad |= np.fromiter((x != y for x, y in zip(a[:n], b[:n])), bool, n)
    return int(bad.sum()) + abs(len(pn) - len(rn))


def _fasta_diff(p: bytes, r: bytes) -> int:
    """Records (header and sequence) that differ, plus the difference in
    record counts."""
    pl, rl = p.split(b"\n"), r.split(b"\n")
    pr = list(zip(pl[0::2], pl[1::2]))
    rr = list(zip(rl[0::2], rl[1::2]))
    n = min(len(pr), len(rr))
    return sum(a != b for a, b in zip(pr[:n], rr[:n])) + abs(len(pr)
                                                              - len(rr))


def checks(prog: Outputs, ref: Outputs) -> dict:
    """{name: value}: every number compared; each must be 0."""
    out = {}
    for i, (p, r) in enumerate(zip(prog.counts, ref.counts)):
        tag = "" if i == 0 else str(i + 1)
        out[f"reads{tag}_diff"] = abs(p.n_reads - r.n_reads)
        out[f"kmers{tag}_diff"] = abs(p.n_kmers - r.n_kmers)
        out[f"spectrum{tag}_diff"] = _spectrum_diff(p, r)
        out[f"hist{tag}_diff"] = sum(a != b for a, b in zip(p.hist, r.hist))
        out[f"threshold{tag}_diff"] = abs(p.threshold - r.threshold)
        if r.table is not None:
            out[f"bloom{tag}_diff"] = (
                int((p.table.to(r.table.device).to(torch.int64)
                     != r.table).sum()) if p.table is not None
                else r.table.numel())
    out["count_passes_diff"] = abs(len(prog.counts) - len(ref.counts))
    if ref.fastq:
        out["fastq_diff"] = sum(_fastq_diff(p, r) for p, r in
                                zip(prog.fastq, ref.fastq)) + abs(
            len(prog.fastq) - len(ref.fastq))
        out["edits_diff"] = (
            abs(prog.result.get("edits", -1) - ref.result["edits"])
            + abs(prog.result.get("edited_reads", -1)
                  - ref.result["edited_reads"]))
    if ref.fasta is not None:
        out["fasta_diff"] = (_fasta_diff(prog.fasta, ref.fasta)
                             if prog.fasta is not None else 1)
    if "validate" in ref.result:
        pv, rv = prog.result.get("validate", {}), ref.result["validate"]
        out["aligned_diff"] = abs(pv.get("aligned", -1) - rv["aligned"])
        out["identity_diff"] = round(abs(pv.get("mean_identity", -1.0)
                                         - rv["mean_identity"]) * 1e4)
    return out
