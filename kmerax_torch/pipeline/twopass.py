"""Two-pass correct+assemble pipeline on one device (port of
kmerax/pipeline/twopass.py; BASELINE.md config 5).

Pass 1: count at k -> correct reads. Pass 2: re-count the corrected reads
at k2 -> unitig assembly. With a `workdir`, every count stage checkpoints
its spectrum (pipeline/checkpoint.py) and every stage writes a done-marker,
so a crashed run resumes from the last complete stage and re-runs only the
unfinished ones; the resumed output is byte-identical to an uninterrupted
run. On a mesh every rank runs the stages and rank 0 alone writes the
checkpoints and markers, each marker after its files; across hosts with a
range-sharded spectrum every host leader saves its shard, every rank waits
at the `save_{stage}` barrier, and then rank 0 alone writes the marker; a
resume loads this host's shard (`host_shard` manifests, raising on another
host count). A resumed mesh run
corrects through the replicated table ("fused"), since a checkpoint keeps
no bucket-sharded one, and a checkpoint without the replicated table
(counted past the replicate budget) refuses to resume.
"""

from __future__ import annotations

import os
from typing import Optional

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.dist import mesh as dmesh
from kmerax_torch.graph.unitig import assemble_to_fasta
from kmerax_torch.pipeline.checkpoint import load_spectrum, save_state, \
    state_from_checkpoint
from kmerax_torch.pipeline.correct import run_correct
from kmerax_torch.pipeline.count import CountState, run_count
from kmerax_torch.utils.cuda import resolve_device
from kmerax_torch.utils.logging import get_logger
from kmerax_torch.utils.metrics import MetricsWriter

log = get_logger("kmerax_torch.twopass")


def _marker(workdir: str, stage: str) -> str:
    return os.path.join(workdir, f"{stage}.done")


def _is_done(workdir: Optional[str], stage: str) -> bool:
    return workdir is not None and os.path.exists(_marker(workdir, stage))


def _mark_done(workdir: Optional[str], stage: str) -> None:
    """Write the stage done-marker through a tmp file (rank 0 of a mesh
    only: its ranks racing one os.replace on the same tmp name would
    consume each other's file)."""
    if workdir is None or not dmesh.is_writer():
        return
    tmp = _marker(workdir, stage) + ".tmp"
    with open(tmp, "w") as f:
        f.write("complete\n")
    os.replace(tmp, _marker(workdir, stage))


def _count_stage(cfg: KmeraxConfig, paths, workdir, stage: str,
                 m: MetricsWriter, device) -> CountState:
    """run_count with spectrum checkpointing + resume; a resumed state has
    its table on `device`."""
    spec_dir = workdir and os.path.join(workdir, stage)
    if _is_done(workdir, stage):
        manifest, arrays = load_spectrum(spec_dir,
                                         pid=dmesh.process_index(),
                                         n_procs=dmesh.process_count())
        if manifest is not None:
            log.info("%s: resumed from checkpoint", stage)
            if "bloom_table" not in arrays:
                raise RuntimeError(
                    f"{stage}: checkpoint has no replicated bloom table "
                    "(counted past the replicate budget) — resume by "
                    "re-counting (delete the stage marker)")
            if cfg.mesh_data * cfg.mesh_bucket > 1:
                log.info("%s: resumed state has no bucket-sharded table — "
                         "mesh correction will use the replicated table",
                         stage)
            return state_from_checkpoint(cfg, manifest, arrays, device,
                                         host_form=True)
    state = run_count(cfg, paths, metrics=m, device=device)
    if workdir is not None:
        save_state(spec_dir, state, stage=stage,
                   extra={"n_reads": state.n_reads,
                          "n_kmers": state.n_kmers})
        _mark_done(workdir, stage)
    return state


def run_two_pass(cfg: KmeraxConfig, paths, out_fastq,
                 out_fasta: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 workdir: Optional[str] = None, *, device) -> dict:
    """count(k) -> correct -> count(k2) [-> assemble] on `device` ('cuda'
    raises without a card), checkpointed into `workdir` when given."""
    if not cfg.k2:
        raise ValueError("two-pass mode needs cfg.k2 set")
    device = resolve_device(device)
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    m = MetricsWriter(metrics_path if dmesh.is_writer() else None)
    # out_fastq may be a list (paired-end R1/R2 per-file outputs)
    out_list = [out_fastq] if isinstance(out_fastq, str) else list(out_fastq)
    try:
        # pass 1: count at k, correct
        state1 = _count_stage(cfg, paths, workdir, "count_k1", m, device)
        if _is_done(workdir, "correct") and all(os.path.exists(p)
                                                for p in out_list):
            log.info("correct: resumed (output exists)")
            stats = {"reads": state1.n_reads, "resumed": True}
        else:
            stats = run_correct(cfg, paths, state1, out_fastq, metrics=m,
                                device=device)
            _mark_done(workdir, "correct")
        result = {"threshold_k1": state1.threshold, **stats}
        del state1          # frees pass 1's table before pass 2 makes its own

        # pass 2: count corrected reads at k2, assemble
        cfg2 = cfg.replace(k=cfg.k2, k2=0)
        state2 = _count_stage(cfg2, out_list, workdir, "count_k2", m, device)
        result["threshold_k2"] = state2.threshold
        if out_fasta is not None:
            if _is_done(workdir, "assemble") and os.path.exists(out_fasta):
                log.info("assemble: resumed (output exists)")
                with open(out_fasta) as f:
                    result["unitigs"] = sum(1 for ln in f
                                            if ln.startswith(">"))
            else:
                with m.stage("assemble") as st:
                    n = assemble_to_fasta(cfg2, state2, out_fasta,
                                          device=device, metrics=m)
                    st.set(unitigs=n)
                _mark_done(workdir, "assemble")
                result["unitigs"] = n
    finally:
        m.close()
    return result
