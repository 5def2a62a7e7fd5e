"""Pipeline orchestrator: count -> correct -> assemble on one device (port
of kmerax/pipeline/run.py::run_pipeline; align-validate is not ported)."""

from __future__ import annotations

from typing import Optional

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.graph.unitig import assemble_to_fasta
from kmerax_torch.pipeline.correct import run_correct
from kmerax_torch.pipeline.count import run_count
from kmerax_torch.utils.cuda import resolve_device
from kmerax_torch.utils.metrics import MetricsWriter


def run_pipeline(cfg: KmeraxConfig, paths, out_fastq,
                 out_fasta: Optional[str] = None,
                 metrics_path: Optional[str] = None, *, device) -> dict:
    """count -> correct [-> assemble] on `device` ('cuda' raises without a
    card). out_fastq: one path, or one per input (paired-end R1/R2)."""
    cfg.require_ported()
    device = resolve_device(device)
    m = MetricsWriter(metrics_path)
    try:
        state = run_count(cfg, paths, metrics=m, device=device)
        stats = run_correct(cfg, paths, state, out_fastq, metrics=m,
                            device=device)
        result = {"threshold": state.threshold, **stats}
        if out_fasta is not None:
            m.stage_start("assemble")
            n_unitigs = assemble_to_fasta(cfg, state, out_fasta,
                                          corrected_fastq=out_fastq,
                                          device=device, metrics=m)
            m.stage_end("assemble", unitigs=n_unitigs)
            result["unitigs"] = n_unitigs
    finally:
        m.close()
    return result
