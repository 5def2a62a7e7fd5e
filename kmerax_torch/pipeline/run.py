"""Pipeline orchestrator: count -> correct [-> assemble [-> align-validate]]
on one device or on every rank of a mesh (port of
kmerax/pipeline/run.py::run_pipeline). On a mesh rank 0 alone writes the
metrics and the files, and aligns (the align stage runs on one device, as
in the JAX package); across hosts each host aligns its own shards."""

from __future__ import annotations

from typing import Optional

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.dist.mesh import is_writer, process_count
from kmerax_torch.graph.unitig import assemble_to_fasta
from kmerax_torch.pipeline import correct as _correct, count as _count
from kmerax_torch.pipeline.align import run_align
from kmerax_torch.pipeline.correct import run_correct
from kmerax_torch.pipeline.count import run_count
from kmerax_torch.utils.cuda import resolve_device
from kmerax_torch.utils.metrics import MetricsWriter


def run_pipeline(cfg: KmeraxConfig, paths, out_fastq,
                 out_fasta: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 validate: bool = False, *, device) -> dict:
    """count -> correct [-> assemble [-> align-validate]] on `device`
    ('cuda' raises without a card). out_fastq: one path, or one per input
    (paired-end R1/R2). `validate` aligns the corrected reads back to the
    contigs and only acts when out_fasta is given, as in the JAX package."""
    device = resolve_device(device)
    m = MetricsWriter(metrics_path if is_writer() else None)
    try:
        state = run_count(cfg, paths, metrics=m, device=device)
        stats = run_correct(cfg, paths, state, out_fastq, metrics=m,
                            device=device)
        result = {"threshold": state.threshold, **stats}
        if out_fasta is not None:
            # no profiler: the re-count inside opens a traced count stage
            with m.stage("assemble") as st:
                n_unitigs = assemble_to_fasta(cfg, state, out_fasta,
                                              corrected_fastq=out_fastq,
                                              device=device, metrics=m)
                st.set(unitigs=n_unitigs)
            result["unitigs"] = n_unitigs
            # one host: rank 0 aligns; across hosts every rank joins
            # the per-host align
            if validate and (is_writer() or process_count() > 1):
                corrected = out_fastq if isinstance(out_fastq, (list, tuple)) \
                    else [out_fastq]
                result["validate"] = run_align(cfg, corrected, out_fasta,
                                               metrics=m, device=device)
    finally:
        m.close()
    return result


def observed() -> dict:
    """The last run's observables: the mesh count's route retries, end
    route safety and host merges, the mesh correction's path and the
    shards this host corrected, and this process's kernel launches
    (utils/cuda.py::LAUNCHES)."""
    from kmerax_torch.utils import cuda

    return {"LAUNCHES": dict(cuda.LAUNCHES),
            "LAST_COUNT_RETRIES": _count.LAST_COUNT_RETRIES,
            "LAST_ROUTE_SAFETY": _count.LAST_ROUTE_SAFETY,
            "LAST_COUNT_FLUSHES": _count.LAST_COUNT_FLUSHES,
            "LAST_CORRECT_PATH": _correct.LAST_CORRECT_PATH,
            "LAST_CORRECT_SHARDS": _correct.LAST_CORRECT_SHARDS}


def restore_observed(obs: dict) -> None:
    """Set `observed()` of another process (a mesh's rank 0) in this one,
    so a caller reads them after a mesh run as after a local one; rank 0's
    kernel launches add to this process's counts."""
    from kmerax_torch.utils import cuda

    for name, n in obs["LAUNCHES"].items():
        cuda.LAUNCHES[name] += n
    _count.LAST_COUNT_RETRIES = obs["LAST_COUNT_RETRIES"]
    _count.LAST_ROUTE_SAFETY = obs["LAST_ROUTE_SAFETY"]
    _count.LAST_COUNT_FLUSHES = obs["LAST_COUNT_FLUSHES"]
    _correct.LAST_CORRECT_PATH = obs["LAST_CORRECT_PATH"]
    _correct.LAST_CORRECT_SHARDS = obs["LAST_CORRECT_SHARDS"]


def with_observed(fn, *args):
    """(fn(*args), observed() after it): what a mesh rank hands back
    through kmerax_torch.dist.mesh.launch."""
    return fn(*args), observed()
