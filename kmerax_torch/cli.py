"""kmerax_torch command line: the single-device subcommands of
kmerax/cli.py (all but `bench`) on one device.

    python -m kmerax_torch.cli count --in R1.fq R2.fq --out spec/ -k 31
    python -m kmerax_torch.cli correct --in R1.fq R2.fq --out c1.fq c2.fq \\
        [--spectrum spec/] [--use-exact]
    python -m kmerax_torch.cli assemble --spectrum spec/ --out contigs.fa
    python -m kmerax_torch.cli pipeline --in R1.fq R2.fq \\
        --out-fastq c1.fq c2.fq --out-fasta contigs.fa [--validate | --k2 63]
    python -m kmerax_torch.cli align --in c1.fq c2.fq \\
        --contigs contigs.fa --out aln.tsv -k 31

Config precedence: defaults < --config TOML < explicit flags. `--device
cuda` (the default) raises where CUDA is absent; `--device cpu` runs the
kernels' plain versions. Flags of paths not yet ported (mesh, multi-host)
fail with a "not yet ported" error. A spectrum directory from `count` is
the JAX package's checkpoint format; either package reads the other's.
"""

from __future__ import annotations

import argparse
import json
import sys

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.utils.logging import get_logger

log = get_logger("kmerax_torch.cli")

# flags of the JAX CLI whose paths the port does not have yet
_UNPORTED = ("mesh_data", "mesh_bucket", "coordinator", "num_procs",
             "process_id")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", help="TOML config file")
    p.add_argument("-k", type=int, default=None, help="k-mer size (odd, <=63)")
    p.add_argument("--threshold", type=int, default=None,
                   help="solid threshold (default: auto from histogram)")
    p.add_argument("--batch-reads", type=int, default=None)
    p.add_argument("--max-read-len", type=int, default=None)
    p.add_argument("--bloom-log2-width", type=int, default=None)
    p.add_argument("--exact-capacity", type=int, default=None)
    p.add_argument("--no-exact", action="store_true",
                   help="skip the exact spectrum (needs --threshold)")
    p.add_argument("--no-wire-pack", action="store_true",
                   help="accepted for compatibility: batches always cross "
                        "as int8 (the 2-bit wire is not ported)")
    p.add_argument("--metrics", default=None, help="metrics.jsonl path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                        "card) or cpu")
    for flag in ("--mesh-data", "--mesh-bucket", "--num-procs",
                 "--process-id"):
        p.add_argument(flag, type=int, default=None, help="not yet ported")
    p.add_argument("--coordinator", default=None, help="not yet ported")


def _cfg(args) -> KmeraxConfig:
    return KmeraxConfig.load(
        args.config,
        k=args.k, threshold=args.threshold, batch_reads=args.batch_reads,
        max_read_len=args.max_read_len,
        bloom_log2_width=args.bloom_log2_width,
        exact_capacity=args.exact_capacity,
        exact_spectrum=False if args.no_exact else None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kmerax_torch",
        description="k-mer counting, correction & assembly on one GPU "
                    "(PyTorch/CUDA port of kmerax)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("count", help="k-mer count pass; saves a spectrum dir")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--out", required=True, help="spectrum output directory")

    p = sub.add_parser("correct", help="error-correct reads")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--out", required=True, nargs="+",
                   help="corrected FASTQ path(s); give one per input for "
                        "paired-end R1/R2 outputs")
    p.add_argument("--spectrum", help="spectrum dir from `count` (else "
                                      "counts first)")
    p.add_argument("--use-exact", action="store_true",
                   help="query the exact spectrum instead of the Bloom")

    p = sub.add_parser("assemble", help="unitig assembly to FASTA")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+",
                   help="reads to (re)count for the graph")
    p.add_argument("--spectrum", help="spectrum dir from `count`")
    p.add_argument("--out", required=True, help="contig FASTA path")

    p = sub.add_parser("align", help="seed-extend align/validate reads "
                                     "against contigs (DESIGN.md 10b)")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--contigs", required=True, help="contig FASTA")
    p.add_argument("--out", default=None, help="per-read TSV "
                   "(name, found, strand, pos, score, identity)")

    p = sub.add_parser("pipeline", help="count+correct(+assemble) end to end")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--out-fastq", required=True, nargs="+",
                   help="one path, or one per input file (paired-end R1/R2)")
    p.add_argument("--out-fasta", default=None)
    p.add_argument("--validate", action="store_true",
                   help="after assemble: seed-extend align corrected reads "
                        "back to the contigs and report identity")
    p.add_argument("--k2", type=int, default=None,
                   help="second-pass k for correct+assemble (BASELINE "
                        "config 5)")
    args = ap.parse_args(argv)

    used = [f"--{n.replace('_', '-')}" for n in _UNPORTED
            if getattr(args, n) not in (None, False)]
    if used:
        raise NotImplementedError(
            f"not yet ported to kmerax_torch: {', '.join(used)}")

    from kmerax_torch.utils.cuda import resolve_device
    from kmerax_torch.utils.metrics import MetricsWriter

    cfg = _cfg(args)
    cfg.require_ported()
    device = resolve_device(args.device)
    if args.cmd == "pipeline":
        result = _pipeline(args, cfg, device)
    else:
        m = MetricsWriter(args.metrics)
        try:
            result = _stage(args, cfg, device, m)
        finally:
            m.close()
    print(json.dumps(result))
    return 0


def _stage(args, cfg: KmeraxConfig, device, m) -> dict:
    """count, correct, assemble or align: one stage, metrics into m."""
    if args.cmd == "count":
        from kmerax_torch.pipeline.checkpoint import save_spectrum
        from kmerax_torch.pipeline.count import run_count

        state = run_count(cfg, args.inputs, metrics=m, device=device)
        save_spectrum(args.out, state, extra={"n_reads": state.n_reads,
                                              "n_kmers": state.n_kmers})
        return {"reads": state.n_reads, "kmers": state.n_kmers,
                "threshold": state.threshold}
    if args.cmd == "correct":
        from kmerax_torch.pipeline.correct import run_correct

        state = _load_or_count(cfg, args, m, device)
        out = args.out if len(args.out) > 1 else args.out[0]
        stats = run_correct(cfg, args.inputs, state, out, metrics=m,
                            device=device, use_exact=args.use_exact)
        return {"threshold": state.threshold, **stats}
    if args.cmd == "assemble":
        from kmerax_torch.graph.unitig import assemble_to_fasta

        state = _load_or_count(cfg, args, m, device)
        n = assemble_to_fasta(cfg, state, args.out, device=device)
        return {"unitigs": n, "threshold": state.threshold}
    from kmerax_torch.pipeline.align import run_align

    return run_align(cfg, args.inputs, args.contigs, out_tsv=args.out,
                     metrics=m, device=device)


def _pipeline(args, cfg: KmeraxConfig, device) -> dict:
    out_fq = args.out_fastq[0] if len(args.out_fastq) == 1 \
        else list(args.out_fastq)
    if args.k2:
        # as in the JAX package: no workdir, and --validate is not run
        from kmerax_torch.pipeline.twopass import run_two_pass

        return run_two_pass(cfg.replace(k2=args.k2), args.inputs, out_fq,
                            args.out_fasta, metrics_path=args.metrics,
                            device=device)
    from kmerax_torch.pipeline.run import run_pipeline

    return run_pipeline(cfg, args.inputs, out_fq, args.out_fasta,
                        metrics_path=args.metrics, validate=args.validate,
                        device=device)


def _load_or_count(cfg: KmeraxConfig, args, m, device):
    """The count state of `correct` and `assemble`: from `--spectrum`
    (with the config saved there) or counted from `--in`. As in the JAX
    package, a checkpoint's spectrum is read from its padded exact form
    only (`exact_uniq`), never from `host_uniq`."""
    from kmerax_torch.pipeline.checkpoint import load_spectrum, \
        state_from_checkpoint
    from kmerax_torch.pipeline.count import run_count

    if getattr(args, "spectrum", None):
        manifest, arrays = load_spectrum(args.spectrum)
        if manifest is None:
            log.error("no spectrum at %s", args.spectrum)
            sys.exit(2)
        scfg = KmeraxConfig(**manifest["config"])
        return state_from_checkpoint(scfg, manifest, arrays, device,
                                     host_form=False)
    if not getattr(args, "inputs", None):
        log.error("need --in reads or --spectrum dir")
        sys.exit(2)
    return run_count(cfg, args.inputs, metrics=m, device=device)


if __name__ == "__main__":
    sys.exit(main())
