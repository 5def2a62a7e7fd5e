"""kmerax_torch command line: the `pipeline` and `align` subcommands of
kmerax/cli.py on one device.

    python -m kmerax_torch.cli pipeline --in R1.fq R2.fq \\
        --out-fastq c1.fq c2.fq --out-fasta contigs.fa --validate \\
        -k 31 --device cuda
    python -m kmerax_torch.cli align --in c1.fq c2.fq \\
        --contigs contigs.fa --out aln.tsv -k 31 --device cuda

Config precedence: defaults < --config TOML < explicit flags. `--device
cuda` (the default) raises where CUDA is absent; `--device cpu` runs the
kernels' plain versions. Flags of paths not yet ported fail with a
"not yet ported" error.
"""

from __future__ import annotations

import argparse
import json
import sys

from kmerax_torch.config import KmeraxConfig

# flags of the JAX CLI whose paths the port does not have yet
_UNPORTED = ("mesh_data", "mesh_bucket", "coordinator", "num_procs",
             "process_id", "k2")


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
                 "--process-id", "--k2"):
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
    args = ap.parse_args(argv)

    used = [f"--{n.replace('_', '-')}" for n in _UNPORTED
            if getattr(args, n) not in (None, False)]
    if used:
        raise NotImplementedError(
            f"not yet ported to kmerax_torch: {', '.join(used)}")

    from kmerax_torch.pipeline.align import run_align
    from kmerax_torch.pipeline.run import run_pipeline
    from kmerax_torch.utils.metrics import MetricsWriter

    cfg = _cfg(args)
    if args.cmd == "align":
        cfg.require_ported()
        m = MetricsWriter(args.metrics)
        try:
            result = run_align(cfg, args.inputs, args.contigs,
                               out_tsv=args.out, metrics=m,
                               device=args.device)
        finally:
            m.close()
    else:
        out_fq = args.out_fastq[0] if len(args.out_fastq) == 1 \
            else list(args.out_fastq)
        result = run_pipeline(cfg, args.inputs, out_fq, args.out_fasta,
                              metrics_path=args.metrics,
                              validate=args.validate, device=args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
