"""kmerax_torch command line: the subcommands of kmerax/cli.py on one
device, on a ("data", "bucket") mesh of one host, or across hosts, `bench`
included (its presets, acceptance configs, `--acceptance N --hosts M` over
M emulated hosts and the weak-scaling `--scaling --hosts 1 2 4`).

    python -m kmerax_torch.cli count --in R1.fq R2.fq --out spec/ -k 31
    python -m kmerax_torch.cli correct --in R1.fq R2.fq --out c1.fq c2.fq \\
        [--spectrum spec/] [--use-exact]
    python -m kmerax_torch.cli assemble --spectrum spec/ --out contigs.fa
    python -m kmerax_torch.cli pipeline --in R1.fq R2.fq \\
        --out-fastq c1.fq c2.fq --out-fasta contigs.fa [--validate | --k2 63]
    python -m kmerax_torch.cli align --in c1.fq c2.fq \\
        --contigs contigs.fa --out aln.tsv -k 31
    python -m kmerax_torch.cli bench --preset {count,correct,align,e2e,all}
    python -m kmerax_torch.cli bench --acceptance 2 --scale 10
    python -m kmerax_torch.cli bench --acceptance 4 --hosts 2 --device cpu
    python -m kmerax_torch.cli bench --scaling --hosts 1 2 4 --device cpu

Config precedence: defaults < --config TOML < explicit flags. `--device
cuda` (the default) raises where CUDA is absent; `--device cpu` runs the
kernels' plain versions. `--mesh-data D --mesh-bucket S` runs count,
correct, assemble and pipeline on a mesh of D·S ranks that this command
spawns, one process per device (dist/mesh.py): rank r on cuda:r over NCCL,
or on the CPU over gloo with `--device cpu`; rank 0 writes the files and
its result is printed. `align` and `bench` run on one device, as in the
JAX package (an acceptance config picks its own mesh); `bench --preset`
with mesh flags fails with a "not yet ported" error.

Multi-host: each of N hosts runs the same command with `--coordinator
HOST0:PORT --num-procs N --process-id p` (or the KMERAX_COORDINATOR,
KMERAX_NUM_PROCS, KMERAX_PROCESS_INDEX environment); each spawns its host's
D·S / N ranks (cuda:0.. of that host) and the hosts parse, correct and
align their own input shards. `align` then runs on every host too.

A spectrum directory from `count` is the JAX package's checkpoint format
(a range-sharded one writes a shard per host); either package reads the
other's. `bloom_counter = "p16"` in the `--config` TOML counts into p16
counters (two saturating 16-bit counters a word) on one device; `correct
--spectrum` and `assemble --spectrum` read the table's layout from its
length. KMERAX_TRACE_DIR=DIR writes a torch.profiler trace of the count,
correct and align stages under DIR/<stage>/ (utils/tracing.py).
"""

from __future__ import annotations

import argparse
import json
import sys

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.utils.logging import get_logger

log = get_logger("kmerax_torch.cli")

# the subcommands that run on the config's mesh (and `align` across hosts)
_MESH_CMDS = ("count", "correct", "assemble", "pipeline")


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
    p.add_argument("--shard-host-spectrum", action="store_true",
                   help="force the key-range-sharded exact spectrum "
                        "(~1/P resident rows per host; k <= 63) — already "
                        "the DEFAULT on multi-host runs")
    p.add_argument("--no-shard-host-spectrum", action="store_true",
                   help="force full spectrum replication onto every host "
                        "(small-run fast path)")
    p.add_argument("--no-wire-pack", action="store_true",
                   help="disable the 2-bit host<->device wire (io/wire.py)"
                        " — every batch uses the int8 wire")
    p.add_argument("--metrics", default=None, help="metrics.jsonl path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                        "card) or cpu")
    p.add_argument("--mesh-data", type=int, default=None,
                   help='mesh "data" axis size (DP over reads)')
    p.add_argument("--mesh-bucket", type=int, default=None,
                   help='mesh "bucket" axis size (spectrum sharding)')
    # multi-host: one CLI process per host with --coordinator host:port
    # --num-procs N --process-id P (or KMERAX_COORDINATOR /
    # KMERAX_NUM_PROCS / KMERAX_PROCESS_INDEX); each spawns its host's
    # D·S / N ranks of the mesh
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (its rank 0 listens there)")
    p.add_argument("--num-procs", type=int, default=None,
                   help="hosts of a multi-host run")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index in [0, --num-procs)")


def _hosts(args):
    """(coordinator, N, p) from the flags, else the KMERAX_* environment,
    as kmerax/dist/mesh.py::init_distributed reads them; (None, 1, 0)
    without a coordinator."""
    import os

    coordinator = args.coordinator or os.environ.get("KMERAX_COORDINATOR")
    if coordinator is None:
        return None, 1, 0
    n = args.num_procs or int(os.environ["KMERAX_NUM_PROCS"])
    p = args.process_id if args.process_id is not None \
        else int(os.environ["KMERAX_PROCESS_INDEX"])
    return coordinator, n, p


def _cfg(args) -> KmeraxConfig:
    return KmeraxConfig.load(
        args.config,
        k=args.k, threshold=args.threshold, batch_reads=args.batch_reads,
        max_read_len=args.max_read_len,
        bloom_log2_width=args.bloom_log2_width,
        exact_capacity=args.exact_capacity,
        exact_spectrum=False if args.no_exact else None,
        shard_host_spectrum=(True if args.shard_host_spectrum else
                             False if args.no_shard_host_spectrum else
                             None),
        wire_pack=False if args.no_wire_pack else None,
        mesh_data=args.mesh_data, mesh_bucket=args.mesh_bucket,
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

    p = sub.add_parser("bench", help="run the benchmark harness")
    _add_common(p)
    p.add_argument("--preset", default="count",
                   choices=["count", "correct", "align", "e2e", "all"])
    p.add_argument("--reads", type=int, default=20000)
    p.add_argument("--acceptance", type=int, default=None, metavar="N",
                   help="run BASELINE.md acceptance config N (1-5) "
                        "end-to-end on simulated data")
    p.add_argument("--scale", default="1.0",
                   help="genome scale factor for --acceptance, or 'full' "
                        "for the real dataset size (config 1 = 4.6Mb)")
    p.add_argument("--scaling", action="store_true",
                   help="multi-host weak-scaling efficiency (hosts emulated "
                        "on this machine: gloo on the CPU, their own cards "
                        "on cuda)")
    p.add_argument("--hosts", type=int, nargs="+", default=None,
                   help="host counts for --scaling (default 1 2 4), or the "
                        "emulated hosts of --acceptance N")
    args = ap.parse_args(argv)

    from kmerax_torch.dist import mesh as dmesh

    cfg = _cfg(args)
    spec = dmesh.MeshSpec(cfg.mesh_data, cfg.mesh_bucket)
    coordinator, n_hosts, host = _hosts(args)
    if (spec.ndev > 1 and args.cmd in _MESH_CMDS) or (
            coordinator is not None and args.cmd in _MESH_CMDS + ("align",)):
        from kmerax_torch.pipeline.run import restore_observed, \
            with_observed

        result, obs = dmesh.launch(spec, args.device, with_observed, _run,
                                   args, coordinator=coordinator,
                                   n_hosts=n_hosts, host=host)
        restore_observed(obs)
    else:
        result = _run(args)
    print(json.dumps(result))
    return 0


def _run(args) -> dict:
    """The subcommand in this process: on the device, or on this rank of
    the current mesh."""
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.utils.cuda import resolve_device
    from kmerax_torch.utils.metrics import MetricsWriter

    cfg = _cfg(args)
    mesh = dmesh.current()
    device = resolve_device(args.device if mesh is None else mesh.device)
    if args.cmd == "pipeline":
        return _pipeline(args, cfg, device)
    if args.cmd == "bench":
        return _bench(args, cfg, device)
    m = MetricsWriter(args.metrics if dmesh.is_writer() else None)
    try:
        return _stage(args, cfg, device, m)
    finally:
        m.close()


def _stage(args, cfg: KmeraxConfig, device, m) -> dict:
    """count, correct, assemble or align: one stage, metrics into m."""
    if args.cmd == "count":
        from kmerax_torch.pipeline.checkpoint import save_state
        from kmerax_torch.pipeline.count import run_count

        state = run_count(cfg, args.inputs, metrics=m, device=device)
        save_state(args.out, state, extra={"n_reads": state.n_reads,
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


def _bench(args, cfg: KmeraxConfig, device) -> dict:
    """An acceptance config (which sizes its own config, as in the JAX
    package) or a benchmark preset on the CLI's config."""
    if args.scaling:
        from kmerax_torch.bench.scaling import run_scaling

        return run_scaling(host_counts=tuple(args.hosts or (1, 2, 4)),
                           device=device)
    if args.acceptance is not None and args.hosts:
        from kmerax_torch.bench.acceptance_mp import run_config_mp

        return run_config_mp(args.acceptance, scale=args.scale,
                             n_procs=args.hosts[0], device=device)
    if args.acceptance is not None:
        from kmerax_torch.bench.acceptance import run_config

        return run_config(args.acceptance, scale=args.scale, device=device)
    from kmerax_torch.bench.runners import run_preset

    if cfg.mesh_data * cfg.mesh_bucket > 1:
        raise NotImplementedError("not yet ported to kmerax_torch: bench "
                                  "--preset on a mesh")
    return run_preset(args.preset, cfg, n_reads=args.reads, device=device)


def _load_or_count(cfg: KmeraxConfig, args, m, device):
    """The count state of `correct` and `assemble`: from `--spectrum`
    (with the config saved there) or counted from `--in`. As in the JAX
    package, a checkpoint's spectrum is read from its padded exact form
    only (`exact_uniq`), never from `host_uniq`. The table is probed in
    its own counter layout: a CLI config that names the other layout
    explicitly raises (the JAX package would read the words in the CLI's
    layout); "auto" takes the table's."""
    from kmerax_torch.pipeline.checkpoint import load_spectrum, \
        state_from_checkpoint
    from kmerax_torch.pipeline.count import run_count

    if getattr(args, "spectrum", None):
        manifest, arrays = load_spectrum(args.spectrum)
        if manifest is None:
            log.error("no spectrum at %s", args.spectrum)
            sys.exit(2)
        scfg = KmeraxConfig(**manifest["config"])
        state = state_from_checkpoint(scfg, manifest, arrays, device,
                                      host_form=False)
        if cfg.bloom_counter not in ("auto", state.counter):
            raise ValueError(
                f"--spectrum {args.spectrum}: the saved bloom_table is in "
                f"the {state.counter} layout, but the config names "
                f"bloom_counter={cfg.bloom_counter!r} (the "
                f"{cfg.bloom_counter} layout)")
        return state
    if not getattr(args, "inputs", None):
        log.error("need --in reads or --spectrum dir")
        sys.exit(2)
    return run_count(cfg, args.inputs, metrics=m, device=device)


if __name__ == "__main__":
    sys.exit(main())
