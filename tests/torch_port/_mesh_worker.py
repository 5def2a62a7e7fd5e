"""One rank of a kmerax_torch mesh run for the tests, in a process of its
own:

    python _mesh_worker.py RANK WORLD INIT_METHOD JOB_JSON

It joins the mesh the job names (gloo on the CPU) through
kmerax_torch.dist.mesh.init_mesh and runs the job's steps in order on this
rank; each step writes its results under the job's `out` directory. It
imports kmerax_torch, torch and numpy only: the tests hold what it writes
against the JAX package in their own process.

Steps ("kind"):
  count     run_count on the config; rank 0 saves the table, the host
            spectrum, histogram, threshold, the route observables and its
            host merges
  pipeline  run_pipeline (count, correct, assemble); rank 0 saves the
            stage results and the correct path
  twopass   run_two_pass with a checkpoint workdir; rank 0 saves the
            result, or with "catch" the error's message
  remove    rank 0 deletes the listed paths; then every rank waits
  route     this rank's k-mers (from an .npz the test wrote) through
            route_prep, the all-to-all and route_back; every rank saves
            what it sent, received and got back
  correct   run_count, then run_correct to `out_fastq` (one path or a
            list); rank 0 saves the stats and the correct path, each host
            leader the shards its host corrected
  align     run_align of `paths` against `contigs` into `out_tsv`; rank 0
            saves the stats
  shardspec run_count, then graph/sharded.py::assemble_sharded on the host
            leaders with small partitions and chunks; each leader saves its
            resident rows, the exchanges' counts and LAST_STATS, and with
            `ckpt` its shard of the spectrum checkpoint first
            (`spectrum_chunk` sets shard_spectrum's rows a step)
  emptyrange assemble_sharded of a 1,500 bp genome's k-mers, all held by
            host 0 (host 1's key range is empty)
  assemble_ckpt  this host's shard of a sharded checkpoint (load_spectrum
            with this host's geometry), then assemble_to_fasta
A job's `budget` replaces REPLICATE_TABLE_BUDGET before its steps, and its
`hosts` (default 1) is the number of hosts the world splits into.
"""

import json
import os
import sys

import numpy as np
import torch


def _cfg(step, mesh):
    """The step's config on the job's mesh."""
    from kmerax_torch.config import KmeraxConfig

    return KmeraxConfig(**step["cfg"], mesh_data=mesh.spec.data,
                        mesh_bucket=mesh.spec.bucket)


def _count(step, mesh, out):
    import kmerax_torch.pipeline.count as count

    cfg = _cfg(step, mesh)
    state = count.run_count(cfg, step["paths"], device="cpu")
    if mesh.n_hosts > 1:
        if mesh.is_leader:
            _save_json(out, f"{step['name']}_h{mesh.host}", {
                "host": type(state.host).__name__,
                "threshold": state.threshold,
                "hist": [int(x) for x in state.hist]})
        return
    if mesh.rank == 0:
        table = state.bloom_table
        np.savez(os.path.join(out, f"{step['name']}.npz"),
                 table=np.zeros(0, np.int32) if table is None
                 else table.numpy(),
                 has_table=table is not None,
                 uniq=state.host.uniq, counts=state.host.counts,
                 hist=state.hist, threshold=state.threshold,
                 n_reads=state.n_reads, n_kmers=state.n_kmers,
                 retries=count.LAST_COUNT_RETRIES,
                 safety=count.LAST_ROUTE_SAFETY,
                 flushes=count.LAST_COUNT_FLUSHES)


def _pipeline(step, mesh, out):
    import kmerax_torch.pipeline.correct as correct
    from kmerax_torch.pipeline.run import run_pipeline

    cfg = _cfg(step, mesh)
    res = run_pipeline(cfg, step["paths"], step["out_fastq"],
                       step["out_fasta"], device="cpu")
    if mesh.rank == 0:
        with open(os.path.join(out, f"{step['name']}.json"), "w") as f:
            json.dump({"result": res, "path": correct.LAST_CORRECT_PATH}, f)


def _twopass(step, mesh, out):
    from kmerax_torch.pipeline.twopass import run_two_pass

    cfg = _cfg(step, mesh)
    try:
        res = run_two_pass(cfg, step["paths"], step["out_fastq"],
                           step["out_fasta"], workdir=step["workdir"],
                           device="cpu")
    except RuntimeError as e:
        if not step.get("catch"):
            raise
        res = {"error": str(e)}
    if mesh.rank == 0:
        with open(os.path.join(out, f"{step['name']}.json"), "w") as f:
            json.dump(res, f)


def _remove(step, mesh, out):
    if mesh.rank == 0:
        for p in step["paths"]:
            os.remove(p)
    mesh.barrier()


def _route(step, mesh, out):
    from kmerax_torch.pipeline.count import bloom_params
    from kmerax_torch.spectrum.sharded import ShardedParams, route, \
        route_back

    cfg = _cfg(step, mesh)
    sp = ShardedParams(bloom_params(cfg, cfg.k), n_shards=mesh.spec.bucket,
                       route_safety=step["route_safety"])
    with np.load(step["kmers"]) as z:
        canon = torch.from_numpy(z["canon"][mesh.rank].astype(np.int64))
        valid = torch.from_numpy(z["valid"][mesh.rank])
    recv, rvalid, overflow, meta = route(canon, valid, sp,
                                         mesh.bucket_group)
    order, slot, ok, _ = meta
    sent = torch.zeros_like(ok)
    sent[order] = ok
    back = route_back(recv[:, 0].contiguous(), meta, mesh.bucket_group)
    np.savez(os.path.join(out, f"{step['name']}_r{mesh.rank}.npz"),
             recv=recv.numpy().view(np.uint32), rvalid=rvalid.numpy(),
             overflow=int(overflow), sent=sent.numpy(),
             back=back.numpy().view(np.uint32))


def _save_json(out, name, obj):
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(obj, f)


def _correct(step, mesh, out):
    import kmerax_torch.pipeline.correct as correct
    from kmerax_torch.pipeline.count import run_count

    cfg = _cfg(step, mesh)
    state = run_count(cfg, step["paths"], device="cpu")
    stats = correct.run_correct(cfg, step["paths"], state, step["out_fastq"],
                                device="cpu")
    if mesh.is_leader:
        _save_json(out, f"{step['name']}_h{mesh.host}", {
            "stats": stats, "path": correct.LAST_CORRECT_PATH,
            "shards": correct.LAST_CORRECT_SHARDS})


def _align(step, mesh, out):
    from kmerax_torch.pipeline.align import run_align

    stats = run_align(_cfg(step, mesh), step["paths"], step["contigs"],
                      step["out_tsv"], device="cpu")
    if mesh.rank == 0:
        _save_json(out, step["name"], stats)


def _shardspec(step, mesh, out):
    import kmerax_torch.graph.sharded as gs
    import kmerax_torch.spectrum.host_sharded as hs
    from kmerax_torch.pipeline.count import run_count

    cfg = _cfg(step, mesh)
    hs.EXCHANGE_CHUNK = step.get("spectrum_chunk", hs.EXCHANGE_CHUNK)
    state = run_count(cfg, step["paths"], device="cpu")
    if not mesh.is_leader:
        return
    host = state.host
    n_local, n_global = host.n_unique_local, host.n_unique
    exchange = dict(hs.LAST_EXCHANGE)
    if step.get("ckpt"):
        from kmerax_torch.pipeline.checkpoint import save_spectrum

        save_spectrum(step["ckpt"], state)
    n = gs.assemble_sharded(host, state.threshold, cfg.k,
                            os.path.join(out, f"{step['name']}.fasta"),
                            device="cpu", partition_rows=256,
                            chunk=step.get("chunk", 1 << 12))
    _save_json(out, f"{step['name']}_h{mesh.host}", {
        "resident": n_local, "distinct": n_global, "exchange": exchange,
        "stats": dict(gs.LAST_STATS), "unitigs": n,
        "threshold": state.threshold})


def _emptyrange(step, mesh, out):
    from kmerax_torch.core.codec import canonical_words
    from kmerax_torch.core.kmers import extract_kmers
    from kmerax_torch.graph.sharded import assemble_sharded
    from kmerax_torch.spectrum.exact import np_merge_counted
    from kmerax_torch.spectrum.host import HostSpectrum
    from kmerax_torch.spectrum.host_sharded import ShardedHostSpectrum

    k = 31
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 1500).astype(np.int32)
    words, valid = extract_kmers(torch.from_numpy(genome[None]), k)
    canon, _ = canonical_words(words, k)
    rows = canon[0][valid[0]].numpy().astype(np.uint32)
    uniq, counts = np_merge_counted(rows, np.ones(len(rows), np.int64))
    if mesh.host == 0:                 # host 0 owns everything
        local = HostSpectrum(uniq, counts, k)
    else:
        local = HostSpectrum(np.zeros((0, 2), np.uint32),
                             np.zeros(0, np.int64), k)
    if mesh.is_leader:
        shost = ShardedHostSpectrum(local, k, mesh.n_hosts, mesh.host,
                                    np.full(mesh.n_hosts - 1,
                                            0xFFFFFFFFFFFFFFFF, np.uint64))
        n = assemble_sharded(shost, 1, k,
                             os.path.join(out, f"{step['name']}.fasta"),
                             device="cpu", partition_rows=128,
                             chunk=1 << 10)
        _save_json(out, f"{step['name']}_h{mesh.host}", {"unitigs": n})


def _assemble_ckpt(step, mesh, out):
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.graph.unitig import assemble_to_fasta
    from kmerax_torch.pipeline.checkpoint import load_spectrum, \
        state_from_checkpoint

    manifest, arrays = load_spectrum(step["dir"], mesh.host, mesh.n_hosts)
    cfg = KmeraxConfig(**manifest["config"]).replace(
        mesh_data=mesh.spec.data, mesh_bucket=mesh.spec.bucket)
    state = state_from_checkpoint(cfg, manifest, arrays, "cpu",
                                  host_form=True)
    n = assemble_to_fasta(cfg, state, step["out_fasta"], device="cpu")
    if mesh.is_leader:
        _save_json(out, f"{step['name']}_h{mesh.host}", {
            "unitigs": n, "host": type(state.host).__name__,
            "shard": manifest["host_shard"]})


STEPS = {"count": _count, "pipeline": _pipeline, "twopass": _twopass,
         "remove": _remove, "route": _route, "correct": _correct,
         "align": _align, "shardspec": _shardspec,
         "emptyrange": _emptyrange, "assemble_ckpt": _assemble_ckpt}


def main():
    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(sys.argv[4]) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    import kmerax_torch.pipeline.count as count
    from kmerax_torch.dist import mesh as dmesh

    if job.get("budget") is not None:
        count.REPLICATE_TABLE_BUDGET = job["budget"]
    mesh = dmesh.init_mesh(dmesh.MeshSpec(*job["mesh"]), "cpu", rank, world,
                           init, job.get("hosts", 1))
    try:
        for step in job["steps"]:
            STEPS[step["kind"]](step, mesh, job["out"])
    finally:
        dmesh.shutdown()


if __name__ == "__main__":
    main()
