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
A job's `budget` replaces REPLICATE_TABLE_BUDGET before its steps.
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


STEPS = {"count": _count, "pipeline": _pipeline, "twopass": _twopass,
         "remove": _remove, "route": _route}


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
                           init)
    try:
        for step in job["steps"]:
            STEPS[step["kind"]](step, mesh, job["out"])
    finally:
        dmesh.shutdown()


if __name__ == "__main__":
    main()
