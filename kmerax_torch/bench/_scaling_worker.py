"""One emulated host of the weak-scaling bench (port of
kmerax/bench/_scaling_worker.py; bench/scaling.py starts one a host):

    python -m kmerax_torch.bench._scaling_worker COORD NPROCS PID \
        DEVICES_PER_HOST N_BATCHES BATCH_PER_HOST DEVICE

It spawns its DEVICES_PER_HOST ranks of an NPROCS x DEVICES_PER_HOST mesh
("data" = hosts, "bucket" = the host's ranks). Each host simulates and
streams its own read shard, every rank counts its rows through the mesh
count step (route + K1r), then corrects them against the merged replicated
table (the per-host correct step, K2 -> K3); host 0 prints the timed
steady-state throughputs as one `SCALING_RESULT {...}` line.
"""

import json
import sys
import time

import numpy as np
import torch


def _rank(n_batches: int, batch_per_host: int) -> dict:
    from kmerax_torch.config import KmeraxConfig
    from kmerax_torch.dist import mesh as dmesh
    from kmerax_torch.pipeline.correct import make_correct_step
    from kmerax_torch.pipeline.count import bloom_params
    from kmerax_torch.spectrum.sharded import ShardedParams, \
        merge_and_replicate, sharded_insert_step

    m = dmesh.current()
    N, G = m.n_hosts, m.local_size
    read_len, k = 150, 31
    cfg = KmeraxConfig(k=k, bloom_log2_width=20, mesh_data=N, mesh_bucket=G)
    sp = ShardedParams(bloom_params(cfg, k), n_shards=G)
    table = torch.zeros(sp.bloom.width // G, dtype=torch.int32,
                        device=m.device)
    step = sharded_insert_step(sp, m, k)

    # this host's deterministic read shard (weak scaling: work a host is
    # constant); each rank takes its local rows of every batch
    rng = np.random.default_rng(1000 + m.host)
    genome = rng.integers(0, 4, 1 << 17).astype(np.uint8)
    rows = m.local_row_slice(batch_per_host)

    def make_batch(seed):
        r = np.random.default_rng(seed * 7919 + m.host)
        starts = r.integers(0, len(genome) - read_len, batch_per_host)
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        return torch.from_numpy(reads[rows].astype(np.int8)).to(m.device)

    batches = [make_batch(s) for s in range(3)]

    def sync():
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        m.barrier()

    step(table, None, batches[0], 0)           # warm-up
    sync()
    t0 = time.perf_counter()
    total = 0
    for i in range(n_batches):
        total += step(table, None, batches[i % 3], 0)[0]   # one host sync
    sync()
    dt = time.perf_counter() - t0
    B_global = batch_per_host * N

    merged = merge_and_replicate(table, m)
    cstep = make_correct_step(sp.bloom, merged, 3, rounds=2, max_runs=8,
                              max_edits=8)
    lengths = torch.full((len(batches[0]),), read_len, dtype=torch.int32,
                         device=m.device)
    nb_c = max(2, n_batches // 2)
    cstep(batches[0], lengths)
    sync()
    t0 = time.perf_counter()
    for i in range(nb_c):
        _, ne = cstep(batches[i % 3], lengths)
        int(ne.sum())
    sync()
    dt_c = time.perf_counter() - t0
    return {"hosts": N, "devices": N * G,
            "reads_per_s": B_global * n_batches / dt,
            "kmers_per_s": total / dt,
            "correct_reads_per_s": B_global * nb_c / dt_c,
            "wall_s": dt}


def main():
    from kmerax_torch.dist import mesh as dmesh

    coord, nprocs, pid, dph, n_batches, batch_per_host, device = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        int(sys.argv[5]), int(sys.argv[6]), sys.argv[7])
    res = dmesh.launch(dmesh.MeshSpec(nprocs, dph), device, _rank,
                       n_batches, batch_per_host, coordinator=coord,
                       n_hosts=nprocs, host=pid)
    if pid == 0:
        print("SCALING_RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
