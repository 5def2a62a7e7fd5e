"""The ("data", "bucket") device mesh on one host (port of
kmerax/dist/mesh.py; DESIGN.md §12), one process per device.

Mesh axes:

  "data"   — reads are sharded over it; partial spectra are merged across it
  "bucket" — the Bloom table is range-sharded over it; k-mers are
             all-to-all routed to their bucket owner

Rank r = d·S + s owns mesh cell (d, s), the JAX package's
`reshape(data, bucket)` of its device list. Every rank builds one "data"
group for each s and one "bucket" group for each d, all in the same order.
On `cuda` the backend is NCCL and rank r uses cuda:r (across hosts its
local rank's card); on `cpu` it is gloo.
A mesh on `cuda` never falls back to gloo or to the CPU.

Multi-host: a JAX process is a host. `--num-procs N` hosts each run the
CLI once with the same mesh flags and `--process-id p`; `launch` then
spawns that host's G = D·S / N local ranks, global rank r = p·G + l
(l the local rank; on `cuda` it uses cuda:l), through a `tcp://` rendezvous
at the coordinator (else the `file://` one of a single host). The order
r = d·S + s is unchanged: the JAX package's process-major
`reshape(data, bucket)` of `jax.devices()`. Besides the data and bucket
groups every rank builds:

  local_group    the G ranks of its host (the JAX package's `_local_mesh`
                 as a (G, 1) data group), on the device backend;
  hosts_group    gloo over every rank, for host numpy arrays, the
                 per-batch lockstep flags and the barriers (`host_allgather`
                 keeps each host leader's entry: a leading axis of N hosts,
                 as `process_allgather` has);
  leaders_group  gloo over the hosts' local rank 0, the leaders, which do
                 the host-level work (the key-range shard of the host
                 spectrum, the sharded graph, the checkpoint shard, the
                 per-host writes) while the other local ranks wait in the
                 next collective.

Host arrays never cross a card (gloo on cards too); device tensors go over
NCCL on cards and never over gloo.

`launch` starts ranks from one process (torch multiprocessing), runs a
function on each, and returns the result of the lowest rank it started. A
process that is a rank of a mesh finds it with `current`.

Rank 0 (or each leader) runs the host graph, the alignment and the writes
while the other ranks wait in the next collective, so every group gets
COLLECTIVE_TIMEOUT, not the backends' default (10 minutes for NCCL's
watchdog), which a large genome's host graph would outlast.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits in a collective for the others
COLLECTIVE_TIMEOUT = timedelta(hours=12)


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    bucket: int = 1

    @property
    def ndev(self) -> int:
        return self.data * self.bucket


@dataclass(frozen=True)
class Mesh:
    """This process's cell of an initialised mesh and its groups."""
    spec: MeshSpec
    device: torch.device
    rank: int
    data_group: object              # the ranks (0..D-1, s)
    bucket_group: object            # the ranks (d, 0..S-1)
    n_hosts: int = 1                # N
    local_group: object = None      # this host's G ranks (device backend)
    hosts_group: object = None      # gloo, every rank
    leaders_group: object = None    # gloo, every host's local rank 0

    @property
    def local_size(self) -> int:
        """G: the ranks of one host."""
        return self.spec.ndev // self.n_hosts

    @property
    def host(self) -> int:
        return self.rank // self.local_size

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    @property
    def is_leader(self) -> bool:
        return self.local_rank == 0

    @property
    def d(self) -> int:
        return self.rank // self.spec.bucket

    @property
    def s(self) -> int:
        return self.rank % self.spec.bucket

    @property
    def world(self) -> int:
        return self.spec.ndev

    def row_slice(self, global_batch: int) -> slice:
        """This rank's rows of a (global_batch, ...) read array sharded over
        ("data", "bucket")."""
        if global_batch % self.world:
            raise ValueError("batch_reads must divide by mesh size")
        per = global_batch // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def local_row_slice(self, host_batch: int) -> slice:
        """This rank's rows of a (host_batch, ...) array of its host,
        sharded over the host's G ranks."""
        if host_batch % self.local_size:
            raise ValueError("batch_reads must divide by mesh size")
        per = host_batch // self.local_size
        return slice(self.local_rank * per, (self.local_rank + 1) * per)

    def all_gather_rows(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Every rank's equal-shaped x, concatenated in rank order (the
        order of the global batch's rows), over `group` (the world if
        None)."""
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    def max_int(self, n: int, group=None) -> int:
        """The largest n over the ranks of `group` (the world if None)."""
        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return int(t)

    def broadcast_int(self, n: int | None) -> int:
        """Rank 0's n on every rank."""
        t = torch.tensor([n if self.rank == 0 else 0], dtype=torch.int64,
                         device=self.device)
        dist.broadcast(t, 0)
        return int(t)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


_CURRENT: Mesh | None = None
# seconds a launch waits for its ranks (None: for ever); the tests set it
LAUNCH_TIMEOUT: float | None = None


def check_hosts(spec: MeshSpec, n_hosts: int = 1,
                host: int | None = 0) -> int:
    """G, the ranks of one host; raises where the mesh does not split over
    `n_hosts` hosts or `host` is not one of them (None: every host)."""
    if n_hosts < 1 or spec.ndev % n_hosts:
        raise ValueError(f"mesh {spec.data}x{spec.bucket} ({spec.ndev} "
                         f"devices) does not divide over {n_hosts} "
                         f"processes")
    if host is not None and not 0 <= host < n_hosts:
        raise ValueError(f"process id {host} outside [0, {n_hosts})")
    return spec.ndev // n_hosts


def check_devices(spec: MeshSpec, device, n_hosts: int = 1) -> None:
    """Raise the JAX package's error where `device` cannot hold this host's
    ranks of the mesh: on cuda one rank a visible card; on cpu gloo runs
    any number."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count()
    G = check_hosts(spec, n_hosts)
    if G > have:
        raise ValueError(
            f"mesh {spec.data}x{spec.bucket} needs {spec.ndev} devices, "
            f"have {have}" if n_hosts == 1 else
            f"mesh {spec.data}x{spec.bucket} over {n_hosts} processes needs "
            f"{G} local devices, have {have}")


def init_mesh(spec: MeshSpec, device, rank: int, world: int,
              init_method: str, n_hosts: int = 1,
              device_index: int | None = None) -> Mesh:
    """Join the process group as `rank` of `world` over `n_hosts` hosts
    (NCCL on cuda, using cuda:<device_index>, by default the local rank;
    gloo on cpu), build every data, bucket and local group and the gloo
    hosts and leaders groups, and make the mesh this process's current
    one. Returns this rank's Mesh."""
    global _CURRENT
    if world != spec.ndev:
        raise ValueError(f"world {world} != mesh size {spec.ndev}")
    G = check_hosts(spec, n_hosts, rank // max(1, world // n_hosts))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        check_devices(spec, dev, n_hosts)
        dev = torch.device("cuda", rank % G if device_index is None
                           else device_index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)

    def group(ranks, backend=None):
        return dist.new_group(ranks, timeout=COLLECTIVE_TIMEOUT,
                              backend=backend)

    D, S = spec.data, spec.bucket
    data_group = bucket_group = local_group = None
    for s in range(S):
        g = group([d * S + s for d in range(D)])
        if rank % S == s:
            data_group = g
    for d in range(D):
        g = group([d * S + s for s in range(S)])
        if rank // S == d:
            bucket_group = g
    for p in range(n_hosts):
        g = group(list(range(p * G, (p + 1) * G)))
        if rank // G == p:
            local_group = g
    hosts_group = group(list(range(world)), "gloo")
    leaders_group = group([p * G for p in range(n_hosts)], "gloo")
    _CURRENT = Mesh(spec, dev, rank, data_group, bucket_group, n_hosts,
                    local_group, hosts_group,
                    leaders_group if rank % G == 0 else None)
    return _CURRENT


def shutdown() -> None:
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def current(cfg=None) -> Mesh | None:
    """This process's mesh; with `cfg`, None for a 1 x 1 config and a
    RuntimeError where the config names a mesh this process is not a rank
    of."""
    if cfg is None or cfg.mesh_data * cfg.mesh_bucket == 1:
        return _CURRENT if cfg is None else None
    spec = MeshSpec(cfg.mesh_data, cfg.mesh_bucket)
    if _CURRENT is None or _CURRENT.spec != spec:
        raise RuntimeError(
            f"mesh {spec.data}x{spec.bucket}: this process is not a rank of "
            f"that mesh; run it through `python -m kmerax_torch.cli ... "
            f"--mesh-data {spec.data} --mesh-bucket {spec.bucket}` or "
            f"kmerax_torch.dist.mesh.launch")
    return _CURRENT


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 of a mesh, or a
    process outside any mesh."""
    return _CURRENT is None or _CURRENT.rank == 0


def process_index() -> int:
    """p, this process's host (the JAX package's jax.process_index()); 0
    outside a mesh."""
    return 0 if _CURRENT is None else _CURRENT.host


def process_count() -> int:
    """N, the hosts of the mesh (jax.process_count()); 1 outside one."""
    return 1 if _CURRENT is None else _CURRENT.n_hosts


# numpy dtypes that torch's collectives carry through a same-width view
_WIRE = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32,
         np.dtype(np.bool_): np.uint8}


def _to_wire(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr.view(_WIRE.get(arr.dtype, arr.dtype)))


def _from_wire(t: torch.Tensor, dtype) -> np.ndarray:
    return t.numpy().view(np.dtype(dtype))


def host_allgather(arr, *, leaders: bool = False) -> np.ndarray:
    """Every host's equal-shaped numpy `arr`, stacked on a leading axis of
    N hosts in host order (the JAX package's process_allgather), with full
    64-bit values. Every rank calls it over hosts_group and each host
    leader's entry is kept; with `leaders`, only the leaders call it, over
    leaders_group. Outside a mesh: arr[None]."""
    arr = np.asarray(arr)
    m = _CURRENT
    if m is None:
        return arr[None]
    group = m.leaders_group if leaders else m.hosts_group
    x = _to_wire(arr)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    if not leaders:
        parts = parts[::m.local_size]
    return _from_wire(torch.stack(parts), arr.dtype)


def host_broadcast(arr, src_rank: int = 0) -> np.ndarray:
    """Rank `src_rank`'s numpy `arr` on every rank, over hosts_group; the
    other ranks pass an array of the same shape and dtype."""
    arr = np.ascontiguousarray(arr)
    if _CURRENT is None:
        return arr
    x = _to_wire(arr).clone()
    dist.broadcast(x, src_rank, group=_CURRENT.hosts_group)
    return _from_wire(x, arr.dtype)


def host_exchange(parts: list) -> list:
    """All-to-all between the host leaders (leaders only): parts[q] is the
    (n_q, V) int64 block this host sends to host q; returns the N blocks it
    received, in host order. One all-to-all of the counts, then one of the
    rows: each block goes to its owner alone."""
    m = _CURRENT
    if m is None:
        return [parts[0]]
    group = m.leaders_group
    V = parts[0].shape[1]
    send_n = torch.tensor([len(x) for x in parts], dtype=torch.int64)
    recv_n = torch.empty_like(send_n)
    dist.all_to_all_single(recv_n, send_n, group=group)
    ins, outs = send_n.tolist(), recv_n.tolist()
    send = torch.from_numpy(np.ascontiguousarray(
        np.concatenate(parts, axis=0), dtype=np.int64).reshape(-1))
    recv = torch.empty(sum(outs) * V, dtype=torch.int64)
    dist.all_to_all_single(recv, send, [n * V for n in outs],
                           [n * V for n in ins], group=group)
    return list(np.split(recv.numpy().reshape(-1, V),
                         np.cumsum(outs)[:-1]))


def host_barrier(tag: str = "", *, leaders: bool = False) -> None:
    """Wait until every rank (with `leaders`: every host leader) reaches
    the barrier of the same tag; a no-op outside a mesh."""
    if _CURRENT is not None:
        dist.barrier(group=_CURRENT.leaders_group if leaders
                     else _CURRENT.hosts_group)


def _worker(i, first, n_local, spec, device, init_method, n_hosts, tmpdir,
            fn, args):
    rank = first + i
    # the host in every log line of this rank (utils/logging.py)
    os.environ["KMERAX_PROCESS_INDEX"] = str(rank // (spec.ndev // n_hosts))
    if torch.device(device).type == "cpu" and "OMP_NUM_THREADS" not in \
            os.environ:
        # the cores split over the ranks started here; hosts emulated on
        # one machine set OMP_NUM_THREADS instead (torch reads it)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_local))
    # the i-th rank started here takes the i-th card here (emulated hosts
    # started together never share one)
    init_mesh(spec, device, rank, spec.ndev, init_method, n_hosts, i)
    try:
        result = fn(*args)
    except BaseException as e:
        try:
            blob = pickle.dumps(e)
        except Exception:
            blob = pickle.dumps(RuntimeError(f"rank {rank}: {e!r}"))
        with open(os.path.join(tmpdir, f"error{rank}.pkl"), "wb") as f:
            f.write(blob)
        raise
    if i == 0:
        with open(os.path.join(tmpdir, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
    shutdown()


def launch(spec: MeshSpec, device, fn, *args, coordinator: str | None = None,
           n_hosts: int = 1, host: int | None = 0):
    """Run fn(*args) on ranks of a fresh mesh of `spec` on `device` (one
    spawned process per rank) and return the result of the lowest rank
    started here. With `n_hosts` = N, this is host `host` of N and starts
    its G = D·S / N ranks p·G .. p·G + G - 1; `host` None starts the ranks
    of every host here (emulated hosts). The rendezvous is
    `tcp://<coordinator>` (host:port of host 0, where rank 0 listens), else
    a `file://` one in a temp dir, which reaches only this machine. A
    rank's exception is raised here (the lowest failing rank's);
    LAUNCH_TIMEOUT seconds without every rank done terminates them all and
    raises TimeoutError. fn must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp

    G = check_hosts(spec, n_hosts, host)
    check_devices(spec, device, 1 if host is None else n_hosts)
    if coordinator is None and n_hosts > 1 and host is not None:
        raise ValueError(f"{n_hosts} processes need a coordinator "
                         f"(host:port of process 0)")
    first, nprocs = (0, spec.ndev) if host is None else (host * G, G)
    timeout = LAUNCH_TIMEOUT
    device = str(torch.device(device).type)
    if device == "cuda":
        # build the kernels once here, not once in every rank
        from kmerax_torch.utils import cuda

        cuda.build()
    with tempfile.TemporaryDirectory(prefix="kmerax_mesh_") as tmpdir:
        init = (f"tcp://{coordinator}" if coordinator else
                "file://" + os.path.join(tmpdir, "rendezvous"))
        ctx = mp.start_processes(
            _worker, args=(first, nprocs, spec, device, init, n_hosts,
                           tmpdir, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"mesh {spec.data}x{spec.bucket}: "
                                       f"ranks not done in {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
            for r in range(first, first + nprocs):
                path = os.path.join(tmpdir, f"error{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        raise pickle.load(f) from err
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        with open(os.path.join(tmpdir, "result.pkl"), "rb") as f:
            return pickle.load(f)
