"""The ("data", "bucket") device mesh on one host (port of
kmerax/dist/mesh.py; DESIGN.md §12), one process per device.

Mesh axes:

  "data"   — reads are sharded over it; partial spectra are merged across it
  "bucket" — the Bloom table is range-sharded over it; k-mers are
             all-to-all routed to their bucket owner

Rank r = d·S + s owns mesh cell (d, s), the JAX package's
`reshape(data, bucket)` of its device list. Every rank builds one "data"
group for each s and one "bucket" group for each d, all in the same order.
On `cuda` the backend is NCCL and rank r uses cuda:r; on `cpu` it is gloo.
A mesh on `cuda` never falls back to gloo or to the CPU.

`launch` starts the D·S ranks of a mesh from one process (torch
multiprocessing, a `file://` rendezvous in a temp directory), runs a
function on each, and returns rank 0's result. A process that is a rank of
a mesh finds it with `current`.

Rank 0 alone runs the host graph, the alignment and the writes while the
other ranks wait in the next collective, so every group gets
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

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_BUCKET = "bucket"

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

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's equal-shaped x, concatenated in rank order (the
        order of the global batch's rows)."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
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


def check_devices(spec: MeshSpec, device) -> None:
    """Raise the JAX package's error where `device` cannot hold the mesh:
    on cuda one rank a visible card; on cpu gloo runs any number."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count()
    if spec.ndev > have:
        raise ValueError(f"mesh {spec.data}x{spec.bucket} needs {spec.ndev} "
                         f"devices, have {have}")


def init_mesh(spec: MeshSpec, device, rank: int, world: int,
              init_method: str) -> Mesh:
    """Join the process group as `rank` of `world` (NCCL on cuda, using
    cuda:rank; gloo on cpu), build every data and bucket group, and make
    the mesh this process's current one. Returns this rank's Mesh."""
    global _CURRENT
    if world != spec.ndev:
        raise ValueError(f"world {world} != mesh size {spec.ndev}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        check_devices(spec, dev)
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    D, S = spec.data, spec.bucket
    data_group = bucket_group = None
    for s in range(S):
        g = dist.new_group([d * S + s for d in range(D)],
                           timeout=COLLECTIVE_TIMEOUT)
        if rank % S == s:
            data_group = g
    for d in range(D):
        g = dist.new_group([d * S + s for s in range(S)],
                           timeout=COLLECTIVE_TIMEOUT)
        if rank // S == d:
            bucket_group = g
    _CURRENT = Mesh(spec, dev, rank, data_group, bucket_group)
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


def _worker(rank, spec, device, init_method, tmpdir, fn, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec.ndev))
    init_mesh(spec, device, rank, spec.ndev, init_method)
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
    if rank == 0:
        with open(os.path.join(tmpdir, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
    shutdown()


def launch(spec: MeshSpec, device, fn, *args):
    """Run fn(*args) on every rank of a fresh mesh of `spec` on `device`
    (one spawned process per rank) and return rank 0's result. A rank's
    exception is raised here (the lowest failing rank's); LAUNCH_TIMEOUT
    seconds without every rank done terminates them all and raises
    TimeoutError. fn must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp

    check_devices(spec, device)
    timeout = LAUNCH_TIMEOUT
    device = str(torch.device(device).type)
    if device == "cuda":
        # build the kernels once here, not once in every rank
        from kmerax_torch.utils import cuda

        cuda.build()
    with tempfile.TemporaryDirectory(prefix="kmerax_mesh_") as tmpdir:
        init = "file://" + os.path.join(tmpdir, "rendezvous")
        ctx = mp.start_processes(
            _worker, args=(spec, device, init, tmpdir, fn, args),
            nprocs=spec.ndev, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"mesh {spec.data}x{spec.bucket}: "
                                       f"ranks not done in {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
            for r in range(spec.ndev):
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
