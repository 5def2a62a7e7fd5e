"""Per-host input sharding (copy of kmerax/io/shard.py; SURVEY.md §1 L1:
"each host reads its own file shard").

A multi-host run must not have every host parse the whole input. Input
FASTQ files are assigned to hosts balanced by on-disk size (deterministic
greedy: biggest file to the least-loaded host, ties by original order);
with fewer plain files than hosts every file splits into record-aligned
byte ranges. Each host parses only its own shards:

  * count: the hosts stream their shards in lockstep global batches
    (pipeline/count.py); counting is order-free, so the merged spectrum is
    the one-process stream's (DESIGN.md §13).
  * correct and align: with a replicated table there is no cross-host
    dependency; each host corrects (aligns) and writes its own shards
    (`shard_units`, `host_share`), and rank 0 concatenates the parts in
    shard order (`concat_parts`).
"""

from __future__ import annotations

import os
import shutil


def _assign_by_size(sizes: list[int], n_procs: int) -> list[list[int]]:
    """Deterministic size-balanced assignment of item indices to processes
    (greedy: biggest item to least-loaded process, ties by order); within a
    process, indices keep their original order."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    load = [0] * n_procs
    owner = [0] * len(sizes)
    for i in order:
        p = min(range(n_procs), key=lambda q: (load[q], q))
        owner[i] = p
        load[p] += sizes[i]
    return [[i for i in range(len(sizes)) if owner[i] == q]
            for q in range(n_procs)]


def _path_sizes(paths: list[str]) -> list[int]:
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    return sizes


def assign_paths(paths: list[str], n_procs: int) -> list[list[int]]:
    """Size-balanced file assignment (see _assign_by_size)."""
    return _assign_by_size(_path_sizes(paths), n_procs)


def local_paths(paths: list[str], n_procs: int, pid: int) -> list[str]:
    return [paths[i] for i in assign_paths(paths, n_procs)[pid]]


def snap_to_record(path: str, offset: int, probe: int = 1 << 16) -> int:
    """First FASTQ record-start byte at or after `offset` (plain files).

    A line is a record header iff it starts with '@' AND the line two
    below starts with '+': a quality line may also start with '@', but
    then the line two below is the next record's sequence (ACGTN...),
    never '+'. Works for any (varying) read lengths.
    """
    if offset <= 0:
        return 0
    size = os.path.getsize(path)
    if offset >= size:
        return size
    with open(path, "rb") as f:
        while True:
            # read from offset-1 so a '\n' right before the offset marks
            # the offset itself as a line-start candidate (idempotence:
            # snapping an already-snapped boundary is a no-op)
            base = offset - 1
            f.seek(base)
            buf = f.read(probe)
            text_end = base + len(buf)
            starts = []
            j = 0
            while True:
                j2 = buf.find(b"\n", j)
                if j2 < 0:
                    break
                starts.append(j2 + 1)
                j = j2 + 1
            need_more = False
            for si, s in enumerate(starts):
                if s < len(buf) and buf[s:s + 1] == b"@":
                    if si + 2 < len(starts):
                        s2 = starts[si + 2]
                        if buf[s2:s2 + 1] == b"+":
                            return base + s
                    elif text_end < size:
                        need_more = True
                        break
            if text_end >= size and not need_more:
                return size
            probe *= 2


def byte_shards(path: str, n: int):
    """Split one plain FASTQ into up to n contiguous record-aligned byte
    ranges [(path, start, end), ...] (SURVEY.md §1 L1 "file shard"; fewer
    ranges for tiny files). .gz is not splittable (stream-compressed) —
    callers fall back to file-level sharding."""
    assert not str(path).endswith(".gz")
    size = os.path.getsize(path)
    bounds = sorted({snap_to_record(path, size * i // n)
                     for i in range(n + 1)} | {0, size})
    return [(path, a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


def shard_size(spec) -> int:
    """Bytes of an input spec: a path string or a (path, start, end)."""
    if isinstance(spec, tuple):
        return spec[2] - spec[1]
    try:
        return os.path.getsize(spec)
    except OSError:
        return 0


def all_input_shards(paths: list[str], n_procs: int):
    """Global ordered input-shard list covering `paths` exactly once.

    With at least one file per process: the files themselves. With fewer
    (plain) files than processes: every file splits into n_procs
    record-aligned byte ranges, so single-file inputs still parse 1/N per
    host (round-3 VERDICT Weak #4). Any .gz input keeps file-level
    sharding (not byte-splittable).
    """
    if len(paths) >= n_procs or any(str(p).endswith(".gz") for p in paths):
        return list(paths)
    shards = []
    for p in paths:
        shards.extend(byte_shards(p, n_procs))
    return shards


def local_shards(paths: list[str], n_procs: int, pid: int):
    """This process's share of all_input_shards, size-balanced."""
    shards = all_input_shards(paths, n_procs)
    sizes = [shard_size(s) for s in shards]
    return [shards[i] for i in _assign_by_size(sizes, n_procs)[pid]]


def use_per_host_io(cfg, paths, mesh) -> bool:
    """Per-host input sharding (kmerax/pipeline/run.py::_use_per_host_io):
    across N > 1 hosts with `per_host_io`, given at least one file a host
    or plain (non-.gz) files, which split into record-aligned byte ranges,
    so a single big FASTQ still parses 1/N a host."""
    if mesh is None or mesh.n_hosts <= 1 or not cfg.per_host_io:
        return False
    return (len(paths) >= mesh.n_hosts
            or not any(str(p).endswith(".gz") for p in paths))


def shard_units(paths: list[str], n_procs: int, out=None):
    """A single output's units across n_procs hosts: ([shard], part) for
    each of all_input_shards(paths, n_procs), in shard order, the part
    path `out.partNNNN` (None where `out` is None)."""
    return [([sh], f"{out}.part{i:04d}" if out else None)
            for i, sh in enumerate(all_input_shards(paths, n_procs))]


def host_share(units, n_procs: int, pid: int) -> list[int]:
    """The indices of the (inputs, output) units host `pid` owns, in
    order: _assign_by_size over the size of each unit's first input."""
    return _assign_by_size([shard_size(u[0][0]) for u in units],
                           n_procs)[pid]


def concat_parts(parts: list[str], dst) -> None:
    """Stream the part files, in the order given (shard order, the read
    order), into the open binary file `dst`, then remove them."""
    for part in parts:
        with open(part, "rb") as src:
            shutil.copyfileobj(src, dst, 8 << 20)
    for part in parts:
        os.remove(part)
