"""Seconds of the assembly's device extension (span `assemble.extend`,
graph/partitioned.py::solid_edges_host, inside `assemble.edges`: each
partition's H2D of its solid rows, `_extensions` and the copy back of the
candidates) per million input reads, over the window's jobs (host
clock)."""

SPAN = "assemble.extend"


def read(run):
    total, reads = 0.0, 0
    for j in run.jobs:
        for s in j.stages:
            if s["stage"] == "assemble":
                if SPAN not in s.get("spans", {}):
                    return None
                total += s["spans"][SPAN][0]
                reads += j.reads
    return total / (reads / 1e6) if reads else None
