"""Seconds of the assembly's host membership join (span `assemble.join`,
graph/partitioned.py::solid_edges_host, inside `assemble.edges`: the
packing of the solid keys and of each partition's 8 candidates a node,
`searchsorted_packed`, the found test and the successor select) per
million input reads, over the window's jobs (host clock)."""

SPAN = "assemble.join"


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
