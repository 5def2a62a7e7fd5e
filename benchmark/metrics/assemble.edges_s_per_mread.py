"""Seconds of the assembly's edge discovery (span `assemble.edges`,
graph/partitioned.py: the solid selection and `solid_edges_host`) per
million input reads, over the window's jobs (host clock)."""

SPAN = "assemble.edges"


def read(run):
    total, reads = 0.0, 0
    for j in run.jobs:
        for s in j.stages:
            if s["stage"] == "assemble":
                if "spans" not in s:
                    return None
                total += s["spans"].get(SPAN, [0.0])[0]
                reads += j.reads
    return total / (reads / 1e6) if reads else None
