"""Seconds of the assembly less its re-count (edges, chains and the FASTA
on the host) per million input reads, over the window's jobs (host
clock)."""


def read(run):
    total, reads = 0.0, 0
    for j in run.jobs:
        for prev, s in zip(j.stages, j.stages[1:]):
            if s["stage"] == "assemble":
                recount = prev["wall_s"] if prev["stage"] == "count" else 0.0
                total += s["wall_s"] - recount
                reads += j.reads
    return total / (reads / 1e6) if reads else None
