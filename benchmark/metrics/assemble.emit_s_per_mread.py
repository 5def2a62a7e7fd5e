"""Seconds of the assembly's emission (span `assemble.emit`: `emit_unitigs`
in graph/partitioned.py and the FASTA write in graph/unitig.py) per
million input reads, over the window's jobs (host clock)."""

SPAN = "assemble.emit"


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
