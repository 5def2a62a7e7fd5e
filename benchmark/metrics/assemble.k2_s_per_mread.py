"""Seconds of a two-pass job's assembly (the assemble record after the
count record whose `k` is the configuration's `k2`: the graph at k2, with
no re-count inside it) per million input reads, over the window's jobs
(host clock). None where no count record carries that k."""


def read(run):
    k2 = run.config.get("k2")
    total, reads = 0.0, 0
    for j in run.jobs:
        last_k = None
        for s in j.stages:
            if s["stage"] == "count":
                last_k = s.get("k")
            elif s["stage"] == "assemble" and k2 and last_k == k2:
                total += s["wall_s"]
                reads += j.reads
    return total / (reads / 1e6) if reads else None
