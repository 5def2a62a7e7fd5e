"""Seconds of a two-pass job's second count pass (the count records whose
`k` is the configuration's `k2`: the re-count of the corrected reads)
per million reads it counted, over the window's jobs (host clock). None
where no record carries that k (a program whose count records name no
k)."""


def read(run):
    k2 = run.config.get("k2")
    recs = [s for j in run.jobs for s in j.stages
            if s["stage"] == "count" and k2 and s.get("k") == k2]
    reads = sum(s["reads"] for s in recs)
    if not reads:
        return None
    return sum(s["wall_s"] for s in recs) / (reads / 1e6)
