"""Seconds of a two-pass job's second count pass's exact-spectrum flushes
(span `count.flush`, pipeline/count.py, in the count records whose `k` is
the configuration's `k2`: `merge_pending` at four words, two int64 keys,
and the last flush's copy back) per million reads it counted, over the
window's jobs (host clock)."""

SPAN = "count.flush"


def read(run):
    k2 = run.config.get("k2")
    recs = [s for j in run.jobs for s in j.stages
            if s["stage"] == "count" and k2 and s.get("k") == k2]
    reads = sum(s["reads"] for s in recs)
    if not reads or any(SPAN not in s.get("spans", {}) for s in recs):
        return None
    return sum(s["spans"][SPAN][0] for s in recs) / (reads / 1e6)
