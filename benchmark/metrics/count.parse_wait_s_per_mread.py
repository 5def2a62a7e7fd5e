"""Seconds the count stages (the first pass and any re-count) waited on the
FASTQ parse thread (span `io.parse_wait`, io/batcher.py) per million
reads they counted, over the window's jobs (host clock)."""

SPAN = "io.parse_wait"


def read(run):
    recs = [s for j in run.jobs for s in j.stages if s["stage"] == "count"]
    if not recs or any("spans" not in s for s in recs):
        return None
    secs = sum(s["spans"].get(SPAN, [0.0])[0] for s in recs)
    reads = sum(s["reads"] for s in recs)
    return secs / (reads / 1e6) if reads else None
