"""Seconds of the align stage's seed table (span `align.seed_table`,
pipeline/align.py: `build_seed_hash`, the cuckoo walk) per million reads
it aligned, over the window's jobs (host clock)."""

SPAN = "align.seed_table"


def read(run):
    recs = [s for j in run.jobs for s in j.stages if s["stage"] == "align"]
    if not recs or any("spans" not in s for s in recs):
        return None
    secs = sum(s["spans"].get(SPAN, [0.0])[0] for s in recs)
    reads = sum(s["reads"] for s in recs)
    return secs / (reads / 1e6) if reads else None
