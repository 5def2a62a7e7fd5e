"""Rows the count stages handed to the exact spectrum's merges (counter
`count.merge_rows`, pipeline/count.py: the resident rows plus the new
valid rows of every flush) per k-mer they counted, over the window's
jobs. A work count: it repeats exactly on a seed."""

COUNTER = "count.merge_rows"


def read(run):
    recs = [s for j in run.jobs for s in j.stages if s["stage"] == "count"]
    if not recs or any("counters" not in s for s in recs):
        return None
    kmers = sum(s["kmers"] for s in recs)
    rows = sum(s["counters"].get(COUNTER, 0) for s in recs)
    return rows / kmers if kmers else None
