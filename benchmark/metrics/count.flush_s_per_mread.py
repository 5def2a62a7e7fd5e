"""Seconds of the count stages' exact-spectrum flushes (span `count.flush`,
pipeline/count.py: on one device the merge of the pending rows into the
spectrum on the card, and in a pass's last flush the spectrum's copy back
to the host; every flush, the last included) per million reads they
counted, over the window's jobs (host clock)."""

SPAN = "count.flush"


def read(run):
    recs = [s for j in run.jobs for s in j.stages if s["stage"] == "count"]
    if not recs or any("spans" not in s for s in recs):
        return None
    secs = sum(s["spans"].get(SPAN, [0.0])[0] for s in recs)
    reads = sum(s["reads"] for s in recs)
    return secs / (reads / 1e6) if reads else None
