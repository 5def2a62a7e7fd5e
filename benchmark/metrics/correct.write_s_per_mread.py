"""Seconds of the correct stage's read-back and FASTQ write (span
`correct.write`, pipeline/correct.py: the D2H, the 2-bit unpack and the
records) per million reads it corrected, over the window's jobs (host
clock)."""

SPAN = "correct.write"


def read(run):
    recs = [s for j in run.jobs for s in j.stages if s["stage"] == "correct"]
    if not recs or any("spans" not in s for s in recs):
        return None
    secs = sum(s["spans"].get(SPAN, [0.0])[0] for s in recs)
    reads = sum(s["reads"] for s in recs)
    return secs / (reads / 1e6) if reads else None
