"""Seconds of the align stage's contig index (span `align.contig_index`,
pipeline/align.py: the FASTA read, `build_contig_index` and the contigs'
H2D) per million reads it aligned, over the window's jobs (host clock)."""

SPAN = "align.contig_index"


def read(run):
    recs = [s for j in run.jobs for s in j.stages if s["stage"] == "align"]
    if not recs or any("spans" not in s for s in recs):
        return None
    secs = sum(s["spans"].get(SPAN, [0.0])[0] for s in recs)
    reads = sum(s["reads"] for s in recs)
    return secs / (reads / 1e6) if reads else None
