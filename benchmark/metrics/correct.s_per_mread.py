"""Seconds of the correct stage (correction and the FASTQ write) per
million reads it corrected, over the window's jobs (host clock)."""


def read(run):
    got = run.stage_totals("correct")
    return None if got is None else got[0] / (got[1] / 1e6)
