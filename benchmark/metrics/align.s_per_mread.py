"""Seconds of the align stage (index build and the aligned reads) per
million reads it aligned, over the window's jobs (host clock)."""


def read(run):
    got = run.stage_totals("align")
    return None if got is None else got[0] / (got[1] / 1e6)
