"""Seconds of the count stages (the first pass and any re-count) per
million reads they counted, over the window's jobs (host clock)."""


def read(run):
    got = run.stage_totals("count")
    return None if got is None else got[0] / (got[1] / 1e6)
