"""Merges of the device pending buffer into the host exact spectrum in a
job, over all its count passes (`LAST_COUNT_FLUSHES` after each pass):
the median over the window's jobs, which all count the same reads."""

import statistics


def read(run):
    if not run.jobs or not run.jobs[0].flushes:
        return None
    return statistics.median(sum(j.flushes) for j in run.jobs)
