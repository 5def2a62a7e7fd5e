"""Device kernels of the profiled job's correct stage per read batch it
corrected (each input file is corrected in batches of batch_reads)."""

import math


def read(run):
    if run.profiled is None:
        return None
    traces = [t for t in run.profiled.trace if t.stage == "correct"]
    if not traces:
        return None
    B = run.config["batch_reads"]
    batches = sum(math.ceil(n / B) for n in run.file_reads)
    return sum(t.kernels() for t in traces) / batches
