"""K1 (`bloom_insert_kernel`, csrc/bloom.cu) against its roofline in a
two-pass job's second count pass: the least time the card could take for
that pass's K1 work at k2 (benchmark/roofline.py, from the pass's k-mers,
batches and batch shape) over K1's kernel time in that pass's count
trace. The profiled job's count traces and count records pair in time
order; the pass is the record whose `k` is the configuration's `k2`."""

import math

from benchmark import roofline

KERNEL = "bloom_insert_kernel"


def read(run):
    k2 = run.config.get("k2")
    if run.profiled is None or not k2:
        return None
    recs = [s for s in run.profiled.stages if s["stage"] == "count"]
    traces = [t for t in run.profiled.trace if t.stage == "count"]
    at = [i for i, s in enumerate(recs) if s.get("k") == k2]
    if len(at) != 1 or len(traces) != len(recs):
        return None
    s, t = recs[at[0]], traces[at[0]]
    secs = sum(float(d) for n, d in zip(t.dev_name, t.dev_dur)
               if KERNEL in n) * 1e-6
    if secs <= 0:
        return None
    c = run.config
    least = roofline.least_seconds(*roofline.k1_work(
        math.ceil(s["reads"] / c["batch_reads"]), c["batch_reads"],
        c["max_read_len"], k2, s["kmers"], c["bloom_hashes"]))
    return 100.0 * least / secs
