"""K1 (`bloom_insert_kernel`, csrc/bloom.cu) against its roofline in the
profiled job: the least time the card could take for the count passes' K1
work (benchmark/roofline.py, from each pass's k-mers, batches and batch
shape) over K1's own kernel time in the count traces."""

import math

from benchmark import roofline

KERNEL = "bloom_insert_kernel"


def read(run):
    if run.profiled is None:
        return None
    secs = sum(float(d) for t in run.profiled.trace if t.stage == "count"
               for n, d in zip(t.dev_name, t.dev_dur) if KERNEL in n) * 1e-6
    if secs <= 0:
        return None
    c = run.config
    least = 0.0
    for s in run.profiled.stages:
        if s["stage"] != "count":
            continue
        batches = math.ceil(s["reads"] / c["batch_reads"])
        least += roofline.least_seconds(*roofline.k1_work(
            batches, c["batch_reads"], c["max_read_len"], c["k"],
            s["kmers"], c["bloom_hashes"]))
    return 100.0 * least / secs
