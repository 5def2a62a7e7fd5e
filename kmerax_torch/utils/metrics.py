"""Per-run metrics.jsonl (copy of kmerax/utils/metrics.py): stage wall
time, reads/s and k-mers/s, so a benchmark is a reading of this file."""

from __future__ import annotations

import json
import time


class MetricsWriter:
    def __init__(self, path: str | None):
        self._f = open(path, "a") if path else None
        self._t0 = {}

    def stage_start(self, stage: str):
        self._t0[stage] = time.perf_counter()

    def stage_end(self, stage: str, **fields):
        wall = time.perf_counter() - self._t0.pop(stage, time.perf_counter())
        rec = {"stage": stage, "wall_s": round(wall, 4),
               "ts": time.time(), **fields}
        if wall > 0:
            if "reads" in fields:
                rec["reads_per_s"] = round(fields["reads"] / wall, 1)
            if "kmers" in fields:
                rec["kmers_per_s"] = round(fields["kmers"] / wall, 1)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()
