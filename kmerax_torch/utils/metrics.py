"""Per-run metrics.jsonl (copy of kmerax/utils/metrics.py): stage wall
time, reads/s and k-mers/s, and the spans and counters taken inside each
stage (utils/tracing.py), so a benchmark is a reading of this file."""

from __future__ import annotations

import contextlib
import json
import time

from kmerax_torch.utils import tracing


class MetricsWriter:
    def __init__(self, path: str | None):
        self._f = open(path, "a") if path else None

    @contextlib.contextmanager
    def stage(self, stage: str, device=None):
        """`with m.stage(name, device) as st:` times the enclosed stage on
        the host clock and writes its record, with the fields given to
        `st.set(...)` and the spans and counters taken inside it. Where
        KMERAX_TRACE_DIR is set and `device` is given, the profiler runs
        over the whole body; the record is written before the profiler
        stops and exports its trace, so the export lies outside `wall_s`.
        A stage that raises writes no record."""
        with tracing.maybe_trace(stage, device) as prof:
            with tracing.opened(annotate=prof is not None) as st:
                t0 = time.perf_counter()
                yield st
                wall = time.perf_counter() - t0
            self._write(stage, wall, st)

    def _write(self, stage: str, wall: float, st: tracing.Stage):
        fields = st.fields
        rec = {"stage": stage, "wall_s": round(wall, 4),
               "ts": time.time(), **fields}
        if wall > 0:
            if "reads" in fields:
                rec["reads_per_s"] = round(fields["reads"] / wall, 1)
            if "kmers" in fields:
                rec["kmers_per_s"] = round(fields["kmers"] / wall, 1)
        rec["spans"] = {name: [round(ns * 1e-9, 6), n]
                        for name, (ns, n) in st.spans.items()}
        rec["counters"] = dict(st.counters)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
