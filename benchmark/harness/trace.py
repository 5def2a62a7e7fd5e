"""Readings of a profiled job's device traces.

The program writes one Chrome trace a stage (`KMERAX_TRACE_DIR/<stage>/`,
utils/tracing.py: the count, correct and align loops; a re-count writes a
second count trace). Each is read once into arrays of its device
operations (kernels, copies, sets) and host operations, then deleted. A
mesh job's ranks write under `KMERAX_TRACE_DIR/rank<r>/<stage>/`; only
rank 0's are read."""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class StageTrace:
    stage: str                  # "count", "correct" or "align"
    dev_name: list              # device operations
    dev_cat: list
    dev_ts: np.ndarray          # microseconds
    dev_dur: np.ndarray
    host_name: list             # host operations (aten and the like)
    host_ts: np.ndarray
    host_dur: np.ndarray
    span_us: float              # first to last event of the trace

    def busy_us(self) -> float:
        return float(sum(e - s for s, e in self.merged()))

    def merged(self) -> list:
        """The union of the device operations' intervals."""
        if not len(self.dev_ts):
            return []
        order = np.argsort(self.dev_ts)
        out = []
        for s, d in zip(self.dev_ts[order], self.dev_dur[order]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def kernels(self) -> int:
        return sum(c == "kernel" for c in self.dev_cat)


def _read(path: str, stage: str) -> StageTrace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dn, dc, dts, ddur, hn, hts, hdur = [], [], [], [], [], [], []
    lo, hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dn.append(ev.get("name", ""))
            dc.append(cat)
            dts.append(ts)
            ddur.append(dur)
        elif cat == "cpu_op":
            hn.append(ev.get("name", ""))
            hts.append(ts)
            hdur.append(dur)
    return StageTrace(stage, dn, dc, np.asarray(dts), np.asarray(ddur), hn,
                      np.asarray(hts), np.asarray(hdur),
                      max(hi - lo, 0.0))


def read_dir(trace_dir: str) -> list[StageTrace]:
    """Every stage trace under trace_dir, in time order; deletes them."""
    found = []
    for stage in sorted(os.listdir(trace_dir)) if os.path.isdir(
            trace_dir) else []:
        d = os.path.join(trace_dir, stage)
        for name in os.listdir(d):
            p = os.path.join(d, name)
            t = _read(p, stage)
            os.remove(p)
            first = float(t.dev_ts.min()) if len(t.dev_ts) else (
                float(t.host_ts.min()) if len(t.host_ts) else 0.0)
            found.append((first, t))
    return [t for _, t in sorted(found, key=lambda x: x[0])]


def read_rank0(trace_dir: str) -> list[StageTrace]:
    """A mesh job's traces: rank 0's (`<trace_dir>/rank0/`), the writer's,
    whose stage records the job's metrics.jsonl holds; every rank's are
    deleted, the others' unread."""
    try:
        return read_dir(os.path.join(trace_dir, "rank0"))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def short(name: str, n: int = 120) -> str:
    """A kernel's name without `void ` and cut to n characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= n else name[:n - 3] + "..."


def device_ops(traces: list[StageTrace], n: int = 10) -> list:
    """[[name, seconds]]: the device operations with the most total
    time."""
    tot = {}
    for t in traces:
        for name, d in zip(t.dev_name, t.dev_dur):
            name = f"{t.stage}: {short(name)}"
            tot[name] = tot.get(name, 0.0) + d * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(traces: list[StageTrace], untraced: list, n: int = 10) -> list:
    """[[label, seconds]]: the longest spans with no device operation,
    each labelled by its stage and the longest host operation inside it;
    `untraced` adds [label, seconds] spans no trace covers."""
    gaps = [list(x) for x in untraced]
    for t in traces:
        m = t.merged()
        gaps += [[(t, e0, s1), (s1 - e0) * 1e-6]
                 for (_, e0), (s1, _) in zip(m[:-1], m[1:])]
    # label the longest only: a label scans every host operation
    return [[_label(*g[0]) if isinstance(g[0], tuple) else g[0], g[1]]
            for g in sorted(gaps, key=lambda g: -g[1])[:n]]


def _label(t: StageTrace, a: float, b: float) -> str:
    """`<stage>: <host op>` for the host operation covering most of
    [a, b]; where none covers half of it, the host ran code the profiler
    does not see (Python, numpy), named after the last operation that
    started before the gap."""
    if len(t.host_ts):
        ov = np.minimum(t.host_ts + t.host_dur, b) - np.maximum(t.host_ts, a)
        i = int(np.argmax(ov))
        if ov[i] >= 0.5 * (b - a):
            return f"{t.stage}: {t.host_name[i]}"
        before = np.nonzero(t.host_ts <= a)[0]
        if len(before):
            j = int(before[np.argmax(t.host_ts[before])])
            return f"{t.stage}: unprofiled host code after {t.host_name[j]}"
    return f"{t.stage}: unprofiled host code"
