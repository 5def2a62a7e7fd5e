"""Spans and work counts inside a stage, and the stage's profiler trace
(port of kmerax/utils/tracing.py).

A stage opens on the calling thread (`utils/metrics.py::MetricsWriter.
stage`). Inside it, `span(name)` adds the seconds of the enclosed code and
one entry, and `count(name, n)` adds n, to the innermost stage open on this
thread; the stage's metrics record carries them as `"spans": {name:
[seconds, n]}` and `"counters": {name: n}`. With no stage open, or on
another thread (the batcher's parse thread), they record nothing. A span
never synchronizes the device: it times the host's side of the work.

Set KMERAX_TRACE_DIR to capture a torch.profiler trace per stage:
    KMERAX_TRACE_DIR=/tmp/trace python -m kmerax_torch.cli pipeline ...
Each stage (count, correct, align) writes a Chrome trace of its whole body,
`$KMERAX_TRACE_DIR/<stage>/<host>_<pid>.<time>.pt.trace.json`, of the host
ops and, on a card, its kernels and copies. While the profiler runs, each
span is also a `record_function` range: a `user_annotation` event on the
same clock as the kernels, so Perfetto (or chrome://tracing, or
`tensorboard --logdir $KMERAX_TRACE_DIR`) shows the program's spans over
the device's timeline. Without the variable the stages run untraced.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

_open = threading.local()


class Stage:
    """What an open stage gathers: its record's fields, its spans
    {name: [nanoseconds, n]} and counters {name: n}; `annotate` is True
    while the stage's profiler runs."""

    __slots__ = ("fields", "spans", "counters", "annotate")

    def __init__(self, annotate: bool):
        self.fields, self.spans, self.counters = {}, {}, {}
        self.annotate = annotate

    def set(self, **fields):
        """Fields of the stage's metrics record."""
        self.fields.update(fields)

    def seconds(self, name: str) -> float:
        """The seconds span `name` has taken so far (0.0 if never
        entered)."""
        return self.spans.get(name, (0, 0))[0] * 1e-9


def _innermost():
    stack = getattr(_open, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def opened(annotate: bool):
    """A Stage open on this thread for the enclosed code."""
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    st = Stage(annotate)
    stack.append(st)
    try:
        yield st
    finally:
        stack.pop()


class _Span:
    __slots__ = ("_name", "_n", "_st", "_t0", "_rf")

    def __init__(self, name: str, n: int):
        self._name, self._n = name, n

    def __enter__(self):
        st = self._st = _innermost()
        if st is not None:
            if st.annotate:
                self._rf = torch.profiler.record_function(self._name)
                self._rf.__enter__()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        st = self._st
        if st is None:
            return False
        dt = time.perf_counter_ns() - self._t0
        if st.annotate:
            self._rf.__exit__(*exc)
        acc = st.spans.get(self._name)
        if acc is None:
            st.spans[self._name] = [dt, self._n]
        else:
            acc[0] += dt
            acc[1] += self._n
        return False


def span(name: str, n: int = 1) -> _Span:
    """`with span(name):` adds the enclosed seconds and `n` entries to
    span `name` of the innermost stage open on this thread (n = 0 adds
    seconds to a span another call already counted)."""
    return _Span(name, n)


def count(name: str, n: int) -> None:
    """Adds n to counter `name` of the innermost stage open on this
    thread."""
    st = _innermost()
    if st is not None:
        st.counters[name] = st.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def maybe_trace(stage: str, device):
    """Trace the enclosed work of `stage` on `device` when KMERAX_TRACE_DIR
    is set and `device` is given: CPU activity, and CUDA activity on a
    card. Yields the running profiler, else None."""
    d = os.environ.get("KMERAX_TRACE_DIR")
    if not d or device is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    path = os.path.join(d, stage)
    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
            path)) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
