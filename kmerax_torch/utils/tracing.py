"""Stage-level profiler tracing (port of kmerax/utils/tracing.py).

Set KMERAX_TRACE_DIR to capture a torch.profiler trace per stage:
    KMERAX_TRACE_DIR=/tmp/trace python -m kmerax_torch.cli pipeline ...
Each stage (count, correct, align) writes a Chrome trace,
`$KMERAX_TRACE_DIR/<stage>/<host>_<pid>.<time>.pt.trace.json`, of the host
ops and, on a card, its kernels and copies; open it in Perfetto or
chrome://tracing, or with `tensorboard --logdir $KMERAX_TRACE_DIR`. Without
the variable the stages run untraced.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def maybe_trace(stage: str, device):
    """Trace the enclosed work of `stage` on `device` when KMERAX_TRACE_DIR
    is set: CPU activity, and CUDA activity on a card."""
    d = os.environ.get("KMERAX_TRACE_DIR")
    if not d:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    path = os.path.join(d, stage)
    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
            path)):
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
