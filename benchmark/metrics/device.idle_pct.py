"""Share of the profiled job's wall in which no kernel, copy or set ran on
the device: 100 - the union of their intervals over the job's wall."""


def read(run):
    if run.profiled is None or not run.profiled.trace:
        return None
    busy = sum(t.busy_us() for t in run.profiled.trace) * 1e-6
    return 100.0 * (1.0 - busy / run.profiled.wall_s)
