"""The breakdown's idle gaps: the longest spans with no device operation,
labelled as if every gap were labelled."""

import numpy as np

from benchmark.harness import trace


def _trace(rng, n):
    ts = np.sort(rng.uniform(0, 1e6, n))
    hts = np.sort(rng.uniform(0, 1e6, n))
    return trace.StageTrace(
        "count", ["k"] * n, ["kernel"] * n, ts, rng.uniform(1, 500, n),
        [f"aten::op{i}" for i in range(n)], hts, rng.uniform(1, 3000, n),
        1e6)


def test_idle_gaps_label_the_longest_as_every_gap_labelled():
    rng = np.random.default_rng(3)
    traces = [_trace(rng, 400), _trace(rng, 300)]
    untraced = [["assemble: graph on the host (untraced)", 0.5],
                ["between stages (CLI, spectrum hand-over)", 0.0]]
    every = [list(x) for x in untraced]
    for t in traces:
        m = t.merged()
        every += [[trace._label(t, e0, s1), (s1 - e0) * 1e-6]
                  for (_, e0), (s1, _) in zip(m[:-1], m[1:])]
    want = sorted(every, key=lambda g: -g[1])[:10]
    got = trace.idle_gaps(traces, untraced)
    assert got == want and len(got) == 10
    assert got[0][0] == "assemble: graph on the host (untraced)"
