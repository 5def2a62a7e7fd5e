"""Solid threshold (port of kmerax/spectrum/histogram.py; DESIGN.md §7)."""

from __future__ import annotations

import numpy as np


def solid_threshold(hist, override: int | None = None) -> int:
    """First-valley rule on host (DESIGN.md §7): smallest c in [2,128) with
    h[c] <= h[c+1]; fallback 2. An explicit override wins."""
    if override is not None:
        return int(override)
    h = np.asarray(hist)
    hi = min(128, len(h) - 1)
    for c in range(2, hi):
        if h[c] <= h[c + 1]:
            return c
    return 2
