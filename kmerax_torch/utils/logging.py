"""Structured logging with per-host prefixes (copy of
kmerax/utils/logging.py): every line reads `HH:MM:SS L [hostN] name:
message`, N the host of the process that logs it.

N is KMERAX_PROCESS_INDEX (default "0"), read when a record is formatted,
not when the logger is made: a mesh rank imports every module (and makes
its loggers) while its spawned process loads the function it runs, before
dist/mesh.py::_worker sets the variable to the rank's host.
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s [host%(host)s] %(name)s: %(message)s"


class _HostFilter(logging.Filter):
    def filter(self, record):
        record.host = os.environ.get("KMERAX_PROCESS_INDEX", "0")
        return True


def get_logger(name: str = "kmerax_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        h.addFilter(_HostFilter())
        logger.addHandler(h)
        logger.setLevel(os.environ.get("KMERAX_LOG", "INFO"))
        logger.propagate = False
    return logger
