"""Structured logging (copy of kmerax/utils/logging.py, one process)."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "kmerax_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("KMERAX_LOG", "INFO"))
        logger.propagate = False
    return logger
