"""Tests of the PyTorch port (kmerax_torch) against the JAX package.

The JAX side runs on the CPU backend that tests/conftest.py forces; data
crosses between the packages as numpy arrays. Each xdist worker keeps torch
to one thread so `-n 6` does not oversubscribe the host.

These tests run on the CPU only: tests/conftest.py imports jax, which the
GPU machine lacks. The kernels are held against their plain versions on
the card by chip_smoke.py.

At import this file also builds the JAX package's C++ FASTQ parser,
kmerax/io/_fastq_ext.so, once for all xdist workers. The JAX package
builds it on first use through one fixed temp path
(kmerax/io/native.py::_build); workers that build at once move each
other's temp file, and tests/unit/test_native_io.py then skips itself.
Every worker collects tests/torch_port/ before tests/unit/, so with the
library built here under a lock the JAX package finds it whole.
"""

import fcntl
import os
import subprocess
from pathlib import Path

import torch

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parents[2]


def _build_fastq_ext() -> None:
    """kmerax/io/native.py's g++ command, under an flock in
    kmerax_torch/_build/, into a temp file of this process; a failed
    build is left to the module's own skip."""
    src = _ROOT / "kmerax" / "io" / "_fastq_ext.cc"
    so = src.with_suffix(".so")
    lock_dir = _ROOT / "kmerax_torch" / "_build"
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "fastq_ext.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
            return
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", str(tmp), str(src)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)


_build_fastq_ext()
