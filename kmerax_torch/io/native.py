"""ctypes loader + auto-build for the C++ FASTQ parser (port of
kmerax/io/native.py).

The parser source is the JAX package's `kmerax/io/_fastq_ext.cc`, read by
path (nothing of that package is imported). It is compiled with g++ on
first use into `kmerax_torch/_build/`, keyed by a hash of the source.
Without a compiler, batching falls back to the pure-Python parser, which
gives identical batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from kmerax_torch.utils.logging import get_logger

log = get_logger("kmerax_torch.io.native")

_SRC = Path(__file__).resolve().parents[2] / "kmerax" / "io" / "_fastq_ext.cc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"

# no -march=native: a build directory copied to another machine must load
_FLAGS = ["-O3", "-shared", "-fPIC"]


def _so_path() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / f"fastq_ext_{digest.hexdigest()[:16]}.so"


_lib = None
_tried = False


def _build(so: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native FASTQ ext build failed (%s); using Python parser",
                    e)
        return False


def get_lib():
    """The loaded extension, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        log.warning("native FASTQ ext load failed (%s)", e)
        return None
    lib.kmerax_fastq_parse.restype = ctypes.c_long
    lib.kmerax_fastq_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_long)]
    _lib = lib
    return _lib


def parse_chunk(buf: bytes, cap_records: int, max_len: int):
    """Parse complete FASTQ records from a bytes chunk via the C++ parser.

    Returns (bases (n, max_len) int8, lengths (n,), names list[bytes],
    quals list[bytes], pluses list[bytes], consumed_bytes). Raises ValueError
    on malformed input (same conditions as the Python parser).
    """
    lib = get_lib()
    assert lib is not None
    bases = np.empty((cap_records, max_len), dtype=np.int8)
    lengths = np.empty(cap_records, dtype=np.int32)
    name_off = np.empty(cap_records, dtype=np.int64)
    name_len = np.empty(cap_records, dtype=np.int32)
    qual_off = np.empty(cap_records, dtype=np.int64)
    qual_len = np.empty(cap_records, dtype=np.int32)
    plus_off = np.empty(cap_records, dtype=np.int64)
    plus_len = np.empty(cap_records, dtype=np.int32)
    consumed = ctypes.c_long(0)
    n = lib.kmerax_fastq_parse(
        buf, len(buf), cap_records, max_len,
        bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qual_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qual_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        plus_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        plus_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(consumed))
    if n == -1:
        raise ValueError("FASTQ name line must start with '@'")
    if n == -2:
        raise ValueError(f"read length exceeds max_read_len {max_len}")
    names = [buf[name_off[i]:name_off[i] + name_len[i]] for i in range(n)]
    quals = [buf[qual_off[i]:qual_off[i] + qual_len[i]] for i in range(n)]
    pluses = [buf[plus_off[i]:plus_off[i] + plus_len[i]] for i in range(n)]
    return bases[:n], lengths[:n], names, quals, pluses, consumed.value
