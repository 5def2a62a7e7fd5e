"""Device selection, and the build, load and launch bookkeeping of the
port's CUDA kernels (kmerax_torch/csrc/*.cu).

The kernels are compiled by `nvcc` (one process per source, in parallel)
into ONE shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so the build takes seconds. The build happens at first
use, into `kmerax_torch/_build/`, keyed by a hash of the sources and
flags, so a checkout builds everything it needs from its own files.
Nothing here runs at import time: this module imports on a machine
without CUDA, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# launches per kernel wrapper: each wrapper adds one where it launches its
# CUDA kernel and nowhere else (never on its plain CPU path), so a run can
# show that the main path went through the kernels
LAUNCHES = {"bloom_insert": 0, "bloom_query_solid": 0,
            "correct_eval_scores": 0, "banded_align_scores": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_device(name: str | torch.device) -> torch.device:
    """The explicit device of a stage. 'cuda' without a usable card raises:
    the port never carries on on the CPU in place of the card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_info(device: torch.device) -> dict:
    """{"name", "power_limit"} of the device a run measured: on a card, as
    `nvidia-smi --query-gpu=name,power.limit` gives them; "cpu" on the
    CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkmerax_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu into the shared library unless the build for these
    exact sources exists: one nvcc per source, all started together, then
    one link. Returns (path, seconds spent compiling and linking)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    work = BUILD_DIR / f"{so.stem}.tmp{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    log, failed = [], []
    try:
        for cmd, proc in jobs:
            out, _ = proc.communicate(timeout=900)
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
    finally:                       # a timeout leaves no compiler running
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / so.name),
               *[str(o) for o in sorted(work.glob("*.o"))]]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    secs = time.perf_counter() - t0
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(work / so.name, so)
    shutil.rmtree(work, ignore_errors=True)
    return so, secs


_lib = None


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build()
    L = ctypes.CDLL(str(so))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    L.kmerax_bloom_insert.argtypes = [
        P, P, I, I, I, ctypes.c_uint32, I, I, I, P, I64, P, P]
    L.kmerax_bloom_query_solid.argtypes = [
        P, P, I, I, I, P, ctypes.c_uint32, I, I, I, I, P, P]
    L.kmerax_correct_eval_scores.argtypes = [
        P, I, P, P, P, P, I64, P, ctypes.c_uint32, I, I, I, I, I, P, P]
    L.kmerax_banded_align_scores.argtypes = [
        P, I, P, I, P, P, I64, I, I, P, P]
    for fn in (L.kmerax_bloom_insert, L.kmerax_bloom_query_solid,
               L.kmerax_correct_eval_scores, L.kmerax_banded_align_scores):
        fn.restype = I
    L.kmerax_cuda_error_string.argtypes = [I]
    L.kmerax_cuda_error_string.restype = ctypes.c_char_p
    _lib = L
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = lib().kmerax_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, shape: tuple | None = None) -> None:
    """Argument checks a kernel wrapper makes before passing a pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
