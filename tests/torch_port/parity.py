"""Shared inputs for the port's parity tests: seeded numpy data handed to
both packages, and both packages' CLIs run on the same arguments."""

import contextlib
import io
import json

import numpy as np
import torch


def reads_with_ns(seed: int, B: int, L: int, k: int, n_rate=0.004,
                  err_rate=0.03, with_errors=False):
    """(B, L) int32 bases from a shared 2 kb genome (k-mers repeat) with
    substitutions, Ns, and ragged lengths >= k padded with 4; with_errors
    also returns the (B, L) mask of substituted bases."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000).astype(np.int32)
    starts = rng.integers(0, 2000 - L, B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]]
    errs = rng.random(reads.shape) < err_rate
    reads = np.where(errs, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.int32)
    reads[rng.random(reads.shape) < n_rate] = 4
    lengths = np.full(B, L, np.int32)
    lengths[: B // 8] = rng.integers(k, L + 1, B // 8)
    for i in range(B):
        reads[i, lengths[i]:] = 4
    if with_errors:
        return reads, lengths, errs & (np.arange(L)[None, :] < lengths[:, None])
    return reads, lengths


def with_short_reads(reads, lengths, k: int):
    """Copies where read 1 is k-1 bases long and read 2 three, padded with
    4: reads with no window (last_j < 0)."""
    reads, lengths = reads.copy(), lengths.copy()
    for i, ln in ((1, k - 1), (2, 3)):
        lengths[i] = ln
        reads[i, ln:] = 4
    return reads, lengths


def t(x) -> torch.Tensor:
    """numpy (or JAX array via numpy) -> CPU tensor; uint32 becomes int64
    words in [0, 2^32), the port's representation."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_clis(argv, device="cpu"):
    """Run the JAX package's CLI, then the port's, on the same arguments.
    "{pkg}" in an argument becomes "j" for the JAX run and "t" for the
    port's, so each writes its own files; the port also gets `--device`.
    Returns (JAX result, port result): the JSON each printed last."""
    from kmerax.cli import main as j_main
    from kmerax_torch.cli import main as t_main

    out = []
    for pkg, main, extra in (("j", j_main, []),
                             ("t", t_main, ["--device", device])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([a.replace("{pkg}", pkg) for a in argv]
                        + extra) == 0
        out.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    return tuple(out)


MESH_TIMEOUT = 300          # seconds a spawned mesh run may take


def run_mesh(jobs, tmp_path, timeout=MESH_TIMEOUT):
    """Run each (mesh (D, S), job dict) on a gloo mesh of D·S processes of
    tests/torch_port/_mesh_worker.py, all meshes at once, each through a
    `file://` rendezvous under tmp_path; wait up to `timeout` seconds, then
    kill every process and fail. A job's steps write under its `out`."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parents[1]))
    procs = []
    try:
        for i, (mesh, job) in enumerate(jobs):
            job = dict(job, mesh=list(mesh))
            spec = tmp_path / f"job{i}.json"
            spec.write_text(json.dumps(job))
            world = mesh[0] * mesh[1]
            init = f"file://{tmp_path / f'rendezvous{i}'}"
            for r in range(world):
                log = open(tmp_path / f"job{i}_r{r}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, str(here / "_mesh_worker.py"), str(r),
                     str(world), init, str(spec)], stdout=log,
                    stderr=subprocess.STDOUT, env=env), log))
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(log.name, p.returncode) for p, log in procs if p.returncode]
    assert not bad, "\n".join(f"{name} exited {rc}:\n" + open(name).read()
                              for name, rc in bad)
