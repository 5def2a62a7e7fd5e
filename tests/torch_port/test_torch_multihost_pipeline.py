"""The port's multi-host path on the CPU: two hosts emulated on 127.0.0.1
(gloo), each one `python -m kmerax_torch.cli ... --coordinator 127.0.0.1:P
--num-procs 2 --process-id p` process that spawns its G ranks, against the
JAX package's single-process run on the same input and config (DESIGN.md
§13 and tests/dist/* pin its bytes as independent of the process count).
Exact: tolerance 0 (byte equality).

The per-host and sharded paths are asserted taken: each host's log names
the one byte-range shard it parsed and the part it corrected, and the
leaders' range shards of the spectrum each hold 0.5/N..1.5/N of the
distinct k-mers (tests/dist/_mp_shardspec_worker.py's band)."""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from kmerax.config import KmeraxConfig as JConfig
from kmerax.pipeline.run import run_pipeline
from sim import ecoli_like, make_fastq

ROOT = Path(__file__).resolve().parents[2]
HOST_TIMEOUT = 300          # seconds a host process may take
# tests/dist/test_shard_host_spectrum.py's sizes
CFG = dict(bloom_log2_width=16, batch_reads=512, max_read_len=100,
           exact_capacity=1 << 16)
ARGS = ["--bloom-log2-width", "16", "--batch-reads", "512",
        "--max-read-len", "100", "--exact-capacity", str(1 << 16)]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_hosts(argv, tmp_path, n_hosts=2, tag="h", cmd=None):
    """Run `python -m kmerax_torch.cli *argv --device cpu --coordinator
    127.0.0.1:P --num-procs N --process-id p` once per host p, all at once
    (`cmd`, a command that takes the CLI's arguments, in place of `python
    -m kmerax_torch.cli`); returns [(printed result, stderr log)] in host
    order. Every host gets HOST_TIMEOUT seconds, then all are killed and
    the test fails."""
    cmd = cmd or [sys.executable, "-m", "kmerax_torch.cli"]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for p in range(n_hosts):
        err = open(tmp_path / f"{tag}{p}.log", "w+")
        procs.append((subprocess.Popen(
            [*cmd, *argv, "--device",
             "cpu", "--coordinator", f"127.0.0.1:{port}", "--num-procs",
             str(n_hosts), "--process-id", str(p)],
            stdout=subprocess.PIPE, stderr=err, env=env, cwd=tmp_path), err))
    out = []
    try:
        for proc, err in procs:
            stdout, _ = proc.communicate(timeout=HOST_TIMEOUT)
            err.seek(0)
            log = err.read()
            assert proc.returncode == 0, log[-4000:]
            out.append((json.loads(stdout.decode().strip().splitlines()[-1]),
                        log))
    finally:
        for proc, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
    return out


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """tests/dist/test_shard_host_spectrum.py's genome and reads."""
    _, rs = ecoli_like(seed=55, genome_len=4000, coverage=30, read_len=100,
                       error_rate=0.01)
    p = tmp_path_factory.mktemp("mh_reads") / "reads.fastq"
    p.write_bytes(make_fastq(rs))
    return p


@pytest.fixture(scope="module")
def jax_runs(reads, tmp_path_factory):
    """The JAX package's single-process run_pipeline at k = 31 and 63:
    {k: (result, FASTQ bytes, FASTA bytes)}."""
    d = tmp_path_factory.mktemp("mh_jax")
    out = {}
    for k in (31, 63):
        res = run_pipeline(JConfig(k=k, **CFG), [str(reads)],
                           str(d / f"{k}.fastq"), str(d / f"{k}.fasta"))
        out[k] = (res, (d / f"{k}.fastq").read_bytes(),
                  (d / f"{k}.fasta").read_bytes())
    return out


@pytest.mark.parametrize("G,k", [(1, 31), (2, 31), (1, 63), (2, 63)],
                         ids=lambda v: str(v))
def test_cli_pipeline_two_hosts(reads, jax_runs, tmp_path, G, k):
    """`pipeline` on two hosts of a 2 x G mesh (G ranks a host): both hosts
    print the JAX package's result, and the FASTQ and FASTA rank 0 wrote
    are its bytes. Each host parsed one byte-range shard of the one input,
    corrected one part, and held a 0.25..0.75 share of the distinct k-mers
    in its range shard; the assembly ran sharded."""
    want, fq, fa = jax_runs[k]
    hosts = run_hosts(["pipeline", "--in", str(reads), "--out-fastq",
                       "out.fastq", "--out-fasta", "out.fasta", "-k", str(k),
                       "--mesh-data", "2", "--mesh-bucket", str(G), *ARGS],
                      tmp_path)
    for p, (res, log) in enumerate(hosts):
        assert res == want
        assert f"count[per-host]: process {p} parses 1 shards of 1 files" \
            in log
        assert f"correct[per-host]: process {p} owns 1/2 shards: " \
            f"['out.fastq.part000{p}']" in log
        assert f"assemble[sharded]:" in log
        m = re.search(rf"\d+ distinct \((\d+) resident on host {p}\)", log)
        n = re.search(r"k-mers, (\d+) distinct \(", log)
        assert 0.25 <= int(m.group(1)) / int(n.group(1)) <= 0.75
    assert (tmp_path / "out.fastq").read_bytes() == fq
    assert (tmp_path / "out.fasta").read_bytes() == fa
    assert not list(tmp_path.glob("*.part*"))
