"""The multi-host bench of the port on the CPU (gloo, hosts emulated on
127.0.0.1): `bench --acceptance 4 --hosts 2` (bench/acceptance_mp.py)
against the one-process acceptance run of the same config, the weak
scaling harness (bench/scaling.py) at 1 and 2 hosts, as
tests/dist/test_scaling.py holds the reference's, and `bench --preset e2e`
across two hosts, its corrected FASTQ held to the JAX package's (exact:
byte equality)."""

import os
import re
import sys

import pytest

from kmerax.config import KmeraxConfig as JConfig
from kmerax.pipeline.run import run_correct as j_run_correct, \
    run_count as j_run_count
from kmerax_torch.bench.acceptance import run_config
from kmerax_torch.bench.acceptance_mp import run_config_mp
from kmerax_torch.bench.runners import e2e_stages
from kmerax_torch.bench.scaling import run_scaling
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.dist import mesh as dmesh
from sim import ecoli_like, make_fastq

from test_torch_multihost_pipeline import run_hosts

# the JAX package's report keys (kmerax/bench/acceptance_mp.py)
MP_KEYS = {"config", "name", "note", "scale", "genome_len", "reads",
           "n_procs", "mesh", "backend", "memory_model", "wall_s",
           "reads_per_s", "accuracy", "workdir"}


def test_acceptance_config4_two_hosts(tmp_path):
    """Config 4 over two emulated hosts (a 2 x 1 mesh, one CLI process a
    host): the hosts parse and correct their own input file, and the
    corrected FASTQ bytes and accuracy equal the one-process run of the
    same config; the report has the JAX package's keys plus the device."""
    one = run_config(4, scale=0.02, workdir=str(tmp_path / "one"),
                     device="cpu")
    two = run_config_mp(4, scale=0.02, n_procs=2, device="cpu",
                        workdir=str(tmp_path / "two"), local_ranks=1,
                        timeout=300)
    assert MP_KEYS | {"device"} <= set(two)
    assert two["mesh"] == [2, 1] and two["n_procs"] == 2
    assert two["device"] == {"name": "cpu", "power_limit": None}
    assert two["reads"] == one["reads"] and two["wall_s"] > 0
    assert two["accuracy"] == one["accuracy"]
    for f in ("corrected_1.fastq", "corrected_2.fastq"):
        assert (tmp_path / "two" / f).read_bytes() == \
            (tmp_path / "one" / f).read_bytes(), f
    for p in range(2):
        log = (tmp_path / "two" / f"worker{p}.log").read_text()
        assert f"count[per-host]: process {p} parses 1 shards of 2 files" \
            in log
        assert f"correct[per-host]: process {p} owns 1/2 shards" in log
    assert not any(n.endswith(".part0000")
                   for n in os.listdir(tmp_path / "two"))


def test_scaling_measurement_path():
    """The weak-scaling harness runs end to end at 1 and 2 emulated hosts
    (two ranks each) and reports sane throughputs; efficiency is 1 at the
    first point by construction."""
    r = run_scaling(host_counts=(1, 2), devices_per_host=2, n_batches=3,
                    batch_per_host=256, device="cpu")
    assert [p["hosts"] for p in r["points"]] == [1, 2]
    assert [p["devices"] for p in r["points"]] == [2, 4]
    for p in r["points"]:
        assert p["reads_per_s"] > 0 and p["correct_reads_per_s"] > 0
        assert p["kmers_per_s"] > p["reads_per_s"]  # ~120 k-mers per read
    assert r["points"][0]["efficiency"] == 1.0
    assert r["backend"] == "cpu-emulated (loopback gloo)"


E2E_CFG = dict(k=31, bloom_log2_width=16, batch_reads=128,
               max_read_len=100, exact_capacity=1 << 16)
# a host process whose e2e FASTQ has 640 reads (the CLI fixes its size, as
# the JAX CLI does; the host process writes it, its ranks read it)
E2E_HOST = ("import sys; import kmerax_torch.bench.runners as r; "
            "r.bench_e2e.__defaults__ = (640, 150); "
            "from kmerax_torch.cli import main; sys.exit(main(sys.argv[1:]))")


def test_bench_e2e_two_hosts_cli(tmp_path):
    """`bench --preset e2e --mesh-data 2` on two emulated hosts (one CLI
    process a host, one gloo rank each, every host its own FASTQ in its
    own temp dir): each host prints its rank's e2e metrics with the ranks'
    start-up apart; the hosts parsed their own byte-range shard and
    corrected their own part, and each rank's log lines carry its host."""
    hosts = run_hosts(["bench", "--preset", "e2e", "--mesh-data", "2",
                       "--bloom-log2-width", "16", "--batch-reads", "256",
                       "--exact-capacity", str(1 << 16)], tmp_path,
                      cmd=[sys.executable, "-c", E2E_HOST])
    for p, (res, log) in enumerate(hosts):
        assert res["metric"] == "e2e_correct_reads_per_s_k31"
        assert res["unit"] == "reads/s/chip" and res["value"] > 0
        assert res["count_wall_s"] > 0 and res["correct_wall_s"] > 0
        assert res["launch_s"] > 0
        assert res["device"] == {"name": "cpu", "power_limit": None}
        lines = [ln for ln in log.splitlines()
                 if f"count[per-host]: process {p} parses 1 shards of 1 "
                    f"files" in ln
                 or f"correct[per-host]: process {p} owns 1/2 shards" in ln]
        assert len(lines) == 2, log[-2000:]
        for ln in lines:
            assert re.match(rf"\d\d:\d\d:\d\d I \[host{p}\] "
                            rf"kmerax_torch\.pipeline: ", ln), ln
    assert not list(tmp_path.glob("*.part*"))


@pytest.fixture(scope="module")
def e2e_input(tmp_path_factory):
    """A 600-read FASTQ and the JAX package's run_count + run_correct of it
    at 1 x 1 and on a 2 x 1 mesh of its CPU devices: (path, {mesh:
    bytes})."""
    d = tmp_path_factory.mktemp("mh_e2e")
    _, reads = ecoli_like(seed=21, genome_len=3000, coverage=20,
                          read_len=100, error_rate=0.01)
    fq = d / "reads.fastq"
    fq.write_bytes(make_fastq(reads))
    refs = {}
    for mesh in ((1, 1), (2, 1)):
        cfg = JConfig(mesh_data=mesh[0], mesh_bucket=mesh[1], **E2E_CFG)
        out = d / f"j{mesh[0]}x{mesh[1]}.fastq"
        j_run_correct(cfg, [str(fq)], j_run_count(cfg, [str(fq)]), str(out))
        refs[mesh] = out.read_bytes()
    return fq, refs


def test_bench_e2e_two_emulated_hosts_matches_jax(e2e_input, tmp_path):
    """The e2e preset's stages (`runners.e2e_stages`) on a 2 x 1 mesh over
    two emulated hosts (one launch, host=None): each host parses and
    corrects its own shard, rank 0 joins the parts, and the corrected
    FASTQ == the JAX package's on its 2 x 1 mesh == its 1 x 1 run."""
    fq, refs = e2e_input
    dmesh.LAUNCH_TIMEOUT, old = 300, dmesh.LAUNCH_TIMEOUT
    try:
        walls = dmesh.launch(dmesh.MeshSpec(2, 1), "cpu", e2e_stages,
                             KmeraxConfig(mesh_data=2, **E2E_CFG), str(fq),
                             str(tmp_path / "t.fastq"), "cpu", n_hosts=2,
                             host=None)
    finally:
        dmesh.LAUNCH_TIMEOUT = old
    assert walls["count_wall_s"] > 0 and walls["correct_wall_s"] > 0
    got = (tmp_path / "t.fastq").read_bytes()
    assert got == refs[(2, 1)] == refs[(1, 1)]
    assert got != fq.read_bytes()
    assert not list(tmp_path.glob("*.part*"))
