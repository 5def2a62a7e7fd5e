"""The multi-host bench of the port on the CPU (gloo, hosts emulated on
127.0.0.1): `bench --acceptance 4 --hosts 2` (bench/acceptance_mp.py)
against the one-process acceptance run of the same config, and the weak
scaling harness (bench/scaling.py) at 1 and 2 hosts, as
tests/dist/test_scaling.py holds the reference's."""

import os

from kmerax_torch.bench.acceptance import run_config
from kmerax_torch.bench.acceptance_mp import run_config_mp
from kmerax_torch.bench.scaling import run_scaling

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
