"""Multi-host weak-scaling bench (port of kmerax/bench/scaling.py;
BASELINE.md: >= 0.8 of linear from 1 to 4 hosts).

Weak scaling: the work a host does is held constant (each host streams its
own read shard) while the host count grows 1 -> 2 -> 4; efficiency =
reads/s(N hosts) / (N x reads/s(1 host)). Each host is one process of
bench/_scaling_worker.py that spawns its `devices_per_host` ranks of an
N x devices_per_host mesh (dist/mesh.py::launch) and times the mesh count
step (route + K1r) and the replicated-table correct step (K2 -> K3). On the
CPU the hosts are emulated on this machine over loopback gloo, so the
numbers validate the measurement path only; on cards each host sees its
own cards and N x devices_per_host cards must exist.

    python -m kmerax_torch.cli bench --scaling --hosts 1 2 4 --device cpu
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from kmerax_torch.bench.acceptance_mp import free_port, host_envs, run_hosts
from kmerax_torch.utils.cuda import device_info, resolve_device


def _run_point(nprocs: int, devices_per_host: int, n_batches: int,
               batch_per_host: int, device, timeout: float = 600) -> dict:
    coord = f"127.0.0.1:{free_port()}"
    envs = host_envs(nprocs, devices_per_host, device)
    with tempfile.TemporaryDirectory(prefix="kmerax_scaling_") as d:
        logs = [os.path.join(d, f"host{p}.log") for p in range(nprocs)]
        run_hosts([[sys.executable, "-m", "kmerax_torch.bench._scaling_worker",
                    coord, str(nprocs), str(p), str(devices_per_host),
                    str(n_batches), str(batch_per_host), device.type]
                   for p in range(nprocs)], envs, logs, timeout)
        with open(logs[0]) as f:
            for line in f:
                if line.startswith("SCALING_RESULT "):
                    return json.loads(line[len("SCALING_RESULT "):])
            raise RuntimeError("no SCALING_RESULT line in host 0's log")


def run_scaling(host_counts=(1, 2, 4), devices_per_host: int = 2,
                n_batches: int = 8, batch_per_host: int = 2048, *,
                device) -> dict:
    """Weak-scaling efficiency across the host counts, hosts emulated on
    this machine."""
    device = resolve_device(device)
    points = [_run_point(n, devices_per_host, n_batches, batch_per_host,
                         device) for n in host_counts]
    base = points[0]["reads_per_s"] / points[0]["hosts"]
    cbase = points[0]["correct_reads_per_s"] / points[0]["hosts"]
    for r in points:
        r["efficiency"] = r["reads_per_s"] / (r["hosts"] * base)
        r["correct_efficiency"] = r["correct_reads_per_s"] / (r["hosts"]
                                                              * cbase)
    return {"metric": "weak_scaling_efficiency",
            "backend": ("cpu-emulated (loopback gloo)" if device.type == "cpu"
                        else "cuda, hosts emulated on one machine"),
            "device": device_info(device),
            "per_host_devices": devices_per_host,
            "points": points,
            "efficiency_1_to_max": points[-1]["efficiency"],
            "target": 0.8,
            "note": "the BASELINE target applies to real multi-host runs; "
                    "emulated numbers validate the measurement path only"}
