"""Spectrum checkpoint / resume (port of kmerax/pipeline/checkpoint.py).

The spectrum (Bloom table + exact sorted array) is the only large state
between passes. It is saved as raw `spectrum.npz` + a JSON
`manifest.json`, written through a `.tmp` file and `os.replace`, in the
JAX package's format: a spectrum saved by one package loads in the other.
A spectrum that fits `exact_capacity` is saved in the JAX package's device
form (`exact_uniq` padded with sentinel rows, `exact_counts` int32,
`exact_n`), built on the host at save time; past capacity as `host_uniq`
and `host_counts`.

A range-sharded host spectrum (spectrum/host_sharded.py) is saved in the
JAX package's sharded form (kmerax/pipeline/checkpoint.py:32-45): each host
leader writes only its shard, `spectrum.p{p}.npz` (`host_uniq`,
`host_counts`, `host_bounds`) and `manifest.p{p}.json` with
`"host_shard": [p, N]`, and host 0 also writes `manifest.json`.
`load_spectrum(dir, pid, n_procs)` raises on a geometry mismatch with the
reference's message, so either package reads the other's shards at the
same N and neither adopts a wrong key range.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.dist import mesh as dmesh
from kmerax_torch.pipeline.count import CountState
from kmerax_torch.spectrum.host import HostSpectrum
from kmerax_torch.spectrum.host_sharded import ShardedHostSpectrum


def _write_manifest(dirpath: str, name: str, manifest: dict) -> None:
    tmp = os.path.join(dirpath, name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(dirpath, name))


def save_spectrum(dirpath: str, state: CountState, *, stage: str = "count",
                  status: str = "complete", extra: dict | None = None):
    """Write `state` (its table, exact or host spectrum and histogram) and
    a manifest with its config and threshold into `dirpath`; a sharded
    host spectrum writes this host's shard only."""
    os.makedirs(dirpath, exist_ok=True)
    arrays = {}
    extra = dict(extra or {})
    npz_name = "spectrum.npz"
    if state.bloom_table is not None:     # None past the replicate budget
        arrays["bloom_table"] = state.bloom_table.cpu().numpy()
    if state.exact_cap is not None:
        uniq, counts, n = state.host.padded(state.exact_cap)
        arrays.update(exact_uniq=uniq, exact_counts=counts, exact_n=n)
    elif isinstance(state.host, ShardedHostSpectrum):
        host = state.host
        arrays.update(host_uniq=host.local.uniq,
                      host_counts=host.local.counts,
                      host_bounds=np.asarray(host.bounds))
        extra["host_shard"] = [host.pid, host.n_procs]
        npz_name = f"spectrum.p{host.pid}.npz"
    elif state.host is not None:
        # host-resident spectrum (past device capacity): save unpadded
        arrays.update(host_uniq=state.host.uniq,
                      host_counts=state.host.counts)
    if state.hist is not None:
        arrays["hist"] = np.asarray(state.hist)
    np.savez(os.path.join(dirpath, npz_name), **arrays)
    manifest = {
        "stage": stage, "status": status, "threshold": state.threshold,
        "config": json.loads(state.cfg.to_json()), "npz": npz_name,
        **extra,
    }
    shard = extra.get("host_shard")
    _write_manifest(dirpath, "manifest.json" if shard is None
                    else f"manifest.p{shard[0]}.json", manifest)
    if shard is not None and shard[0] == 0:
        # host 0 also writes the canonical manifest (the done checks)
        _write_manifest(dirpath, "manifest.json", manifest)


def save_state(dirpath: str, state: CountState, **kw) -> None:
    """save_spectrum from the ranks that keep `state`: every host leader for
    a sharded host spectrum, rank 0 alone for anything else; across hosts
    every rank then waits until every writer is done, so a later marker
    implies every shard is on disk."""
    sharded = isinstance(state.host, ShardedHostSpectrum) \
        and state.host.n_procs > 1
    if sharded or dmesh.is_writer():
        save_spectrum(dirpath, state, **kw)
    if dmesh.process_count() > 1:
        dmesh.host_barrier(f"save_{kw.get('stage', 'count')}")


def load_spectrum(dirpath: str, pid: int | None = None,
                  n_procs: int | None = None):
    """Returns (manifest dict, arrays dict) or (None, None) if absent.

    A sharded save holds one npz a host; pass this host's `pid` (and
    `n_procs`) to load its shard. Where the manifest is a shard, its
    [pid, n_procs] must be the caller's: a resume under another host count,
    or a missing per-host manifest falling back to host 0's shard, would
    adopt the wrong key range, so it raises the reference's error."""
    mpath = os.path.join(dirpath, "manifest.json")
    if pid is not None and os.path.exists(
            os.path.join(dirpath, f"manifest.p{pid}.json")):
        mpath = os.path.join(dirpath, f"manifest.p{pid}.json")
    if not os.path.exists(mpath):
        return None, None
    with open(mpath) as f:
        manifest = json.load(f)
    if "host_shard" in manifest:
        want = [pid if pid is not None else 0,
                n_procs if n_procs is not None else 1]
        if manifest["host_shard"] != want:
            raise RuntimeError(
                f"sharded spectrum checkpoint geometry mismatch: manifest "
                f"{mpath} holds shard {manifest['host_shard']} but this "
                f"process is {want} — resume with the original process "
                f"count, or delete the stage checkpoint to re-count")
    with np.load(os.path.join(dirpath,
                              manifest.get("npz", "spectrum.npz"))) as z:
        arrays = dict(z)
    return manifest, arrays


def state_from_checkpoint(cfg: KmeraxConfig, manifest: dict, arrays: dict,
                          device, *, host_form: bool) -> CountState:
    """A CountState from a loaded checkpoint, with the table on `device`.

    The spectrum comes from the padded exact form (its first exact_n rows,
    counts as int64). `host_form` also reads `host_uniq`/`host_counts`, as
    the JAX package's two-pass resume does (a `host_shard` manifest's as
    this host's ShardedHostSpectrum); its CLI's `_load_or_count` does not,
    so there a host-form checkpoint gives a state without a spectrum
    (correct still works; assemble raises)."""
    host, cap = None, None
    if "exact_uniq" in arrays:
        n = int(arrays["exact_n"])
        host = HostSpectrum(
            np.ascontiguousarray(arrays["exact_uniq"][:n]),
            arrays["exact_counts"][:n].astype(np.int64), cfg.k)
        cap = len(arrays["exact_uniq"])
    elif host_form and "host_uniq" in arrays:
        host = HostSpectrum(arrays["host_uniq"],
                            arrays["host_counts"].astype(np.int64), cfg.k)
        if "host_shard" in manifest:
            pid, n_procs = manifest["host_shard"]
            host = ShardedHostSpectrum(
                host, cfg.k, n_procs, pid,
                arrays.get("host_bounds", np.zeros(0, np.uint64)))
    table = torch.from_numpy(arrays["bloom_table"]).to(device)
    return CountState(cfg, table, arrays.get("hist"), manifest["threshold"],
                      manifest.get("n_reads", 0), manifest.get("n_kmers", 0),
                      host=host, exact_cap=cap)
