"""Spectrum checkpoint / resume (port of kmerax/pipeline/checkpoint.py).

The spectrum (Bloom table + exact sorted array) is the only large state
between passes. It is saved as raw `spectrum.npz` + a JSON
`manifest.json`, written through a `.tmp` file and `os.replace`, in the
JAX package's format: a spectrum saved by one package loads in the other.
A spectrum that fits `exact_capacity` is saved in the JAX package's device
form (`exact_uniq` padded with sentinel rows, `exact_counts` int32,
`exact_n`), built on the host at save time; past capacity as `host_uniq`
and `host_counts`. The multi-host sharded form is not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from kmerax_torch.config import KmeraxConfig
from kmerax_torch.pipeline.count import CountState
from kmerax_torch.spectrum.host import HostSpectrum


def save_spectrum(dirpath: str, state: CountState, *, stage: str = "count",
                  status: str = "complete", extra: dict | None = None):
    """Write `state` (its table, exact or host spectrum and histogram) and
    a manifest with its config and threshold into `dirpath`."""
    os.makedirs(dirpath, exist_ok=True)
    arrays = {}
    if state.bloom_table is not None:     # None past the replicate budget
        arrays["bloom_table"] = state.bloom_table.cpu().numpy()
    if state.exact_cap is not None:
        uniq, counts, n = state.host.padded(state.exact_cap)
        arrays.update(exact_uniq=uniq, exact_counts=counts, exact_n=n)
    elif state.host is not None:
        # host-resident spectrum (past device capacity): save unpadded
        arrays.update(host_uniq=state.host.uniq,
                      host_counts=state.host.counts)
    if state.hist is not None:
        arrays["hist"] = np.asarray(state.hist)
    npz_name = "spectrum.npz"
    np.savez(os.path.join(dirpath, npz_name), **arrays)
    manifest = {
        "stage": stage, "status": status, "threshold": state.threshold,
        "config": json.loads(state.cfg.to_json()), "npz": npz_name,
        **(extra or {}),
    }
    tmp = os.path.join(dirpath, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(dirpath, "manifest.json"))


def load_spectrum(dirpath: str):
    """Returns (manifest dict, arrays dict) or (None, None) if absent."""
    mpath = os.path.join(dirpath, "manifest.json")
    if not os.path.exists(mpath):
        return None, None
    with open(mpath) as f:
        manifest = json.load(f)
    if "host_shard" in manifest:
        raise NotImplementedError(
            "not yet ported to kmerax_torch: the multi-host sharded "
            f"spectrum checkpoint at {dirpath}")
    with np.load(os.path.join(dirpath,
                              manifest.get("npz", "spectrum.npz"))) as z:
        arrays = dict(z)
    return manifest, arrays


def state_from_checkpoint(cfg: KmeraxConfig, manifest: dict, arrays: dict,
                          device, *, host_form: bool) -> CountState:
    """A CountState from a loaded checkpoint, with the table on `device`.

    The spectrum comes from the padded exact form (its first exact_n rows,
    counts as int64). `host_form` also reads `host_uniq`/`host_counts`, as
    the JAX package's two-pass resume does; its CLI's `_load_or_count`
    does not, so there a host-form checkpoint gives a state without a
    spectrum (correct still works; assemble raises)."""
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
    table = torch.from_numpy(arrays["bloom_table"]).to(device)
    return CountState(cfg, table, arrays.get("hist"), manifest["threshold"],
                      manifest.get("n_reads", 0), manifest.get("n_kmers", 0),
                      host=host, exact_cap=cap)
