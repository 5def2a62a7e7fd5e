"""Run configuration: the same frozen dataclass as the JAX package's
`kmerax/config.py` (same fields, defaults and validation), so a config
serialized by one package loads in the other, and the port honours every
field.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KmeraxConfig:
    # k-mer / minimizer (DESIGN.md §§2,4)
    k: int = 31
    minimizer_m: int = 11
    num_buckets: int = 256
    # "hash": bucket = h1 bits (DESIGN.md §5a); "minimizer": DESIGN.md §4
    bucket_scheme: str = "hash"

    # counting Bloom spectrum (DESIGN.md §5)
    bloom_log2_width: int = 24
    bloom_hashes: int = 4
    # counter storage: "i32", or "p16" (two saturating 16-bit counters a
    # word, half the table bytes); "auto" resolves to "i32" in the port, as
    # in the JAX package off a TPU (its p16 keeps tables VMEM-resident).
    # Sharded spectra (a mesh) keep i32 counters.
    bloom_counter: str = "auto"

    # exact spectrum (DESIGN.md §6): needed for auto-threshold + assembly
    exact_spectrum: bool = True
    exact_capacity: int = 1 << 22     # sizes the pending raw-row buffer
    # multi-host key-range sharding of the exact spectrum: in one process
    # it only reaches the checkpoint manifest, as in the JAX package
    shard_host_spectrum: Optional[bool] = None

    # solid threshold (DESIGN.md §7); None = auto from histogram valley
    threshold: Optional[int] = None

    # correction (DESIGN.md §8)
    rounds: int = 2
    max_runs: int = 8
    max_edits: int = 8

    # alignment (DESIGN.md §10)
    band: int = 15

    # batching / IO
    batch_reads: int = 4096
    max_read_len: int = 160
    per_host_io: bool = True
    # 2-bit host<->device wire for N-free batches (io/wire.py); the output
    # bytes are identical either way (DESIGN.md §11b)
    wire_pack: bool = True

    # mesh (DESIGN.md §12): D x S ranks, one process per device
    mesh_data: int = 1
    mesh_bucket: int = 1

    # two-pass mode (BASELINE.md config 5): second-pass k, 0 = disabled
    k2: int = 0

    def __post_init__(self):
        if self.k % 2 == 0 or not (0 < self.k <= 63):
            raise ValueError(f"k must be odd in (0, 63], got {self.k}")
        if not (0 < self.minimizer_m <= 15 and self.minimizer_m < self.k):
            raise ValueError(f"minimizer_m must be in (0,15] and < k")
        if self.k2 and (self.k2 % 2 == 0 or not (0 < self.k2 <= 63)):
            raise ValueError(f"k2 must be odd in (0, 63], got {self.k2}")
        if not (0 < self.bloom_log2_width <= 31):
            raise ValueError("bloom_log2_width must be in (0, 31]")
        nb = self.num_buckets
        if nb & (nb - 1) or nb <= 0:
            raise ValueError("num_buckets must be a power of two")
        if self.bucket_scheme not in ("hash", "minimizer"):
            raise ValueError("bucket_scheme must be 'hash' or 'minimizer'")
        if self.bloom_counter not in ("auto", "i32", "p16"):
            raise ValueError("bloom_counter must be auto, i32, or p16")
        if (nb - 1).bit_length() > self.bloom_log2_width - 7:
            raise ValueError(
                "bloom_log2_width must be >= log2(num_buckets) + 7 "
                "(128-lane blocks, DESIGN.md §5)")
        mb = self.mesh_bucket
        if mb & (mb - 1) or mb <= 0 or mb > nb:
            raise ValueError("mesh_bucket must be a power of two <= num_buckets")

    @property
    def num_words(self) -> int:
        return (self.k + 15) // 16

    def replace(self, **kw) -> "KmeraxConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "KmeraxConfig":
        return cls(**json.loads(s))

    @classmethod
    def load(cls, toml_path: Optional[str] = None, **overrides) -> "KmeraxConfig":
        """defaults <- TOML file <- explicit overrides (None values ignored)."""
        fields = {}
        if toml_path:
            import tomllib
            with open(toml_path, "rb") as f:
                data = tomllib.load(f)
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(data) - known
            if unknown:
                raise ValueError(f"unknown config keys in {toml_path}: {sorted(unknown)}")
            fields.update(data)
        fields.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**fields)
