"""kmerax_torch — the PyTorch/CUDA port of kmerax for one NVIDIA H100.

The JAX package `kmerax/` is the reference: this package mirrors its layout
and names and produces the same bytes (DESIGN.md §13) for every
entry point of its CLI on one host: count, correct (Bloom or exact
spectrum), assemble, the pipeline (one pass or two, k -> k2) with spectrum
checkpoints and resume, align-validate, and the `bench` presets and
acceptance configs, under either bucket scheme, on either wire (int8 or
2-bit), on one device or on a ("data", "bucket") mesh of one process per
device. It imports torch and never jax or kmerax.

  core/      2-bit codec, k-mer extraction, hashing, minimizers (torch,
             int64 words)
  io/        FASTQ/FASTA streaming, batching, the 2-bit wire and a batch's
             trip to the device, per-host shards and unit plan (numpy,
             torch)
  spectrum/  counting Bloom (kernels K1, K1r, K2), exact host spectrum,
             the bucket-sharded spectrum of a mesh
  dist/      the mesh: process groups over torch.distributed, launch
  ops/       error correction (kernel K3), seed index and banded
             alignment (kernel K4)
  graph/     unitig assembly of a given spectrum, host path (kernel K5)
  pipeline/  count / correct / align / run stages (run re-counts for the
             assembly), checkpoint, twopass
  bench/     benchmark presets, acceptance configs, read simulator
  cli        `python -m kmerax_torch.cli count|correct|assemble|pipeline|
             align|bench ...`
  csrc/      the CUDA kernels (sm_90a), built at first use
"""

__version__ = "0.1.0"

from kmerax_torch.config import KmeraxConfig
