"""kmerax_torch — the PyTorch/CUDA port of kmerax for one NVIDIA H100.

The JAX package `kmerax/` is the reference: this package mirrors its layout
and names and produces the same bytes (DESIGN.md §13) for every
single-device entry point of its CLI but `bench`: count, correct (Bloom or
exact spectrum), assemble, the pipeline (one pass or two, k -> k2) with
spectrum checkpoints and resume, and align-validate, under either bucket
scheme. It imports torch and never jax or kmerax.

  core/      2-bit codec, k-mer extraction, hashing, minimizers (torch,
             int64 words)
  io/        FASTQ/FASTA streaming, batching (numpy)
  spectrum/  counting Bloom (kernels K1, K2), exact host spectrum
  ops/       error correction (kernel K3), seed index and banded
             alignment (kernel K4)
  graph/     unitig assembly, host path
  pipeline/  count / correct / align / run stages, checkpoint, twopass
  cli        `python -m kmerax_torch.cli count|correct|assemble|pipeline|
             align ...`
  csrc/      the CUDA kernels (sm_90a), built at first use
"""

__version__ = "0.1.0"

from kmerax_torch.config import KmeraxConfig
